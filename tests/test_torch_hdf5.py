"""The port's combined-HDF5 corpus and label index against the JAX package's.

Files written by one side are read by the other: ``write_combined_hdf5``
and ``EcgDataset`` (the partially-denoised mask, the 250 Hz assert), the
label index of ``export_ptbxl_labels`` (pandas on the JAX side, the ``csv``
module in the port), and the splits of ``load_ptbxl_from_export``, which
must be byte-equal to JAX's on the same files.
"""
import json

import h5py
import numpy as np
import pandas as pd
import pytest

from ecg_representation_learning_tpu import cli as jcli
from ecg_representation_learning_tpu.data import datasets as jds
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.data import datasets as tds

SIDES = {'jax': jds, 'port': tds}


def _signals(n=24, length=320, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 12, length)).astype(np.float32)


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
def test_combined_hdf5_round_trips(tmp_path, writer, reader):
    x = _signals()
    path = SIDES[writer].write_combined_hdf5(str(tmp_path / 'a' / 'x-combined.hdf5'), x,
                                             dataset_name='INCART')
    ds = SIDES[reader].EcgDataset(path)
    try:
        assert ds.attrs == {'dnm': 'INCART', 'fqs': 250}
        assert ds.is_full and len(ds) == 24
        np.testing.assert_array_equal(ds.idxs_processed, np.arange(24))
        got = ds.load()
        assert got.dtype == np.float32 and got.tobytes() == x.tobytes()
        assert ds.load([3, 5]).tobytes() == x[[3, 5]].tobytes()
    finally:
        ds.close()
    with h5py.File(path, 'r') as f:
        assert json.loads(f.attrs['meta']) == {'dnm': 'INCART', 'fqs': 250}


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_partially_denoised_file_masks_zero_records_like_jax(tmp_path, writer):
    """All-zero records are masked; a record whose first 8 samples of lead
    0 are zero passes the cheap probe's miss and is kept by the full scan."""
    x = _signals()
    x[[2, 9, 17]] = 0.0
    x[5, 0, :8] = 0.0
    path = SIDES[writer].write_combined_hdf5(str(tmp_path / 'p.hdf5'), x)
    dsets = [jds.EcgDataset(path), tds.EcgDataset(path)]
    try:
        j, t = dsets
        assert not t.is_full and t.is_full == j.is_full
        np.testing.assert_array_equal(t.idxs_processed, j.idxs_processed)
        assert 5 in t.idxs_processed and 2 not in t.idxs_processed and len(t) == len(j) == 21
        assert t.load().tobytes() == j.load().tobytes() == x[t.idxs_processed].tobytes()
    finally:
        for d in dsets:
            d.close()


def test_dataset_asserts_the_250_hz_grid(tmp_path):
    path = jds.write_combined_hdf5(str(tmp_path / 'f.hdf5'), _signals(n=2), fqs=500)
    with pytest.raises(AssertionError):
        tds.EcgDataset(path)
    with pytest.raises(AssertionError):
        jds.EcgDataset(path)
    tds.EcgDataset(path, fqs=500).close()


def _corpus(tmp_path, writer):
    """(hdf5, labels csv) of a synthetic corpus, written by ``cli synth`` of
    the JAX package (pandas) or of the port (csv module)."""
    out = tmp_path / writer
    argv = ['synth', '--n', '60', '--seed', '3', '--out', str(out)]
    (jcli.main if writer == 'jax' else cli.main)(argv)
    return str(out / 'PTB-XL-combined.hdf5'), str(out / 'ptb-xl-labels.csv')


def test_cli_synth_writes_the_jax_files(tmp_path):
    jh5, jcsv = _corpus(tmp_path, 'jax')
    th5, tcsv = _corpus(tmp_path, 'port')
    assert open(tcsv, 'rb').read() == open(jcsv, 'rb').read()
    with h5py.File(jh5, 'r') as a, h5py.File(th5, 'r') as b:
        assert a['data'][()].tobytes() == b['data'][()].tobytes()
        assert a.attrs['meta'] == b.attrs['meta']


@pytest.mark.parametrize('n_sample', [None, 7])
@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_splits_are_byte_equal_to_the_jax_loader(tmp_path, writer, n_sample):
    h5, labels_csv = _corpus(tmp_path, writer)
    want = jds.load_ptbxl_from_export(h5, labels_csv, n_sample)
    got = tds.load_ptbxl_from_export(h5, labels_csv, n_sample)
    for name in ('train', 'eval', 'test'):
        a, b = getattr(want, name), getattr(got, name)
        assert isinstance(b.signals, np.ndarray) and b.signals.dtype == np.float32
        assert b.signals.tobytes() == a.signals.tobytes(), name
        assert b.labels.dtype == a.labels.dtype and b.labels.tobytes() == a.labels.tobytes()
        if n_sample:
            assert len(b) <= n_sample


DATABASE_CSV = '''ecg_id,patient_id,age,sex,scp_codes,strat_fold,filename_lr
1,15709.0,56.0,1,"{'NORM': 100.0, 'LVOLT': 0.0, 'SR': 0.0}",3,records100/00000/00001_lr
2,13243.0,19.0,0,"{'NORM': 80.0, 'SBRAD': 0.0}",2,records100/00000/00002_lr
5,11315.0,24.0,0,"{'NORM': 100.0, 'SR': 0.0}",10,records100/00000/00005_lr
7,19005.0,,1,"{'IMI': 35.0, 'ABQRS': 0.0, 'NOTACODE': 50.0}",9,records100/00000/00007_lr
9,17014.0,45.0,0,"{}",1,records100/00000/00009_lr
'''


def test_export_ptbxl_labels_matches_the_jax_index(tmp_path):
    db = tmp_path / 'ptbxl_database.csv'
    db.write_text(DATABASE_CSV)
    jout = jds.export_ptbxl_labels(str(db), str(tmp_path / 'j' / 'ptb-xl-labels.csv'))
    tout = tds.export_ptbxl_labels(str(db), str(tmp_path / 't' / 'ptb-xl-labels.csv'))
    assert open(tout, 'rb').read() == open(jout, 'rb').read()
    want, got = pd.read_csv(jout), pd.read_csv(tout)
    pd.testing.assert_frame_equal(got, want)
    assert list(got.columns) == ['ecg_id', 'patient_id', 'strat_fold', 'labels']
    assert got['labels'][0] == str(jds.parse_scp_codes("{'NORM': 1, 'LVOLT': 0, 'SR': 0}"))
    # the index loads into splits on both sides (five rows, folds 3, 2, 10, 9, 1)
    h5 = jds.write_combined_hdf5(str(tmp_path / 'x.hdf5'), _signals(n=5))
    for loader_csv in (jout, tout):
        a = jds.load_ptbxl_from_export(h5, loader_csv)
        b = tds.load_ptbxl_from_export(h5, loader_csv)
        for name in ('train', 'eval', 'test'):
            assert getattr(a, name).labels.tobytes() == getattr(b, name).labels.tobytes()
            assert getattr(a, name).signals.tobytes() == getattr(b, name).signals.tobytes()
