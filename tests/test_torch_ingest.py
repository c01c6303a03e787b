"""The port's raw-corpus ingest (registry corpus table, data/readers.py,
data/native.py with its own C++ source, the ingest half of data/export.py,
cli export and export-shards) against the JAX package's.

Against JAX, on the same files:
  * every case of tests/test_wfdb_conformance.py (formats 212 odd and
    interleaved, 16 with offset/sentinel/checksum, 80, 24, 32,
    multi-frequency frames, gain 0, scientific gain, checksum mismatch,
    the hand values), through the port's numpy path and through its native
    build, each bit for bit equal to JAX's ``read_record`` / ``_decode_fmt``
    (JAX's numpy readers);
  * ``read_csv_record`` (stdlib csv) against JAX's pandas reader, bit for bit
    after the f32 cast; ``BulkHdf5Reader`` in both orientations;
  * ``export_combined`` (FFT resample on the port's device, here the CPU)
    within ``SUM_ORDER`` of the largest output (the resample tolerance of
    tests/test_torch_denoise_ops.py), its meta equal; ``export_shards``' data
    byte for byte and its meta equal; ``records.csv`` byte for byte;
  * the native batch reader bit for bit equal to the numpy path on a
    PTB-XL-shaped tree; the CLI subcommands end to end, with the row
    alignment of tests/test_raw_tree_integration.py.
The native cases need a C++ compiler; without one they skip.
"""
import dataclasses
import json
import os

import h5py
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu import cli as jcli
from ecg_representation_learning_tpu import registry as jreg
from ecg_representation_learning_tpu.data import export as jexport
from ecg_representation_learning_tpu.data import readers as jreaders
from ecg_representation_learning_tpu_torch import cli, registry
from ecg_representation_learning_tpu_torch.data import export, native, readers
from ecg_representation_learning_tpu_torch.ops import _build
from test_raw_tree_integration import DC_PER_ID, _make_tree, _write_record
from test_torch_denoise_ops import SUM_ORDER
from test_wfdb_conformance import (_A_DAT, _A_DIG, _A_HEA, _B_DAT, _B_HEA, _C_DAT, _C_HEA,
                                   _D_DAT, _F_DAT, _F_HEA, _G24_DAT, _PAYLOADS)

HAVE_CXX = _build.host_compiler() is not None
PATHS = ['numpy', pytest.param('native', marks=pytest.mark.skipif(
    not HAVE_CXX, reason='no C++ compiler for the native decoder'))]


@pytest.fixture
def path_mode(request):
    """Run the body on the numpy path (native disabled) or the native one."""
    if request.param == 'numpy':
        with native.disabled():
            yield 'numpy'
    else:
        assert native.native_available()
        yield 'native'


def _write(tmp_path, name, hea: str, dat: bytes):
    (tmp_path / f'{name}.hea').write_text(hea)
    (tmp_path / f'{name}.dat').write_bytes(dat)
    return str(tmp_path / name)


# every record of test_wfdb_conformance.py: (name, header, payload, verify)
_H32 = np.array([1, -1, 2147483647, -2147483648], '<i4').tobytes()
RECORDS = [
    ('recA', _A_HEA, _A_DAT, True),                                           # 212, odd count
    ('recB', _B_HEA, _B_DAT, True),                                           # 212, interleaved
    ('recC', _C_HEA, _C_DAT, True),                                           # 16+24, sentinel
    ('recD', 'recD 1 250 4\nrecD.dat 80\n', _D_DAT, False),                  # 80, bare line
    ('recE', 'recE 1 250 4\nrecE.dat 80 0 8 0 0 -2 0 lead\n', _D_DAT, True),  # gain 0
    ('recG', 'recG 1 250 4\nrecG.dat 24 1000(0)/mV 24 0 65536 -1 0 x\n', _G24_DAT, True),
    ('recH', 'recH 1 250 4\nrecH.dat 32 1(0)/mV 32 0 1 -1 0 x\n', _H32, True),
    ('recF', _F_HEA, _F_DAT, True),                                           # 16x2 frames
    ('recI', 'recI 1 500/1000 4\nrecI.dat 80 1.234e+03(-5)/uV 8 -5 0 -2 0 my lead name\n',
     _D_DAT, False),                                                          # scientific gain
]


def test_registry_corpus_table_is_the_jax_copy():
    assert registry.DATASETS.keys() == jreg.DATASETS.keys()
    for key, meta in registry.DATASETS.items():
        assert dataclasses.asdict(meta) == dataclasses.asdict(jreg.DATASETS[key]), key
    assert registry.EXPORT_DATASETS == jreg.EXPORT_DATASETS
    assert registry.WFDB_DATASETS == jreg.WFDB_DATASETS


@pytest.mark.parametrize('path_mode', PATHS, indirect=True)
@pytest.mark.parametrize('name,hea,dat,verify', RECORDS, ids=[r[0] for r in RECORDS])
def test_read_record_is_jax_bit_for_bit(path_mode, name, hea, dat, verify, tmp_path):
    path = _write(tmp_path, name, hea, dat)
    for physical in (False, True):
        got, hdr = readers.read_record(path, physical=physical, verify_checksum=verify)
        want, jhdr = jreaders.read_record(path, physical=physical, verify_checksum=verify)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)        # NaNs in the same places
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert dataclasses.asdict(hdr) == dataclasses.asdict(jhdr)


@pytest.mark.parametrize('path_mode', PATHS, indirect=True)
def test_hand_values(path_mode, tmp_path):
    """The literal values of the conformance suite, on the port."""
    dig, hdr = readers.read_record(_write(tmp_path, 'recA', _A_HEA, _A_DAT),
                                   physical=False, verify_checksum=True)
    np.testing.assert_array_equal(dig[0], _A_DIG)
    assert hdr.fs == 250.0 and hdr.signals[0].checksum == 34
    phys, _ = readers.read_record(_write(tmp_path, 'recB', _B_HEA, _B_DAT))
    np.testing.assert_allclose(phys[1, [0, 1, 3]], [-0.025, -0.02, -0.01], rtol=1e-6)
    assert np.isnan(phys[0, 1]) and np.isnan(phys[1, 2])
    phys, hdr = readers.read_record(_write(tmp_path, 'recC', _C_HEA, _C_DAT))
    np.testing.assert_allclose(phys[0, :2], [0.3, -0.3], rtol=1e-6)
    assert hdr.signals[0].byte_offset == 24 and np.isnan(phys[0, 2])
    phys, hdr = readers.read_record(_write(tmp_path, 'recF', _F_HEA, _F_DAT))
    np.testing.assert_allclose(phys, [[0.15, 0.40], [0.07, -0.09]], rtol=1e-6)
    hdr = readers.read_header(_write(tmp_path, 'recI', RECORDS[-1][1], _D_DAT) + '.hea')
    assert (hdr.fs, hdr.signals[0].gain, hdr.signals[0].baseline) == (500.0, 1234.0, -5)
    assert hdr.signals[0].description == 'my lead name'


@pytest.mark.parametrize('path_mode', PATHS, indirect=True)
def test_checksum_mismatch_raises(path_mode, tmp_path):
    bad = _A_HEA.replace(' 34 ', ' 35 ').replace('recA', 'recJ')
    path = _write(tmp_path, 'recJ', bad, _A_DAT)
    with pytest.raises(ValueError, match='checksum mismatch'):
        readers.read_record(path, verify_checksum=True)
    dig, _ = readers.read_record(path, physical=False)
    np.testing.assert_array_equal(dig[0], _A_DIG)


_ALL_PAYLOADS = _PAYLOADS + [(32, _H32, 4, [1, -1, 2147483647, -2147483648])]


@pytest.mark.parametrize('path_mode', PATHS, indirect=True)
@pytest.mark.parametrize('fmt,raw,n,expected', _ALL_PAYLOADS)
def test_decode_fmt_is_jax_and_the_hand_values(path_mode, fmt, raw, n, expected):
    got = readers._decode_fmt(raw, fmt, n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(got, jreaders._decode_fmt(raw, fmt, n))
    if fmt == 212:
        np.testing.assert_array_equal(readers._decode_fmt212(raw, n), expected)


@pytest.mark.skipif(not HAVE_CXX, reason='no C++ compiler for the native decoder')
@pytest.mark.parametrize('fmt,raw,n,expected', _PAYLOADS)
def test_native_decoders_match_hand_values(fmt, raw, n, expected):
    np.testing.assert_array_equal(native.decode_fmt(raw, fmt, n), expected)
    assert native.decode_fmt(raw, 32, 1) is None          # no native fmt 32


@pytest.mark.skipif(not HAVE_CXX, reason='no C++ compiler for the native decoder')
def test_native_dig2phys_is_the_numpy_division(rng):
    """Every int16 value at several gains and baselines: the library's
    (d - baseline) / gain equals numpy's f32 division bit for bit, sentinel
    as NaN (the JAX package's C++ multiplies by 1/gain instead, which
    differs in the last bit)."""
    lib = native.load_native()
    d = np.arange(-32768, 32768, dtype=np.int32)
    for gain, base in ((200.0, 0), (1000.0, 7), (1234.0, -5), (0.5, 3)):
        out = np.empty(d.size, np.float32)
        lib.dig2phys(d, d.size, gain, base, -32768, 1, out)
        want = (d.astype(np.float32) - base) / gain
        want = np.where(d == -32768, np.nan, want)
        np.testing.assert_array_equal(out, want)


def test_native_library_is_built_from_the_port_source():
    if not HAVE_CXX:
        pytest.skip('no C++ compiler')
    assert native.native_available()
    assert native.SOURCE.parent == (
        __import__('pathlib').Path(export.__file__).resolve().parent / 'csrc')
    built = _build.host_library_path(native.SOURCE, _build.host_compiler())
    assert built.is_file() and built.parent == _build.BUILD_DIR
    assert 'native/libwfdb_native.so' not in str(built)


def test_native_none_without_a_compiler(monkeypatch, tmp_path):
    """No compiler: ``load_native()`` is None and the readers take numpy."""
    monkeypatch.setattr(native, '_TRIED', False)
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(_build, 'host_compiler', lambda: None)
    assert native.load_native() is None and not native.native_available()
    assert native.decode_fmt(_A_DAT, 212, 5) is None
    dig, _ = readers.read_record(_write(tmp_path, 'recA', _A_HEA, _A_DAT), physical=False)
    np.testing.assert_array_equal(dig[0], _A_DIG)


@pytest.mark.skipif(not HAVE_CXX, reason='no C++ compiler')
def test_native_build_failure_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / 'wfdb_native.cpp'
    bad.write_text('this is not C++;\n')
    monkeypatch.setattr(native, '_TRIED', False)
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, 'SOURCE', bad)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='host build of wfdb_native.cpp failed') as err:
        native.load_native()
    assert 'error' in str(err.value)


# ---------------------------------------------------------------------------
# CSV and bulk readers
# ---------------------------------------------------------------------------
def _write_csv(path, values, fmt):
    with open(path, 'w') as f:
        f.write(','.join(jreg.LEAD_NAMES) + '\n')
        for row in values:
            f.write(','.join(fmt(v) for v in row) + '\n')


@pytest.mark.parametrize('fmt', ['repr', 'g6', 'f3', 'e', 'int'])
def test_read_csv_record_matches_pandas(fmt, rng, tmp_path):
    """Random values written five ways: equal to the pandas reader after the
    f32 cast, bit for bit (pandas' C float parser is not always correctly
    rounded in f64, but no such case reached f32 here)."""
    values = rng.standard_normal((600, 12)) * 10.0 ** rng.integers(-3, 4, (600, 12))
    if fmt == 'int':
        values = np.round(values * 1000)
    write = {'repr': lambda v: repr(float(v)), 'g6': lambda v: f'{v:g}', 'f3': lambda v: f'{v:.3f}',
             'e': lambda v: f'{v:.9e}', 'int': lambda v: str(int(v))}[fmt]
    path = tmp_path / 'r.csv'
    _write_csv(path, values, write)
    got, want = readers.read_csv_record(str(path)), jreaders.read_csv_record(str(path))
    assert got.shape == want.shape == (12, 600) and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_csv_record_na_strings_and_blank_lines(tmp_path):
    path = tmp_path / 'na.csv'
    path.write_text('I,II,III\n1.5,,NaN\n\n-2,NA,3e-3\nnan,4,null\n')
    got, want = readers.read_csv_record(str(path)), jreaders.read_csv_record(str(path))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 3) and np.isnan(got).sum() == 5


@pytest.mark.parametrize('layout', ['n_12_l', 'n_l_12'])
def test_bulk_hdf5_reader_both_orientations(layout, rng, tmp_path):
    data = rng.standard_normal((5, 12, 300)).astype(np.float32)
    path = tmp_path / 'ecg_tracings.hdf5'
    with h5py.File(path, 'w') as f:
        f.create_dataset('tracings', data=data if layout == 'n_12_l' else
                         data.transpose(0, 2, 1))
    got, want = readers.BulkHdf5Reader(str(path)), jreaders.BulkHdf5Reader(str(path))
    assert len(got) == len(want) == 5 and got.record_length == want.record_length == 300
    for i in range(5):
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(got[i], data[i])


# ---------------------------------------------------------------------------
# trees, batch readers, exports
# ---------------------------------------------------------------------------
FS_A, LEN_A = 500, 1000


def _ptbxl_tree(tmp_path, n, rng, lengths=None):
    root = tmp_path / 'rawA'
    rec_dir = root / 'PTB-XL' / 'records500' / '00000'
    rec_dir.mkdir(parents=True)
    for ecg_id in range(1, n + 1):
        length = LEN_A if lengths is None else lengths[ecg_id - 1]
        _write_record(rec_dir, ecg_id,
                      rng.normal(0, 0.4, (12, length)).astype(np.float32))
    return str(root)


def _codetest_tree(tmp_path, n, rng, length=820, transposed=False):
    root = tmp_path / 'rawB'
    (root / 'CODE-test').mkdir(parents=True)
    data = rng.normal(0, 0.4, (n, 12, length)).astype(np.float32)
    with h5py.File(root / 'CODE-test' / 'ecg_tracings.hdf5', 'w') as f:
        f.create_dataset('tracings', data=data.transpose(0, 2, 1) if transposed else data)
    return str(root)


def _chapman_tree(tmp_path, n, rng, length=700):
    root = tmp_path / 'rawC'
    d = root / 'Chapman-Shaoxing' / 'ECGData'
    d.mkdir(parents=True)
    for i in range(n):
        _write_csv(d / f'MUSE_{i:04d}.csv', rng.normal(0, 50, (length - 3 * i, 12)),
                   lambda v: f'{v:.4f}')
    return str(root)


@pytest.mark.skipif(not HAVE_CXX, reason='no C++ compiler for the native decoder')
def test_batch_reader_native_equals_numpy_and_jax(rng, tmp_path):
    root = _ptbxl_tree(tmp_path, 20, rng)
    paths = export.get_rec_paths('PTB-XL', root)
    assert paths == jexport.get_rec_paths('PTB-XL', root) and len(paths) == 20
    n, read = export._batch_reader('PTB-XL', paths)
    fast = read(0, n)
    with native.disabled():
        slow = export._batch_reader('PTB-XL', paths)[1](0, n)
    jn, jread = jexport._batch_reader('PTB-XL', paths)
    want = jread(0, jn)
    assert n == jn == 20
    for a, b, c in zip(fast, slow, want):
        assert a.dtype == b.dtype == c.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert export._wfdb_native_batch(paths, '.dat', 4) is not None


@pytest.mark.parametrize('key', ['PTB-XL', 'CODE-TEST', 'CHAP-SHAO'])
def test_probe_max_len_is_jax(key, rng, tmp_path):
    root = {'PTB-XL': lambda: _ptbxl_tree(tmp_path, 4, rng, lengths=[900, 1000, 960, 700]),
            'CODE-TEST': lambda: _codetest_tree(tmp_path, 3, rng, transposed=True),
            'CHAP-SHAO': lambda: _chapman_tree(tmp_path, 3, rng)}[key]()
    paths = export.get_rec_paths(key, root)
    assert export._probe_max_len(key, paths) == jexport._probe_max_len(key, paths)


def _combined(path):
    with h5py.File(path, 'r') as f:
        return np.asarray(f['data']), json.loads(f.attrs['meta'])


@pytest.mark.parametrize('key', ['PTB-XL', 'CODE-TEST', 'CHAP-SHAO'])
def test_export_combined_matches_jax(key, rng, tmp_path):
    """Ragged PTB-XL records (grouped by length), a bulk CODE-TEST file and
    Chapman CSVs: the port's file within the resample tolerance of JAX's,
    the same shape and meta; batch 3 splits the corpus across batches."""
    root = {'PTB-XL': lambda: _ptbxl_tree(tmp_path, 5, rng, lengths=[1000, 900, 1000, 880, 900]),
            'CODE-TEST': lambda: _codetest_tree(tmp_path, 5, rng),
            'CHAP-SHAO': lambda: _chapman_tree(tmp_path, 4, rng)}[key]()
    got_path = export.export_combined(key, root, str(tmp_path / 'port'), batch=3,
                                      device='cpu')
    want_path = jexport.export_combined(key, root, str(tmp_path / 'jax'), batch=3)
    assert os.path.basename(got_path) == os.path.basename(want_path)
    (got, meta), (want, jmeta) = _combined(got_path), _combined(want_path)
    assert meta == jmeta and got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=SUM_ORDER * np.abs(want).max())


@pytest.mark.parametrize('key,wire', [('PTB-XL', 'int16'), ('CODE-TEST', 'int16'),
                                      ('PTB-XL', 'float32')])
def test_export_shards_byte_equal_to_jax(key, wire, rng, tmp_path):
    root = (_ptbxl_tree(tmp_path, 7, rng) if key == 'PTB-XL'
            else _codetest_tree(tmp_path, 7, rng, transposed=True))
    got = export.export_shards(key, root, str(tmp_path / 'port'), records_per_shard=3,
                               wire_dtype=wire, wire_scale=500.0)
    want = jexport.export_shards(key, root, str(tmp_path / 'jax'), records_per_shard=3,
                                 wire_dtype=wire, wire_scale=500.0)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 3
    for g, w in zip(got, want):
        (gd, gm), (wd, wm) = _combined(g), _combined(w)
        assert gd.dtype == wd.dtype == np.dtype(wire) and gd.shape == wd.shape
        assert gd.tobytes() == wd.tobytes()
        assert gm == wm == export.read_shard_meta(g) == jexport.read_shard_meta(w)


def test_wire_chunk_clips_and_rounds():
    rec = np.array([[0.0004, 0.0006, -0.0015, 40.0, -40.0, np.nan]], np.float32)
    wire = export.wire_chunk([rec], 8)
    np.testing.assert_array_equal(wire, [[[0, 1, -2, 32767, -32768, 0, 0, 0]]])
    assert wire.dtype == np.int16


def test_export_records_csv_is_the_pandas_file(rng, tmp_path):
    root = _ptbxl_tree(tmp_path, 3, rng)
    got = export.export_records_csv(['PTB-XL', 'INCART'], root, str(tmp_path / 'p' / 'r.csv'))
    want = jexport.export_records_csv(['PTB-XL', 'INCART'], root, str(tmp_path / 'j' / 'r.csv'))
    assert open(got, 'rb').read() == open(want, 'rb').read()
    assert open(got).read().splitlines()[0] == 'dataset,record,path'
    empty = export.export_records_csv(['INCART'], root, str(tmp_path / 'e.csv'))
    jempty = jexport.export_records_csv(['INCART'], root, str(tmp_path / 'je.csv'))
    assert open(empty, 'rb').read() == open(jempty, 'rb').read()


def test_resample_chunk_is_the_combined_body(rng):
    chunk = [rng.standard_normal((12, n)).astype(np.float32) for n in (1000, 800, 1000)]
    chunk[1][3, 10] = np.nan
    out = export.resample_chunk(chunk, 500, 250, 480, device='cpu')
    assert out.shape == (3, 12, 480) and np.isfinite(out).all()
    assert (out[1, :, 400:] == 0).all() and not (out[0, :, 400:] == 0).all()


def test_cli_export_then_labels_keep_rows_aligned(monkeypatch, rng, tmp_path):
    """`cli export` on a PTB-XL tree with the identity watermark: the port's
    file equals the JAX CLI's within the resample tolerance, records.csv
    byte for byte, and every row's labels join to its record."""
    from ecg_representation_learning_tpu_torch.data import (export_ptbxl_labels,
                                                            load_ptbxl_from_export)
    monkeypatch.setattr(export, 'default_device', lambda device=None: torch.device('cpu'))

    def label_fn(ecg_id):
        return sorted({ecg_id % 71, (ecg_id * 7 + 3) % 71})
    root, db_csv = _make_tree(tmp_path, 20, label_fn, rng)
    cli.main(['export', '--dataset', 'PTB-XL', '--data-root', str(root),
              '--out', str(tmp_path / 'port')])
    jcli.main(['export', '--dataset', 'PTB-XL', '--data-root', str(root),
               '--out', str(tmp_path / 'jax')])
    (got, meta), (want, jmeta) = (_combined(tmp_path / d / 'PTB-XL-combined.hdf5')
                                  for d in ('port', 'jax'))
    assert meta == jmeta == {'dnm': 'PTB-XL', 'fqs': 250} and got.shape == (20, 12, 2500)
    np.testing.assert_allclose(got, want, rtol=0, atol=SUM_ORDER * np.abs(want).max())
    assert ((tmp_path / 'port' / 'records.csv').read_bytes()
            == (tmp_path / 'jax' / 'records.csv').read_bytes())
    labels_csv = str(tmp_path / 'labels.csv')
    export_ptbxl_labels(str(db_csv), labels_csv)
    splits = load_ptbxl_from_export(str(tmp_path / 'port' / 'PTB-XL-combined.hdf5'),
                                    labels_csv)
    n = 0
    for split in (splits.train, splits.eval, splits.test):
        for sig, lab in zip(split.signals, split.labels):
            ecg_id = int(round(float(sig[0].mean()) / DC_PER_ID))
            want_lab = np.zeros(lab.shape, lab.dtype)
            want_lab[label_fn(ecg_id)] = 1.0
            assert np.array_equal(lab, want_lab), ecg_id
            n += 1
    assert n == 20


def test_cli_export_shards_is_the_jax_cli(capsys, rng, tmp_path):
    root = _codetest_tree(tmp_path, 10, rng)
    args = ['export-shards', '--dataset', 'CODE-TEST', '--data-root', root,
            '--records-per-shard', '4']
    cli.main(args + ['--out', str(tmp_path / 'port')])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(args + ['--out', str(tmp_path / 'jax')])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got['shards'] == want['shards'] == 3
    assert os.path.basename(got['first']) == os.path.basename(want['first'])
    for i in range(3):
        name = f'CODE-TEST-shard-{i:04d}.hdf5'
        (gd, gm), (wd, wm) = (_combined(tmp_path / d / name) for d in ('port', 'jax'))
        assert gd.tobytes() == wd.tobytes() and gm == wm
        assert gm == {'dnm': 'CODE-TEST', 'fqs': 400, 'wire_dtype': 'int16',
                      'wire_scale': 1000.0}
