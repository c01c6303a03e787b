"""The denoise path of the port against the JAX package: ``zheng_denoise``,
``fused_export`` and ``fused_train_path`` on the same numpy inputs, then
``export_denoised`` and ``cli denoise`` end to end through a small combined
HDF5 file (resume and the broken-record lead included).  The port runs on
the CPU (``device='cpu'``), where the NLM step is the kernel's plain version;
the JAX package runs its CPU path (the scan form of NLM).

Tolerance of the chain: 5e-5 of the input's scale, the LOESS bar of
``tests/test_torch_denoise_ops.py`` (the robust LOESS's Cramer solve is where
the two float32 chains part most); 1e-5 for the resample/filter path.
"""
import json

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu import cli as jcli
from ecg_representation_learning_tpu.configs import PreprocessConfig as JaxPreprocessConfig
from ecg_representation_learning_tpu.data.export import export_denoised as jax_export_denoised
from ecg_representation_learning_tpu.ops import preprocess as jpre
from ecg_representation_learning_tpu.registry import PTBXL_TRAIN_STATS as JAX_STATS
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.configs import PreprocessConfig
from ecg_representation_learning_tpu_torch.data import synth_ecg
from ecg_representation_learning_tpu_torch.data.export import denoise_chunk, export_denoised
from ecg_representation_learning_tpu_torch.ops import preprocess
from ecg_representation_learning_tpu_torch.registry import PTBXL_TRAIN_STATS

CHAIN = 5e-5
RESAMPLE = 1e-5


def assert_close(got, want, scale, rel):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(scale).max())


def records(seed, n, length, n_lead=12):
    return synth_ecg(np.random.default_rng(seed), n, n_lead=n_lead, length=length)


def test_preprocess_config_copy_equals_the_jax_one():
    import dataclasses
    assert dataclasses.asdict(PreprocessConfig()) == dataclasses.asdict(JaxPreprocessConfig())


def test_denoise_constants_equal_the_jax_registry():
    from ecg_representation_learning_tpu import registry as jreg
    from ecg_representation_learning_tpu_torch import registry as treg
    assert treg.LOW_PASS.__dict__ == jreg.LOW_PASS.__dict__
    assert treg.NLM.__dict__ == jreg.NLM.__dict__


@pytest.mark.parametrize('shape,width', [((2, 12, 1000), 64), ((1, 1, 1000), None)],
                         ids=['search64', 'full-search'])
def test_zheng_denoise_matches_jax(shape, width):
    x = records(1, shape[0], shape[2], shape[1])
    want = np.asarray(jpre.zheng_denoise(jnp.asarray(x), fqs=250,
                                         cfg=JaxPreprocessConfig(nlm_search_width=width)))
    got = preprocess.zheng_denoise(torch.from_numpy(x), fqs=250,
                                   cfg=PreprocessConfig(nlm_search_width=width)).numpy()
    assert np.isfinite(got).all()
    assert_close(got, want, x, CHAIN)


@pytest.mark.parametrize('denoise', [True, False])
def test_fused_export_matches_jax(denoise):
    x = records(2, 1, 600, 2)
    kw = dict(nlm_search_width=16, loess_window=51)
    want = np.asarray(jpre.fused_export(jnp.asarray(x), fqs=500,
                                        cfg=JaxPreprocessConfig(**kw), denoise=denoise))
    got = preprocess.fused_export(torch.from_numpy(x), fqs=500, cfg=PreprocessConfig(**kw),
                                  denoise=denoise).numpy()
    assert got.shape == (1, 2, 300)
    assert_close(got, want, x, CHAIN if denoise else RESAMPLE)


@pytest.mark.parametrize('fqs', [500, 1000])
@pytest.mark.parametrize('lowpass', [True, False])
def test_fused_train_path_matches_jax(fqs, lowpass):
    x = records(3, 2, fqs * 4)
    mean, std = (np.asarray(JAX_STATS['original'][k], np.float32) for k in ('mean', 'std'))
    want = np.asarray(jpre.fused_train_path(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(std),
                                            fqs=fqs, lowpass=lowpass))
    tmean, tstd = (torch.tensor(PTBXL_TRAIN_STATS['original'][k]) for k in ('mean', 'std'))
    got = preprocess.fused_train_path(torch.from_numpy(x), tmean, tstd, fqs=fqs,
                                      lowpass=lowpass).numpy()
    assert got.shape == (2, 12, 1024)
    assert np.abs(got[..., 1000:]).max() == 0.0
    assert_close(got, want, want, RESAMPLE)


def test_denoise_chunk_keeps_an_all_zero_lead_zero():
    x = records(4, 2, 500)
    x[1, 11] = 0.0
    cfg = PreprocessConfig(nlm_search_width=32)
    raw = preprocess.zheng_denoise(torch.from_numpy(x), fqs=250, cfg=cfg).numpy()
    assert np.isnan(raw[1, 11, 11:-10]).all()          # h = 0: NaN, as in JAX
    got = denoise_chunk(x, 250, cfg, device='cpu')
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[1, 11], 0.0)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], raw[0])


N_RECORDS, LENGTH, DONE_ROW, BROKEN = 3, 500, 1, (2, 11)
FLAGS = ['--batch', '2', '--nlm-search-width', '32', '--loess-robust-iters', '2']
CFG = dict(nlm_search_width=32, loess_robust_iters=2)


@pytest.fixture(scope='module')
def combined(tmp_path_factory):
    """A combined export (N, 12, 500) at 250 Hz with one broken lead, and
    the JAX package's denoised file from it: resumed over a file whose
    DONE_ROW is already filled, and from scratch through its CLI."""
    root = tmp_path_factory.mktemp('denoise')
    x = records(5, N_RECORDS, LENGTH)
    x[BROKEN] = 0.0
    src = root / 'ptbxl-combined.hdf5'
    with h5py.File(src, 'w') as f:
        f.create_dataset('data', data=x)
        f.attrs['meta'] = json.dumps({'fqs': 250, 'dataset': 'synthetic'})

    def prefilled(name):
        path = root / name
        with h5py.File(path, 'w') as f:
            data = np.zeros_like(x)
            data[DONE_ROW] = 1.0
            f.create_dataset('data', data=data)
            f.attrs['meta'] = json.dumps({'fqs': 250, 'dataset': 'synthetic',
                                          'denoised': True})
        return str(path)

    jax_resumed = jax_export_denoised(str(src), prefilled('jax-resumed.hdf5'),
                                      cfg=JaxPreprocessConfig(**CFG), batch=2)
    jcli.main(['--platform', 'cpu', 'denoise', '--input', str(src), '--out',
               str(root / 'jax-cli.hdf5'), *FLAGS])
    return {'x': x, 'src': str(src), 'root': root, 'prefilled': prefilled,
            'jax_resumed': read(jax_resumed), 'jax_cli': read(root / 'jax-cli.hdf5')}


def read(path):
    with h5py.File(path, 'r') as f:
        return np.asarray(f['data']), json.loads(f.attrs['meta'])


def test_export_denoised_resumes_like_jax(combined):
    out = export_denoised(combined['src'], combined['prefilled']('port-resumed.hdf5'),
                          cfg=PreprocessConfig(**CFG), batch=2, device='cpu')
    got, meta = read(out)
    want, want_meta = combined['jax_resumed']
    assert meta == want_meta
    np.testing.assert_array_equal(got[DONE_ROW], 1.0)   # a done row is kept
    np.testing.assert_array_equal(got[BROKEN], 0.0)     # the broken lead stays zero
    assert np.isfinite(got).all()
    assert_close(got, want, combined['x'], CHAIN)


def test_cli_denoise_matches_the_jax_cli(combined, capsys):
    out = str(combined['root'] / 'port-cli.hdf5')
    cli.main(['denoise', '--input', combined['src'], '--out', out, *FLAGS, '--device', 'cpu'])
    assert capsys.readouterr().out.strip() == out
    got, meta = read(out)
    want, want_meta = combined['jax_cli']
    assert meta == want_meta == {'fqs': 250, 'dataset': 'synthetic', 'denoised': True}
    np.testing.assert_array_equal(got[BROKEN], 0.0)
    assert np.abs(got[DONE_ROW]).max() > 0
    assert_close(got, want, combined['x'], CHAIN)


def test_cli_denoise_default_output_name_and_no_resume(combined):
    src = combined['src']
    cli.main(['denoise', '--input', src, *FLAGS, '--device', 'cpu'])
    out = src.replace('-combined', '-denoised')
    first, _ = read(out)
    with h5py.File(out, 'r+') as f:        # a finished row is skipped on resume...
        f['data'][0] = 7.0
    cli.main(['denoise', '--input', src, *FLAGS, '--device', 'cpu'])
    np.testing.assert_array_equal(read(out)[0][0], 7.0)
    cli.main(['denoise', '--input', src, *FLAGS, '--device', 'cpu', '--no-resume'])
    np.testing.assert_array_equal(read(out)[0], first)   # ...and redone without it
