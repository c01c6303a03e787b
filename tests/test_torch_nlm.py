"""The fused NLM kernel's plain version (``ops/nlm_fused.py``) and the
attribution variants' plain versions (``tools/nlm_sol_probe.py`` of the port)
against the JAX package: the Pallas kernels run in interpret mode on the CPU,
as ``tests/test_nlm_pallas.py`` runs them, and the scan form ``ops/nlm.nlm``.

Tolerance: 2e-6 of the output's scale, the JAX package's own bar between its
kernel and the scan (``tests/test_nlm_pallas.py``): the box sums and
accumulations are taken in another order.
"""
import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import ecg_representation_learning_tpu.ops.nlm  # noqa: F401
from ecg_representation_learning_tpu.ops.nlm_pallas import _nlm_pallas_2d, nlm_pallas
from ecg_representation_learning_tpu_torch.ops import _build, nlm_fused
from ecg_representation_learning_tpu_torch.tools import nlm_sol_probe as probe
from tools.nlm_sol_probe import _variant_kernel

jnlm = sys.modules['ecg_representation_learning_tpu.ops.nlm']
TOL = 2e-6


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.nanmax(np.abs(want)))


def bandwidths(x2: np.ndarray, pw: int) -> np.ndarray:
    return nlm_fused.nlm_bandwidth(torch.from_numpy(x2), 1.5, pw).numpy()


@pytest.mark.parametrize('shape,sw,pw', [
    ((2, 3, 150), 32, 10),
    ((1, 1, 120), None, 5),   # full search
    ((4, 2, 200), 64, 7),
    ((1, 12, 500), 64, 10),
])
def test_nlm_fused_matches_jax_kernel_and_scan(rng, shape, sw, pw):
    x = rng.standard_normal(shape).astype(np.float32) * 10
    want_kernel = np.asarray(nlm_pallas(jnp.asarray(x), sch_wd=sw, patch_wd=pw, block_rows=8,
                                        interpret=True))
    want_scan = np.asarray(jnlm.nlm(jnp.asarray(x), sch_wd=sw, patch_wd=pw))
    got = nlm_fused.nlm_fused(torch.from_numpy(x), sch_wd=sw, patch_wd=pw).numpy()
    assert got.shape == shape and got.dtype == np.float32
    assert_close(got, want_kernel)
    assert_close(got, want_scan)


# rows not a multiple of the TPU's row block, lengths off the 128-lane grid,
# search wider than the signal
@pytest.mark.parametrize('rows,n,sw,pw', [(13, 199, 64, 7), (5, 150, 150, 10),
                                          (3, 70, 90, 3), (2, 64, 64, 0)])
def test_nlm_rows_reference_matches_the_jax_kernel(rng, rows, n, sw, pw):
    x2 = rng.standard_normal((rows, n)).astype(np.float32) * 3
    h2 = bandwidths(x2, pw)
    want = np.asarray(_nlm_pallas_2d(jnp.asarray(x2), jnp.asarray(h2), sw, pw, block_rows=8,
                                     interpret=True))
    got = nlm_fused.nlm_rows_reference(torch.from_numpy(x2), torch.from_numpy(h2), sw, pw)
    assert_close(got.numpy(), want)


def test_edges_pass_through(rng):
    x = rng.standard_normal((1, 100)).astype(np.float32)
    pw = 7
    got = nlm_fused.nlm_fused(torch.from_numpy(x), sch_wd=16, patch_wd=pw).numpy()
    np.testing.assert_array_equal(got[0, :pw + 1], x[0, :pw + 1])
    np.testing.assert_array_equal(got[0, -pw:], x[0, -pw:])
    assert not np.array_equal(got[0, pw + 1:-pw], x[0, pw + 1:-pw])


def test_all_zero_row_is_nan_in_both(rng):
    x2 = rng.standard_normal((4, 120)).astype(np.float32)
    x2[2] = 0.0
    pw = 5
    h2 = bandwidths(x2, pw)
    assert h2[2] == 0.0
    want = np.asarray(_nlm_pallas_2d(jnp.asarray(x2), jnp.asarray(h2), 40, pw, block_rows=8,
                                     interpret=True))
    got = nlm_fused.nlm_rows(torch.from_numpy(x2), torch.from_numpy(h2), 40, pw).numpy()
    interior = slice(pw + 1, 120 - pw)
    assert np.isnan(want[2, interior]).all() and np.isnan(got[2, interior]).all()
    np.testing.assert_array_equal(got[2, :pw + 1], 0.0)
    keep = [0, 1, 3]
    assert np.isfinite(got[keep]).all()
    assert_close(got[keep], want[keep])


def jax_variant(x2, h2, sch_wd, patch_wd, flags, block_rows=8):
    """The JAX probe's ``_variant_kernel`` in interpret mode, with
    ``_run_variant``'s grid and block specs."""
    r, n = x2.shape
    lp = -(-(n + patch_wd) // 128) * 128
    rp = -(-r // block_rows) * block_rows
    xp = jnp.pad(x2, ((0, rp - r), (0, lp - n)))
    hp = jnp.broadcast_to(
        jnp.pad(1.0 / h2, (0, rp - r), constant_values=1.0).reshape(rp, 1), (rp, 128))
    kernel = functools.partial(
        _variant_kernel, n_real=n, n_pairs=sch_wd, patch_wd=patch_wd, lp=lp,
        boxtree=flags.get('boxtree', True), use_exp=flags.get('exp', True),
        mirror=flags.get('mirror', True), accum=flags.get('accum', True))
    out = pl.pallas_call(
        kernel,
        out_shape=jax_struct((rp, lp)),
        grid=(rp // block_rows, sch_wd),
        in_specs=[pl.BlockSpec((block_rows, lp), lambda rb, si: (rb, 0)),
                  pl.BlockSpec((block_rows, 128), lambda rb, si: (rb, 0))],
        out_specs=pl.BlockSpec((block_rows, lp), lambda rb, si: (rb, 0)),
        scratch_shapes=[pltpu.VMEM((block_rows, lp), jnp.float32),
                        pltpu.VMEM((block_rows, lp), jnp.float32)],
        compiler_params=pltpu.CompilerParams(dimension_semantics=('parallel', 'arbitrary')),
        interpret=True,
    )(xp, hp)
    return np.asarray(out[:r, :n])


def jax_struct(shape):
    import jax
    return jax.ShapeDtypeStruct(shape, jnp.float32)


@pytest.mark.parametrize('name,flags', probe.VARIANTS, ids=[v[0] for v in probe.VARIANTS])
def test_variant_reference_matches_the_jax_probe_kernel(rng, name, flags):
    # the probe's inputs: N(0, 1) rows with h = 1, here at (12, 300), search 32
    x2 = rng.standard_normal((12, 300)).astype(np.float32)
    h2 = np.ones(12, np.float32)
    want = jax_variant(jnp.asarray(x2), jnp.asarray(h2), 32, 10, flags)
    got = probe.run_variant(torch.from_numpy(x2), torch.from_numpy(h2), 32, 10, flags)
    assert np.isfinite(got.numpy()).all()
    assert_close(got.numpy(), want)


def test_full_variant_is_the_kernel_up_to_eps(rng):
    x2 = torch.from_numpy(rng.standard_normal((3, 90)).astype(np.float32))
    h2 = torch.ones(3)
    full = probe.variant_reference(x2, h2, 20, 4, {})
    torch.testing.assert_close(full, nlm_fused.nlm_rows_reference(x2, h2, 20, 4),
                               rtol=0, atol=0)


def test_wrappers_run_the_plain_version_on_the_cpu_and_count_no_launch(rng):
    x2 = torch.from_numpy(rng.standard_normal((3, 80)).astype(np.float32))
    h2 = torch.full((3,), 2.0)
    before = _build.launch_counts()
    torch.testing.assert_close(nlm_fused.nlm_rows(x2, h2, 16, 4),
                               nlm_fused.nlm_rows_reference(x2, h2, 16, 4), rtol=0, atol=0)
    torch.testing.assert_close(probe.run_variant(x2, h2, 16, 4, {'exp': False}),
                               probe.variant_reference(x2, h2, 16, 4, {'exp': False}),
                               rtol=0, atol=0)
    assert _build.launch_counts() == before
    with pytest.raises(RuntimeError, match='no nlm'):
        nlm_fused.nlm_rows(x2.to('meta'), h2.to('meta'), 16, 4)
    with pytest.raises(ValueError, match='CUDA'):
        nlm_fused.nlm_rows_kernel(x2, 1.0 / h2, 16, 4)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        probe.measure()


@pytest.mark.parametrize('n,sw,pw', [(40, 40, 3), (53, 30, 4), (30, 45, 3), (2500, 128, 10)])
def test_needed_weights_counts_the_terms(n, sw, pw):
    # brute force: positions whose weight a +s or a -s term reads, their hull
    total = 0
    for s in range(min(sw, n)):
        used = [i for i in range(pw + 1, n - pw) if i + s < n]
        used += [i - s for i in range(pw + 1, n - pw) if s > 0 and i - s > 0]
        if used:
            total += max(used) + 1 - min(used)
    assert nlm_fused.needed_weights(n, sw, pw) == total
