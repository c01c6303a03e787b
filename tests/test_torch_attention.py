"""The port's attention op against the JAX package's (ops/attention.py).

Same numpy inputs through both: the hashed dropout mask must be bit-equal,
the flash forward's plain version must match the Pallas kernel run in
interpret mode, and the dispatcher's plain branch must match JAX's.  The
CUDA kernel itself runs only on the GPU (chip_smoke.py holds it against the
plain version there); here its wrapper's input checks are covered.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu_torch.ops import _build
from ecg_representation_learning_tpu_torch.ops import attention as tattn

# the JAX package's ops/__init__ re-exports attention(), which shadows the
# module of the same name on attribute access
jattn = importlib.import_module('ecg_representation_learning_tpu.ops.attention')

torch.set_num_threads(2)


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize('rate', [0.1, 0.5])
@pytest.mark.parametrize('seed', [0, 1, 77, 2 ** 30, 2 ** 30 + 12345, 2 ** 31 - 1])
def test_dropout_keep_bit_equal(seed, rate):
    # (B*H, T, T) grid = (2*3, 41, 41), seeds past 2^30 exercise the wrap
    want = np.asarray(jattn._keep_full(jnp.int32(seed), 2, 3, 41, rate))
    got = tattn.keep_full(seed, 2, 3, 41, rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1.0 - rate)) < 0.02


def test_dropout_keep_broadcasts_scalars():
    want = np.asarray(jattn.dropout_keep(jnp.int32(5), 3, jnp.arange(64)[:, None],
                                         jnp.arange(64)[None, :], 0.3))
    got = tattn.dropout_keep(5, 3, torch.arange(64)[:, None],
                             torch.arange(64)[None, :], 0.3).numpy()
    np.testing.assert_array_equal(got, want)


# (t, d, rate, dtype, atol, return_lse): T = 1 one row, 41 one key tile, 65
# and 130 ragged; bf16 atol: the Pallas kernel rounds the unnormalized p, the
# plain version the normalized p, and the output is bf16 (2^-8 relative).
# The f32 cases without lse are named t-d-rate, the rest t-d-rate-dtype-lse.
_FLASH_REF_CASES = [
    pytest.param(t, d, rate, dtype, atol, lse,
                 id=f'{t}-{d}-{rate}' + ('' if dtype is np.float32 and not lse
                                         else f'-{np.dtype(dtype).name}-{"lse" if lse else "out"}'))
    for dtype, atol in ((np.float32, 1e-5), (jnp.bfloat16, 2e-2))
    for lse in (False, True)
    for t in (1, 41, 65, 130) for d in (16, 64) for rate in (0.0, 0.1)]


@pytest.mark.parametrize('t,d,rate,dtype,atol,return_lse', _FLASH_REF_CASES)
def test_flash_reference_matches_pallas_interpret(t, d, rate, dtype, atol, return_lse):
    q, k, v = (x.astype(dtype) for x in _qkv(t * d, (2, 3, t, d)))
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    args = [torch.from_numpy(x.astype(np.float32)).to(tdt) for x in (q, k, v)]
    if return_lse:
        want, want_lse = jattn._flash_forward(
            *map(jnp.asarray, (q, k, v)), 1234, d ** -0.5, 128, 128, interpret=True,
            return_lse=True, dropout_rate=rate)
        got, got_lse = tattn.flash_attention_forward_reference(
            *args, seed=1234, dropout_rate=rate, return_lse=True)
        # f32 row sums of the same scores in both dtypes
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=0)
    else:
        want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), 1234, None, 128, 128,
                                     True, rate)
        got = tattn.flash_attention_forward_reference(*args, seed=1234, dropout_rate=rate)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_flash_forward_on_cpu_runs_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(3, (2, 2, 41, 16)))
    before = _build.launch_counts()
    got = tattn.flash_attention_forward(q, k, v, seed=9, dropout_rate=0.1)
    want = tattn.flash_attention_forward_reference(q, k, v, seed=9, dropout_rate=0.1)
    assert torch.equal(got, want)
    assert _build.launch_counts() == before


@pytest.mark.parametrize('dtype,atol', [(np.float32, 1e-5),
                                        # bf16 output: one bf16 ulp near 1
                                        (jnp.bfloat16, 1e-2)])
def test_dispatcher_plain_branch_matches_jax(dtype, atol):
    q, k, v = _qkv(5, (2, 4, 41, 16))
    want = np.asarray(jattn.attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                                      use_flash=False), np.float32)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = tattn.attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                          use_flash=False)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_dispatcher_routes_by_min_seq(monkeypatch):
    q, k, v = map(torch.from_numpy, _qkv(6, (1, 2, 41, 16)))
    calls = []
    real = tattn.flash_attention_forward
    monkeypatch.setattr(tattn, 'flash_attention_forward',
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tattn.attention(q, k, v, min_seq=42)
    assert not calls                       # T=41 < min_seq: plain branch
    tattn.attention(q, k, v, min_seq=41)
    assert len(calls) == 1                 # T >= min_seq: flash


def test_dispatcher_dropout_uses_the_hashed_kernel_mask():
    q, k, v = _qkv(8, (2, 2, 41, 16))
    want = np.asarray(jattn.flash_attention(
        *map(jnp.asarray, (q, k, v)), 42, None, 128, 128, True, 0.1))
    got = tattn.attention(*map(torch.from_numpy, (q, k, v)), dropout_rate=0.1,
                          deterministic=False, seed=42).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # eval (deterministic) ignores the rate
    eval_out = tattn.attention(*map(torch.from_numpy, (q, k, v)), dropout_rate=0.1)
    np.testing.assert_allclose(
        eval_out.numpy(),
        np.asarray(jattn.flash_attention(*map(jnp.asarray, (q, k, v)), 0, None,
                                         128, 128, True)), atol=1e-5, rtol=0)
    # the plain branch drops with raw bits from its generator (JAX's
    # bits < round((1 - rate) * (2^32 - 1))), not the hashed mask
    with pytest.raises(ValueError, match='generator'):
        tattn.attention(*map(torch.from_numpy, (q, k, v)), dropout_rate=0.1,
                        deterministic=False, use_flash=False)
    plain = tattn.attention(*map(torch.from_numpy, (q, k, v)), dropout_rate=0.1,
                            deterministic=False, use_flash=False,
                            generator=torch.Generator().manual_seed(0))
    assert plain.shape == got.shape and not np.allclose(plain.numpy(), got, atol=1e-3)


@pytest.mark.parametrize('bad,err', [
    (dict(k=torch.zeros(1, 2, 40, 16)), ValueError),          # shape mismatch
    (dict(dtype=torch.float16), TypeError),                   # dtype
    (dict(d=129), ValueError),                                # D > 128
    (dict(strided=True), ValueError),                         # not contiguous
    (dict(seed=-1), ValueError),
    (dict(rate=1.0), ValueError),
    (dict(), ValueError),                                     # a CPU tensor
])
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(bad, err):
    d = bad.get('d', 16)
    dtype = bad.get('dtype', torch.float32)
    q = torch.zeros(1, 2, 41, d, dtype=dtype)
    k = bad.get('k', torch.zeros_like(q))
    v = torch.zeros_like(q)
    if bad.get('strided'):
        q = torch.zeros(1, 2, d, 41).transpose(-1, -2)
    with pytest.raises(err):
        tattn.flash_fwd_kernel(q, k, v, bad.get('seed', 0), 0.25, bad.get('rate', 0.0))
