"""The training half of the port's attention op against the JAX package's.

Same numpy inputs through both: the plain lse forward against the Pallas
``_flash_kernel_lse`` in interpret mode, the plain blocked backward against
``_flash_backward_blocked`` (interpret mode, called directly), and the
``FlashAttention`` gradient against ``jax.grad`` of ``flash_attention`` on
both sides of the blocked-backward threshold.  The CUDA kernels run only on
the GPU (chip_smoke.py holds them against these plain versions there); here
their wrappers' input checks are covered.

Tolerance, f32: 2e-5 * max(1, max |JAX|), as tests/test_flash_bwd_blocked.py
(the sums run in another order).  bf16: both sides round ds and the outputs
to bf16 at the same places; a ds that lands on the other side of a rounding
boundary moves an output by one bf16 ulp, so 1e-2 * max(1, max |JAX|).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu_torch.ops import attention as tattn

jattn = importlib.import_module('ecg_representation_learning_tpu.ops.attention')

torch.set_num_threads(2)
TOL = {np.float32: 2e-5, jnp.bfloat16: 1e-2}


def _inputs(seed, shape, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1.0))


def _t(x, dtype):
    return torch.from_numpy(x).to(torch.float32 if dtype is np.float32 else torch.bfloat16)


@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('t', [41, 200])     # one block; two, ragged
def test_lse_forward_matches_pallas_interpret(t, rate):
    q, k, v = _inputs(t, (2, 3, t, 64), 3)
    want_o, want_lse = jattn._flash_forward(
        *map(jnp.asarray, (q, k, v)), 77, 0.125, 128, 128, interpret=True,
        return_lse=True, dropout_rate=rate)
    got_o, got_lse = tattn.flash_attention_forward_reference(
        *map(torch.from_numpy, (q, k, v)), seed=77, dropout_rate=rate, return_lse=True)
    assert got_lse.shape == (2, 3, t) and got_lse.dtype == torch.float32
    _close(got_o.numpy(), want_o, 1e-5)
    _close(got_lse.numpy(), want_lse, 1e-5)


@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('dtype', [np.float32, jnp.bfloat16])
@pytest.mark.parametrize('t,d', [
    pytest.param(41, 64, id='41'),              # one block
    pytest.param(200, 64, id='200'),            # two, ragged
    pytest.param(1, 64, id='1'),                # one row
    pytest.param(65, 64, id='65'),              # one past a 64-row tile
    pytest.param(65, 80, id='65-d80'),          # and ragged D (128-column tiles)
    pytest.param(1, 80, id='1-d80'),
])
def test_blocked_backward_matches_pallas_interpret(t, d, dtype, rate):
    """The plain versions the card's kernels are held to, pinned to the
    Pallas kernels at ragged tiles of T and D."""
    q, k, v, g = _inputs(1000 + t + (d - 64), (2, 3, t, d))
    jq, jk, jv, jg = (jnp.asarray(x, dtype) for x in (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, 4242, 0.125, 128, 128, interpret=True,
                                    return_lse=True, dropout_rate=rate)
    want = jattn._flash_backward_blocked(jq, jk, jv, out, lse, jg, 4242, 0.125, 128,
                                         128, interpret=True, dropout_rate=rate)
    tq, tk, tv, tg = (_t(x, dtype) for x in (q, k, v, g))
    tout = torch.from_numpy(np.array(out, np.float32)).to(tq.dtype)
    got = tattn.flash_attention_backward_blocked(
        tq, tk, tv, tout, torch.from_numpy(np.array(lse)), tg, 4242, 0.125, rate)
    for a, b in zip(got, want):
        assert a.dtype == tq.dtype and a.shape == tq.shape
        _close(a.float().numpy(), b, TOL[dtype])


@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('port_min_seq', [0, 1024])   # blocked kernels; f32 recompute
def test_function_grads_match_jax_grad(monkeypatch, port_min_seq, rate):
    """The JAX side runs its recompute backward at T = 41; the port runs
    either of its backwards on the same inputs."""
    monkeypatch.setattr(tattn, 'BLOCKED_BWD_MIN_SEQ', port_min_seq)
    q, k, v, g = _inputs(3, (2, 3, 41, 64))
    with jax.default_matmul_precision('highest'):
        want = jax.grad(lambda a, b, c: (jattn.flash_attention(
            a, b, c, 99, None, 128, 128, True, rate) * jnp.asarray(g)).sum(),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tattn.flash_attention(tq, tk, tv, 99, None, rate) * torch.from_numpy(g)).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        _close(a.numpy(), b, TOL[np.float32])


def test_function_grads_match_jax_grad_on_the_blocked_path():
    """T = 1024: both sides past their thresholds run the blocked backward."""
    q, k, v, g = _inputs(4, (1, 2, 1024, 64))
    with jax.default_matmul_precision('highest'):
        want = jax.grad(lambda a, b, c: (jattn.flash_attention(
            a, b, c, 5, None, 128, 128, True, 0.1) * jnp.asarray(g)).sum(),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tattn.flash_attention(tq, tk, tv, 5, None, 0.1) * torch.from_numpy(g)).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        _close(a.numpy(), b, TOL[np.float32])


def test_function_saves_lse_only_past_the_threshold(monkeypatch):
    q, k, v = (torch.randn(1, 2, 41, 16, requires_grad=True) for _ in range(3))
    for min_seq, n_saved in ((41, 5), (42, 3)):
        monkeypatch.setattr(tattn, 'BLOCKED_BWD_MIN_SEQ', min_seq)
        out = tattn.flash_attention(q, k, v)
        assert len(out.grad_fn.saved_tensors) == n_saved
    # without a gradient to record it is the forward alone
    with torch.no_grad():
        assert tattn.flash_attention(q, k, v).grad_fn is None


def test_kernels_on_cpu_run_the_plain_versions():
    q, k, v, g = map(torch.from_numpy, _inputs(6, (1, 2, 41, 16)))
    counts = [tattn.flash_fwd_lse_kernel.launches, tattn.flash_bwd_dq_kernel.launches,
              tattn.flash_bwd_dkv_kernel.launches]
    out, lse = tattn.flash_attention_forward(q, k, v, 3, None, 0.1, return_lse=True)
    want = tattn.flash_attention_forward_reference(q, k, v, 3, None, 0.1, return_lse=True)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    grads = tattn.flash_attention_backward_blocked(q, k, v, out, lse, g, 3, None, 0.1)
    delta = (g * out).sum(-1)
    ref = tattn.flash_backward_blocked_reference(q, k, v, g, lse, delta, 3, None, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    assert counts == [tattn.flash_fwd_lse_kernel.launches,
                      tattn.flash_bwd_dq_kernel.launches,
                      tattn.flash_bwd_dkv_kernel.launches]


def _bwd_case(bad):
    d = bad.get('d', 16)
    dtype = bad.get('dtype', torch.float32)
    q = torch.zeros(1, 2, 41, d, dtype=dtype)
    k, v = torch.zeros_like(q), torch.zeros_like(q)
    do = bad.get('do', torch.zeros_like(q))
    if bad.get('strided'):
        q = torch.zeros(1, 2, d, 41).transpose(-1, -2)
    lse = bad.get('lse', torch.zeros(1, 2, 41))
    return q, k, v, do, lse, torch.zeros(1, 2, 41)


BAD = [(dict(do=torch.zeros(1, 2, 40, 16)), ValueError),    # shape mismatch
       (dict(dtype=torch.float16), TypeError),               # dtype
       (dict(d=129), ValueError),                            # D > 128
       (dict(strided=True), ValueError),                     # not contiguous
       (dict(lse=torch.zeros(1, 2, 40)), ValueError),        # lse shape
       (dict(lse=torch.zeros(1, 2, 41, dtype=torch.float64)), ValueError),
       (dict(seed=-1), ValueError),
       (dict(rate=1.0), ValueError),
       (dict(), ValueError)]                                 # a CPU tensor


@pytest.mark.parametrize('kernel', ['flash_bwd_dq_kernel', 'flash_bwd_dkv_kernel'])
@pytest.mark.parametrize('bad,err', BAD)
def test_backward_wrappers_reject_what_the_kernels_cannot_take(kernel, bad, err):
    with pytest.raises(err):
        getattr(tattn, kernel)(*_bwd_case(bad), bad.get('seed', 0), 0.25,
                               bad.get('rate', 0.0))


@pytest.mark.parametrize('bad,err', [b for b in BAD if 'lse' not in b[0] and 'do' not in b[0]])
def test_lse_wrapper_rejects_what_the_kernel_cannot_take(bad, err):
    q, k, v = _bwd_case(bad)[:3]
    with pytest.raises(err):
        tattn.flash_fwd_lse_kernel(q, k, v, bad.get('seed', 0), 0.25, bad.get('rate', 0.0))
