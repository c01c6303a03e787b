"""The port's ring attention against the JAX package's.

One group of four gloo CPU ranks for the file (``parallel.LocalRanks``; the
rank programs are in ``tests/test_torch_ring_pipeline_ranks.py``).  The JAX
side runs ``parallel.ring_attention.ring_attention`` on four of the 8 CPU
devices of ``tests/conftest.py`` at ``precision='highest'``; both sides get
the same numpy inputs:

  * the forward on (2, 4, 64, 32), the sequence split 4 x 16: within 2e-5
    max abs of JAX's (the JAX test's own bound against full attention);
  * dQ, dK and dV of sum(out * w): each within 1e-5 relative
    (||a - b|| / ||b||) of JAX's;
  * bf16 inputs keep f32 statistics: the forward within the bf16 rounding
    of the output (2e-2) of JAX's;
  * at world 1 (no mesh) ring attention is plain attention.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.ops.attention import _attn_reference
from ecg_representation_learning_tpu.parallel import make_mesh as jax_mesh
from ecg_representation_learning_tpu.parallel.ring_attention import ring_attention as jax_ring
from ecg_representation_learning_tpu_torch.ops.attention import attention
from ecg_representation_learning_tpu_torch.parallel import LocalRanks, ring_attention_local

import test_torch_ring_pipeline_ranks as prog

SHAPE = (2, 4, 64, 32)


@pytest.fixture(scope='module')
def ranks():
    with LocalRanks(4) as r:
        yield r


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(14)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / np.linalg.norm(np.asarray(b, np.float64)))


def _jax(q, k, v, w):
    mesh = jax_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    with jax.default_matmul_precision('highest'):
        out = jax_ring(*map(jnp.asarray, (q, k, v)), mesh)
        grads = jax.grad(lambda a, b, c: (jax_ring(a, b, c, mesh) * w).sum(),
                         argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def test_forward_and_gradients_on_4_ranks_match_jax(ranks, inputs):
    q, k, v, w = inputs
    want, want_grads = _jax(q, k, v, w)
    out = ranks.run(prog.ring_fwd_grad, *map(torch.from_numpy, (q, k, v, w)))
    got = torch.cat([o[0] for o in out], dim=2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    for j, name in enumerate(('dq', 'dk', 'dv')):
        g = torch.cat([o[1 + j] for o in out], dim=2).numpy()
        assert np.abs(g).max() > 0, name
        assert _rel(g, want_grads[j]) <= 1e-5, (name, _rel(g, want_grads[j]))


def test_bf16_inputs_keep_f32_statistics(ranks, inputs):
    q, k, v, w = inputs
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    mesh = jax_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    with jax.default_matmul_precision('highest'):
        want = np.asarray(jax_ring(*[jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf],
                                   mesh).astype(jnp.float32))
    out = ranks.run(prog.ring_fwd_grad, *bf, torch.from_numpy(w).to(torch.bfloat16))
    got = torch.cat([o[0] for o in out], dim=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-2)


def test_world_1_is_plain_attention(inputs):
    q, k, v, _ = map(torch.from_numpy, inputs)
    got = ring_attention_local(q, k, v, 'data')          # no mesh: one shard
    plain = attention(q, k, v, use_flash=False)
    want = np.asarray(_attn_reference(*map(jnp.asarray, inputs[:3]), 1.0 / np.sqrt(SHAPE[-1])))
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
