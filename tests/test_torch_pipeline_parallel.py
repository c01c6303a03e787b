"""The port's GPipe core (``parallel/pipeline_parallel.py``) against the JAX
package's.

One group of four gloo CPU ranks for the file (the rank programs are in
``tests/test_torch_ring_pipeline_ranks.py``); the JAX side runs
``pipeline_apply`` on four of the 8 CPU devices at ``precision='highest'``.
A 'debug' ``Block`` stack of 4 layers, its params JAX's (stacked (L, ...)):

  * S = 4 stages (one data rank) and S = 2 on a 2 x 2 ('data', 'stage')
    mesh (each data rank its half of every microbatch, JAX's
    ``x_spec=P(None, 'data')``): the outputs within 1e-5 max abs of JAX's
    pipeline and of the sequential stack, the stage gradients of sum(out *
    w) within 1e-5 relative (||a - b|| / ||b||) of JAX's;
  * M = 6 microbatches over 4 stages (not a multiple of S);
  * dropout streams: two runs from one seed give the same bits, another seed
    other bits, dropout off others again, and two data ranks fed identical
    rows draw different masks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models.vit import Block as JaxBlock
from ecg_representation_learning_tpu.parallel.pipeline_parallel import (
    pipeline_apply as jax_pipeline, place_stage_params as jax_place,
    stack_stage_params as jax_stack)
from ecg_representation_learning_tpu_torch.configs import VitConfig
from ecg_representation_learning_tpu_torch.models.port import state_dict_from_flax
from ecg_representation_learning_tpu_torch.models.vit import ScannedBlocks
from ecg_representation_learning_tpu_torch.parallel import LocalRanks

import test_torch_ring_pipeline_ranks as prog

JCFG = JaxVitConfig.from_defined('debug', max_signal_length=256, patch_size=32,
                                 use_flash_attention=False, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0)
L, B, T, H = JCFG.num_hidden_layers, 4, 8, JCFG.hidden_size


@pytest.fixture(scope='module')
def ranks():
    with LocalRanks(4) as r:
        yield r


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / np.linalg.norm(np.asarray(b, np.float64)))


@pytest.fixture(scope='module')
def stacked():
    blk = JaxBlock(JCFG)
    dummy = jnp.zeros((B, T, H), jnp.float32)
    per = [blk.init({'params': k}, dummy, True)['params']
           for k in jax.random.split(jax.random.PRNGKey(0), L)]
    return jax.tree.map(lambda *a: np.asarray(jnp.stack(a)), *per)


def _port_stack(tree, cfg):
    with torch.device('meta'):
        model = ScannedBlocks(cfg)
    return state_dict_from_flax(tree, model)


def _jax_block(lp, h):
    return JaxBlock(JCFG).apply({'params': lp}, h, True)[0]


def _jax_run(stacked, x, w, n_data):
    """JAX pipeline on (n_data, 4 / n_data) devices: (outputs, stage grads
    as (L, ...) stacks)."""
    n_stage = 4 // n_data
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(n_data, n_stage), ('data', 'stage'))
    spec = JP(None, 'data')

    def loss(st):
        return (jax_pipeline(jax_stack(st, n_stage), jnp.asarray(x), _jax_block, mesh,
                             x_spec=spec) * w).sum()
    with jax.default_matmul_precision('highest'):
        out = jax.jit(lambda p, a: jax_pipeline(p, a, _jax_block, mesh, x_spec=spec))(
            jax_place(jax_stack(stacked, n_stage), mesh), jnp.asarray(x))
        grads = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, stacked)) if w is not None \
            else None
    return np.asarray(out), None if grads is None else jax.tree.map(np.asarray, grads)


def _sequential(stacked, x):
    def run_one(h):
        for i in range(L):
            h = _jax_block(jax.tree.map(lambda a, i=i: a[i], stacked), h)
        return h
    with jax.default_matmul_precision('highest'):
        return np.asarray(jax.jit(jax.vmap(run_one))(jnp.asarray(x)))


def _port_run(ranks, stacked, x, w, n_data, rng=None, cfg=None):
    cfg = cfg or VitConfig(**dataclasses.asdict(JCFG))
    out = ranks.run(prog.pipe_apply, cfg, _port_stack(stacked, cfg), torch.from_numpy(x),
                    torch.from_numpy(w), n_data, rng)
    return out


@pytest.mark.parametrize('n_data', [1, 2])
def test_forward_and_gradients_match_jax(ranks, stacked, n_data):
    rng = np.random.default_rng(n_data)
    x = rng.standard_normal((4, B, T, H)).astype(np.float32)    # M = 4
    w = rng.standard_normal(x.shape).astype(np.float32)
    want, want_grads = _jax_run(stacked, x, w, n_data)
    np.testing.assert_allclose(want, _sequential(stacked, x), rtol=0, atol=1e-5)
    out = _port_run(ranks, stacked, x, w, n_data)
    n_stage = 4 // n_data
    for got, (lo, hi), _ in out:       # every stage of a data rank holds its rows' outputs
        np.testing.assert_allclose(got.numpy(), want[:, lo:hi], rtol=0, atol=1e-5)
    cfg = VitConfig(**dataclasses.asdict(JCFG))
    want_port = _port_stack(want_grads, cfg)
    for name, g in want_port.items():
        # stage s of every data rank holds layers [s L/S, (s + 1) L/S); sum the data ranks
        stages = [sum(out[d * n_stage + s][2][name] for d in range(n_data))
                  for s in range(n_stage)]
        got = torch.cat(stages).numpy()
        assert _rel(got, g.numpy()) <= 1e-5, (name, _rel(got, g.numpy()))


def test_microbatches_not_a_multiple_of_stages(ranks, stacked):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((6, B, T, H)).astype(np.float32)    # M = 6 over S = 4
    want = _jax_run(stacked, x, None, 1)[0]
    np.testing.assert_allclose(want, _sequential(stacked, x), rtol=0, atol=1e-5)
    for got, _, _ in _port_run(ranks, stacked, x, np.ones_like(x), 1):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_dropout_streams_are_deterministic_and_decorrelated_over_data(ranks, stacked):
    cfg = VitConfig(**dataclasses.asdict(dataclasses.replace(
        JCFG, hidden_dropout_prob=0.3, attention_probs_dropout_prob=0.1)))
    row = np.random.default_rng(7).standard_normal((4, 1, T, H)).astype(np.float32)
    x = np.concatenate([row, row], axis=1)                      # identical rows, B = 2
    w = np.ones_like(x)
    a = _port_run(ranks, stacked, x, w, 2, rng=5, cfg=cfg)
    b = _port_run(ranks, stacked, x, w, 2, rng=5, cfg=cfg)
    c = _port_run(ranks, stacked, x, w, 2, rng=6, cfg=cfg)
    off = _port_run(ranks, stacked, x, w, 2, rng=None, cfg=cfg)
    assert all(torch.equal(p[0], q[0]) for p, q in zip(a, b))    # the same bits again
    assert not torch.equal(a[0][0], c[0][0])                     # another seed
    assert not torch.equal(a[0][0], off[0][0])                   # dropout acts
    torch.testing.assert_close(off[0][0], off[2][0])             # same rows, no dropout
    assert not torch.allclose(a[0][0], a[2][0])                  # data ranks 0 and 1 differ
