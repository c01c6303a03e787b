"""The port's ('data', 'model') mesh rules and its per-rank randomness against
the JAX package.

  * ``param_spec``, ``_fsdp_spec`` and ``opt_state_shardings`` give JAX's
    spec for every leaf of the ViT, MAE, contrastive, Switch-MoE and
    scan-stacked trees (the JAX specs from ``param_shardings`` on the
    8-device CPU mesh of ``tests/conftest.py``, the port's from the port's
    parameters, matched by flax path);
  * the single-process ``initialize_distributed`` and
    ``process_local_batch_slice`` give JAX's values;
  * the sharded attention's dropout masks are JAX's ``flash_attention_sharded``
    masks at 2 x 2 and 4 x 2 (the JAX kernel in interpret mode; with q = k =
    0 and v one-hot over the keys the output's nonzero pattern is the mask,
    so the comparison is exact), and the port's rank slices reassemble it;
  * at model == 1 JAX runs the global program: a data rank's ``bh_offset``
    gives the global masks, and the hashed hidden dropout of a rank's slice
    (``frame``) the global array's, bit for bit, on the plain versions.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import ContrastiveConfig as JCon
from ecg_representation_learning_tpu.configs import MaeConfig as JMae
from ecg_representation_learning_tpu.configs import VitConfig as JVit
from ecg_representation_learning_tpu.models import EcgContrastive as JContrastive
from ecg_representation_learning_tpu.models import EcgMae as JEcgMae
from ecg_representation_learning_tpu.models import EcgVit as JEcgVit
from ecg_representation_learning_tpu.parallel import mesh as jmesh
from ecg_representation_learning_tpu.parallel.distributed import (
    initialize_distributed as jax_init, process_local_batch_slice as jax_slice)
from ecg_representation_learning_tpu.train.optim import FusedAdamW as JFusedAdamW
from ecg_representation_learning_tpu_torch.configs import (ContrastiveConfig, MaeConfig,
                                                           VitConfig)
from ecg_representation_learning_tpu_torch.models import port
from ecg_representation_learning_tpu_torch.models.contrastive import EcgContrastive
from ecg_representation_learning_tpu_torch.models.mae import EcgMae
from ecg_representation_learning_tpu_torch.models.vit import EcgVit
from ecg_representation_learning_tpu_torch.ops import attention as tattn
from ecg_representation_learning_tpu_torch.ops import dropout as tdropout
from ecg_representation_learning_tpu_torch.parallel import (
    initialize_distributed, mesh as tmesh, process_local_batch_slice)

jattn = importlib.import_module('ecg_representation_learning_tpu.ops.attention')
jdropout = importlib.import_module('ecg_representation_learning_tpu.ops.dropout')


class _Shape:
    """What the port's rules read of a mesh."""

    def __init__(self, n_data, n_model):
        self.shape = {'data': n_data, 'model': n_model}


def _jax_trees():
    """(name, flax param tree (shapes), the port's model) of each tree."""
    base = dict(max_signal_length=320)
    vit = JVit.from_defined('debug', **base)
    moe = dataclasses.replace(vit, moe_num_experts=4, moe_every=2)
    scan = dataclasses.replace(vit, scan_blocks=True)
    x = jnp.zeros((1, 12, 320), jnp.float32)
    key = jax.random.PRNGKey(0)
    out = []
    for name, jmodel, tmodel in (
            ('vit', JEcgVit(vit), lambda: EcgVit(VitConfig(**dataclasses.asdict(vit)))),
            ('moe', JEcgVit(moe), lambda: EcgVit(VitConfig(**dataclasses.asdict(moe)))),
            ('scan', JEcgVit(scan), lambda: EcgVit(VitConfig(**dataclasses.asdict(scan)))),
            ('mae', JEcgMae(vit, JMae(decoder_num_layers=1)),
             lambda: EcgMae(VitConfig(**dataclasses.asdict(vit)), MaeConfig(decoder_num_layers=1))),
            ('contrastive', JContrastive(vit, JCon(proj_hidden_size=32, proj_dim=8)),
             lambda: EcgContrastive(VitConfig(**dataclasses.asdict(vit)),
                                    ContrastiveConfig(proj_hidden_size=32, proj_dim=8)))):
        rngs = {'params': key, 'mask': key, 'dropout': key}
        shapes = jax.eval_shape(lambda: jmodel.init(rngs, x))
        with torch.device('meta'):
            model = tmodel()
        out.append((name, shapes['params'], model))
    return out


TREES = _jax_trees()


def _by_path(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {'/'.join(getattr(k, 'key', str(k)) for k in kp): v for kp, v in flat}


@pytest.mark.parametrize('n_data,n_model', [(2, 2), (4, 2), (8, 1), (1, 4)])
@pytest.mark.parametrize('fsdp', [False, True])
@pytest.mark.parametrize('tree', [t[0] for t in TREES])
def test_param_and_fsdp_specs_match_jax(tree, fsdp, n_data, n_model):
    _, shapes, model = next(t for t in TREES if t[0] == tree)
    jm = jmesh.make_mesh(n_data, n_model, devices=jax.devices()[:n_data * n_model])
    want = {k: tuple(v.spec) for k, v in
            _by_path(jmesh.param_shardings(shapes, jm, fsdp=fsdp)).items()}
    got = tmesh.param_shardings(model, _Shape(n_data, n_model), fsdp=fsdp)
    got = {'/'.join(port.flax_path(k)): tuple(v) for k, v in got.items()}
    assert set(got) == set(want)
    # JAX's PartitionSpec drops nothing; compare with trailing Nones removed
    strip = lambda s: tuple(s[:max([i + 1 for i, a in enumerate(s) if a] or [0])])
    assert {k: strip(v) for k, v in got.items()} == {k: strip(v) for k, v in want.items()}


@pytest.mark.parametrize('tree', ['vit', 'moe', 'scan'])
def test_opt_state_shardings_lay_the_moments_out_like_the_params(tree):
    _, shapes, model = next(t for t in TREES if t[0] == tree)
    jm = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    opt_state = JFusedAdamW(1e-3).init(params)
    psh = jmesh.param_shardings(params, jm, fsdp=True)
    osh = jmesh.opt_state_shardings(opt_state, psh, jm)
    want_mu = {k: tuple(v.spec) for k, v in _by_path(osh.mu).items()}
    tpsh = tmesh.param_shardings(model, _Shape(2, 2), fsdp=True)
    got = tmesh.opt_state_shardings(None, tpsh, _Shape(2, 2))
    assert tuple(got['count']) == tuple(osh.count.spec) == ()
    got_mu = {'/'.join(port.flax_path(k)): tuple(v) for k, v in got['mu'].items()}
    assert got['nu'] == got['mu']
    strip = lambda s: tuple(s[:max([i + 1 for i, a in enumerate(s) if a] or [0])])
    assert {k: strip(v) for k, v in got_mu.items()} == {k: strip(v) for k, v in want_mu.items()}


def test_single_process_distributed_matches_jax():
    want, got = jax_init(), initialize_distributed()
    assert got['process_id'] == want['process_id'] == 0
    assert got['num_processes'] == want['num_processes'] == 1
    assert got['local_devices'] == got['devices'] == 1   # one device per process
    for n in (64, 7):
        assert process_local_batch_slice(n) == jax_slice(n) == slice(0, n)


def _mask_inputs(b, h, t):
    """q = k = 0 and v one-hot over the keys (t <= 64 = D): output column c
    is nonzero iff key c is kept."""
    q = np.zeros((b, h, t, 64), np.float32)
    v = np.zeros_like(q)
    v[:, :, np.arange(t), np.arange(t)] = 1.0
    return q, v


class _Coords:
    """A rank's coordinates on a mesh, as ``flash_attention_sharded`` reads them."""

    def __init__(self, n_data, n_model, i_data, i_model):
        self.shape = {'data': n_data, 'model': n_model}
        self._index = {'data': i_data, 'model': i_model}

    def index(self, axis):
        return self._index[axis]


@pytest.mark.parametrize('n_data,n_model', [(2, 2), (4, 2)])
def test_sharded_attention_masks_match_jax(n_data, n_model):
    b, h, t, seed, rate = 2 * n_data, 2 * n_model, 24, 12345, 0.3
    q, v = _mask_inputs(b, h, t)
    jm = jmesh.make_mesh(n_data, n_model, devices=jax.devices()[:n_data * n_model])
    want = np.asarray(jattn.flash_attention_sharded(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(v), jm, seed=seed, dropout_rate=rate,
        interpret=True))
    bl, hl = b // n_data, h // n_model
    got = np.zeros_like(want)
    for i in range(n_data):
        for j in range(n_model):
            blk = (slice(i * bl, (i + 1) * bl), slice(j * hl, (j + 1) * hl))
            got[blk] = tattn.flash_attention_sharded(
                torch.from_numpy(q[blk]), torch.from_numpy(q[blk]), torch.from_numpy(v[blk]),
                _Coords(n_data, n_model, i, j), seed=seed, dropout_rate=rate).numpy()
    assert np.array_equal(got[..., :t] != 0, want[..., :t] != 0)   # the masks, exactly
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a fold that differs per shard: not the global mask
    assert not np.array_equal(got[..., :t] != 0,
                              tattn.keep_full(seed, b, h, t, rate).numpy())


@pytest.mark.parametrize('n_data', [2, 4])
def test_data_rank_offsets_give_the_global_masks(n_data):
    """model == 1: JAX runs the global kernel; rank r's bh_offset = r * b * H
    and its hidden-dropout frame reproduce the global masks."""
    b, h, t, seed, rate = 2 * n_data, 3, 41, 777, 0.2
    want = np.asarray(jattn._keep_full(jnp.int32(seed), b, h, t, rate))
    bl = b // n_data
    got = np.concatenate([tattn.keep_full(seed, bl, h, t, rate, bh_offset=r * bl * h).numpy()
                          for r in range(n_data)])
    assert np.array_equal(got, want)
    # the plain forward kernel of a rank with its offset: the global rows
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, h, t, 16)).astype(np.float32) for _ in range(3))
    full = tattn.flash_attention_forward_reference(*map(torch.from_numpy, (q, k, v)), seed,
                                                   None, rate)
    for r in range(n_data):
        rows = slice(r * bl, (r + 1) * bl)
        part = tattn.flash_attention_forward_reference(
            *(torch.from_numpy(a[rows]) for a in (q, k, v)), seed, None, rate,
            bh_offset=r * bl * h)
        assert torch.equal(part, full[rows])
    # hashed hidden dropout: a rank's slice of (B, T, d) and of a Megatron
    # (B, T, f / n_model) hidden, against JAX's mask of the global array
    x = rng.standard_normal((b, 5, 8)).astype(np.float32)
    want = np.asarray(jdropout._masked(jnp.asarray(x), jnp.int32(seed), rate, 3))
    for r in range(n_data):
        rows = slice(r * bl, (r + 1) * bl)
        for j, cols in enumerate((slice(0, 4), slice(4, 8))):
            frame = {0: (r * bl, b), 2: (4 * j, 8)}
            part = tdropout._masked(torch.from_numpy(x[rows, :, cols]), seed, rate, 3, frame)
            assert np.array_equal(part.numpy(), want[rows, :, cols])


def test_fold_seed_is_the_int32_fold():
    for seed in (0, 1, 2 ** 31 - 1, 1 << 30):
        for shard in range(8):
            want = (jnp.int32(seed) + (shard + 1) * jnp.int32(0x3C6EF3)) & jnp.int32(0x7FFFFFFF)
            assert tattn.fold_seed(seed, shard) == int(want)
