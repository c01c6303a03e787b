"""Rank programs of the mesh tests, and the tests of the local launcher.

The functions here run on gloo CPU ranks (``parallel.LocalRanks``), one
process per rank with one thread; they import torch and the port only, so a
rank starts without JAX.  The tests that hold them against the JAX package
are ``tests/test_torch_parallel_{rules,steps,pretrain}.py``; the tests in this
file check the launcher and the helpers that need no JAX.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ecg_representation_learning_tpu_torch.configs import (ContrastiveConfig, MaeConfig,
                                                           TrainConfig, VitConfig)
from ecg_representation_learning_tpu_torch.models.port import state_dict_from_flax
from ecg_representation_learning_tpu_torch.ops import adamw
from ecg_representation_learning_tpu_torch.parallel import (LocalRanks, make_mesh,
                                                            process_local_batch_slice, spmd)
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer
from ecg_representation_learning_tpu_torch.train.contrastive import ContrastiveTrainer
from ecg_representation_learning_tpu_torch.train.pretrain import MaeTrainer

MAE = MaeConfig(decoder_hidden_size=32, decoder_num_layers=1, decoder_num_heads=2,
                decoder_intermediate_size=64)
CON = ContrastiveConfig(proj_hidden_size=32, proj_dim=8)


# ------------------------------------------------------------------ programs
def rank_info():
    return dist.get_rank(), dist.get_world_size(), os.environ['RANK']


def fail_on(rank: int):
    if dist.get_rank() == rank:
        raise ValueError(f'rank {rank} fails')
    return dist.get_rank()


def build(kind: str, cfg: VitConfig, tcfg: TrainConfig, mesh, data=None, out=None):
    """A trainer of ``kind`` ('sup', 'mae', 'con') on the CPU (on ``mesh``)."""
    kw = dict(train_data=data, eval_data=data, device='cpu', mesh=mesh, output_dir=out)
    if kind == 'sup':
        return Trainer(cfg, tcfg, **kw)
    if kind == 'mae':
        return MaeTrainer(cfg, MAE, tcfg, **kw)
    return ContrastiveTrainer(cfg, CON, tcfg, **kw)


def model_of(kind: str, cfg: VitConfig) -> torch.nn.Module:
    """The unsharded model of a trainer of ``kind``, on the meta device."""
    from ecg_representation_learning_tpu_torch.models.contrastive import EcgContrastive
    from ecg_representation_learning_tpu_torch.models.mae import EcgMae
    from ecg_representation_learning_tpu_torch.models.vit import EcgVit
    with torch.device('meta'):
        if kind == 'sup':
            return EcgVit(cfg)
        return EcgMae(cfg, MAE) if kind == 'mae' else EcgContrastive(cfg, CON)


def train_run(kind, cfg, tcfg, shape, data, flax_params, out):
    """``train()`` on a (n_data, n_model) mesh (``shape`` None: one device,
    no process group needed) from the flax weights: (logged train losses, the
    result, the full state_dict, the local leaves' shapes)."""
    mesh = None if shape is None else make_mesh(*shape, device='cpu')
    tr = build(kind, cfg, tcfg, mesh, data, out)
    tr.init_state()
    if flax_params is not None:
        tr.set_params(state_dict_from_flax(flax_params, model_of(kind, cfg)))
    logged = []
    log = tr._log
    tr._log = lambda p: (logged.append(p), log(p))
    result = tr.train()
    losses = [p.get('train/loss', p.get('pretrain/loss')) for p in logged
              if 'train/loss' in p or 'pretrain/loss' in p]
    history = result.get('history')
    return {'losses': losses, 'history': [h['loss'] for h in history] if history else None,
            'state': tr.state_dict(),
            'local_shapes': {k: tuple(v.shape) for k, v in tr._leaves().items()},
            'mu_shapes': {k: tuple(v.shape) for k, v in tr.opt_state.mu.items()}}


def replay_steps(kind, cfg, tcfg, shape, data, flax_params, steps):
    """``len(steps)`` train steps fed the given randomness (each step: MAE
    noise per microbatch, or the two views' draws, for the global batch; the
    rank keeps its rows): per step the global loss and the full state after
    it."""
    mesh = None if shape is None else make_mesh(*shape, device='cpu')
    tr = build(kind, cfg, tcfg, mesh, data)
    tr.init_state()
    tr.set_params(state_dict_from_flax(flax_params, model_of(kind, cfg)))
    n_data = 1 if mesh is None else mesh.shape['data']
    out = []
    for k, draws in enumerate(steps):
        if kind == 'mae':
            queue = list(draws)

            def forward(x, rng=None, _fwd=type(tr.model).forward, _m=tr.model):
                noise = queue.pop(0)
                rows = process_local_batch_slice(noise.shape[0], mesh) if n_data > 1 else \
                    slice(None)
                return _fwd(_m, x, rng, noise=noise[rows])
            tr.model.forward = forward
        else:
            def views(sig, gen, draws=draws, prep=None):
                rows = process_local_batch_slice(draws[0]['shift'].shape[0], mesh) \
                    if n_data > 1 else slice(None)
                mine = tuple({k: v[rows] for k, v in d.items()} for d in draws)
                return ContrastiveTrainer._views(tr, sig, gen, draws=mine, prep=prep)
            tr._views = views
        bs = tcfg.train_batch_size
        m = tr.train_step(data, np.arange(bs * k, bs * (k + 1)))
        out.append((float(m['loss']), float(m['grad_norm']), tr.state_dict()))
    return out


def save_and_eval(kind, cfg, tcfg, shape, data, out):
    """Train one epoch on the mesh, save ``ckpt-final``; (eval loss, path)."""
    mesh = make_mesh(*shape, device='cpu')
    tr = build(kind, cfg, tcfg, mesh, data, out)
    tr.train()
    ev = tr.evaluate(data)
    return (ev if isinstance(ev, float) else ev['loss']), tr.latest_checkpoint()


def restore_and_eval(kind, cfg, tcfg, shape, data, path):
    """Eval loss of the checkpoint ``path`` restored onto a mesh (``shape``)
    or one device (None)."""
    mesh = None if shape is None else make_mesh(*shape, device='cpu')
    tr = build(kind, cfg, tcfg, mesh, data)
    tr.load_checkpoint(path)
    ev = tr.evaluate(data)
    return ev if isinstance(ev, float) else ev['loss']


def dp_steps(cfg, tcfg, data, shape, steps: int = 2):
    """``steps`` train steps of a ``Trainer`` from its seeded init, on one
    device (``shape`` None) or a mesh: (global losses, the full state, the
    first state of the Bernoulli mask generator)."""
    mesh = None if shape is None else make_mesh(*shape, device='cpu')
    tr = build('sup', cfg, tcfg, mesh, data)
    tr.init_state()
    mask = None if tr.rng.mask is None else tr.rng.mask.get_state()
    bs = tcfg.train_batch_size
    losses = [float(tr.train_step(data, np.arange(bs * k, bs * (k + 1)))['loss'])
              for k in range(steps)]
    return losses, tr.state_dict(), mask


def mesh_norm(grads_full, shards, clip, poison_rank=None):
    """FusedAdamW's step on this rank's pieces of ``grads_full`` (a list of
    full gradients; ``shards[i]`` the leaf's dim sharded over the ranks, or
    None for a replicated leaf), with the mesh-wide norm: (grad_norm,
    nonfinite count, the updated local params).  ``poison_rank`` puts a NaN
    into that rank's first leaf."""
    r, n = dist.get_rank(), dist.get_world_size()
    grads, weights = [], []
    for g, dim in zip(grads_full, shards):
        if dim is None:
            grads.append(g.clone())
            weights.append(1.0 / n)
        else:
            grads.append(g.chunk(n, dim)[r].contiguous())
            weights.append(1.0)
    if poison_rank == r:
        grads[0].view(-1)[0] = float('nan')
    params = [torch.ones_like(g) for g in grads]
    mus = [torch.zeros_like(g) for g in grads]
    nus = [torch.zeros_like(g) for g in grads]
    count = torch.zeros((), dtype=torch.int32)
    norm, count = adamw.adamw_tail(params, grads, mus, nus, (1e-2, 0.1, 0.001), count,
                                   clip_norm=clip, zero_nonfinite=True, b1=0.9, b2=0.999,
                                   eps=1e-8, wd=0.0, reduce=adamw.NormReduce(weights))
    return float(norm), int(count), params


# --------------------------------------------------------------------- tests
@pytest.fixture(scope='module')
def ranks():
    with LocalRanks(2) as r:
        yield r


def test_local_ranks_share_one_group(ranks):
    assert ranks.run(rank_info) == [(0, 2, '0'), (1, 2, '1')]


def test_a_failing_rank_raises_with_its_traceback(ranks):
    with pytest.raises(RuntimeError, match='rank 1 fails'):
        ranks.run(fail_on, 1)
    assert ranks.run(rank_info)[1][0] == 1     # the group is still usable


def test_spmd_helpers_are_identities_without_a_mesh():
    x = torch.arange(6.0).reshape(3, 2)
    assert spmd.current() is None
    for fn in (spmd.copy_to_model, spmd.reduce_from_model, spmd.gather_from_model,
               spmd.all_reduce_data, spmd.gather_rows, spmd.mean_over_data):
        assert fn(x) is x
    assert spmd.all_gather_data(x) == [x]
    assert spmd.batch_frame(3) is None and spmd.frame((3, 2)) is None
    assert spmd.global_draw(3, lambda n: torch.arange(n)).tolist() == [0, 1, 2]
    assert spmd.data_index() == (0, 1) and spmd.model_index() == (0, 1)


def test_trainer_without_a_group_is_the_one_device_trainer():
    tr = Trainer(VitConfig.from_defined('debug'), TrainConfig(), device='cpu')
    assert tr.mesh is None and tr.sharded is None
    with pytest.raises(RuntimeError, match='process group'):
        Trainer(VitConfig.from_defined('debug'), TrainConfig(mesh_model=2), device='cpu')


def _corpus(n=32, length=256):
    rng = np.random.default_rng(9)
    return SplitData((0.5 * rng.standard_normal((n, 12, length))).astype(np.float32),
                     (rng.uniform(size=(n, 71)) < 0.2).astype(np.float32))


def test_dp2_with_hashed_dropout_equals_the_one_device_step(ranks):
    """Both ranks take 8 of each 16 rows; the attention kernel's masks (its
    plain version here) hash the global bh (``bh_offset``), the hidden
    dropout the global index (``frame``), and TimeOut is drawn for the global
    batch: two steps equal the one-device steps on the same 16 rows."""
    cfg = VitConfig.from_defined('debug', max_signal_length=320, dropout_impl='hash',
                                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                                 flash_min_seq=0)
    tcfg = TrainConfig(train_batch_size=16, eval_batch_size=16, augment_timeout=True,
                       learning_rate=1e-3, log_to_console=False, save_final=False)
    data = _corpus()
    want_losses, want, _ = dp_steps(cfg, tcfg, data, None)
    out = ranks.run(dp_steps, cfg, tcfg, data, (2, 1))
    for losses, state, _ in out:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
        num = sum(float((state[k].double() - want[k].double()).square().sum()) for k in want)
        den = sum(float(want[k].double().square().sum()) for k in want)
        assert (num / den) ** 0.5 <= 1e-6
    # the dropout is on: without it the first loss differs
    plain, _, _ = dp_steps(dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                                               attention_probs_dropout_prob=0.0),
                           tcfg, data, None, 1)
    assert abs(plain[0] - want_losses[0]) > 1e-4


def test_flax_dropout_masks_come_from_a_generator_per_data_rank(ranks):
    cfg = VitConfig.from_defined('debug', max_signal_length=320, dropout_impl='flax',
                                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.0)
    tcfg = TrainConfig(train_batch_size=16, eval_batch_size=16, log_to_console=False,
                       save_final=False)
    out = ranks.run(dp_steps, cfg, tcfg, _corpus(), (2, 1), 1)
    assert not torch.equal(out[0][2], out[1][2])            # decorrelated masks
    assert all(np.isfinite(o[0][0]) for o in out) and out[0][0] == out[1][0]
