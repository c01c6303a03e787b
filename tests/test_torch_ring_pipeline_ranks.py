"""Rank programs of the ring and pipeline tests, and their JAX-free tests.

The functions here run on gloo CPU ranks (``parallel.LocalRanks``), one
process per rank with one thread; they import torch and the port only, so a
rank starts without JAX.  The tests holding them to the JAX package are
``tests/test_torch_{ring_attention,long_record,pipeline_parallel,
pipeline_vit,orbax_convert}.py``.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models.vit import Block
from ecg_representation_learning_tpu_torch.parallel import (make_mesh, make_pp_mesh,
                                                            pipeline_apply, place_stage_params,
                                                            ring_attention, spmd,
                                                            stack_stage_params)
from ecg_representation_learning_tpu_torch.train import SplitData
from ecg_representation_learning_tpu_torch.train.long_record import RingPretrainer
from ecg_representation_learning_tpu_torch.train.pipeline_vit import (PipelineVitTrainer,
                                                                      data_rows,
                                                                      pipeline_vit_forward)


# ------------------------------------------------------------------- ring
def ring_fwd_grad(q, k, v, w):
    """This rank's shard of ring attention over every rank on 'data', and
    the rank's slices of d sum(out * w) / d (q, k, v)."""
    mesh = make_mesh(dist.get_world_size(), 1, device='cpu')
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ring_attention(q, k, v, mesh)
    i, n = spmd.axis_index('data', mesh)
    part = slice(i * q.shape[2] // n, (i + 1) * q.shape[2] // n)
    (out * w[:, :, part]).sum().backward()
    return out.detach(), q.grad[:, :, part], k.grad[:, :, part], v.grad[:, :, part]


def ring_steps(cfg, tcfg, params, xs, masks, out_dir=None):
    """``RingPretrainer`` steps from ``params`` on the given batches and
    masks: (losses, the state_dict after them)."""
    mesh = make_mesh(dist.get_world_size(), 1, device='cpu')
    tr = RingPretrainer(cfg, tcfg, mesh, total_steps=len(xs), output_dir=out_dir)
    tr.init(0)
    if params is not None:
        tr.set_params(params)
    losses = [float(tr.train_step(x, m)) for x, m in zip(xs, masks)]
    return losses, tr.state_dict()


def ring_resume(cfg, tcfg, path, x, mask, total_steps):
    """``RingPretrainer`` restored from the checkpoint ``path``: (its
    state_dict, Adam's count, mu and nu, and its step as restored; the loss
    of one step on ``x`` with ``mask``; the state_dict after that step)."""
    mesh = make_mesh(dist.get_world_size(), 1, device='cpu')
    tr = RingPretrainer(cfg, tcfg, mesh, total_steps=total_steps)
    tr.init(0)
    tr.load_checkpoint(path)
    opt = tr.opt_state
    restored = ({k: v.clone() for k, v in tr.state_dict().items()}, opt.count,
                {k: v.clone() for k, v in opt.mu.items()},
                {k: v.clone() for k, v in opt.nu.items()}, tr.step)
    loss = float(tr.train_step(x, mask))
    return restored, loss, tr.state_dict()


def ring_grads(cfg, tcfg, params, x, mask):
    """``RingPretrainer.loss_and_grads`` from ``params`` on one batch and
    mask: (the loss, the gradients summed over the ranks)."""
    mesh = make_mesh(dist.get_world_size(), 1, device='cpu')
    tr = RingPretrainer(cfg, tcfg, mesh, total_steps=1)
    tr.init(0)
    tr.set_params(params)
    loss, grads = tr.loss_and_grads(x, mask)
    return float(loss), grads


def ring_masks(cfg, tcfg, batch, steps, seed=0):
    """The masks ``RingPretrainer`` draws for ``steps`` steps, and their
    row counts."""
    mesh = make_mesh(dist.get_world_size(), 1, device='cpu')
    tr = RingPretrainer(cfg, tcfg, mesh, total_steps=steps)
    tr.init(seed)
    return [tr.draw_mask(batch) for _ in range(steps)]


def _stream(n, cfg, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield rng.standard_normal((2, cfg.num_channels, cfg.max_signal_length)).astype(
            np.float32)


def ring_train(cfg, tcfg, steps, out_dir, ckpt_every=0, resume=False):
    """``RingPretrainer.train`` over a deterministic stream: (losses, the
    final state, the committed checkpoints' names)."""
    import os
    mesh = make_mesh(dist.get_world_size(), 1, device='cpu')
    tr = RingPretrainer(cfg, tcfg, mesh, total_steps=6, output_dir=out_dir)
    res = tr.train(_stream(6, cfg), steps=steps, ckpt_every=ckpt_every, resume=resume)
    names = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    return res['losses'], tr.state_dict(), names


# --------------------------------------------------------------- pipeline
def _block_fn(cfg):
    with torch.device('meta'):
        template = Block(cfg)

    def block_fn(lp, a, rng=None):
        template.train(rng is not None)
        return torch.func.functional_call(template, lp, (a, rng))[0]
    return block_fn


def pipe_apply(cfg, stacked, x, w, n_data, rng=None):
    """``pipeline_apply`` of the (L, ...) block stack ``stacked`` over
    (n_data, world / n_data) ranks on the microbatches ``x`` (M, B, T, H)
    (each data rank its slice of every microbatch): (this rank's outputs,
    its rows, d sum(out * w) / d its stage's layers)."""
    n_stage = dist.get_world_size() // n_data
    mesh = make_pp_mesh(n_stage, n_data, device='cpu')
    mine = {k: v.clone().requires_grad_(True)
            for k, v in place_stage_params(stack_stage_params(stacked, n_stage), mesh).items()}
    d = mesh.index('data')
    per = x.shape[1] // n_data
    rows = slice(d * per, (d + 1) * per)
    out = pipeline_apply(mine, x[:, rows], _block_fn(cfg), mesh, rng=rng)
    (out * w[:, rows]).sum().backward()
    return out.detach(), (d * per, (d + 1) * per), {k: v.grad for k, v in mine.items()}


def pp_forward_grad(cfg, full, sig, lab, n_data, n_micro):
    """``pipeline_vit_forward`` on a (n_data, world / n_data) mesh from the
    full (scan layout) state_dict ``full``: (this rank's logits and rows,
    the BCE loss over the global batch, the full gradient (boundary summed
    over 'stage' and every leaf averaged over 'data', stacks gathered))."""
    from ecg_representation_learning_tpu_torch.models.vit import bce_with_logits
    n_stage = dist.get_world_size() // n_data
    tcfg = TrainConfig(mesh_stage=n_stage, mesh_data=n_data, train_batch_size=len(sig),
                       log_to_console=False)
    tr = PipelineVitTrainer(cfg, tcfg, device='cpu', n_micro=n_micro)
    tr.init_state()
    tr.set_merged_params(full)
    rows = data_rows(len(sig), n_micro, tr.mesh)
    logits = pipeline_vit_forward(cfg, tr.model, sig[rows], tr.mesh, n_micro)
    loss = bce_with_logits(logits, lab[rows])
    (loss * float(tr.stage == n_stage - 1)).backward()
    grads = {k: p.grad for k, p in tr.model.named_parameters()}
    spmd.sum_grads(list(grads.values()), 'data', tr.mesh, divide=n_data)
    spmd.sum_grads([g for k, g in grads.items() if k not in tr.stage_names], 'stage', tr.mesh)
    loss = loss.detach()
    dist.all_reduce(loss, group=tr.mesh.group('data'))
    return logits.detach(), rows, float(loss) / n_data, tr._full(grads)


def pp_train(cfg, tcfg, data, full, out_dir, n_micro=None, steps=None):
    """``PipelineVitTrainer`` from the full state_dict ``full`` (None: its
    own init): per-step global losses (``train()`` when ``steps`` is None,
    else ``steps`` steps on consecutive rows), the merged params, the
    shapes of this rank's leaves and moments."""
    tr = PipelineVitTrainer(cfg, tcfg, train_data=data, device='cpu', n_micro=n_micro,
                            output_dir=out_dir)
    tr.init_state()
    if full is not None:
        tr.set_merged_params(full)
    losses = []
    if steps is None:
        step = tr.train_step
        tr.train_step = lambda d, take: (lambda l: (losses.append(float(l)), l)[1])(
            step(d, take))
        tr.train()
    else:
        bs = tcfg.train_batch_size
        losses = [float(tr.train_step(data, np.arange(bs * k, bs * (k + 1))))
                  for k in range(steps)]
    return {'losses': losses, 'merged': tr.merged_params(),
            'local': {k: tuple(v.shape) for k, v in tr._leaves().items()},
            'mu': {k: tuple(v.shape) for k, v in tr.opt_state.mu.items()},
            'stage': tr.stage, 'n_local_layers': tr.model_cfg.num_hidden_layers // tr.n_stage}


# ------------------------------------------------------------ JAX-free tests
class _StubMesh:
    """A rank's place on a mesh, without a process group (for index maths)."""

    def __init__(self, shape, index):
        self.shape, self._index = shape, index

    def index(self, axis):
        return self._index[axis]

    def group(self, axis):
        return None


def test_ring_and_pipeline_collectives_are_identities_without_a_mesh():
    x = torch.randn(2, 3, 4, requires_grad=True)
    assert spmd.ppermute(x, 'data') is x and spmd.sum_over(x, 'stage') is x
    assert spmd.ppermute_many([x], 'data')[0] is x
    assert spmd.axis_index('data') == (0, 1)
    g = [torch.ones(3)]
    spmd.sum_grads(g, 'data')
    assert torch.equal(g[0], torch.ones(3))
    spmd.sum_grads(g, 'data', divide=4)
    assert torch.equal(g[0], torch.full((3,), 0.25))


def test_data_rows_take_each_rank_s_slice_of_every_microbatch():
    # JAX's P(None, 'data') over (M, B / M, ...): B = 16, M = 4, two data ranks
    rows = [data_rows(16, 4, _StubMesh({'data': 2, 'stage': 2}, {'data': d, 'stage': 0}))
            for d in range(2)]
    assert rows[0].tolist() == [0, 1, 4, 5, 8, 9, 12, 13]
    assert rows[1].tolist() == [2, 3, 6, 7, 10, 11, 14, 15]
    one = data_rows(16, 4, _StubMesh({'data': 1, 'stage': 4}, {'data': 0, 'stage': 3}))
    assert one.tolist() == list(range(16))
    import pytest
    with pytest.raises(ValueError, match='microbatches'):
        data_rows(10, 4, _StubMesh({'data': 1, 'stage': 2}, {'data': 0, 'stage': 0}))


def test_stage_norm_weights_count_each_leaf_once():
    from ecg_representation_learning_tpu_torch.parallel.mesh import stage_norm_weights
    mesh = _StubMesh({'data': 2, 'stage': 4}, {'data': 0, 'stage': 0})
    w = stage_norm_weights(['head.weight', 'encoder.blocks.attn.qkv.weight'],
                           ['encoder.blocks.attn.qkv.weight'], mesh)
    assert w == [1 / 8, 1 / 2]   # boundary: a copy per rank; a stage leaf: per data rank


def test_stage_stacks_split_and_place():
    stacked = {'w': torch.arange(24.).reshape(4, 3, 2)}
    st = stack_stage_params(stacked, 2)
    assert st['w'].shape == (2, 2, 3, 2) and torch.equal(st['w'].reshape(4, 3, 2), stacked['w'])
    mesh = _StubMesh({'data': 1, 'stage': 2}, {'data': 0, 'stage': 1})
    mesh.device = torch.device('cpu')
    assert torch.equal(place_stage_params(st, mesh)['w'], stacked['w'][2:])
    import pytest
    with pytest.raises(ValueError, match='stages'):
        stack_stage_params(stacked, 3)


def test_a_dropout_frame_of_scattered_rows_indexes_the_global_array():
    from ecg_representation_learning_tpu_torch.ops.dropout import flat_index, hash_mul
    rows = torch.tensor([1, 3, 6])
    idx = flat_index((3, 2, 4), {0: (rows, 8)}, 'cpu')
    assert torch.equal(idx, torch.arange(64).reshape(8, 2, 4)[rows])
    x = torch.randn(8, 2, 4)
    assert torch.equal(hash_mul(x[rows], 5, 0.5, 5, {0: (rows, 8)}), hash_mul(x, 5, 0.5, 5)[rows])
