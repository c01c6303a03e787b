"""Kernel #5's bf16 compute copies on the CPU's plain route
(``train/loop.py``'s ``ComputeCopies``, ``ops/adamw.py``).

A training step reads each cast leaf's copy in place of casting the
parameter, keeps the copies' bf16 gradients apart per microbatch and hands
them to the update, which takes the mean and writes the copies.  Held to the
cast route, rebuilt here from autograd's f32 gradients (every layer
casting its parameters, the microbatches summed by autograd and divided in
place) and ``adamw_tail_reference``: after the steps, parameters, moments,
every loss and gradient norm are the same bits -- for ViT-tiny bf16 at
accum 1 and 2, a toy DeepSeek block (latent attention, ``HeldExperts``) at
accum 2, and the K = 4 step tape on the CPU.  Every copy equals
``p.to(bfloat16)`` after init, after every step (a non-finite, zeroed step
too) and after ``load_checkpoint``; ``state_dict`` is the model's as it was;
the router, norm, head and position leaves keep f32 gradients; the
microbatch count reaches the update with the gradients.
"""
import inspect

import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models.vit import EcgVit
from ecg_representation_learning_tpu_torch.ops import adamw
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer, loop
from ecg_representation_learning_tpu_torch.train import trainer as trainer_mod
from ecg_representation_learning_tpu_torch.train.dispatch import Dispatcher

torch.set_num_threads(2)
BSZ = 16


def _vit() -> VitConfig:
    return VitConfig.from_defined('debug', hidden_size=64, dtype='bfloat16',
                                  max_signal_length=640)


def _deepseek() -> VitConfig:
    return VitConfig.from_preset('moonlight-16b-a3b-ep8', hidden_size=64, num_attention_heads=2,
                                 qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
                                 kv_lora_rank=32, intermediate_size=96,
                                 moe_intermediate_size=32, moe_num_experts=8, moe_top_k=3,
                                 moe_held=(0, 4), num_hidden_layers=2, max_signal_length=640)


def _data(n: int = 96, nan_rows=()) -> SplitData:
    rng = np.random.default_rng(0)
    sig = rng.standard_normal((n, 12, 600)).astype(np.float32)
    sig[list(nan_rows)] = np.nan
    lab = (rng.random((n, 71)) < 0.3).astype(np.float32)
    return SplitData(sig, lab)


def _trainer(cfg: VitConfig, tmp_path, name: str, data: SplitData, **train) -> Trainer:
    tcfg = TrainConfig(train_batch_size=BSZ, num_train_epoch=1, do_eval=False, save_final=False,
                       log_to_console=False, seed=5, grad_clip_norm=1.0, **train)
    tr = Trainer(cfg, tcfg, train_data=data, output_dir=str(tmp_path / name), device='cpu')
    tr.init_state(5)
    return tr


def _copies_current(tr: Trainer) -> None:
    copies = tr._copies
    assert copies is not None and copies.copies
    assert list(copies.copies) == list(loop.cast_leaves(tr.model))
    for name, c in copies.copies.items():
        assert torch.equal(c, tr.model.get_parameter(name).detach().to(torch.bfloat16)), name


def _replaced_route(tr: Trainer, monkeypatch) -> None:
    """The cast route the copies stand in for, on ``tr``: no copies (every layer
    casts its f32 parameters), the gradients autograd's f32 sums divided in
    place by accum (``torch._foreach_div_``) and handed to the update as
    the mean gradients, the tail's plain version on them, with no copies."""
    tr._copies = None
    monkeypatch.setattr(tr, '_compute_copies', lambda: None)
    real = loop.grad_accum

    def grad_accum(micro_fn, params, idx, accum, sharded=None, marks=loop.tracing.NO_MARKS,
                   copies=None):
        assert copies is None
        aux, grads = real(micro_fn, params, idx, accum, sharded, marks)
        assert grads.accum == accum
        mean = grads.leaves
        assert all(isinstance(g, torch.Tensor) and g.dtype == torch.float32
                   for g in mean.values())
        if accum > 1:
            torch._foreach_div_(list(mean.values()), float(accum))
        return aux, mean
    monkeypatch.setattr(trainer_mod, 'grad_accum', grad_accum)
    tr.optimizer.tail = adamw.adamw_tail_reference


def _run(tr: Trainer, steps: int, tape: bool, check_copies: bool):
    """``steps`` steps (``tape``: one K = 4 dispatch of the step tape, then
    the rest one a dispatch); each step's (loss, grad_norm)."""
    out = []
    if tape:
        disp = Dispatcher(tr, 4, scan=False)
        losses, norms, _ = disp.run(np.arange(4 * BSZ).reshape(4, BSZ))
        assert disp.info()['route'] == 'eager'
        out += list(zip(losses.tolist(), norms.tolist()))
        steps -= 4
    for i in range(steps):
        m = tr.train_step(tr.train_data, np.arange(BSZ * i, BSZ * (i + 1)) % len(tr.train_data))
        out.append((float(m['loss']), float(m['grad_norm'])))
        if check_copies:
            _copies_current(tr)
    return out


def _same_state(a: Trainer, b: Trainer) -> None:
    for (name, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), name
    for m in ('mu', 'nu'):
        for k, v in getattr(a.opt_state, m).items():
            assert torch.equal(v, getattr(b.opt_state, m)[k]), (m, k)


ROUTES = {'vit_accum1': (_vit, 1, False), 'vit_accum2': (_vit, 2, False),
          'deepseek_accum2': (_deepseek, 2, False), 'tape_k4': (_vit, 2, True)}


def _equal_to_the_replaced_route(case: str, tmp_path, monkeypatch) -> None:
    make, accum, tape = ROUTES[case]
    data = _data()
    new = _trainer(make(), tmp_path, 'new', data, grad_accum=accum, steps_per_dispatch=1)
    _copies_current(new)
    got = _run(new, 5 if tape else 3, tape, check_copies=True)
    _copies_current(new)
    old = _trainer(make(), tmp_path, 'old', data, grad_accum=accum, steps_per_dispatch=1)
    _replaced_route(old, monkeypatch)
    want = _run(old, 5 if tape else 3, tape, check_copies=False)
    assert got == want
    _same_state(new, old)


def _nonfinite_step(tmp_path, monkeypatch) -> None:
    """A step whose gradient norm is not finite (debug_nans zeroes it) still
    writes every copy; the steps equal the replaced route's."""
    data = _data(nan_rows=[BSZ + 3])
    runs = []
    for name in ('new', 'old'):
        tr = _trainer(_vit(), tmp_path, name, data, grad_accum=2, debug_nans=True)
        if name == 'old':
            _replaced_route(tr, monkeypatch)
        runs.append((tr, _run(tr, 3, False, check_copies=name == 'new')))
    (new, got), (old, want) = runs
    assert not np.isfinite(got[1][1]) and int(new._nonfinite) == 1
    assert np.array_equal(np.array(got), np.array(want), equal_nan=True)
    _same_state(new, old)
    _copies_current(new)


def _load_checkpoint(tmp_path) -> None:
    """A checkpoint restored into another trainer: its copies are the
    restored parameters', and its next step equals the saving trainer's."""
    data = _data()
    a = _trainer(_vit(), tmp_path, 'a', data, grad_accum=2)
    _run(a, 2, False, check_copies=False)
    path = a.save_checkpoint('mid')
    b = _trainer(_vit(), tmp_path, 'b', data, grad_accum=2)
    b.init_state(11)
    b.load_checkpoint(path)
    _copies_current(b)
    step_a = a.train_step(data, np.arange(BSZ))
    step_b = b.train_step(data, np.arange(BSZ))
    assert float(step_a['loss']) == float(step_b['loss'])
    _same_state(a, b)
    _copies_current(b)


def _state_dict_unchanged(tmp_path) -> None:
    for make in (_vit, _deepseek):
        tr = _trainer(make(), tmp_path, make.__name__, _data(), grad_accum=2)
        _run(tr, 1, False, check_copies=False)
        with torch.device('cpu'):
            plain = EcgVit(make()).state_dict()
        got = tr.model.state_dict()
        assert list(got) == list(plain)
        assert all(got[k].shape == plain[k].shape and got[k].dtype == plain[k].dtype
                   for k in plain)
        assert not any('copies' in k for k in got)


def _f32_leaves(make, tmp_path, monkeypatch) -> None:
    """The copy route covers the bf16 layers' weights and biases (ViT-tiny:
    the patch projection's 2 leaves and 7 a block), and every other leaf --
    router, norms, head, class token, position table -- keeps one f32
    gradient."""
    seen = {}
    real = loop.grad_accum

    def grad_accum(*args, **kw):
        aux, grads = real(*args, **kw)
        seen.update(grads.leaves)
        return aux, grads
    monkeypatch.setattr(trainer_mod, 'grad_accum', grad_accum)
    tr = _trainer(make(), tmp_path, 'f32', _data(), grad_accum=2)
    _run(tr, 1, False, check_copies=True)
    copied = set(tr._copies.copies)
    if make is _vit:
        assert len(copied) == 2 + 7 * tr.model_cfg.num_hidden_layers
    for name, g in seen.items():
        if name in copied:
            assert isinstance(g, tuple) and len(g) == 2
            assert all(x.dtype == torch.bfloat16 for x in g), name
        else:
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float32, name
    f32 = set(seen) - copied
    kinds = ('norm', 'head.', 'cls_token', 'pos_embed', 'gate.weight', 'layernorm')
    assert f32 == {n for n in seen if any(k in n for k in kinds)}, f32
    if make is _deepseek:
        assert any(n.endswith('experts.gate_up') for n in copied)
        assert any(n.endswith('gate.weight') for n in f32)


def _accum_with_the_grads(tmp_path, monkeypatch) -> None:
    """The step's microbatch count travels with its gradients
    (``loop.StepGrads``), and the update tail takes the mean from it: no
    caller hands the divisor over on its own."""
    seen = []
    real = loop.finish_update

    def finish_update(optimizer, cfg, opt_state, params, grads, *args, **kw):
        seen.append(grads)
        return real(optimizer, cfg, opt_state, params, grads, *args, **kw)
    monkeypatch.setattr(trainer_mod, 'finish_update', finish_update)
    tr = _trainer(_vit(), tmp_path, 'accum', _data(), grad_accum=2)
    _run(tr, 1, False, check_copies=False)
    (grads,) = seen
    assert isinstance(grads, loop.StepGrads) and grads.accum == 2
    assert 'accum' not in inspect.signature(loop.finish_update).parameters


CASES = [*ROUTES, 'nonfinite', 'load_checkpoint', 'state_dict', 'f32_leaves_vit',
         'f32_leaves_deepseek', 'accum_with_the_grads']


@pytest.mark.parametrize('case', CASES)
def test_the_copy_route(case, tmp_path, monkeypatch):
    if case in ROUTES:
        _equal_to_the_replaced_route(case, tmp_path, monkeypatch)
    elif case == 'nonfinite':
        _nonfinite_step(tmp_path, monkeypatch)
    elif case == 'load_checkpoint':
        _load_checkpoint(tmp_path)
    elif case == 'state_dict':
        _state_dict_unchanged(tmp_path)
    elif case == 'accum_with_the_grads':
        _accum_with_the_grads(tmp_path, monkeypatch)
    else:
        _f32_leaves(_vit if case.endswith('vit') else _deepseek, tmp_path, monkeypatch)
