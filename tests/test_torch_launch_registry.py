"""The launch registry of the port's hand-written kernels (ops/_build.py), on
the CPU: it holds one counter for each kernel and direction, by the names of
chip_smoke.py's kernels line, ``flash_bwd_ws`` (the launches of #3 and #4
that took the warp-specialised route) and ``param_cast``; a CPU call of each kernel's
wrapper runs the plain version and counts nothing, as does a CPU training
forward's parameter cast; and a step tape's CUDA graph
(train/dispatch.py) puts back what its capture counted and adds it again at
each replay, for every counter, #8's as #1-#5's."""
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu_torch.models.moe import sort_pairs
from ecg_representation_learning_tpu_torch.models.vit import Dense
from ecg_representation_learning_tpu_torch.ops import (_build, adamw, attention, dropout,
                                                       moe_glue, nlm_fused)
from ecg_representation_learning_tpu_torch.tools import nlm_sol_probe
from ecg_representation_learning_tpu_torch.train import dispatch, loop

NAMES = ('flash_fwd', 'flash_fwd_lse', 'flash_bwd_dq', 'flash_bwd_dkv', 'flash_bwd_ws', 'adamw',
         'adamw_norm', 'nlm_rows', 'nlm_variant', 'gelu_dropout', 'gelu_dropout_bwd',
         'dropout_add', 'dropout_add_bwd', 'moe_permute', 'moe_permute_bwd', 'moe_swiglu',
         'moe_swiglu_bwd', 'moe_combine', 'moe_combine_bwd', 'param_cast')
HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _flash(lse: bool):
    q, k, v = (_randn(1, 2, 41, 16, seed=s) for s in range(3))
    return attention.flash_attention_forward(q, k, v, 3, None, 0.1, return_lse=lse)


def _flash_bwd():
    q, k, v, g = (_randn(1, 2, 41, 16, seed=s) for s in range(4))
    out, lse = attention.flash_attention_forward(q, k, v, 3, None, 0.1, return_lse=True)
    return attention.flash_attention_backward_blocked(q, k, v, out, lse, g, 3, None, 0.1)


def _adamw(tail: bool):
    params = [torch.zeros(3, 4), torch.zeros(71)]
    mus, nus = [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
    grads = [torch.ones_like(p) for p in params]
    if tail:
        return adamw.adamw_tail(params, grads, mus, nus, (0.1, 0.1, 0.001), clip_norm=1.0,
                                zero_nonfinite=True, **HYPER)
    return adamw.adamw_update(params, grads, mus, nus,
                              torch.tensor([1.0, 0.1, 0.1, 0.001, 1.0]), **HYPER)


def _nlm(flags):
    x2, h2 = _randn(3, 80), torch.full((3,), 2.0)
    if flags is None:
        return nlm_fused.nlm_rows(x2, h2, 16, 4)
    return nlm_sol_probe.run_variant(x2, h2, 16, 4, flags)


def _site(kind: str, backward: bool):
    a = _randn(2, 7, 33).requires_grad_()
    keep = torch.rand(2, 7, 33, generator=torch.Generator().manual_seed(1)) > 0.1
    out = (dropout.gelu_dropout(a, keep.float(), 0.1) if kind == 'gelu_dropout'
           else dropout.dropout_add(_randn(2, 7, 33, seed=2), a, keep.float(), 0.1))
    if backward:
        out.sum().backward()
    return out


def _glue(op: str, backward: bool):
    t, d, f, k = 12, 16, 8, 3
    idx = torch.stack([torch.randperm(8, generator=torch.Generator().manual_seed(i))[:k]
                       for i in range(t)])
    rows = t * k
    order, pos, held, _, offs = sort_pairs(idx, 0, 4, rows)
    if op == 'permute':
        xs = _randn(t, d).requires_grad_()
        out = moe_glue.permute(xs, order, pos, held, offs, rows, torch.float32)[:int(offs[-1])]
    elif op == 'swiglu':
        h = _randn(rows, 2 * f).requires_grad_()
        out = moe_glue.swiglu(h, offs)[:int(offs[-1])]
    else:
        y = _randn(rows, d).requires_grad_()
        gates = torch.rand(t, k, generator=torch.Generator().manual_seed(3)).requires_grad_()
        out = moe_glue.combine(y, gates, pos, held, order, offs)
    if backward:
        out.sum().backward()
    return out


def _param_cast():
    """A training forward of a bf16 Dense, counted as the trainers count
    (``loop.count_param_casts``): it casts its weight and bias."""
    layer = Dense(16, 8, dtype=torch.bfloat16).train()
    loop.count_param_casts(layer)
    return layer(_randn(3, 16))


CPU_CALLS = {
    'flash_fwd': lambda: _flash(lse=False),
    'flash_fwd_lse': lambda: _flash(lse=True),
    'flash_bwd_dq': _flash_bwd,
    'flash_bwd_dkv': _flash_bwd,
    'flash_bwd_ws': _flash_bwd,
    'adamw': lambda: _adamw(tail=False),
    'adamw_norm': lambda: _adamw(tail=True),
    'nlm_rows': lambda: _nlm(None),
    'nlm_variant': lambda: _nlm({'exp': False}),
    **{f'{kind}{way}': (lambda kind=kind, way=way: _site(kind, way == '_bwd'))
       for kind in ('gelu_dropout', 'dropout_add') for way in ('', '_bwd')},
    **{f'moe_{op}{way}': (lambda op=op, way=way: _glue(op, way == '_bwd'))
       for op in ('permute', 'swiglu', 'combine') for way in ('', '_bwd')},
    'param_cast': _param_cast,
}


class _Graph:
    """A stand-in for a captured CUDA graph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _check_names():
    assert tuple(_build.launch_counts()) == NAMES == _build.COUNTERS
    assert sorted(CPU_CALLS) == sorted(NAMES)


def _check_cpu_call(name: str):
    before = _build.launch_counts()
    CPU_CALLS[name]()
    assert _build.launch_counts() == before


def _check_dispatch_accounting():
    """A capture that launched #8 (``gelu_dropout``, counted here by hand, as
    the wrapper counts a launch on the card) leaves the registry as it was;
    three replays add three times the captured launches."""
    before = _build.launch_counts()
    out, captured = dispatch._uncounted(lambda: (_build.add_launches({'gelu_dropout': 2}),
                                                 'metrics')[1])
    assert out == 'metrics'
    assert _build.launch_counts() == before
    assert captured == {**dict.fromkeys(NAMES, 0), 'gelu_dropout': 2}
    graph = _Graph()
    dispatch._replayed(graph, captured, 3)
    assert graph.replays == 3
    assert _build.launch_counts() == {**before, 'gelu_dropout': before['gelu_dropout'] + 6}
    _build.add_launches(captured, -3)
    assert _build.launch_counts() == before


@pytest.mark.parametrize('case', ['names', *(f'cpu_{name}' for name in NAMES),
                                  'dispatch_accounting'])
def test_the_registry(case):
    if case == 'names':
        _check_names()
    elif case == 'dispatch_accounting':
        _check_dispatch_accounting()
    else:
        _check_cpu_call(case[len('cpu_'):])


def test_reset_sets_every_counter_to_zero():
    saved = _build.launch_counts()
    _build.add_launches({'dropout_add_bwd': 5, 'moe_swiglu': 1})
    _build.reset_launches()
    assert _build.launch_counts() == dict.fromkeys(NAMES, 0)
    _build.add_launches(saved)
