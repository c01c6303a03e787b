"""The MoE layer's glue (``ops/moe_glue.py``) on the CPU, where each entry
runs its plain version: held against the chain of PyTorch operations that
``DeepseekMoe`` ran before the glue had kernels (copied below as
``_Chain*``), bit for bit in values and gradients, in f32 and bf16, at
held counts from none to every pair; the rows of a buffer past the held
count are NaN and reach no output or gradient; the wrappers refuse what the
kernels do not take.  The kernels themselves are held against these plain
versions on the card (``tests/test_torch_moe_glue_card.py``).
"""
import copy

import pytest
import torch
import torch.nn.functional as F

from ecg_representation_learning_tpu_torch.configs import VitConfig
from ecg_representation_learning_tpu_torch.models.moe import DeepseekMoe, sort_pairs
from ecg_representation_learning_tpu_torch.ops import _build, moe_glue

torch.set_num_threads(2)
DTYPES = [torch.float32, torch.bfloat16]
# (first held expert, held experts, correction bias of the held ones) of 8
# experts, top 3: every pair held, some, one expert, none
HELD = {'all': (0, 8, 0.0), 'some': (2, 3, 0.0), 'one': (7, 1, 0.0), 'none': (0, 2, -100.0)}
T, D, F_INNER, E, K = 24, 16, 8, 8, 3


class _ChainPermute(torch.autograd.Function):
    """The layer's permute before the kernels."""

    @staticmethod
    def forward(ctx, xs, src, pos, held, dtype):
        ctx.save_for_backward(pos, held)
        return xs.to(dtype).index_select(0, src)

    @staticmethod
    def backward(ctx, g):
        pos, held = ctx.saved_tensors
        gx = torch.zeros((pos.shape[0], g.shape[1]), dtype=torch.float32, device=g.device)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        for j in range(pos.shape[1]):
            gx += torch.where(held[:, j, None], g.index_select(0, pos[:, j]), zero)
        return gx, None, None, None, None


class _ChainCombine(torch.autograd.Function):
    """The layer's combine before the kernels."""

    @staticmethod
    def forward(ctx, y, gates, pos, held, order, valid):
        zero = torch.zeros((), dtype=y.dtype, device=y.device)
        yc = torch.where(valid[:, None], y, zero)
        w = torch.where(held, gates, torch.zeros((), device=gates.device))
        out = torch.zeros((pos.shape[0], y.shape[1]), dtype=torch.float32, device=y.device)
        for j in range(pos.shape[1]):
            out.addcmul_(yc.index_select(0, pos[:, j]), w[:, j, None])
        ctx.save_for_backward(yc, w, pos, held, order)
        return out

    @staticmethod
    def backward(ctx, dout):
        yc, w, pos, held, order = ctx.saved_tensors
        k = pos.shape[1]
        dgates = torch.stack([(yc.index_select(0, pos[:, j]) * dout).sum(dim=-1)
                              for j in range(k)], dim=1)
        dgates = torch.where(held, dgates, torch.zeros((), device=dgates.device))
        src = order[:yc.shape[0]]
        dy = dout.index_select(0, src // k) * w.reshape(-1).index_select(0, src)[:, None]
        return dy.to(yc.dtype), dgates, None, None, None, None


def chain_permute(xs, order, pos, held, offs, rows, dtype):
    return _ChainPermute.apply(xs, order[:rows] // pos.shape[1], pos, held, dtype)


def chain_swiglu(h, offs):
    f = h.shape[1] // 2
    return F.silu(h[:, :f]) * h[:, f:]


def chain_combine(y, gates, pos, held, order, offs):
    valid = torch.arange(y.shape[0], device=y.device) < offs[-1]
    return _ChainCombine.apply(y, gates, pos, held, order, valid)


def _routing(held_case: str, seed: int = 0):
    """(order, pos, held, offs, rows) of T tokens' top-K choices of E experts."""
    first, n_held, bias = HELD[held_case]
    g = torch.Generator().manual_seed(seed)
    scores = torch.rand(T, E, generator=g)
    scores[:, first:first + n_held] += bias
    idx = torch.topk(scores, K, dim=-1, sorted=False).indices
    rows = T * min(K, n_held)
    order, pos, held, _, offs = sort_pairs(idx, first, n_held, rows)
    return order, pos, held, offs, rows


def _draw(shape, dtype, seed, requires_grad=False):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 2).to(dtype).requires_grad_(requires_grad)


def _equal_rows(a, b, n):
    """Rows < n equal in value (+0 and -0 alike)."""
    return torch.equal(a[:n], b[:n])


@pytest.mark.parametrize('held_case', list(HELD))
@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'bf16'])
def test_plain_entries_equal_the_chain(dtype, held_case):
    order, pos, held, offs, rows = _routing(held_case)
    n = int(offs[-1])
    assert n == int(held.sum()) and (n == 0) == (held_case == 'none')
    # permute
    xs = _draw((T, D), torch.float32, 1, requires_grad=True)
    xp = moe_glue.permute_forward_reference(xs.detach(), order, offs, rows, dtype)
    want = chain_permute(xs, order, pos, held, offs, rows, dtype)
    assert _equal_rows(xp, want, n) and torch.isnan(xp[n:]).all()
    g = _draw((rows, D), dtype, 2)
    assert torch.equal(moe_glue.permute_backward_reference(g, pos, held),
                       torch.autograd.grad(want, xs, g)[0])
    # swiglu
    h = _draw((rows, 2 * F_INNER), dtype, 3, requires_grad=True)
    a = moe_glue.swiglu_forward_reference(h.detach(), offs)
    want = chain_swiglu(h, offs)
    assert _equal_rows(a, want, n) and torch.isnan(a[n:]).all()
    da = _draw((rows, F_INNER), dtype, 4)
    dh = moe_glue.swiglu_backward_reference(h.detach(), da, offs)
    assert _equal_rows(dh, torch.autograd.grad(want, h, da)[0], n)
    # combine
    y = _draw((rows, D), dtype, 5, requires_grad=True)
    gates = _draw((T, K), torch.float32, 6).abs().requires_grad_(True)
    out = moe_glue.combine_forward_reference(y.detach(), gates.detach(), pos, held, offs)
    want = chain_combine(y, gates, pos, held, order, offs)
    assert torch.equal(out, want)
    dout = _draw((T, D), torch.float32, 7)
    dy, dgates = moe_glue.combine_backward_reference(y.detach(), gates.detach(), dout, pos,
                                                     held, order, offs)
    want_dy, want_dgates = torch.autograd.grad(want, (y, gates), dout)
    assert _equal_rows(dy, want_dy, n) and torch.isnan(dy[n:]).all()
    assert torch.equal(dgates, want_dgates)


@pytest.mark.parametrize('held_case', list(HELD))
@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'bf16'])
def test_layer_equals_the_chain_in_values_and_gradients(dtype, held_case, monkeypatch):
    """DeepseekMoe through the glue entries against the same layer through
    the chain: output, balance loss and the gradients of the input, the
    router, the correction-biased gates' path, the held and the shared
    experts, bit for bit."""
    first, n_held, bias = HELD[held_case]
    cfg = VitConfig.from_preset('moonlight-16b-a3b-ep8', hidden_size=D, num_attention_heads=4,
                                moe_intermediate_size=F_INNER, moe_num_experts=E, moe_top_k=K,
                                moe_held=(first, n_held), dtype='float32')
    torch.manual_seed(0)
    layer = DeepseekMoe(cfg, dtype)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.5)
        layer.gate.e_score_correction_bias[first:first + n_held] += bias
    x = _draw((2, T // 2, D), torch.float32, 11, requires_grad=True)
    w_out = _draw((2, T // 2, D), torch.float32, 12)
    results = []
    for glue in ('entries', 'chain'):
        model = copy.deepcopy(layer).train()
        if glue == 'chain':
            monkeypatch.setattr(moe_glue, 'permute', chain_permute)
            monkeypatch.setattr(moe_glue, 'swiglu', chain_swiglu)
            monkeypatch.setattr(moe_glue, 'combine', chain_combine)
        out, aux = model(x)
        loss = (out * w_out).sum() + aux
        params = [p for _, p in model.named_parameters()]
        grads = torch.autograd.grad(loss, [x, *params])
        results.append((out, aux, grads, int(model.held_rows)))
    (out, aux, grads, n), (out2, aux2, grads2, n2) = results
    assert n == n2 and (n == 0) == (held_case == 'none')
    assert torch.equal(out, out2) and torch.equal(aux, aux2)
    assert torch.isfinite(out).all()
    names = ['x'] + [k for k, _ in layer.named_parameters()]
    for name, a, b in zip(names, grads, grads2):
        assert torch.isfinite(a).all() and torch.equal(a, b), name


@pytest.mark.parametrize('held_case', ['some', 'one'])
@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'bf16'])
def test_rows_past_the_count_never_reach_an_output(dtype, held_case):
    """NaN in every input row at or past the held count: each entry's
    outputs are those of finite rows there, and finite."""
    order, pos, held, offs, rows = _routing(held_case, seed=1)
    n = int(offs[-1])
    assert 0 < n < rows

    def poisoned(t):
        bad = t.clone()
        bad[n:] = float('nan')
        return bad

    g, y = _draw((rows, D), dtype, 21), _draw((rows, D), dtype, 22)
    h, da = _draw((rows, 2 * F_INNER), dtype, 23), _draw((rows, F_INNER), dtype, 24)
    gates, dout = _draw((T, K), torch.float32, 25).abs(), _draw((T, D), torch.float32, 26)
    cases = [
        (lambda g: moe_glue.permute_backward(g, pos, held), g),
        (lambda h: moe_glue.swiglu_forward(h, offs)[:n], h),
        (lambda h: moe_glue.swiglu_backward(h, poisoned(da), offs)[:n], h),
        (lambda y: moe_glue.combine_forward(y, gates, pos, held, offs), y),
        (lambda y: moe_glue.combine_backward(y, gates, dout, pos, held, order, offs)[1], y),
        (lambda y: moe_glue.combine_backward(y, gates, dout, pos, held, order, offs)[0][:n], y)]
    for fn, t in cases:
        got = fn(poisoned(t))
        assert torch.isfinite(got).all() and torch.equal(got, fn(t))
    counts = _build.launch_counts()
    assert (counts['moe_permute'], counts['moe_combine_bwd']) == (0, 0)


def _bad_inputs():
    order, pos, held, offs, rows = _routing('some')
    xs, g = torch.randn(T, D), torch.randn(rows, D)
    h, da = torch.randn(rows, 2 * F_INNER), torch.randn(rows, F_INNER)
    y, gates, dout = torch.randn(rows, D), torch.rand(T, K), torch.randn(T, D)
    wide = torch.randn(D, T).t()   # (T, D), not contiguous
    return {
        'permute_forward shape': lambda: moe_glue.permute_forward(xs, order[:-1], offs, rows,
                                                                  torch.bfloat16),
        'permute_forward dtype': lambda: moe_glue.permute_forward(xs, order, offs, rows,
                                                                  torch.float16),
        'permute_forward strides': lambda: moe_glue.permute_forward(wide, order, offs, rows,
                                                                    torch.bfloat16),
        'permute_backward dtype': lambda: moe_glue.permute_backward(g, pos.int(), held),
        'permute_backward shape': lambda: moe_glue.permute_backward(g, pos, held[:-1]),
        'swiglu_forward shape': lambda: moe_glue.swiglu_forward(h[:, :-1], offs),
        'swiglu_forward offs': lambda: moe_glue.swiglu_forward(h, offs.float()),
        'swiglu_backward dtype': lambda: moe_glue.swiglu_backward(h, da.bfloat16(), offs),
        'swiglu_backward strides': lambda: moe_glue.swiglu_backward(h[:, ::2], da, offs),
        'combine_forward dtype': lambda: moe_glue.combine_forward(y, gates.double(), pos, held,
                                                                  offs),
        'combine_forward strides': lambda: moe_glue.combine_forward(y, gates.t().contiguous().t(),
                                                                    pos, held, offs),
        'combine_backward shape': lambda: moe_glue.combine_backward(y, gates, dout[1:], pos,
                                                                    held, order, offs),
        'combine_backward dtype': lambda: moe_glue.combine_backward(y, gates, dout, pos,
                                                                    held.int(), order, offs),
    }


@pytest.mark.parametrize('case', list(_bad_inputs()))
def test_wrappers_refuse_wrong_inputs(case):
    with pytest.raises(ValueError):
        _bad_inputs()[case]()
