"""The MoE glue kernels (``ops/csrc/moe_glue.cu``) on the card.

Every test here needs a CUDA device and skips without one; on a machine with
a card run them with ``python -m pytest --noconftest -p no:cacheprovider -m
card tests/test_torch_moe_glue_card.py`` (this file imports no JAX).

The shapes are the ``moonlight_ep8_cls_k4`` cell's: a microbatch of 256
records of 41 tokens (T = 10,496), d 2,048, top 6 of 64 experts with the
first 8 held, the experts' SwiGLU 1,408 wide (buffer of 62,976 rows), with
the held experts drawn at the share of the pairs the cell's router holds over
its measured window (~10 %) and at the uniform one (12.5 %).  Each kernel is
held against its plain version on the card, with NaN in every input row past
the held count:

  * the permute, the SwiGLU both ways and the combine's row gradients equal
    the plain versions' values (the kernels round where PyTorch's kernels
    round);
  * the combine (a multiply-add a choice, as ``addcmul_`` compiles on the
    card) and the permute's gradient (one add a choice, as ``+=``) sum the
    same f32 terms in the same order; they are held within 2**-22 of the sum
    of the terms' magnitudes (two f32 ulps), against another build
    contracting differently (an H100 with torch 2.11 reads them bit-equal);
  * the gates' gradients are dot products over d = 2,048 terms that the
    kernel sums per lane and then across the warp, PyTorch in its reduction
    tree: held within 1e-5 of the sum of the products' magnitudes (f32 error
    bounds for sums of 2,048 terms in two orders);
  * a layer's call makes one launch of each entry forward and one backward,
    and at the cell's widths its output and gradients stay within 1e-4 of
    the layer run through the plain versions, and finite with the memory
    it allocates poisoned with NaN beforehand;
  * a row whose width is not a multiple of 8, or a row tensor that does
    not start on 16 bytes, is refused with ValueError before any launch.
"""
import copy

import pytest
import torch

from ecg_representation_learning_tpu_torch.configs import VitConfig
from ecg_representation_learning_tpu_torch.models.moe import DeepseekMoe, sort_pairs
from ecg_representation_learning_tpu_torch.ops import _build, moe_glue

RECORDS, TOKENS, D, F_INNER, E, K, HELD = 256, 41, 2048, 1408, 64, 6, 8
T = RECORDS * TOKENS
# a held expert's weight against the others' 1 when drawing the choices: the
# cell's router holds ~10 % of the pairs over its window, a uniform one 12.5 %
SHARES = {'cell': 0.76, 'uniform': 1.0}
SUM_ULPS = 2.0 ** -22
DOT_RTOL = 1e-5


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _routing(t: int, weight: float, dev, gen):
    """(order, pos, held, offs, rows) of ``t`` tokens' top-K of E experts,
    the first HELD held, each drawn with ``weight`` against 1."""
    w = torch.ones(E, device=dev)
    w[:HELD] = weight
    idx = torch.multinomial(w.expand(t, E), K, replacement=False, generator=gen)
    rows = t * min(K, HELD)
    order, pos, held, _, offs = sort_pairs(idx, 0, HELD, rows)
    return order, pos, held, offs, rows


def _draw(shape, dtype, dev, gen, offset=0):
    """A normal draw of ``shape`` (times 2) starting ``offset`` elements into
    its buffer (contiguous either way)."""
    n = 1
    for s in shape:
        n *= s
    buf = (2 * torch.randn(n + offset, device=dev, generator=gen)).to(dtype)
    return buf[offset:].view(shape)


def _poison(t: torch.Tensor, n: int) -> torch.Tensor:
    t[n:] = float('nan')
    return t


def _values_equal(a, b, n=None):
    return bool(torch.equal(a[:n], b[:n]))


def _within_sum_bound(got, want, scale, rtol):
    return bool(((got - want).abs() <= rtol * scale).all())


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=['bf16', 'f32'])
@pytest.mark.parametrize('share', list(SHARES))
def test_kernels_match_their_plain_versions(card, dtype, share):
    t, d, f = T, D, F_INNER
    gen = torch.Generator(device=card).manual_seed(7)
    order, pos, held, offs, rows = _routing(t, SHARES[share], card, gen)
    n = int(offs[-1])
    print(f'{share} t={t}: {n} held rows of {rows} ({100 * n / rows:.2f} %)')
    xs = _draw((t, d), torch.float32, card, gen)
    h = _poison(_draw((rows, 2 * f), dtype, card, gen), n)
    da = _poison(_draw((rows, f), dtype, card, gen), n)
    y = _poison(_draw((rows, d), dtype, card, gen), n)
    g = _poison(_draw((rows, d), dtype, card, gen), n)
    gates = _draw((t, K), torch.float32, card, gen).abs()
    dout = _draw((t, d), torch.float32, card, gen)

    got = moe_glue.permute_forward(xs, order, offs, rows, dtype)
    assert _values_equal(got, moe_glue.permute_forward_reference(xs, order, offs, rows, dtype),
                         n)
    got = moe_glue.swiglu_forward(h, offs)
    assert torch.isfinite(got[:n]).all()
    assert _values_equal(got, moe_glue.swiglu_forward_reference(h, offs), n)
    got = moe_glue.swiglu_backward(h, da, offs)
    assert torch.isfinite(got[:n]).all()
    assert _values_equal(got, moe_glue.swiglu_backward_reference(h, da, offs), n)

    yf = torch.where(torch.isnan(y), 0.0, y.float())
    terms = yf.index_select(0, pos.reshape(-1)).reshape(t, K, d).abs()   # |y| of each pair
    scale = (terms * (gates * held)[..., None]).sum(1)
    got = moe_glue.combine_forward(y, gates, pos, held, offs)
    want = moe_glue.combine_forward_reference(y, gates, pos, held, offs)
    print(f'combine: max abs err {float((got - want).abs().max()):.3e}, '
          f'bits equal {bool(torch.equal(got, want))}')
    assert torch.isfinite(got).all() and _within_sum_bound(got, want, scale, SUM_ULPS)
    got_dy, got_dg = moe_glue.combine_backward(y, gates, dout, pos, held, order, offs)
    want_dy, want_dg = moe_glue.combine_backward_reference(y, gates, dout, pos, held, order,
                                                           offs)
    assert _values_equal(got_dy, want_dy, n)
    dot_scale = (terms * dout.abs()[:, None, :]).sum(-1) * held
    print(f'dgates: max abs err {float((got_dg - want_dg).abs().max()):.3e}, largest share '
          f'of the bound {float(((got_dg - want_dg).abs() / (DOT_RTOL * dot_scale + 1e-30)).max()):.3f}')
    assert torch.isfinite(got_dg).all() and _within_sum_bound(got_dg, want_dg, dot_scale,
                                                               DOT_RTOL)
    assert bool((got_dg[~held] == 0).all())

    got = moe_glue.permute_backward(g, pos, held)
    want = moe_glue.permute_backward_reference(g, pos, held)
    gf = torch.where(torch.isnan(g), 0.0, g.float())
    scale = (gf.index_select(0, pos.reshape(-1)).reshape(t, K, d).abs() * held[..., None]).sum(1)
    print(f'permute backward: max abs err {float((got - want).abs().max()):.3e}, '
          f'bits equal {bool(torch.equal(got, want))}')
    assert torch.isfinite(got).all() and _within_sum_bound(got, want, scale, SUM_ULPS)


def _cell_layer(dev) -> DeepseekMoe:
    cfg = VitConfig.from_preset('moonlight-16b-a3b-ep8', dtype='bfloat16')
    assert (cfg.hidden_size, cfg.moe_intermediate_size, cfg.moe_num_experts, cfg.moe_top_k,
            cfg.moe_held) == (D, F_INNER, E, K, (0, HELD))
    torch.manual_seed(0)
    with torch.device(dev):
        layer = DeepseekMoe(cfg, torch.bfloat16)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.02)
    return layer.train()


def _counts():
    counts = _build.launch_counts()
    return [(counts[f'moe_{op}'], counts[f'moe_{op}_bwd'])
            for op in ('permute', 'swiglu', 'combine')]


def _fwd_bwd(layer, x, w_out):
    out, aux = layer(x)
    grads = torch.autograd.grad((out * w_out).sum() + aux, [x, *layer.parameters()])
    return out.detach(), grads


@pytest.mark.card
def test_layer_launches_and_matches_the_plain_glue(card, monkeypatch):
    """Two calls of the layer at the cell's widths: one launch of each
    entry each way per call; the output and every gradient finite with the
    allocator's free memory poisoned with NaN, and within 1e-4 (relative
    norm) of the layer through the plain versions."""
    layer = _cell_layer(card)
    gen = torch.Generator(device=card).manual_seed(3)
    x = _draw((RECORDS, TOKENS, D), torch.float32, card, gen).requires_grad_(True)
    w_out = _draw((RECORDS, TOKENS, D), torch.float32, card, gen)
    torch.cuda.synchronize()
    poison = torch.full((3 << 28,), float('nan'), device=card)   # 3 GiB, then freed
    del poison
    before = _counts()
    runs = [_fwd_bwd(layer, x, w_out) for _ in range(2)]
    torch.cuda.synchronize()
    after = _counts()
    assert all((a - b, c - d) == (2, 2) for (a, c), (b, d) in zip(after, before))
    (out, grads), (out2, grads2) = runs
    assert torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert torch.isfinite(out).all() and all(torch.isfinite(g).all() for g in grads)

    plain = copy.deepcopy(layer)
    for name in ('permute_forward', 'permute_backward', 'swiglu_forward', 'swiglu_backward',
                 'combine_forward', 'combine_backward'):
        monkeypatch.setattr(moe_glue, name, getattr(moe_glue, f'{name}_reference'))
    want_out, want_grads = _fwd_bwd(plain, x, w_out)
    assert _counts() == after
    names = ['x'] + [k for k, _ in layer.named_parameters()]
    gaps = {'out': float((out - want_out).norm() / want_out.norm())}
    gaps.update({k: float((a - b).norm() / b.norm().clamp_min(1e-30))
                 for k, a, b in zip(names, grads, want_grads)})
    print({k: f'{v:.2e}' for k, v in gaps.items()})
    assert max(gaps.values()) <= 1e-4


def _refused_layouts(dev):
    """Calls of each entry with rows 4 elements short of a multiple of 8
    wide, or (f32) starting 4 bytes past 16."""
    gen = torch.Generator(device=dev).manual_seed(9)
    t, d, f = 97, 36, 20
    order, pos, held, offs, rows = _routing(t, 1.0, dev, gen)

    def draw(shape, dtype=torch.float32, offset=0):
        return _draw(shape, dtype, dev, gen, offset)
    xs, h, da = draw((t, d)), draw((rows, 2 * f)), draw((rows, f))
    y, g = draw((rows, d), torch.bfloat16), draw((rows, d), torch.bfloat16)
    gates, dout = draw((t, K)).abs(), draw((t, d))
    # widths of 8k, the first row 4 bytes off 16
    xs8, dout8, h8 = draw((t, 32), offset=1), draw((t, 32), offset=1), draw((rows, 16), offset=1)
    y8, da8 = draw((rows, 32), torch.bfloat16), draw((rows, 8))
    return {
        'permute_forward width': lambda: moe_glue.permute_forward(xs, order, offs, rows,
                                                                  torch.bfloat16),
        'permute_forward address': lambda: moe_glue.permute_forward(xs8, order, offs, rows,
                                                                    torch.bfloat16),
        'permute_backward width': lambda: moe_glue.permute_backward(g, pos, held),
        'swiglu_forward width': lambda: moe_glue.swiglu_forward(h, offs),
        'swiglu_forward address': lambda: moe_glue.swiglu_forward(h8, offs),
        'swiglu_backward width': lambda: moe_glue.swiglu_backward(h, da, offs),
        'swiglu_backward address': lambda: moe_glue.swiglu_backward(h8, da8, offs),
        'combine_forward width': lambda: moe_glue.combine_forward(y, gates, pos, held, offs),
        'combine_backward width': lambda: moe_glue.combine_backward(y, gates, dout, pos, held,
                                                                    order, offs),
        'combine_backward address': lambda: moe_glue.combine_backward(y8, gates, dout8, pos,
                                                                      held, order, offs),
    }


REFUSED = ['permute_forward width', 'permute_forward address', 'permute_backward width',
           'swiglu_forward width', 'swiglu_forward address', 'swiglu_backward width',
           'swiglu_backward address', 'combine_forward width', 'combine_backward width',
           'combine_backward address']


@pytest.mark.card
@pytest.mark.parametrize('case', REFUSED)
def test_kernels_refuse_rows_they_cannot_vectorise(card, case):
    """The entry raises ValueError, and launches nothing, for a row width
    that is not a multiple of 8 or a row tensor that does not start on 16
    bytes: the kernels move rows in 16-byte vectors only."""
    calls = _refused_layouts(card)
    assert sorted(calls) == sorted(REFUSED)
    before = _counts()
    with pytest.raises(ValueError, match='starting on 16 bytes'):
        calls[case]()
    assert _counts() == before
