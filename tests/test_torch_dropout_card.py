"""The dropout site kernels (``ops/csrc/dropout_sites.cu``) on the card.

Every test here needs a CUDA device and skips without one; on a machine with
a card run them with ``python -m pytest --noconftest -p no:cacheprovider -m
card tests/test_torch_dropout_card.py`` (this file imports no JAX, and
``--noconftest`` keeps the JAX set-up of ``tests/conftest.py`` out).  Each
kernel is held against its plain version, which is the chain of PyTorch
kernels the model ran before: the output sites (``dropout_add``) bit for
bit both ways, the MLP hidden site (``gelu_dropout``) within one ulp of its
type (erf and exp may round differently in another build of the CUDA math
library).  The shapes are ViT-base's at bs 64 and 41 tokens (2,624 rows of
768 and of 3,072) and a ragged one; an offset of one element makes every
pointer miss 16-byte alignment, so the kernel's one-element path runs.
"""
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.ops import _build, dropout
from ecg_representation_learning_tpu_torch.registry import PTBXL_TRAIN_STATS
from ecg_representation_learning_tpu_torch.train import dispatch

RATE = 0.1
SHAPES = [(2624, 768), (2624, 3072), (37, 771)]
SITE_SHAPES = [(64, 41, 768), (64, 41, 3072)]   # the cell's output and hidden sites
RESIDUAL_TYPES = [(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
                  (torch.bfloat16, torch.bfloat16)]   # (x, y)


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _tensor(shape, dtype, dev, gen, offset, scale=2.0):
    """A normal draw of ``shape`` starting ``offset`` elements into its
    buffer (contiguous either way)."""
    n = int(np.prod(shape))
    buf = torch.randn(n + offset, generator=gen, device=dev) * scale
    return buf.to(dtype)[offset:].view(shape)


def _keep(shape, dev, gen, offset, dtype=torch.bool):
    n = int(np.prod(shape))
    buf = torch.empty(n + offset, dtype=dtype, device=dev).bernoulli_(1 - RATE, generator=gen)
    return buf[offset:].view(shape)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in units in the last place between two tensors
    of one float type (+0 and -0 coincide)."""
    int_type = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    bits = torch.iinfo(int_type).bits

    def ordered(t):
        i = t.contiguous().view(int_type).long()
        return torch.where(i < 0, -(i & ((1 << (bits - 1)) - 1)), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and _ulps(a, b) == 0


@pytest.mark.card
@pytest.mark.parametrize('offset', [0, 1])
@pytest.mark.parametrize('types', RESIDUAL_TYPES, ids=['f32-bf16', 'f32-f32', 'bf16-bf16'])
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_dropout_add_kernel_is_the_chain_bit_for_bit(card, shape, types, offset):
    gen = torch.Generator(device=card).manual_seed(sum(shape) + offset)
    x0 = _tensor(shape, types[0], card, gen, offset)
    y0 = _tensor(shape, types[1], card, gen, offset)
    keep = _keep(shape, card, gen, offset)
    out_type = torch.promote_types(*types)
    g = _tensor(shape, out_type, card, gen, offset)
    results = []
    for fn in (dropout.dropout_add, dropout.dropout_add_reference):
        x, y = x0.clone().requires_grad_(), y0.clone().requires_grad_()
        before = _build.launch_counts()['dropout_add_bwd']
        out = fn(x, y, keep, RATE)
        out.backward(g)
        results.append((out, x.grad, y.grad,
                        _build.launch_counts()['dropout_add_bwd'] - before))
    (out, dx, dy, launched), (want, want_dx, want_dy, _) = results
    assert launched == 1
    assert out.dtype == want.dtype == out_type
    assert _same_bits(out, want) and _same_bits(dx, want_dx) and _same_bits(dy, want_dy)


@pytest.mark.card
@pytest.mark.parametrize('offset', [0, 1])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_gelu_dropout_kernel_is_the_chain_within_an_ulp(card, shape, dtype, offset):
    gen = torch.Generator(device=card).manual_seed(sum(shape) + offset + 1)
    a0 = _tensor(shape, dtype, card, gen, offset, scale=3.0)
    keep = _keep(shape, card, gen, offset)
    g = _tensor(shape, dtype, card, gen, offset)
    results = []
    for fn in (dropout.gelu_dropout, dropout.gelu_dropout_reference):
        a = a0.clone().requires_grad_()
        h = fn(a, keep, RATE)
        h.backward(g)
        results.append((h, a.grad))
    (h, da), (want_h, want_da) = results
    assert h.dtype == want_h.dtype == dtype
    assert _ulps(h, want_h) <= 1 and _ulps(da, want_da) <= 1
    assert torch.equal(h == 0, want_h == 0)   # the mask zeroes the same elements


@pytest.mark.card
def test_a_captured_graph_replays_the_eager_sites(card):
    """Both site kinds each way, captured once, replayed on new inputs
    written into the captured ones: the eager call's bits on those inputs.
    Counted as a step tape's graph is, the capture leaves the launch counts
    as they were and the replay adds the captured launches."""
    gen = torch.Generator(device=card).manual_seed(7)
    shape = SITE_SHAPES[1]

    def inputs():
        return [_tensor(shape, torch.bfloat16, card, gen, 0),
                _tensor(shape, torch.float32, card, gen, 0),
                _keep(shape, card, gen, 0), _keep(shape, card, gen, 0),
                _tensor(shape, torch.bfloat16, card, gen, 0),
                _tensor(shape, torch.float32, card, gen, 0)]

    def sites(a, x, keep_h, keep_o, g_h, g_o):
        h = dropout.gelu_dropout(a, keep_h, RATE)
        out = dropout.dropout_add(x, h, keep_o, RATE)
        dh, = torch.autograd.grad(h, a, g_h, retain_graph=True)
        dx, da = torch.autograd.grad(out, (x, a), g_o)
        return [t.clone() for t in (h, out, dh, dx, da)]

    def leaves(ins):
        return [ins[0].clone().requires_grad_(), ins[1].clone().requires_grad_(), *ins[2:]]

    first, second = inputs(), inputs()
    want = sites(*leaves(second))
    # leaves of their own, first used on the capture's stream
    static = leaves(first)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        sites(*static)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _build.launch_counts()
    with torch.cuda.graph(graph, stream=side):   # counted as a step tape's capture
        outs, captured = dispatch._uncounted(lambda: sites(*static))
    assert _build.launch_counts() == before   # the capture puts its counts back
    # the gelu site's backward runs in both gradients
    assert {k: n for k, n in captured.items() if n} == {
        'gelu_dropout': 1, 'gelu_dropout_bwd': 2, 'dropout_add': 1, 'dropout_add_bwd': 1}
    with torch.no_grad():
        for dst, src in zip(static, second):
            dst.copy_(src)
    dispatch._replayed(graph, captured, 1)
    torch.cuda.synchronize(card)
    # a replay adds the captured launches
    assert _build.launch_counts() == {k: n + captured[k] for k, n in before.items()}
    assert all(torch.equal(o, w) for o, w in zip(outs, want))


@pytest.mark.card
def test_a_vit_base_step_launches_every_block_site_once_each_way(card, monkeypatch):
    from ecg_representation_learning_tpu_torch.train import SplitData, Trainer
    plain = []
    for name in ('gelu_dropout_reference', 'dropout_add_reference'):
        fn = getattr(dropout, name)
        monkeypatch.setattr(dropout, name,
                            lambda *a, _fn=fn, _name=name: (plain.append(_name), _fn(*a))[1])
    chain = dropout.BernoulliDropout.forward
    forwards = []
    monkeypatch.setattr(dropout.BernoulliDropout, 'forward',
                        lambda self, *a: (forwards.append(1), chain(self, *a))[1])
    cfg = VitConfig.from_defined('base', dtype='bfloat16')
    rng = np.random.default_rng(0)
    data = SplitData(signals=(0.2 * rng.standard_normal((64, 12, 2500))).astype(np.float32),
                     labels=(rng.uniform(size=(64, 71)) < 0.1).astype(np.float32))
    tr = Trainer(cfg, TrainConfig(train_batch_size=64, log_to_console=False,
                                  save_final=False), train_data=data,
                 norm_stats=PTBXL_TRAIN_STATS['original'], device=card)
    tr.init_state()
    before = _build.launch_counts()
    loss = float(tr.train_step(data, np.arange(64))['loss'])
    after = _build.launch_counts()
    counts = [(after[k] - before[k], after[f'{k}_bwd'] - before[f'{k}_bwd'])
              for k in ('gelu_dropout', 'dropout_add')]
    layers = cfg.num_hidden_layers
    assert np.isfinite(loss)
    assert counts == [(layers, layers), (2 * layers, 2 * layers)]   # 36 each way
    assert plain == [] and len(forwards) == 1   # the embedding's site alone is unfused


@pytest.mark.card
@pytest.mark.parametrize('shape', SITE_SHAPES, ids=str)
def test_a_bool_draw_keeps_the_f32_bits_and_the_next_draw(card, shape):
    gen = torch.Generator(device=card)
    for seed in (0, 2 ** 31 + 11):
        gen.manual_seed(seed)
        want = torch.empty(shape, device=card).bernoulli_(1 - RATE, generator=gen)
        want_next = torch.empty(shape, device=card).bernoulli_(1 - RATE, generator=gen)
        gen.manual_seed(seed)
        got = torch.empty(shape, dtype=torch.bool, device=card).bernoulli_(1 - RATE,
                                                                           generator=gen)
        got_next = torch.empty(shape, device=card).bernoulli_(1 - RATE, generator=gen)
        assert torch.equal(got, want.bool()) and torch.equal(got_next, want_next)
