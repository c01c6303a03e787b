"""The port's training randomness against the JAX package's.

The counter-hash dropout (``ops/dropout.py``) must give bit-equal masks to
the JAX ``_masked`` for the same seed and salt, forward and backward;
``timeout`` fed the draws the JAX rng made must zero the same spans.  The
Bernoulli dropout (``dropout_impl='flax'``) cannot match flax's bits, so its
distribution is held instead.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.ops import augment as jaugment
from ecg_representation_learning_tpu.ops.dropout import _hash_mul, _masked
from ecg_representation_learning_tpu_torch.configs import VitConfig
from ecg_representation_learning_tpu_torch.models import vit as tvit
from ecg_representation_learning_tpu_torch.ops import _build, augment, dropout

torch.set_num_threads(2)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize('rate', [0.1, 0.5])
@pytest.mark.parametrize('salt', [1, 2, 3, 4, 5])
@pytest.mark.parametrize('seed', [0, 77, 2 ** 30 + 7, 2 ** 31 - 1])
def test_hash_mul_bit_equal_to_jax(seed, salt, rate):
    x = _x(seed % 1000 + salt, (3, 41, 64))
    want = np.asarray(_masked(jnp.asarray(x), jnp.int32(seed), rate, salt))
    got = dropout.hash_mul(torch.from_numpy(x), seed, rate, salt).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs((got != 0).mean() - (1 - rate)) < 0.02


def test_hash_mul_backward_regenerates_the_mask():
    x, g = _x(1, (2, 5, 7)), _x(2, (2, 5, 7))
    _, vjp = jax.vjp(lambda a: _hash_mul(a, jnp.int32(123), 0.3, 3), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tx = torch.from_numpy(x).requires_grad_()
    y = dropout.hash_mul(tx, 123, 0.3, 3)
    assert y.grad_fn.saved_tensors == ()        # no mask kept for the backward
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), want)


@pytest.mark.parametrize('lo,hi', [(0.0, 0.5), (0.1, 0.3)])
@pytest.mark.parametrize('shape', [(4, 12, 704), (12, 640), (2, 3, 12, 256)])
def test_timeout_with_jax_draws_equals_jax(shape, lo, hi):
    x = _x(len(shape), shape)
    key = jax.random.PRNGKey(sum(shape))
    want = np.asarray(jaugment.timeout(key, jnp.asarray(x), lo, hi))
    batch = shape[:-2]
    k_span, k_start = jax.random.split(key)
    span = np.array(jax.random.uniform(k_span, batch, minval=lo, maxval=hi))
    start = np.array(jax.random.uniform(k_start, batch))
    got = augment.timeout(torch.from_numpy(x), lo, hi, span_draw=torch.from_numpy(span),
                          start_draw=torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(got, want)


def test_timeout_default_draws_come_from_the_generator():
    x = torch.from_numpy(_x(0, (64, 12, 500)))
    a = augment.timeout(x, generator=torch.Generator().manual_seed(1))
    b = augment.timeout(x, generator=torch.Generator().manual_seed(1))
    c = augment.timeout(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    zeroed = (a == 0).all(dim=1).float().mean(dim=1)       # span share per sample
    assert 0.15 < zeroed.mean().item() < 0.35              # E = 0.25 for U(0, 0.5)


@pytest.mark.parametrize('rate', [0.1, 0.5])
def test_bernoulli_dropout_distribution(rate):
    """flax ``nn.Dropout``: keep ~ Bernoulli(1 - rate), kept / (1 - rate)."""
    x = torch.ones(256, 512)
    mod = dropout.BernoulliDropout(rate).train()
    rng = dropout.DropoutRng(torch.Generator().manual_seed(0), torch.Generator().manual_seed(5))
    y = mod(x, rng)
    keep = (y != 0).float().mean().item()
    assert abs(keep - (1 - rate)) < 0.01
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / (1 - rate), rtol=1e-6)
    assert torch.equal(mod.eval()(x, rng), x)


def test_dropout_modules_are_identity_in_eval_and_at_rate_zero():
    x = torch.randn(3, 4)
    for mod in (dropout.HashDropout(0.3, salt=2), dropout.BernoulliDropout(0.3)):
        assert mod.eval()(x) is x
    assert dropout.HashDropout(0.0).train()(x) is x
    with pytest.raises(ValueError, match='dropout_impl'):
        dropout.make_dropout('xla', 0.1, 1)


def test_dropout_rng_seeds_are_31_bit_and_reproducible():
    a = dropout.DropoutRng(torch.Generator().manual_seed(3), torch.Generator())
    b = dropout.DropoutRng(torch.Generator().manual_seed(3), torch.Generator())
    seeds = [a.seed() for _ in range(200)]
    assert seeds == [b.seed() for _ in range(200)]
    assert all(0 <= s < 2 ** 31 for s in seeds) and len(set(seeds)) == 200


@pytest.mark.parametrize('impl', ['hash', 'flax'])
def test_model_training_forward_draws_from_its_rng(impl):
    cfg = VitConfig.from_defined('debug', max_signal_length=320, dropout_impl=impl,
                                 flash_min_seq=0)
    m = tvit.EcgVit(cfg).train()
    x = torch.from_numpy(_x(4, (2, 12, 320)))

    def logits(seed):
        rng = dropout.DropoutRng(torch.Generator().manual_seed(seed),
                                 torch.Generator().manual_seed(seed + 1))
        return m(x, rng=rng).logits
    assert torch.equal(logits(1), logits(1)) and not torch.equal(logits(1), logits(2))
    # with every rate at 0 the training forward is the eval forward
    m0 = tvit.EcgVit(dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                                         attention_probs_dropout_prob=0.0))
    m0.load_state_dict(m.state_dict())
    np.testing.assert_allclose(m0.train()(x).logits.detach().numpy(),
                               m0.eval()(x).logits.detach().numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the block's dropout sites with their GELU or residual add (``_Site.gelu``,
# ``_Site.add_to``): on the CPU the plain route, which is the chain the
# model ran before; the kernels are held to it on the card
# (tests/test_torch_dropout_card.py)
# ---------------------------------------------------------------------------
def _rng(seed):
    return dropout.DropoutRng(torch.Generator().manual_seed(seed),
                              torch.Generator().manual_seed(seed + 1))


def _launches():
    return _build.launch_counts()


def _chain(monkeypatch):
    """Route every Bernoulli site through the chain: dropout's forward
    after the GELU, before the add."""
    monkeypatch.setattr(dropout.BernoulliDropout, 'gelu', dropout._Site.gelu)
    monkeypatch.setattr(dropout.BernoulliDropout, 'add_to', dropout._Site.add_to)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize('site', ['gelu', 'add_to'])
def test_a_site_on_the_cpu_is_the_chain_bit_for_bit(site, dtype):
    mod = dropout.BernoulliDropout(0.3).train()
    before = _launches()
    a = torch.from_numpy(_x(5, (2, 7, 33))).to(dtype).requires_grad_()
    x = torch.from_numpy(_x(6, (2, 7, 33))).requires_grad_()
    if site == 'gelu':
        got, want = (mod.gelu(a, _rng(9)),
                     mod(torch.nn.functional.gelu(a, approximate='none'), _rng(9)))
        inputs = (a,)
    else:
        got, want = mod.add_to(x, a, _rng(9)), x + mod(a, _rng(9))
        inputs = (x, a)
    assert got.dtype == want.dtype and torch.equal(got, want)
    g = torch.from_numpy(_x(7, (2, 7, 33))).to(got.dtype)
    for dg, dw in zip(torch.autograd.grad(got, inputs, g), torch.autograd.grad(want, inputs, g)):
        assert dg.dtype == dw.dtype and torch.equal(dg, dw)
    assert _launches() == before   # no kernel on the CPU


@pytest.mark.parametrize('case', ['eval', 'rate_0', 'hash'])
def test_inactive_and_hashed_sites_take_the_old_path(case, monkeypatch):
    def refuse(*args):
        raise AssertionError('a fused site ran')
    monkeypatch.setattr(dropout, 'gelu_dropout', refuse)
    monkeypatch.setattr(dropout, 'dropout_add', refuse)
    a, x = torch.from_numpy(_x(1, (3, 5, 16))), torch.from_numpy(_x(2, (3, 5, 16)))
    gelu = torch.nn.functional.gelu(a, approximate='none')
    if case == 'hash':
        mod = dropout.HashDropout(0.3, salt=3).train()
        assert torch.equal(mod.gelu(a, _rng(4)), mod(gelu, _rng(4)))
        assert torch.equal(mod.add_to(x, a, _rng(4)), x + mod(a, _rng(4)))
        return
    mod = (dropout.BernoulliDropout(0.3).eval() if case == 'eval'
           else dropout.BernoulliDropout(0.0).train())
    assert torch.equal(mod.gelu(a, _rng(4)), gelu)
    assert torch.equal(mod.add_to(x, a, _rng(4)), x + a)


def _loss_and_grads(m, x, lab, cfg, taped: bool):
    rng = _rng(21)
    params = [p for p in m.parameters() if p.requires_grad]
    seeds = list(range(1000, 1000 + tvit.seeds_per_forward(cfg)))
    with rng.taped(seeds) if taped else contextlib.nullcontext():
        loss = m(x, lab, rng=rng).loss
        return loss.detach(), torch.autograd.grad(loss, params)


@pytest.mark.parametrize('taped', [False, True], ids=['generators', 'step_tape'])
@pytest.mark.parametrize('remat', [False, True], ids=['no_remat', 'remat'])
@pytest.mark.parametrize('size,dtype', [('debug', 'bfloat16'), ('debug', 'float32'),
                                        ('tiny', 'bfloat16')])
def test_a_vit_on_the_cpu_keeps_its_loss_and_gradients(size, dtype, remat, taped,
                                                        monkeypatch):
    """The model's loss and every gradient are the chain's bit for bit, with
    and without remat, drawing from the generators or under a step tape."""
    cfg = VitConfig.from_defined(size, max_signal_length=640, dtype=dtype, remat=remat,
                                 hidden_dropout_prob=0.3)
    torch.manual_seed(3)
    m = tvit.EcgVit(cfg).train()
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.1)
    x = torch.from_numpy(_x(8, (2, 12, 640)))
    lab = (torch.from_numpy(_x(9, (2, cfg.num_class))) > 0.5).float()
    before = _launches()
    got = _loss_and_grads(m, x, lab, cfg, taped)
    _chain(monkeypatch)
    want = _loss_and_grads(m, x, lab, cfg, taped)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert _launches() == before
