"""The port's contrastive family (ops/augment.py, models/contrastive.py)
against the JAX package's.

Each augment stage and ``contrastive_view`` take the JAX draws, replayed
from the same keys in the order of the JAX ``contrastive_view``
(``split(key, 5)`` -> shift, scale, lead, jitter, timeout; the timeout key
split again into span and start); ``nt_xent`` and ``EcgContrastive`` (flax
params carried by ``models.port.state_dict_from_flax``) on the same numpy
inputs, at the debug width, the JAX side with ``use_flash_attention=False``.

Tolerances: augment stages and views 1e-6 (the jitter's std is a
reduction in another order); ``nt_xent`` and its accuracy 1e-6; the
projections to rtol 1e-5 with an atol of 1e-5 of their largest magnitude
(unit vectors: an element near zero carries the absolute rounding of the
trunk's sums); the gradients of NT-Xent to rtol 1e-4 with an atol of 2e-4
of each parameter's largest gradient, the JAX CPU gradients' own distance
from an f64 evaluation (tests/test_torch_mae.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import ContrastiveConfig as JaxContrastiveConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models import contrastive as jcon
from ecg_representation_learning_tpu.ops import augment as jaug
from ecg_representation_learning_tpu_torch.configs import ContrastiveConfig, VitConfig
from ecg_representation_learning_tpu_torch.models import contrastive as con
from ecg_representation_learning_tpu_torch.models.port import state_dict_from_flax
from ecg_representation_learning_tpu_torch.ops import augment

torch.set_num_threads(2)
VIEW_TOL = 1e-6


def jax_view_draws(key, shape, cc) -> dict:
    """The draws of the JAX ``contrastive_view(key, x, **knobs)`` for an x of
    ``shape``, under the port's argument names (``cc``: the view knobs of a
    ``ContrastiveConfig``)."""
    k_shift, k_scale, k_lead, k_jit, k_to = jax.random.split(key, 5)
    batch, length = shape[:-2], shape[-1]
    d = {}
    if cc.shift_frac > 0:
        d['shift'] = jax.random.randint(k_shift, batch, 0,
                                        max(int(round(cc.shift_frac * length)), 1))
    if cc.scale_lo != 1.0 or cc.scale_hi != 1.0:
        d['gain'] = jax.random.uniform(k_scale, batch, minval=cc.scale_lo, maxval=cc.scale_hi)
    if cc.lead_dropout > 0:
        d['keep_draw'] = jax.random.uniform(k_lead, shape[:-1])
    if cc.jitter_sigma > 0:
        d['noise'] = jax.random.normal(k_jit, shape, jnp.float32)
    if cc.timeout_hi > 0:
        k_frac, k_start = jax.random.split(k_to)
        d['span_draw'] = jax.random.uniform(k_frac, batch, minval=0.0, maxval=cc.timeout_hi)
        d['start_draw'] = jax.random.uniform(k_start, batch)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _view_knobs(cc) -> dict:
    return dict(scale_lo=cc.scale_lo, scale_hi=cc.scale_hi, jitter_sigma=cc.jitter_sigma,
                lead_dropout=cc.lead_dropout, shift_frac=cc.shift_frac,
                timeout_hi=cc.timeout_hi)


def _x(seed, shape=(4, 12, 250)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=VIEW_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_time_shift_matches_jax():
    x, key = _x(0), jax.random.PRNGKey(1)
    want = jaug.time_shift(key, jnp.asarray(x), max_frac=0.3)
    shift = torch.from_numpy(np.array(jax.random.randint(key, (4,), 0, 75)))
    _close(augment.time_shift(torch.from_numpy(x), 0.3, shift=shift), want, 0)


def test_amplitude_scale_matches_jax():
    x, key = _x(1), jax.random.PRNGKey(2)
    want = jaug.amplitude_scale(key, jnp.asarray(x), lo=0.5, hi=2.0)
    gain = torch.from_numpy(np.array(jax.random.uniform(key, (4,), minval=0.5, maxval=2.0)))
    _close(augment.amplitude_scale(torch.from_numpy(x), 0.5, 2.0, gain=gain), want)


@pytest.mark.parametrize('rate', [0.2, 0.5, 0.999999])
def test_channel_dropout_matches_jax(rate):
    x, key = _x(2), jax.random.PRNGKey(3)
    want = jaug.channel_dropout(key, jnp.asarray(x), rate=rate)
    draw = torch.from_numpy(np.array(jax.random.uniform(key, (4, 12))))
    _close(augment.channel_dropout(torch.from_numpy(x), rate, keep_draw=draw), want, 0)


def test_gaussian_jitter_matches_jax():
    x, key = 3 * _x(3) + 1, jax.random.PRNGKey(4)
    want = jaug.gaussian_jitter(key, jnp.asarray(x), sigma=0.1)
    noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float32)))
    _close(augment.gaussian_jitter(torch.from_numpy(x), 0.1, noise=noise), want)


def test_timeout_matches_jax():
    x, key = _x(4), jax.random.PRNGKey(5)
    want = jaug.timeout(key, jnp.asarray(x), 0.0, 0.25)
    k_frac, k_start = jax.random.split(key)
    span = torch.from_numpy(np.array(jax.random.uniform(k_frac, (4,), minval=0.0, maxval=0.25)))
    start = torch.from_numpy(np.array(jax.random.uniform(k_start, (4,))))
    _close(augment.timeout(torch.from_numpy(x), 0.0, 0.25, span_draw=span, start_draw=start),
           want, 0)


@pytest.mark.parametrize('knobs', [
    {}, dict(jitter_sigma=0.02, lead_dropout=0.1, timeout_hi=0.1),
    dict(shift_frac=0.0, scale_lo=1.0, scale_hi=1.0), dict(lead_dropout=0.0, timeout_hi=0.0),
    dict(jitter_sigma=0.0, shift_frac=1.0)])
@pytest.mark.parametrize('seed', [0, 7])
def test_contrastive_view_matches_jax(knobs, seed):
    cc = ContrastiveConfig(**knobs)
    x, key = 2 * _x(10 + seed, (5, 12, 256)), jax.random.PRNGKey(seed)
    want = jaug.contrastive_view(key, jnp.asarray(x), **_view_knobs(cc))
    got = augment.contrastive_view(torch.from_numpy(x), **_view_knobs(cc),
                                   draws=jax_view_draws(key, x.shape, cc))
    _close(got, want)


def test_augment_semantics_with_the_ports_own_draws():
    """The JAX test_augment_ops_shapes_and_semantics, on the port's draws."""
    x = torch.from_numpy(_x(5, (4, 12, 250)))
    g = torch.Generator().manual_seed(3)
    gains = augment.amplitude_scale(x, 0.5, 2.0, g) / x
    assert torch.allclose(gains, gains[:, :1, :1].expand_as(gains), rtol=1e-5)
    assert ((gains[:, 0, 0] >= 0.5 - 1e-6) & (gains[:, 0, 0] <= 2.0 + 1e-6)).all()
    y = augment.gaussian_jitter(x, 0.1, g)
    assert y.shape == x.shape and not torch.allclose(y, x)
    y = augment.channel_dropout(x, 0.5, g)
    zeroed, kept = (y == 0).all(-1), torch.isclose(y, x).all(-1)
    assert (zeroed | kept).all() and (~zeroed).any(1).all()
    assert (augment.channel_dropout(x, 0.999999, g) != 0).all(-1).all()
    y = augment.time_shift(x, 0.5, g)
    for b in range(4):
        assert torch.equal(torch.sort(y[b, 0]).values, torch.sort(x[b, 0]).values)
        shift = next(s for s in range(125) if torch.equal(torch.roll(x[b, 0], -s), y[b, 0]))
        assert torch.equal(torch.roll(x[b, 5], -shift), y[b, 5])
    v1 = augment.contrastive_view(x, generator=torch.Generator().manual_seed(4))
    v2 = augment.contrastive_view(x, generator=torch.Generator().manual_seed(4))
    v3 = augment.contrastive_view(x, generator=torch.Generator().manual_seed(5))
    assert torch.isfinite(v1).all() and torch.equal(v1, v2) and not torch.allclose(v1, v3)


def _unit(rng, n, d):
    z = rng.standard_normal((n, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


@pytest.mark.parametrize('n,d,temperature', [(8, 16, 0.1), (32, 128, 0.5), (128, 128, 0.1)])
def test_nt_xent_and_accuracy_match_jax(n, d, temperature):
    z = _unit(np.random.default_rng(n), n, d)
    half = n // 2
    z[half:half + 2] = z[:2] + 0.05 * z[2:4]              # a few easy positives
    z[half:half + 2] /= np.linalg.norm(z[half:half + 2], axis=-1, keepdims=True)
    loss_j, acc_j = jcon.nt_xent(jnp.asarray(z), temperature, with_accuracy=True)
    loss_t, acc_t = con.nt_xent(torch.from_numpy(z), temperature, with_accuracy=True)
    _close(loss_t, loss_j)
    _close(acc_t, acc_j)
    assert 0 < float(acc_t) < 1
    _close(con.nt_xent(torch.from_numpy(z), temperature), loss_j)


def test_nt_xent_accuracy_takes_the_first_of_tied_maxima():
    z = np.zeros((4, 2), np.float32)
    z[:, 0] = 1.0                                          # every similarity ties
    _, acc_j = jcon.nt_xent(jnp.asarray(z), 0.1, with_accuracy=True)
    _, acc_t = con.nt_xent(torch.from_numpy(z), 0.1, with_accuracy=True)
    assert float(acc_t) == float(acc_j)


JCFG = JaxVitConfig.from_defined('debug', max_signal_length=256, use_flash_attention=False,
                                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CFG = VitConfig(**dataclasses.asdict(JCFG))
JCC = JaxContrastiveConfig(proj_hidden_size=64, proj_dim=16)
CC = ContrastiveConfig(**dataclasses.asdict(JCC))


@pytest.fixture(scope='module')
def models():
    model_j = jcon.EcgContrastive(JCFG, JCC)
    params = model_j.init(jax.random.PRNGKey(0), jnp.zeros((2, 12, 256)))
    params = jax.tree.map(np.asarray, params)
    model_t = con.EcgContrastive(CFG, CC)
    model_t.load_state_dict(state_dict_from_flax(params, model_t))
    assert {'encoder.blocks.0.attn.qkv.weight', 'proj_fc1.weight', 'proj_fc2.bias'} <= \
        set(model_t.state_dict())
    return model_j, params, model_t


@pytest.mark.parametrize('pool', ['cls', 'mean'])
def test_projections_match_jax(models, pool):
    _, params, model_t = models
    model_j = jcon.EcgContrastive(dataclasses.replace(JCFG, pool=pool), JCC)
    pooled = con.EcgContrastive(dataclasses.replace(CFG, pool=pool), CC).eval()
    pooled.load_state_dict(model_t.state_dict())
    x = _x(20, (6, 12, 256))
    want = np.asarray(model_j.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pooled(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)


def test_nt_xent_gradients_match_jax(models):
    model_j, params, model_t = models
    x = _x(21, (8, 12, 256))
    grads_j = jax.grad(lambda p: jcon.nt_xent(model_j.apply(p, jnp.asarray(x)), 0.1))(params)
    want = state_dict_from_flax(jax.tree.map(np.asarray, grads_j), model_t)
    model_t.zero_grad()
    con.nt_xent(model_t.train()(torch.from_numpy(x)), 0.1).backward()
    for name, p in model_t.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=2e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_weights_round_trip_flax_port_flax_bit_exact(models):
    from ecg_representation_learning_tpu_torch.models.port import flax_params_from_state_dict
    _, params, model_t = models
    back = flax_params_from_state_dict(model_t.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
