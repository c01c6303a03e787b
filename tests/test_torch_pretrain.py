"""The port's pretraining slice (train/optim.py's optax chain,
train/pretrain.py, train/contrastive.py, cli pretrain and the handoff)
against the JAX package's.

Against JAX, on the same numpy inputs:
  * ``AdamChain`` (``make_optimizer(fused_optimizer=False)``) and the probe
    optimizer against the optax chains over 5 steps, rtol 1e-6 (both take
    optax's f32 operations in optax's order; the global norms that scale the
    clipped gradients are sums in another order, one ulp apart), with an
    atol of 1e-6 of the learning rate (a parameter near zero carries the
    rounding of its update) -- lr * 2^-7 with a bf16 first moment (one bf16
    ulp of mu moves a step by under lr * 2^-7, as tests/test_torch_optim.py
    holds it); the moments
    with an atol of 1e-6 of the largest moment (an EMA of gradients of both
    signs cancels near zero, measured 3.4e-8 of the largest); a bf16 first
    moment to one bf16 ulp;
  * ``transfer_encoder`` and ``transfer_contrastive_encoder``, bit for bit;
  * the slice: three steps of ``MaeTrainer`` and of ``ContrastiveTrainer``,
    each from the JAX trainer's state before it, fed the JAX step's mask
    noise or view draws (replayed from its state's key), dropout off: loss
    and accuracy to rtol 1e-5, the gradient norm to rtol 1e-4 (the
    gradients' tolerance in tests/test_torch_mae.py: the JAX package's CPU
    gradients sit 1e-4 of their scale from an f64 evaluation; measured 2.1e-5
    on the norm), the updated parameters as ``_check_steps`` says.
Then the behaviours of the JAX tests test_pretrain.py, test_contrastive.py
and test_pretrain_accum_ema.py (all marked slow there) as fast cases on the
port alone: the loss falls, a probe on the pretrained trunk is above chance,
the CLI round trip, evaluation of a split smaller than the batch, the
non-finite sanitizer, exact resume, the grad-accum warning, the EMA
handoff.  The JAX side runs with ``use_flash_attention=False``.
"""
import dataclasses
import json
import logging

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecg_representation_learning_tpu.configs import ContrastiveConfig as JaxContrastiveConfig
from ecg_representation_learning_tpu.configs import MaeConfig as JaxMaeConfig
from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.data import synth_ptbxl
from ecg_representation_learning_tpu.models import contrastive as jcon
from ecg_representation_learning_tpu.models import mae as jmae
from ecg_representation_learning_tpu.models import vit as jvit
from ecg_representation_learning_tpu.train import contrastive as jtcon
from ecg_representation_learning_tpu.train import loop as jloop
from ecg_representation_learning_tpu.train import optim as joptim
from ecg_representation_learning_tpu.train import pretrain as jpre
from ecg_representation_learning_tpu.train.trainer import SplitData as JaxSplitData
from ecg_representation_learning_tpu.train.trainer import TrainState
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.configs import (ContrastiveConfig, MaeConfig,
                                                           TrainConfig, VitConfig)
from ecg_representation_learning_tpu_torch.data import get_ptbxl_splits
from ecg_representation_learning_tpu_torch.models.contrastive import EcgContrastive
from ecg_representation_learning_tpu_torch.models.mae import EcgMae
from ecg_representation_learning_tpu_torch.models.port import (state_dict_from_flax,
                                                               vit_state_dict_from_flax)
from ecg_representation_learning_tpu_torch.train import checkpoint, loop, optim
from ecg_representation_learning_tpu_torch.train import trainer as ttrainer
from ecg_representation_learning_tpu_torch.train.contrastive import (
    ContrastiveTrainer, detect_encoder_kind, load_any_encoder, transfer_contrastive_encoder)
from ecg_representation_learning_tpu_torch.train.metrics import roc_auc
from ecg_representation_learning_tpu_torch.train.pretrain import (
    MaeTrainer, load_pretrained_encoder, make_probe_optimizer, transfer_encoder)
from ecg_representation_learning_tpu_torch.train.trainer import SplitData, Trainer
from test_torch_contrastive import jax_view_draws

torch.set_num_threads(2)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
JCFG = JaxVitConfig.from_defined('debug', max_signal_length=320, use_flash_attention=False,
                                 **NO_DROPOUT)
CFG = VitConfig(**dataclasses.asdict(JCFG))
JMAE = JaxMaeConfig(decoder_hidden_size=64, decoder_num_layers=1, decoder_num_heads=4,
                    decoder_intermediate_size=128)
MAE = MaeConfig(**dataclasses.asdict(JMAE))
JCC = JaxContrastiveConfig(proj_hidden_size=64, proj_dim=16)
CC = ContrastiveConfig(**dataclasses.asdict(JCC))


# ---------------------------------------------------------------------------
# the optax chain and the probe optimizer
# ---------------------------------------------------------------------------
def _tree(rng, scale=1.0):
    return {'params': {
        'encoder': {'dense': {'kernel': (rng.standard_normal((16, 8)) * scale).astype(np.float32),
                              'bias': (rng.standard_normal(8) * scale).astype(np.float32)},
                    'norm': {'scale': (rng.standard_normal(16) * scale).astype(np.float32)}},
        'head': {'kernel': (rng.standard_normal((8, 4)) * scale).astype(np.float32),
                 'bias': (rng.standard_normal(4) * scale).astype(np.float32)}}}


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out['.'.join(k.key for k in path[1:])] = torch.from_numpy(np.array(leaf, np.float32))
    return out


def _moments(state):
    """(mu, nu) of an optax chain(clip, adam...) state, or of that chain
    wrapped once more (the probe's chain(opt, masked))."""
    if not hasattr(state[1][0], 'mu'):
        state = state[0]
    return state[1][0].mu, state[1][0].nu


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _check_moments(ts, js, mu_bf16=False):
    mu, nu = _moments(js)
    for name, want in _flat(jax.tree.map(lambda a: np.asarray(a, np.float32), mu)).items():
        assert ts.mu[name].dtype == (torch.bfloat16 if mu_bf16 else torch.float32)
        _close(ts.mu[name].float(), want, rtol=2 ** -7 if mu_bf16 else 1e-6,
               atol=1e-6 * float(want.abs().max()))
    for name, want in _flat(jax.tree.map(np.asarray, nu)).items():
        _close(ts.nu[name], want, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize('case', ['clip', 'no_clip_adam', 'mu_bf16', 'constant'])
def test_optax_chain_matches_jax_over_five_steps(case):
    rng = np.random.default_rng(['clip', 'no_clip_adam', 'mu_bf16', 'constant'].index(case))
    kw = dict(learning_rate=3e-4, warmup_ratio=0.1, fused_optimizer=False,
              schedule='constant' if case == 'constant' else 'cosine',
              optimizer='Adam' if case == 'no_clip_adam' else 'AdamW',
              adam_mu_dtype='bfloat16' if case == 'mu_bf16' else None)
    gscale = 0.05 if case == 'no_clip_adam' else 10.0       # 10: ||g|| > 1, the clip engages
    jopt, _ = joptim.make_optimizer(JaxTrainConfig(**kw), 50)
    topt, _ = optim.make_optimizer(TrainConfig(**kw), 50)
    assert isinstance(topt, optim.AdamChain)
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    js, tp = jopt.init(jp), _flat(jp)
    ts = topt.init(tp)
    for _ in range(5):
        grads = _tree(rng, gscale)
        updates, js = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, updates)
        ts = topt.apply(_flat(grads), ts, tp)
        for name, want in _flat(jp).items():
            _close(tp[name], want, atol=3e-4 * (2 ** -7 if case == 'mu_bf16' else 1e-6))
    assert ts.count == 5
    _check_moments(ts, js, mu_bf16=case == 'mu_bf16')


def test_nonfinite_step_through_finish_update_matches_jax():
    """The chain's sanitizer lives in finish_update (a select that zeroes the
    gradients; the clip then sees a norm of 0), with the EMA after it."""
    rng = np.random.default_rng(5)
    kw = dict(learning_rate=1e-3, warmup_ratio=0.0, fused_optimizer=False, ema_decay=0.9)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jopt, _ = joptim.make_optimizer(jcfg, 20)
    topt, _ = optim.make_optimizer(tcfg, 20)
    params = jax.tree.map(jnp.asarray, _tree(rng))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=jopt.init(params), rng=jax.random.PRNGKey(0),
                       ema_params=jax.tree.map(jnp.copy, params))
    tp = _flat(params)
    ts, ema = topt.init(tp), {k: v.clone() for k, v in tp.items()}
    j_bad, t_bad = jnp.zeros((), jnp.int32), torch.zeros((), dtype=torch.int32)
    for step in range(5):
        grads = _tree(rng, 3.0)
        if step == 2:
            grads['params']['encoder']['dense']['kernel'][0, 0] = np.nan
        state, j_norm, j_bad = jloop.finish_update(jopt, jcfg, state,
                                                   jax.tree.map(jnp.asarray, grads),
                                                   state.rng, j_bad)
        ts, t_norm, t_bad = loop.finish_update(topt, tcfg, ts, tp, _flat(grads), t_bad, ema)
        assert np.isnan(float(j_norm)) == np.isnan(float(t_norm))
        for name, want in _flat(state.params).items():
            _close(tp[name], want, atol=1e-3 * 1e-6)
            assert torch.isfinite(tp[name]).all()
        for name, want in _flat(state.ema_params).items():
            _close(ema[name], want, atol=1e-3 * 1e-6)
    assert int(j_bad) == int(t_bad) == 1
    _check_moments(ts, state.opt_state)


def test_probe_optimizer_matches_jax_and_freezes_the_trunk():
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=256, use_flash_attention=False)
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    _, params = jvit.create_vit(jcfg, jax.random.PRNGKey(0))
    kw = dict(learning_rate=1e-2, warmup_ratio=0.0)
    jopt, _ = jpre.make_probe_optimizer(JaxTrainConfig(**kw), 10, params)
    tp = vit_state_dict_from_flax(jax.tree.map(np.asarray, params), cfg)
    before = {k: v.clone() for k, v in tp.items()}
    topt, _ = make_probe_optimizer(TrainConfig(**kw), 10, tp)
    assert topt.trainable == {'head.weight', 'head.bias'}
    js, ts = jopt.init(params), topt.init(tp)
    rng = np.random.default_rng(1)
    for _ in range(5):
        grads = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32) * 0.1), params)
        updates, js = jopt.update(grads, js, params)
        params = optax.apply_updates(params, updates)
        ts = topt.apply(vit_state_dict_from_flax(jax.tree.map(np.asarray, grads), cfg), ts, tp)
    want = vit_state_dict_from_flax(jax.tree.map(np.asarray, params), cfg)
    for name in tp:
        _close(tp[name], want[name], atol=1e-2 * 1e-6)
        if 'head' in name:
            assert not torch.equal(tp[name], before[name]), name
        else:
            assert torch.equal(tp[name], before[name]), name     # the same bits
    mu, nu = (vit_state_dict_from_flax(jax.tree.map(np.asarray, m), cfg) for m in _moments(js))
    for got, want in ((ts.mu, mu), (ts.nu, nu)):      # the trunk's moments move too
        for name in want:
            _close(got[name], want[name], atol=1e-6 * float(want[name].abs().max()))


# ---------------------------------------------------------------------------
# encoder transfer
# ---------------------------------------------------------------------------
def _jax_vit(jcfg, seed=2):
    return jax.tree.map(np.asarray, jvit.create_vit(jcfg, jax.random.PRNGKey(seed))[1])


def test_transfer_encoder_is_the_jax_transfer_bit_for_bit():
    x = jnp.zeros((1, 12, 320))
    mae_params = jax.tree.map(np.asarray, jmae.EcgMae(JCFG, JMAE).init(
        {'params': jax.random.PRNGKey(0), 'mask': jax.random.PRNGKey(1)}, x))
    vit_params = _jax_vit(JCFG)
    want = vit_state_dict_from_flax(jax.tree.map(np.asarray, jpre.transfer_encoder(
        mae_params, vit_params)), CFG)
    mae_sd = state_dict_from_flax(mae_params, EcgMae(CFG, MAE))
    vit_sd = vit_state_dict_from_flax(vit_params, CFG)
    got = transfer_encoder(mae_sd, vit_sd)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got['encoder.pos_embed'][:, 1:], mae_sd['encoder_pos_embed'])
    assert torch.equal(got['encoder.pos_embed'][:, :1], vit_sd['encoder.pos_embed'][:, :1])
    assert torch.equal(got['head.weight'], vit_sd['head.weight'])


def test_transfer_contrastive_encoder_is_the_jax_transfer_bit_for_bit():
    jcfg = dataclasses.replace(JCFG, max_signal_length=256)
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    con_params = jax.tree.map(np.asarray, jcon.EcgContrastive(jcfg, JCC).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 12, 256))))
    vit_params = _jax_vit(jcfg)
    want = vit_state_dict_from_flax(jax.tree.map(np.asarray, jtcon.transfer_contrastive_encoder(
        con_params, vit_params)), cfg)
    got = transfer_contrastive_encoder(
        state_dict_from_flax(con_params, EcgContrastive(cfg, CC)),
        vit_state_dict_from_flax(vit_params, cfg))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    big = ttrainer.EcgVit(VitConfig.from_defined('tiny', max_signal_length=256)).state_dict()
    with pytest.raises(ValueError, match='wrong model size'):
        transfer_contrastive_encoder(got, big)


# ---------------------------------------------------------------------------
# the slice: trainer steps against the JAX trainers
# ---------------------------------------------------------------------------
STEP_KW = dict(num_train_epoch=1, train_batch_size=16, eval_batch_size=16,
               learning_rate=1e-3, log_to_console=False, save_final=False)


@pytest.fixture(scope='module')
def corpus():
    signals, labels, folds = synth_ptbxl(n=96, length=256)
    return signals, labels, folds


def _flax_rng(key, stream: str):
    """The key ``self.make_rng(stream)`` gives a top-level flax module whose
    ``apply`` got ``rngs={stream: key}`` (the JAX MAE draws its mask so)."""
    class Draw(nn.Module):
        @nn.compact
        def __call__(self):
            return self.make_rng(stream)
    return Draw().apply({}, rngs={stream: key})


def _jax_steps(jtr, data, n_steps, replay):
    """Run ``n_steps`` JAX steps; ``replay(key)`` turns each step's sub-key
    into the draws the port is fed.  Returns, per step, (params and
    optimizer state before it, its metrics, the draws, params after it)."""
    jtr.init_state()
    jtr._build_step()
    nonfinite, out = jnp.zeros((), jnp.int32), []
    for k in range(n_steps):
        before = jax.tree.map(np.asarray, (jtr.state.params, jtr.state.opt_state))
        draws = replay(jax.random.split(jtr.state.rng, 3)[1])
        sigs, idx = jtr._sig_inputs(data, np.arange(16 * k, 16 * (k + 1)))
        with jtr.mesh:
            jtr.state, metrics, nonfinite = jtr._train_step(jtr.state, sigs, idx, nonfinite)
        out.append((before, {k: float(v) for k, v in metrics.items()}, draws,
                    jax.tree.map(np.asarray, jtr.state.params)))
    return out


def _check_steps(tr, data, steps, feed):
    """Each port step from the JAX state before it (params and moments
    carried over): its loss and accuracy to rtol 1e-5, its gradient norm to
    rtol 1e-4, and the updated parameters to
    JAX's within 2.2 lr -- under Adam, a gradient element at rounding level
    whose sign differs between the two moves its weight by up to 2 lr --
    with 99 % of them within 1e-6."""
    tr.init_state()
    for k, ((params, opt), want, draws, after) in enumerate(steps):
        sd = state_dict_from_flax(params, tr.model)
        with torch.no_grad():
            for name, p in tr.params().items():
                p.copy_(sd[name])
        tr.opt_state = optim.FusedAdamWState(count=int(opt.count),
                                             mu=state_dict_from_flax(opt.mu, tr.model),
                                             nu=state_dict_from_flax(opt.nu, tr.model))
        tr.step = k
        with feed(draws):
            got = tr.train_step(data, np.arange(16 * k, 16 * (k + 1)))
        for key, rtol in (('loss', 1e-5), ('contrast_acc', 1e-5), ('grad_norm', 1e-4)):
            if key in want:
                _close(float(got[key]), want[key], rtol=rtol)
        lr = want['learning_rate']
        _close(got['learning_rate'], lr, rtol=1e-6, atol=1e-9)
        want_after = state_dict_from_flax(after, tr.model)
        diffs = []
        for name, p in tr.params().items():
            _close(p.detach(), want_after[name], rtol=1e-5, atol=2.2 * lr + 1e-7)
            diffs.append((p.detach() - want_after[name]).abs().flatten())
        assert torch.quantile(torch.cat(diffs), 0.99) <= 1e-6


class _Patch:
    def __init__(self, obj, name, value):
        self.obj, self.name, self.value = obj, name, value

    def __enter__(self):
        self.old = self.obj.__dict__.get(self.name)
        setattr(self.obj, self.name, self.value)

    def __exit__(self, *exc):
        if self.old is None:
            delattr(self.obj, self.name)
        else:
            setattr(self.obj, self.name, self.old)


def test_mae_trainer_steps_match_jax(corpus):
    jtr = jpre.MaeTrainer(JCFG, JMAE, JaxTrainConfig(
        **STEP_KW, prng_impl=jax.config.jax_default_prng_impl))
    data = JaxSplitData(corpus[0][:64], np.zeros((64, 1), np.float32))
    n_patch = JCFG.max_signal_length // JCFG.patch_size
    steps = _jax_steps(jtr, data, 3, lambda key: torch.from_numpy(
        np.array(jax.random.uniform(_flax_rng(key, 'mask'), (16, n_patch)))))
    tr = MaeTrainer(CFG, MAE, TrainConfig(**STEP_KW), device='cpu')
    forward = tr.model.forward

    def feed(noise):
        return _Patch(tr.model, 'forward', lambda x, rng=None: forward(x, rng, noise=noise))
    _check_steps(tr, SplitData(data.signals, data.labels), steps, feed)


def test_contrastive_trainer_steps_match_jax(corpus):
    jcfg = dataclasses.replace(JCFG, max_signal_length=256)
    jtr = jtcon.ContrastiveTrainer(jcfg, JCC, JaxTrainConfig(
        **STEP_KW, prng_impl=jax.config.jax_default_prng_impl))
    data = JaxSplitData(corpus[0][:64], np.zeros((64, 1), np.float32))

    def replay(key):
        return [jax_view_draws(k, (16, 12, 256), CC) for k in jax.random.split(key)]
    steps = _jax_steps(jtr, data, 3, replay)
    tr = ContrastiveTrainer(VitConfig(**dataclasses.asdict(jcfg)), CC, TrainConfig(**STEP_KW),
                            device='cpu')

    def feed(draws):
        return _Patch(tr, '_views', lambda sig, gen, prep=None: ContrastiveTrainer._views(
            tr, sig, gen, draws=draws, prep=prep))
    _check_steps(tr, SplitData(data.signals, data.labels), steps, feed)


# ---------------------------------------------------------------------------
# behaviours of the JAX pretrain tests, on the port
# ---------------------------------------------------------------------------
def _splits(n, length, **kw):
    return get_ptbxl_splits(*synth_ptbxl(n=n, length=length, **kw))


def _mae(tmp_path, train=None, eval_data=None, cfg=CFG, **kw):
    base = dict(num_train_epoch=1, train_batch_size=16, eval_batch_size=16,
                log_to_console=False, do_eval=False)
    return MaeTrainer(cfg, MAE, TrainConfig(**{**base, **kw}), train_data=train,
                      eval_data=eval_data, output_dir=str(tmp_path), device='cpu')


def _con_data(n=64, length=256):
    """tests/test_contrastive.py's corpus: one distinct tone per record."""
    rng = np.random.default_rng(77)
    t = np.arange(length) / 250.0
    freq = np.linspace(2.0, 60.0, n)
    sig = np.sin(2 * np.pi * freq[:, None] * t + rng.uniform(0, 2 * np.pi, size=n)[:, None])
    sig = (sig[:, None, :] * rng.uniform(0.5, 1.5, size=(n, 12, 1))
           + 0.05 * rng.standard_normal((n, 12, length)))
    return SplitData(signals=sig.astype(np.float32), labels=np.zeros((n, 1), np.float32))


def _con(tmp_path, data=None, cc=CC, **kw):
    base = dict(num_train_epoch=2, train_batch_size=16, eval_batch_size=16,
                do_eval=False, save_final=False, log_per_epoch=True, log_to_console=False)
    return ContrastiveTrainer(VitConfig.from_defined('debug', max_signal_length=256), cc,
                              TrainConfig(**{**base, **kw}), train_data=data, eval_data=data,
                              output_dir=str(tmp_path), device='cpu')


def test_mae_pretraining_reduces_loss(tmp_path):
    splits = _splits(128, 256)
    tr = _mae(tmp_path, splits.train, num_train_epoch=3, train_batch_size=32,
              learning_rate=2e-3)
    tr.init_state()
    x = tr._model_input(torch.from_numpy(splits.train.signals[:32]))
    noise = torch.rand((32, 5), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        loss0 = float(tr.model(x, noise=noise).loss)
    res = tr.train()
    assert np.isfinite(res['loss']) and res['loss'] < loss0


def test_contrastive_loss_falls_and_beats_chance(tmp_path):
    data = _con_data()
    cc = ContrastiveConfig(proj_hidden_size=64, proj_dim=16, jitter_sigma=0.02,
                           lead_dropout=0.1, timeout_hi=0.1)
    tr = _con(tmp_path, data, cc, num_train_epoch=10, learning_rate=1e-3)
    tr.init_state()
    first = tr.evaluate(data, seed=0)
    res = tr.train()
    last = tr.evaluate(data, seed=0)
    chance = np.log(2 * 16 - 1)
    assert np.isfinite(res['loss'])
    assert last < first - 0.5 and last < chance - 0.3, (first, last, chance)
    sigs, idx = tr._sig_inputs(data, np.arange(16))
    _, acc = tr.eval_batch(sigs.index_select(0, idx), torch.Generator().manual_seed(0))
    assert float(acc) > 0.2, float(acc)


def test_probe_on_the_pretrained_trunk_is_above_chance(tmp_path):
    from ecg_representation_learning_tpu_torch.registry import PTBXL_ID2CODE
    splits = _splits(256, 640)
    cfg = VitConfig.from_defined('debug', max_signal_length=704)
    tr = _mae(tmp_path / 'mp', splits.train, cfg=cfg, num_train_epoch=4, train_batch_size=32,
              learning_rate=1e-3)
    tr.train()
    probe = Trainer(cfg, TrainConfig(learning_rate=3e-2, warmup_ratio=0.0, schedule='constant',
                                     linear_probe=True, train_batch_size=32, num_train_epoch=60,
                                     log_to_console=False), device='cpu')
    probe.init_state(seed=7)
    probe.set_params(transfer_encoder(tr.model.state_dict(), probe.model.state_dict()))
    trunk = {k: v.clone() for k, v in probe.model.state_dict().items() if 'head' not in k}
    host = np.random.default_rng(0)
    for _ in range(60):
        probe.train_step(splits.train, host.choice(len(splits.train), size=32, replace=False))
    assert all(torch.equal(v, probe.model.state_dict()[k]) for k, v in trunk.items())
    probs = probe.predict(splits.test.signals)
    nid = PTBXL_ID2CODE.index('NORM')
    auc = roc_auc(probs[:, nid], splits.test.labels[:, nid])
    assert auc > 0.75, auc


def test_cli_pretrain_flags_are_the_jax_names_and_defaults():
    """The port's pretrain flags are among the JAX CLI's (its common flags
    plus the ones its main() adds for pretrain), with the same defaults."""
    from ecg_representation_learning_tpu import cli as jcli
    p = jcli.argparse.ArgumentParser()
    jcli._add_common_train_flags(p)
    for flag, default in (('--synth-n', 512), ('--stats', None), ('--resume-from', None),
                          ('--hdf5', None), ('--labels-csv', None),
                          ('--objective', 'mae'), ('--mask-ratio', 0.75),
                          ('--temperature', 0.1), ('--stream', None),
                          ('--stream-steps', 1000), ('--stream-weights', None),
                          ('--stream-raw-fqs', None), ('--stream-wire-scale', None),
                          ('--ckpt-every', 0), ('--resume', False), ('--log-every', 50)):
        p.add_argument(flag, default=default)
    want = {a.option_strings[-1]: a.default for a in p._actions if a.option_strings}
    sub = next(a for a in cli.build_parser()._actions if a.dest == 'cmd').choices
    got = {a.option_strings[-1]: a.default for a in sub['pretrain']._actions
           if a.option_strings and a.dest != 'help'}
    assert set(got) <= set(want), set(got) - set(want)
    assert {k: want[k] for k in got} == got


@pytest.mark.parametrize('objective', ['mae', 'contrastive'])
def test_cli_pretrain_then_probe_handoff(objective, monkeypatch, tmp_path, capsys):
    """`cli pretrain` writes a checkpoint; `cli train --init-encoder <ckpt>
    --probe` loads its trunk (the kind detected) and trains the head only."""
    monkeypatch.setattr(ttrainer, 'default_device', lambda device=None: torch.device('cpu'))
    out = str(tmp_path / objective)
    cli.main(['pretrain', '--objective', objective, '--size', 'debug', '--synth-n', '96',
              '--epochs', '1', '--batch-size', '32', '--no-bf16', '--output-dir', out])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {'pretrain_loss', 'best_eval_loss', 'checkpoint'}
    assert np.isfinite(res['pretrain_loss']) and 'ckpt-' in res['checkpoint']
    assert detect_encoder_kind(res['checkpoint']) == objective
    ft = str(tmp_path / 'ft')
    cli.main(['train', '--size', 'debug', '--synth-n', '96', '--epochs', '1',
              '--batch-size', '32', '--no-bf16', '--init-encoder', res['checkpoint'],
              '--probe', '--output-dir', ft])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {'best_eval_loss', 'test_macro_auc', 'epochs'}
    assert np.isfinite(out['best_eval_loss'])
    trained = checkpoint.restore_checkpoint(f'{ft}/ckpt-final')['params']
    cfg = VitConfig.from_defined('debug', dtype='float32')
    fresh = Trainer(cfg, TrainConfig(log_to_console=False), device='cpu')
    fresh.init_state()
    want = load_any_encoder(res['checkpoint'], fresh.model.state_dict())
    for k, v in trained.items():
        if 'head' not in k:
            assert torch.equal(v, want[k]), k
    if objective == 'mae':
        mae_params = load_pretrained_encoder(res['checkpoint'], cfg)
        assert torch.equal(trained['encoder.blocks.0.attn.qkv.weight'],
                           mae_params['encoder_blocks.0.attn.qkv.weight'])


def test_mae_evaluate_split_smaller_than_batch(tmp_path):
    splits = _splits(48, 256)
    assert 0 < len(splits.eval) < 32
    tr = _mae(tmp_path, splits.train, splits.eval, eval_batch_size=32)
    tr.init_state()
    loss = tr.evaluate()
    n = len(splits.eval)            # the batch: n real rows, then row 0 again
    x = tr._model_input(torch.from_numpy(splits.eval.signals[np.r_[0:n, [0] * (32 - n)]]))
    noise = torch.rand((32, 5), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = tr.model(x, noise=noise).per_sample_loss[:n].mean()
    assert np.isfinite(loss) and loss == pytest.approx(float(want), rel=1e-6)
    # contrastive: a split smaller than the batch is one smaller batch
    data = _con_data(10)
    small = _con(tmp_path, data, eval_batch_size=64)
    small.init_state()
    assert np.isfinite(small.evaluate())
    with pytest.raises(ValueError, match='>= 4'):
        small.evaluate(SplitData(data.signals[:3], data.labels[:3]))


def test_mae_nonfinite_grad_sanitizer(tmp_path):
    splits = _splits(64, 256)
    signals = splits.train.signals.copy()
    signals[:, 0, 0] = np.inf
    tr = _mae(tmp_path, SplitData(signals, splits.train.labels), debug_nans=True,
              save_final=False)
    with pytest.raises(FloatingPointError, match='non-finite'):
        tr.train()
    assert all(torch.isfinite(v).all() for v in tr.model.state_dict().values())


@pytest.mark.parametrize('kind', ['mae', 'contrastive'])
def test_exact_resume_from_a_pretrain_checkpoint(kind, tmp_path):
    """Params, moments, count, step, epoch, EMA and the generators round-trip,
    so the next step (mask or views, dropout) is the same as without the
    restart."""
    if kind == 'mae':
        data = _splits(96, 256).train
        dropout_cfg = VitConfig.from_defined('debug', max_signal_length=320)   # dropout 0.1

        def make():
            return _mae(tmp_path, data, cfg=dropout_cfg, ema_decay=0.5)
    else:
        data = _con_data(48)

        def make():
            return _con(tmp_path, data, ema_decay=0.5)
    tr = make()
    tr.train()
    path = tr.save_checkpoint('resume-test')
    tr2 = make()
    tr2.init_state(seed=123)
    tr2.load_checkpoint(path)
    assert (tr2.step, tr2.epoch, tr2.opt_state.count) == (tr.step, tr.epoch, tr.opt_state.count)
    for name, state in (('params', lambda t: t.model.state_dict()), ('ema', lambda t: t.ema),
                        ('mu', lambda t: t.opt_state.mu), ('nu', lambda t: t.opt_state.nu)):
        a, b = state(tr), state(tr2)
        assert all(torch.equal(a[k], b[k]) for k in a), name
    take = np.arange(16)
    m1, m2 = tr.train_step(data, take), tr2.train_step(data, take)
    assert float(m1['loss']) == float(m2['loss'])
    assert all(torch.equal(a, b) for a, b in zip(tr.model.state_dict().values(),
                                                 tr2.model.state_dict().values()))
    assert checkpoint.latest_committed_checkpoint(str(tmp_path)) is not None


def test_early_stopping_periodic_checkpoints_and_resume_by_train(tmp_path):
    """lr 0: the eval loss never improves after the first epoch, so patience
    2 stops at epoch 3; every epoch is saved; train(resume=True) restarts
    from the newest checkpoint."""
    splits = _splits(96, 256)
    tr = _mae(tmp_path, splits.train, splits.eval, num_train_epoch=10, learning_rate=0.0,
              patience=2, do_eval=True, save_every_n_epoch=1, save_final=False)
    res = tr.train()
    assert res['epochs'] == 3 and len(res['eval_history']) == 3 and res['checkpoint'] is None
    assert res['best_eval_loss'] == res['eval_history'][0]
    assert all((tmp_path / f'ckpt-ep{e}').is_dir() for e in (1, 2, 3))
    assert (tmp_path / 'ckpt-best').is_dir()
    again = _mae(tmp_path, splits.train, splits.eval, num_train_epoch=4, do_eval=False)
    res2 = again.train(resume=True)
    assert res2['epochs'] == 4 and again.step == tr.step + tr.steps_per_epoch


def test_grad_accum_warns_of_microbatch_negatives():
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    logger = logging.getLogger('EcgContrastive Pretrain')
    handler = Capture()
    logger.addHandler(handler)
    try:
        ContrastiveTrainer(CFG, CC, TrainConfig(train_batch_size=16, grad_accum=4),
                           device='cpu')
    finally:
        logger.removeHandler(handler)
    assert any('MICROBATCH-local (4 samples, not 16)' in r for r in records), records
    with pytest.raises(ValueError, match='must divide'):
        MaeTrainer(CFG, MAE, TrainConfig(train_batch_size=16, grad_accum=5), device='cpu')


@pytest.mark.parametrize('kind', ['mae', 'contrastive'])
def test_accum_and_ema_train_and_the_handoff_takes_the_ema(kind, tmp_path):
    if kind == 'mae':
        tr = _mae(tmp_path, _splits(96, 256).train, grad_accum=4, ema_decay=0.9)
    else:
        tr = _con(tmp_path, _con_data(48), grad_accum=2, ema_decay=0.9, save_final=True)
    res = tr.train()
    assert np.isfinite(res['loss']) and tr.step == tr.steps_per_epoch * tr.cfg.num_train_epoch
    params = tr.model.state_dict()
    assert any(not torch.equal(params[k], tr.ema[k]) for k in params)
    assert np.isfinite(tr.evaluate(tr.train_data))
    path = tr.save_checkpoint('ema')
    vit = Trainer(tr.model_cfg, TrainConfig(log_to_console=False), device='cpu')
    vit.init_state()
    moved = load_any_encoder(path, vit.model.state_dict())
    src = 'encoder_patch_embed.proj.weight' if kind == 'mae' else 'encoder.patch_embed.proj.weight'
    assert torch.equal(moved['encoder.patch_embed.proj.weight'], tr.ema[src])   # EMA, not raw
