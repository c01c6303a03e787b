"""The port's Switch-MoE (models/moe.py and the MoE blocks of the ViT, MAE and
contrastive models, their trainers, int8 and the CLI) against the JAX
package's.

The JAX trees (numpy leaves) are carried into the port with
``state_dict_from_flax`` / ``vit_state_dict_from_flax``; both sides run the
same numpy inputs, made from a seed.  The single-device cases of
tests/test_moe.py come first (its expert-parallel mesh case waits for the
parallelism slice), then the models, the trainer steps, int8, the init and
the CLI.

Tolerances: ``MoeMlp``'s output and aux loss to 1e-6 relative (the output
with an atol of 1e-6 of its largest magnitude: an element near zero carries
the rounding of the sums it came from), with the dropped-token mask equal;
the models' logits, losses and gradients of task + aux to 1e-5 (gradients
with an atol of 1e-5 of the parameter's largest gradient; measured 2.8e-6 on
the debug ViT); the trainer steps at ``_check_steps``' tolerances
(tests/test_torch_pretrain.py); int8 tensors and scales equal, int8 predict
to 1e-5 (tests/test_torch_quantize.py's bar).
"""
import contextlib
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu import registry as jregistry
from ecg_representation_learning_tpu.configs import ContrastiveConfig as JaxContrastiveConfig
from ecg_representation_learning_tpu.configs import MaeConfig as JaxMaeConfig
from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models import contrastive as jcon
from ecg_representation_learning_tpu.models import mae as jmae
from ecg_representation_learning_tpu.models import moe as jmoe
from ecg_representation_learning_tpu.models import quantize as jquant
from ecg_representation_learning_tpu.models import vit as jvit
from ecg_representation_learning_tpu.train import contrastive as jtcon
from ecg_representation_learning_tpu.train import pretrain as jpre
from ecg_representation_learning_tpu.train import trainer as jtrainer
from ecg_representation_learning_tpu.train.trainer import SplitData as JaxSplitData
from ecg_representation_learning_tpu_torch import cli, registry
from ecg_representation_learning_tpu_torch.configs import (ContrastiveConfig, MaeConfig,
                                                           TrainConfig, VitConfig)
from ecg_representation_learning_tpu_torch.models import moe, quantize
from ecg_representation_learning_tpu_torch.models.contrastive import EcgContrastive
from ecg_representation_learning_tpu_torch.models.mae import EcgMae
from ecg_representation_learning_tpu_torch.models.port import (flax_params_from_state_dict,
                                                               flax_path, state_dict_from_flax,
                                                               vit_state_dict_from_flax)
from ecg_representation_learning_tpu_torch.models.vit import EcgVit
from ecg_representation_learning_tpu_torch.train import trainer as ttrainer
from ecg_representation_learning_tpu_torch.train.contrastive import (ContrastiveTrainer,
                                                                     load_any_encoder)
from ecg_representation_learning_tpu_torch.train.pretrain import MaeTrainer
from ecg_representation_learning_tpu_torch.train.trainer import SplitData, Trainer
from test_torch_contrastive import jax_view_draws
from test_torch_pretrain import (STEP_KW, _check_steps, _close, _flax_rng, _jax_steps,
                                 _Patch)
from test_torch_stream import (BS, RAW_LEN, STATS, _check_stream_steps, _jax_stream_steps,
                               _wire)

torch.set_num_threads(2)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
MOE = dict(moe_num_experts=4, moe_every=2)
# the debug ladder with E = 4 experts on every second block
JCFG = JaxVitConfig.from_defined('debug', max_signal_length=320, use_flash_attention=False,
                                 **MOE, **NO_DROPOUT)
CFG = VitConfig(**dataclasses.asdict(JCFG))
JMAE = JaxMaeConfig(decoder_hidden_size=64, decoder_num_layers=1, decoder_num_heads=4,
                    decoder_intermediate_size=128)
MAE = MaeConfig(**dataclasses.asdict(JMAE))
JCC = JaxContrastiveConfig(proj_hidden_size=64, proj_dim=16)
CC = ContrastiveConfig(**dataclasses.asdict(JCC))


def tiny_cfg(**kw):
    """tests/test_moe.py's MoeMlp config (both packages' VitConfig)."""
    base = dict(num_channels=3, max_signal_length=320, patch_size=32, hidden_size=32,
                num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                use_flash_attention=False, **MOE)
    base.update(kw)
    return JaxVitConfig(**base), VitConfig(**base)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mlp_pair(jcfg, cfg, x, seed, edit=None):
    """(JAX output, JAX aux, JAX params, port MoeMlp) on one JAX init;
    ``edit(params)`` may change the JAX params before both sides run."""
    mod = jmoe.MoeMlp(jcfg)
    params = jax.tree.map(np.asarray, mod.init({'params': jax.random.PRNGKey(seed)},
                                               jnp.asarray(x), deterministic=True)['params'])
    if edit is not None:
        params = edit(params)
    y, mut = mod.apply({'params': params}, jnp.asarray(x), deterministic=True,
                       mutable=['moe'])
    tm = moe.MoeMlp(cfg, torch.float32)
    tm.load_state_dict(state_dict_from_flax({'params': params}, tm))
    return np.asarray(y), float(mut['moe']['aux_loss']), params, tm


def _jax_dropped(params, x, experts, cf):
    """tests/test_moe.py's routing recomputation: which tokens overflow."""
    xs = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xs @ params['router']['kernel']).astype(jnp.float32), -1)
    onehot = jax.nn.one_hot(probs.argmax(-1), experts)
    pos = ((jnp.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    return np.asarray(pos >= moe.capacity(cf, xs.shape[0], experts))


def _check_mlp(y_want, aux_want, params, tm, x, cf, experts):
    """The port's MoeMlp against JAX: output and aux to 1e-6 relative, the
    dropped-token mask equal.  Returns (port output, dropped mask)."""
    with torch.no_grad():
        y, aux = tm(torch.from_numpy(x))
        _, _, _, slot, _ = tm.route(torch.from_numpy(x).reshape(-1, x.shape[-1]))
    y = y.numpy()
    np.testing.assert_allclose(y, y_want, rtol=1e-6, atol=1e-6 * np.abs(y_want).max())
    _close(float(aux), aux_want, rtol=1e-6)
    dropped = (slot < 0).numpy()
    np.testing.assert_array_equal(dropped, _jax_dropped(params, x, experts, cf))
    return y, dropped


# ---------------------------------------------------------------------------
# the single-device cases of tests/test_moe.py
# ---------------------------------------------------------------------------
def test_moe_mlp_matches_dense_routing_math():
    # ample capacity (no drops): gate * FFN_{argmax expert}(x) per token, and JAX
    jcfg, cfg = tiny_cfg(moe_capacity_factor=4.0, hidden_dropout_prob=0.0)
    x = _x(1, (2, 10, 32))
    y_want, aux_want, p, tm = _mlp_pair(jcfg, cfg, x, 1)
    y, dropped = _check_mlp(y_want, aux_want, p, tm, x, 4.0, 4)
    assert not dropped.any()
    xs = x.reshape(-1, 32).astype(np.float64)
    logits = xs @ p['router']['kernel']
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ref = []
    for i, e in enumerate(probs.argmax(-1)):
        h = xs[i] @ p['w1'][e] + p['b1'][e]
        h = 0.5 * h * (1 + np.vectorize(math.erf)(h / np.sqrt(2)))
        ref.append(probs[i].max() * (h @ p['w2'][e] + p['b2'][e]))
    np.testing.assert_allclose(y, np.stack(ref).reshape(x.shape), rtol=2e-4, atol=2e-5)


def test_moe_capacity_overflow_drops_to_zero():
    # cap = ceil(cf * S / E); tokens past an expert's buffer contribute 0
    jcfg, cfg = tiny_cfg(moe_num_experts=2, moe_capacity_factor=0.25, hidden_dropout_prob=0.0)
    x = _x(2, (1, 16, 32))
    y_want, aux_want, p, tm = _mlp_pair(jcfg, cfg, x, 2)
    y, dropped = _check_mlp(y_want, aux_want, p, tm, x, 0.25, 2)
    assert dropped.any(), 'the setup should overflow the capacity buffer'
    assert np.count_nonzero(~dropped) == 2 * moe.capacity(0.25, 16, 2)
    assert (y[0][dropped] == 0).all()
    assert (np.linalg.norm(y[0][~dropped], axis=-1) > 1e-4).all()


def test_moe_capacity_ceil_not_truncated():
    # exact: cf 1.1 * 100 / 10 is 11 (a float product gives 11.000000000000002
    # and would ceil to 12); ceil(0.45 * 10 / 2) = 3, not ceil(int(4.5) / 2) = 2
    assert moe.capacity(1.1, 100, 10) == 11
    assert moe.capacity(0.45, 10, 2) == 3 and moe.capacity(1.25, 64 * 41, 4) == 820
    # a zeroed router ties every token to expert 0 (argmax takes the lowest
    # index): token 2 kept (slot 2 < 3), token 3 dropped
    jcfg, cfg = tiny_cfg(moe_num_experts=2, moe_capacity_factor=0.45, hidden_dropout_prob=0.0)
    x = _x(3, (1, 10, 32))
    y_want, aux_want, p, tm = _mlp_pair(
        jcfg, cfg, x, 3, edit=lambda p: {**p, 'router': {'kernel': np.zeros_like(
            p['router']['kernel'])}})
    y, dropped = _check_mlp(y_want, aux_want, p, tm, x, 0.45, 2)
    assert dropped.tolist() == [False] * 3 + [True] * 7
    assert np.linalg.norm(y[0, 2]) > 1e-4 and (y[0, 3] == 0).all()


def test_moe_vit_grad_and_aux_loss():
    """The MoE ViT against ``jax.grad`` of task + aux: logits, loss, aux and
    every gradient; the router gets gradient; eval mode runs."""
    model, params = jvit.create_vit(JCFG, jax.random.PRNGKey(0))
    assert set(params) == {'params', 'moe'}            # init sows the aux collection
    params = jax.tree.map(np.asarray, {'params': params['params']})
    assert 'moe' in params['params']['encoder']['block_1']
    assert 'mlp' in params['params']['encoder']['block_0']
    tm = EcgVit(CFG).train()
    tm.load_state_dict(vit_state_dict_from_flax(params, CFG))
    x = _x(4, (4, 12, 320))
    lab = (np.random.default_rng(5).uniform(size=(4, CFG.num_class)) < 0.2).astype(np.float32)

    def objective(p):
        out, aux = jmoe.apply_with_moe(model, p, jnp.asarray(x), labels=jnp.asarray(lab),
                                       deterministic=False, moe=True)
        return out.loss + JCFG.moe_aux_weight * aux, (out.logits, out.loss, aux)
    grads, (logits, loss_want, aux_want) = jax.grad(objective, has_aux=True)(params)
    out = tm(torch.from_numpy(x), labels=torch.from_numpy(lab))
    assert 0.9 < out.aux_loss.item() < CFG.moe_num_experts
    (out.loss + CFG.moe_aux_weight * out.aux_loss).backward()
    logits = np.asarray(logits)
    np.testing.assert_allclose(out.logits.detach().numpy(), logits, rtol=1e-5,
                               atol=1e-5 * np.abs(logits).max())
    _close(out.loss.item(), float(loss_want), rtol=1e-5)
    _close(out.aux_loss.item(), float(aux_want), rtol=1e-5)
    want_g = vit_state_dict_from_flax(jax.tree.map(np.asarray, grads), CFG)
    for name, p in tm.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    assert tm.encoder.blocks[1].moe.router.weight.grad.abs().max() > 0
    with torch.no_grad():
        ev = tm.eval()(torch.from_numpy(x), labels=torch.from_numpy(lab))
    assert np.isfinite(float(ev.loss))


def test_apply_with_moe_dense_passthrough():
    # a dense model's aux is 0 and its objective the task loss itself
    cfg = dataclasses.replace(CFG, moe_num_experts=0)
    tr = Trainer(cfg, TrainConfig(log_to_console=False), device='cpu')
    tr.init_state()
    x = torch.from_numpy(_x(6, (2, 12, 320)))
    with torch.no_grad():
        out = tr.model(x, labels=torch.zeros(2, cfg.num_class))
    assert float(out.aux_loss) == 0.0
    assert tr._objective(out.loss, out.aux_loss) is out.loss


def _mae_models(cfg_j, cfg_t):
    model_j = jmae.EcgMae(cfg_j, JMAE)
    v = model_j.init({'params': jax.random.PRNGKey(0), 'mask': jax.random.PRNGKey(1)},
                     jnp.zeros((2, 12, 320)))
    params = jax.tree.map(np.asarray, {'params': v['params']})
    model_t = EcgMae(cfg_t, MAE)
    model_t.load_state_dict(state_dict_from_flax(params, model_t))
    return model_j, params, model_t


def test_moe_reaches_pretrain_trunks():
    """MAE and contrastive trunks place MoE blocks by the same rule, keep
    the MAE decoder dense, and give JAX's loss and aux."""
    model_j, params, model_t = _mae_models(JCFG, CFG)
    enc = params['params']
    assert 'moe' in enc['encoder_block_1'] and 'mlp' in enc['encoder_block_0']
    assert 'mlp' in enc['decoder']['block_0']
    x = _x(7, (3, 12, 320))
    key = jax.random.PRNGKey(8)
    want, mut = model_j.apply(params, jnp.asarray(x), deterministic=True, rngs={'mask': key},
                              mutable=['moe'])
    noise = torch.from_numpy(np.array(jax.random.uniform(_flax_rng(key, 'mask'), (3, 5))))
    with torch.no_grad():
        got = model_t.eval()(torch.from_numpy(x), noise=noise)
    assert float(got.aux_loss) > 0.5
    _close(float(got.loss), float(want.loss), rtol=1e-5)
    _close(float(got.aux_loss), float(jmoe.moe_aux_loss(mut)), rtol=1e-5)

    cm = jcon.EcgContrastive(JCFG, JCC)
    cv = cm.init({'params': jax.random.PRNGKey(2)}, jnp.zeros((2, 12, 320)))
    cparams = jax.tree.map(np.asarray, {'params': cv['params']})
    assert 'moe' in cparams['params']['encoder']['block_1']
    tc = EcgContrastive(CFG, CC).eval()
    tc.load_state_dict(state_dict_from_flax(cparams, tc))
    z_want, cmut = cm.apply(cparams, jnp.asarray(x), mutable=['moe'])
    with torch.no_grad():
        z, aux = tc(torch.from_numpy(x), return_aux=True)
        assert torch.equal(tc(torch.from_numpy(x)), z)
    z_want = np.asarray(z_want)
    np.testing.assert_allclose(z.numpy(), z_want, rtol=1e-5, atol=1e-5)
    _close(float(aux), float(jmoe.moe_aux_loss(cmut)), rtol=1e-5)


@pytest.mark.parametrize('objective', ['mae', 'contrastive'])
def test_moe_trunk_hands_off_layer_for_layer(tmp_path, objective):
    # a Switch trunk pretrained by either objective transfers into the MoE
    # classifier expert for expert (the JAX placement rule on both sides)
    tcfg = TrainConfig(log_to_console=False)
    if objective == 'mae':
        pre = MaeTrainer(CFG, MAE, tcfg, output_dir=str(tmp_path), device='cpu')
    else:
        pre = ContrastiveTrainer(CFG, CC, tcfg, output_dir=str(tmp_path), device='cpu')
    pre.init_state(seed=3)
    path = pre.save_checkpoint('pre')
    vit = Trainer(CFG, tcfg, device='cpu')
    vit.init_state()
    moved = load_any_encoder(path, vit.model.state_dict())
    src = 'encoder_blocks.1.moe.' if objective == 'mae' else 'encoder.blocks.1.moe.'
    for leaf in ('router.weight', 'w1', 'b1', 'w2', 'b2'):
        assert torch.equal(moved[f'encoder.blocks.1.moe.{leaf}'],
                           pre.model.state_dict()[src + leaf])
    vit.set_params(moved)


# ---------------------------------------------------------------------------
# trainer steps against the JAX trainers
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def corpus():
    from ecg_representation_learning_tpu.data import synth_ptbxl
    signals, _, _ = synth_ptbxl(n=64, length=256)
    labels = (np.random.default_rng(12).uniform(size=(64, CFG.num_class)) < 0.1)
    return signals, labels.astype(np.float32)


def test_supervised_trainer_steps_match_jax(corpus):
    """Three ``Trainer`` steps of the MoE debug trunk, each from the JAX
    state before it, at ``_check_steps``' tolerances."""
    jtr = jtrainer.Trainer(JCFG, JaxTrainConfig(
        **STEP_KW, prng_impl=jax.config.jax_default_prng_impl))
    data = JaxSplitData(*corpus)
    jtr.init_state()
    jtr._build_steps()
    nonfinite, steps = jnp.zeros((), jnp.int32), []
    for k in range(3):
        before = jax.tree.map(np.asarray, (jtr.state.params, jtr.state.opt_state))
        sigs, labs, idx = jtr._step_inputs(data, np.arange(16 * k, 16 * (k + 1)))
        with jtr.mesh:
            jtr.state, metrics, _, nonfinite = jtr._train_step(jtr.state, sigs, labs, idx,
                                                               nonfinite)
        steps.append((before, {m: float(v) for m, v in metrics.items()}, None,
                      jax.tree.map(np.asarray, jtr.state.params)))
    tr = Trainer(CFG, TrainConfig(**STEP_KW), device='cpu')
    _check_steps(tr, SplitData(*corpus), steps, lambda _: contextlib.nullcontext())


def test_mae_trainer_steps_match_jax(corpus):
    jtr = jpre.MaeTrainer(JCFG, JMAE, JaxTrainConfig(
        **STEP_KW, prng_impl=jax.config.jax_default_prng_impl))
    data = JaxSplitData(corpus[0], np.zeros((64, 1), np.float32))
    steps = _jax_steps(jtr, data, 3, lambda key: torch.from_numpy(
        np.array(jax.random.uniform(_flax_rng(key, 'mask'), (16, 5)))))
    tr = MaeTrainer(CFG, MAE, TrainConfig(**STEP_KW), device='cpu')
    forward = tr.model.forward

    def feed(noise):
        return _Patch(tr.model, 'forward', lambda x, rng=None: forward(x, rng, noise=noise))
    _check_steps(tr, SplitData(data.signals, data.labels), steps, feed)


def test_contrastive_trainer_steps_match_jax(corpus):
    jcfg = dataclasses.replace(JCFG, max_signal_length=256)
    jtr = jtcon.ContrastiveTrainer(jcfg, JCC, JaxTrainConfig(
        **STEP_KW, prng_impl=jax.config.jax_default_prng_impl))
    data = JaxSplitData(corpus[0], np.zeros((64, 1), np.float32))

    def replay(key):
        return [jax_view_draws(k, (16, 12, 256), CC) for k in jax.random.split(key)]
    steps = _jax_steps(jtr, data, 3, replay)
    tr = ContrastiveTrainer(VitConfig(**dataclasses.asdict(jcfg)), CC, TrainConfig(**STEP_KW),
                            device='cpu')

    def feed(draws):
        return _Patch(tr, '_views', lambda sig, gen, prep=None: ContrastiveTrainer._views(
            tr, sig, gen, draws=draws, prep=prep))
    _check_steps(tr, SplitData(data.signals, data.labels), steps, feed)


def test_mae_stream_step_matches_jax(monkeypatch):
    jtr = jpre.MaeTrainer(JCFG, JMAE, JaxTrainConfig(
        **STEP_KW, prng_impl=jax.config.jax_default_prng_impl), norm_stats=STATS)
    batches = _wire(9, n=1)
    steps = _jax_stream_steps(jtr, jpre, batches, lambda key: torch.from_numpy(
        np.array(jax.random.uniform(_flax_rng(key, 'mask'), (BS, 5)))), monkeypatch)
    tr = MaeTrainer(CFG, MAE, TrainConfig(**STEP_KW), norm_stats=STATS, device='cpu')
    forward = tr.model.forward

    def feed(noise):
        return _Patch(tr.model, 'forward', lambda x, rng=None: forward(x, rng, noise=noise))
    _check_stream_steps(tr, batches, steps, feed)
    assert RAW_LEN // 2 == CFG.max_signal_length


# ---------------------------------------------------------------------------
# int8, init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('size,experts', [('debug', 4), ('tiny', 16)])
def test_int8_leaves_of_a_moe_model_equal_jax(size, experts):
    # tiny with 16 experts: d * E = 4096 puts the router over MIN_QUANT_SIZE
    model = EcgVit(VitConfig.from_defined(size, moe_num_experts=experts))
    ttrainer.flax_init_(model, 3)
    sd = model.state_dict()
    qweights, scales = quantize.quantize_int8(sd)
    jq, jscales = jquant.quantize_params_int8(
        jax.tree.map(jnp.asarray, flax_params_from_state_dict(sd)))
    paths = {k: '/'.join(('params',) + flax_path(k)) for k in sd}
    assert {paths[k] for k in qweights} == set(jscales)
    router = {k for k in qweights if k.endswith('moe.router.weight')}
    assert len(router) == (2 if size == 'tiny' else 0)
    assert {k for k in qweights if k.endswith(('moe.w1', 'moe.w2'))}
    jleaves = {'/'.join(p.key for p in path): leaf
               for path, leaf in jax.tree_util.tree_flatten_with_path(jq)[0]}
    for key, q in qweights.items():
        stack = key.endswith(('.w1', '.w2'))
        want_q, want_s = np.asarray(jleaves[paths[key]]), np.asarray(jscales[paths[key]])
        if not stack:
            want_q, want_s = want_q.T, want_s.T
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), want_q)
        np.testing.assert_array_equal(scales[key].numpy(), want_s)


def test_int8_predict_of_a_moe_model_matches_jax():
    # eval batch 8: 11 records pad the second batch with row 0, which changes
    # S and so the capacity; both sides must pad the same way
    jcfg = dataclasses.replace(JCFG, moe_capacity_factor=1.0)
    jtr = jtrainer.Trainer(jcfg, JaxTrainConfig(eval_batch_size=8, log_to_console=False),
                           norm_stats=jregistry.PTBXL_TRAIN_STATS['original'])
    jtr.init_state()
    params = jax.tree.map(np.asarray, jtr.state.params)
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    tr = Trainer(cfg, TrainConfig(eval_batch_size=8, log_to_console=False),
                 norm_stats=registry.PTBXL_TRAIN_STATS['original'], device='cpu')
    tr.set_params(vit_state_dict_from_flax(params, cfg))
    sigs = [(0.2 * _x(s, (n, 12, length))) for s, n, length in ((10, 11, 250), (11, 3, 900))]
    for sig in sigs:           # f32 first, then int8
        np.testing.assert_allclose(tr.predict_long(sig), jtr.predict_long(sig), atol=1e-5,
                                   rtol=0)
    tr.enable_int8_inference()
    jtr.enable_int8_inference()
    for sig in sigs:
        np.testing.assert_allclose(tr.predict_long(sig), jtr.predict_long(sig), atol=1e-5,
                                   rtol=0)


def test_moe_init_has_flax_fan_in():
    # lecun_normal of an (E, d, f) leaf counts E in the fan-in (flax
    # variance_scaling's receptive field): std 1/sqrt(E d) and 1/sqrt(E f)
    model = EcgVit(VitConfig.from_defined('debug', moe_num_experts=8))
    ttrainer.flax_init_(model, 0)
    m = model.encoder.blocks[1].moe
    e, d, f = m.w1.shape
    assert abs(m.w1.std().item() * np.sqrt(e * d) - 1) < 0.05
    assert abs(m.w2.std().item() * np.sqrt(e * f) - 1) < 0.05
    assert not m.b1.any() and not m.b2.any()
    r = m.router.weight
    assert abs(r.std().item() * np.sqrt(d) - 1) < 0.1 and r.abs().max() <= 2 / np.sqrt(d) / 0.8796


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_train_evaluate_and_infer_int8_with_moe(monkeypatch, tmp_path, capsys):
    """``cli train --moe-experts 4`` -> ``evaluate --checkpoint`` -> ``infer
    --int8``, round trip: the checkpoint holds the expert stacks, and the
    CLI's int8 predictions are those of a trainer restored from it."""
    from ecg_representation_learning_tpu_torch.data import EcgDataset
    monkeypatch.setattr(ttrainer, 'default_device', lambda device=None: torch.device('cpu'))
    flags = ['--size', 'debug', '--no-bf16', '--moe-experts', '4']
    cli.main(['synth', '--n', '80', '--out', str(tmp_path / 'data')])
    hdf5 = str(tmp_path / 'data' / 'PTB-XL-combined.hdf5')
    data = ['--hdf5', hdf5, '--labels-csv', str(tmp_path / 'data' / 'ptb-xl-labels.csv')]
    cli.main(['train', *flags, *data, '--epochs', '1', '--batch-size', '16',
              '--n-sample', '48', '--output-dir', str(tmp_path / 'run')])
    ckpt = str(tmp_path / 'run' / 'ckpt-final')
    params = torch.load(ckpt + '/state.pt', weights_only=True)['params']
    assert params['encoder.blocks.1.moe.w1'].shape == (4, 64, 256)
    assert 'encoder.blocks.0.mlp.fc1.weight' in params
    capsys.readouterr()
    cli.main(['evaluate', *flags, *data, '--checkpoint', ckpt, '--out', str(tmp_path / 'ev')])
    aucs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(aucs) == {'eval', 'test'}
    cli.main(['infer', *flags, '--hdf5', hdf5, '--checkpoint', ckpt, '--int8',
              '--out', str(tmp_path / 'pred.json')])
    got = json.loads((tmp_path / 'pred.json').read_text())
    tr = Trainer(dataclasses.replace(VitConfig.from_defined('debug'), **MOE),
                 TrainConfig(log_to_console=False), device='cpu')
    tr.load_checkpoint(ckpt)
    tr.enable_int8_inference()
    ds = EcgDataset(hdf5)
    try:
        signals = ds.load()
    finally:
        ds.close()
    assert got == json.loads(json.dumps(cli.infer_records(tr, signals, 5)))
    assert got['n_records'] == 80
