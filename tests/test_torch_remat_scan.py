"""The port's ``scan_blocks`` and ``remat`` (models/vit.py) against the JAX
package's, and against the port's own unrolled, recompute-free model.

``scan_blocks``: JAX's stacked ``encoder/blocks`` tree carried into the
port's ``ScannedBlocks`` drives the same forward (the cases of
tests/test_models.py:191 and :221); the port's stack and unstack are the JAX
functions' counterparts bit for bit; gradients flow through the stack with
hash dropout (tests/test_hash_dropout.py:87); a scanned checkpoint does not
load into an unrolled model; int8 of the stacks is JAX's and gives the
unrolled model's predictions.  ``remat``: the gradients of JAX's remat model
and the port's; within the port, with dropout on ('hash' and 'flax'), the
loss, every gradient and both generator states after the step are the bits
of the same step without remat.  Init: the per-layer kernels of a stack have
the std of 1/sqrt(fan_in).

Tolerances: logits within 1e-6 of their largest magnitude (f32 in another
operation order; measured 2.6e-6 on logits of magnitude 2.7 through the
kernel's plain version, 1.8e-6 through plain attention).  Gradients: remat
changes no bit on either side; the port's gradient as a whole within 2e-6 of
JAX's in norm, and each parameter's within 1e-5 of its largest element, the
bar of tests/test_torch_moe.py.  The norm bar is the f32 floor of the
comparison, not a remat effect: measured 9.7e-7 between the two sides, with
the port 1.2e-6 and JAX 1.1e-6 from the port's model evaluated in f64, the
same with and without remat.  The port against itself: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models import vit as jvit
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models import vit as tvit
from ecg_representation_learning_tpu_torch.models.port import vit_state_dict_from_flax
from ecg_representation_learning_tpu_torch.ops.dropout import DropoutRng
from ecg_representation_learning_tpu_torch.train import checkpoint
from ecg_representation_learning_tpu_torch.train import trainer as ttrainer
from ecg_representation_learning_tpu_torch.train.trainer import SplitData, Trainer

torch.set_num_threads(2)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _jcfg(**kw):
    """tests/test_models.py's scan config: debug widths, 256 samples, patch 32."""
    return JaxVitConfig.from_defined('debug', max_signal_length=256, patch_size=32,
                                     flash_interpret=True, **kw)


def _x(seed, n=2, length=256):
    return np.random.default_rng(seed).standard_normal((n, 12, length)).astype(np.float32)


def _labels(n=2):
    lab = np.zeros((n, 71), np.float32)
    lab[:, 0] = 1.0
    return lab


def _port(jcfg, params):
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    model = tvit.EcgVit(cfg)
    model.load_state_dict(vit_state_dict_from_flax(params, cfg))
    return model


# ---------------------------------------------------------------------------
# scan_blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('flash_min_seq', [0, 128])
def test_scanned_model_on_jax_scanned_params_gives_jax_logits(flash_min_seq):
    jcfg = _jcfg(scan_blocks=True, flash_min_seq=flash_min_seq)
    model, params = jvit.create_vit(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    assert params['params']['encoder']['blocks']['attn']['qkv']['kernel'].shape[0] == 4
    tm = _port(jcfg, params).eval()
    assert isinstance(tm.encoder.blocks, tvit.ScannedBlocks)
    assert tm.state_dict()['encoder.blocks.attn.qkv.weight'].shape == (4, 192, 64)
    x, lab = _x(0), _labels()
    want = model.apply(params, jnp.asarray(x), labels=jnp.asarray(lab))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), labels=torch.from_numpy(lab))
    logits = np.asarray(want.logits)
    np.testing.assert_allclose(got.logits.numpy(), logits, rtol=1e-6,
                               atol=1e-6 * np.abs(logits).max())
    assert np.isfinite(got.loss.item())


def test_unstacked_jax_params_drive_the_unrolled_model_to_the_same_bits():
    """The port's scanned model and its unrolled model on the unstacked
    weights (the JAX ``unstack_scanned_params`` tree, carried over) compute
    the same bits; the unrolled one gives the attention maps."""
    jcfg = _jcfg(scan_blocks=True, **NO_DROPOUT)
    _, params = jvit.create_vit(jcfg, jax.random.PRNGKey(2))
    params = jax.tree.map(np.asarray, params)
    scanned = _port(jcfg, params).eval()
    flat_j = dataclasses.replace(jcfg, scan_blocks=False)
    flat = _port(flat_j, jax.tree.map(np.asarray, jvit.unstack_scanned_params(params, 4))).eval()
    x = torch.from_numpy(_x(1))
    with torch.no_grad():
        a, b = scanned(x).logits, flat(x).logits
        assert torch.equal(a, b)
        out = flat(x, return_attention=True)
        maps = scanned(x, return_attention=True).attention
    assert out.attention.shape == (4, 2, 4, 9, 9) and torch.equal(maps, out.attention)


def test_stack_and_unstack_round_trip_and_match_jax():
    jcfg = _jcfg()
    _, params = jvit.create_vit(jcfg, jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    scfg = dataclasses.replace(cfg, scan_blocks=True)
    flat = vit_state_dict_from_flax(params, cfg)
    stacked = tvit.stack_unrolled_state_dict(flat, 4)
    want = vit_state_dict_from_flax(
        jax.tree.map(np.asarray, jvit.stack_unrolled_params(params, 4)), scfg)
    assert set(stacked) == set(want)
    for k, v in want.items():
        assert torch.equal(stacked[k], v), k
    back = tvit.unstack_scanned_state_dict(stacked, 4)
    assert set(back) == set(flat) and all(torch.equal(back[k], flat[k]) for k in flat)
    want_flat = vit_state_dict_from_flax(jax.tree.map(
        np.asarray, jvit.unstack_scanned_params(jvit.stack_unrolled_params(params, 4), 4)), cfg)
    assert all(torch.equal(back[k], want_flat[k]) for k in flat)
    tvit.EcgVit(scfg).load_state_dict(stacked)       # the scanned model takes it


def test_scanned_checkpoint_does_not_load_into_an_unrolled_model(tmp_path):
    cfg = VitConfig.from_defined('debug', max_signal_length=256, patch_size=32)
    scanned = Trainer(dataclasses.replace(cfg, scan_blocks=True),
                      TrainConfig(log_to_console=False), output_dir=str(tmp_path), device='cpu')
    scanned.init_state()
    path = scanned.save_checkpoint('scanned')
    flat = tvit.EcgVit(cfg)
    with pytest.raises(ValueError, match='does not match'):
        checkpoint.check_params(checkpoint.restore_checkpoint(path)['params'],
                                flat.state_dict(), 'scanned checkpoint')
    unrolled = Trainer(cfg, TrainConfig(log_to_console=False), device='cpu')
    with pytest.raises(ValueError, match='do not match this model'):
        unrolled.load_checkpoint(path)
    # unstacked, it loads
    unrolled.set_params(tvit.unstack_scanned_state_dict(scanned.model.state_dict(), 4))


def test_grad_flows_through_the_stack_with_hash_dropout():
    cfg = VitConfig.from_defined('debug', max_signal_length=512, scan_blocks=True,
                                 dropout_impl='hash')
    model = tvit.EcgVit(cfg).train()
    ttrainer.flax_init_(model, 2)
    rng = DropoutRng(host=torch.Generator().manual_seed(3),
                     device=torch.Generator().manual_seed(4))
    model(torch.from_numpy(_x(5, length=512)), labels=torch.from_numpy(_labels()),
          rng=rng).loss.backward()
    total = sum(p.grad.abs().sum().item() for p in model.parameters())
    assert np.isfinite(total) and total > 0
    g = model.encoder.blocks.attn.qkv.weight.grad
    assert all(g[i].abs().max() > 0 for i in range(4))      # every layer's slice


def test_scanned_stack_init_is_per_layer_lecun():
    # nn.scan initialises each layer alone: the fan-in of a stacked kernel
    # is its layer's, and the layers are independent draws
    model = tvit.EcgVit(VitConfig.from_defined('small', scan_blocks=True))
    ttrainer.flax_init_(model, 0)
    blocks = model.encoder.blocks
    for name in ('attn.qkv.weight', 'attn.out.weight', 'mlp.fc1.weight', 'mlp.fc2.weight'):
        w = blocks.get_parameter(name)
        fan_in = w.shape[-1]
        for i in range(w.shape[0]):
            assert abs(w[i].std().item() * np.sqrt(fan_in) - 1) < 0.05, (name, i)
        assert not torch.equal(w[0], w[1])
    assert (blocks.norm1.weight == 1).all() and not blocks.mlp.fc1.bias.any()


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('scan', [False, True])
def test_remat_gradients_match_jax(scan):
    """JAX's remat gradients against the port's: remat changes no bit on
    either side (each against its own model without remat), and the two
    sides agree as their f32 arithmetic allows."""
    jcfg = _jcfg(remat=True, scan_blocks=scan, **NO_DROPOUT)
    x, lab = _x(6), _labels()
    grads = {}
    for remat in (True, False):
        cfg_j = dataclasses.replace(jcfg, remat=remat)
        model, params = jvit.create_vit(cfg_j, jax.random.PRNGKey(4))
        params = jax.tree.map(np.asarray, params)
        g = jax.grad(lambda p: model.apply(p, jnp.asarray(x), labels=jnp.asarray(lab),
                                           deterministic=False).loss)(params)
        tm = _port(cfg_j, params).train()
        tm(torch.from_numpy(x), labels=torch.from_numpy(lab)).loss.backward()
        grads[remat] = (vit_state_dict_from_flax(jax.tree.map(np.asarray, g), tm.cfg),
                        {n: p.grad for n, p in tm.named_parameters()})
    (want, got), (want_plain, got_plain) = grads[True], grads[False]
    assert all(torch.equal(got[n], got_plain[n]) for n in got)
    assert all(torch.equal(want[n], want_plain[n]) for n in want)
    diff = sum(((got[n] - want[n]).double() ** 2).sum().item() for n in got)
    norm = sum((want[n].double() ** 2).sum().item() for n in got)
    assert np.sqrt(diff / norm) <= 2e-6
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def _step(cfg, state, x, lab, seed):
    """Loss, gradients and the generator states after one training forward
    and backward of ``cfg`` from ``state``."""
    model = tvit.EcgVit(cfg).train()
    model.load_state_dict(state)
    rng = DropoutRng(host=torch.Generator().manual_seed(seed),
                     device=torch.Generator().manual_seed(seed + 1))
    loss = model(x, labels=lab, rng=rng).loss
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            rng.host.get_state(), rng.device.get_state())


@pytest.mark.parametrize('scan', [False, True])
@pytest.mark.parametrize('impl', ['hash', 'flax'])
def test_remat_keeps_the_bits_with_dropout(impl, scan):
    cfg = VitConfig.from_defined('debug', max_signal_length=256, patch_size=32,
                                 dropout_impl=impl, scan_blocks=scan, flash_min_seq=0,
                                 hidden_dropout_prob=0.2, attention_probs_dropout_prob=0.2)
    model = tvit.EcgVit(cfg)
    ttrainer.flax_init_(model, 5)
    state = model.state_dict()
    x, lab = torch.from_numpy(_x(7)), torch.from_numpy(_labels())
    loss, grads, host, dev = _step(cfg, state, x, lab, 11)
    r_loss, r_grads, r_host, r_dev = _step(dataclasses.replace(cfg, remat=True), state, x,
                                           lab, 11)
    assert torch.equal(loss, r_loss)
    assert all(torch.equal(grads[n], r_grads[n]) for n in grads)
    assert torch.equal(host, r_host) and torch.equal(dev, r_dev)
    # dropout was live: another seed gives another loss
    assert not torch.equal(loss, _step(cfg, state, x, lab, 12)[0])


def test_remat_and_scan_trainer_steps_are_the_unrolled_steps():
    """``Trainer`` steps with hash dropout, TimeOut and EMA: a scanned stack
    under remat gives the bits of the scanned stack without it; against the
    unrolled model (the same weights, stacked) the first step's loss is the
    same bits and its gradient norm, a sum over differently shaped leaves,
    equal to 1e-6."""
    rng = np.random.default_rng(8)
    data = SplitData(signals=(0.3 * rng.standard_normal((32, 12, 250))).astype(np.float32),
                     labels=(rng.uniform(size=(32, 71)) < 0.2).astype(np.float32))
    base = VitConfig.from_defined('debug', max_signal_length=320, dropout_impl='hash')
    tcfg = TrainConfig(train_batch_size=16, augment_timeout=True, log_to_console=False,
                       ema_decay=0.9)
    trainers = {}
    for name, kw in (('unrolled', {}), ('scan', dict(scan_blocks=True)),
                     ('scan_remat', dict(scan_blocks=True, remat=True))):
        trainers[name] = Trainer(dataclasses.replace(base, **kw), tcfg, device='cpu')
        trainers[name].init_state()
    flat = trainers['unrolled'].model.state_dict()
    for name in ('scan', 'scan_remat'):
        trainers[name].set_params(tvit.stack_unrolled_state_dict(flat, 4))
    for k in range(2):
        take = np.arange(16 * k, 16 * (k + 1))
        m = {name: tr.train_step(data, take) for name, tr in trainers.items()}
        assert torch.equal(m['scan']['loss'], m['scan_remat']['loss'])
        assert torch.equal(m['scan']['grad_norm'], m['scan_remat']['grad_norm'])
        if k == 0:
            assert torch.equal(m['unrolled']['loss'], m['scan']['loss'])
            np.testing.assert_allclose(m['scan']['grad_norm'].item(),
                                       m['unrolled']['grad_norm'].item(), rtol=1e-6)
    a, b = trainers['scan'], trainers['scan_remat']
    assert all(torch.equal(v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items())
    assert all(torch.equal(v, b.ema[k]) for k, v in a.ema.items())
    assert torch.equal(a.rng.device.get_state(), b.rng.device.get_state())
    np.testing.assert_array_equal(a.predict(data.signals[:5]), b.predict(data.signals[:5]))


def test_int8_of_a_scanned_model_is_jax_and_the_unrolled_models():
    """int8 of a stacked tree: the int8 stacks and scales are JAX's (the last
    two axes swapped), and the scanned model's int8 predictions are the bits
    of the unrolled model's on the same weights."""
    from ecg_representation_learning_tpu.models import quantize as jquant
    from ecg_representation_learning_tpu_torch.models import quantize
    from ecg_representation_learning_tpu_torch.models.port import (
        flax_params_from_state_dict, flax_path)
    cfg = VitConfig.from_defined('debug', max_signal_length=320)
    scfg = dataclasses.replace(cfg, scan_blocks=True)
    flat = Trainer(cfg, TrainConfig(eval_batch_size=8, log_to_console=False), device='cpu')
    flat.init_state()
    scanned = Trainer(scfg, TrainConfig(eval_batch_size=8, log_to_console=False), device='cpu')
    scanned.set_params(tvit.stack_unrolled_state_dict(flat.model.state_dict(), 4))
    sd = scanned.model.state_dict()
    qweights, scales = quantize.quantize_int8(sd)
    jq, jscales = jquant.quantize_params_int8(jax.tree.map(jnp.asarray,
                                                           flax_params_from_state_dict(sd)))
    paths = {k: '/'.join(('params',) + flax_path(k)) for k in sd}
    assert {paths[k] for k in qweights} == set(jscales)
    assert qweights['encoder.blocks.attn.qkv.weight'].shape == (4, 192, 64)
    jleaves = {'/'.join(p.key for p in path): leaf
               for path, leaf in jax.tree_util.tree_flatten_with_path(jq)[0]}
    for key, q in qweights.items():
        np.testing.assert_array_equal(q.numpy(), np.swapaxes(np.asarray(jleaves[paths[key]]),
                                                             -1, -2))
        np.testing.assert_array_equal(scales[key].numpy(),
                                      np.swapaxes(np.asarray(jscales[paths[key]]), -1, -2))
    flat.enable_int8_inference()
    scanned.enable_int8_inference()
    sig = 0.2 * _x(9, n=11, length=250)
    np.testing.assert_array_equal(scanned.predict(sig), flat.predict(sig))
