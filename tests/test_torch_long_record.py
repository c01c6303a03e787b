"""The port's long-record pretraining (``train/long_record.py``) against the
JAX package's.

One group of four gloo CPU ranks for the file (the rank programs are in
``tests/test_torch_ring_pipeline_ranks.py``); the JAX side runs on four of
the 8 CPU devices at ``precision='highest'``.  A 'debug' ViT over 4 leads,
patch 64, 512 samples (8 patches, 2 per rank), dropout off:

  * ``EcgMim``'s (masked-MSE sum, masked count) on one shard at a non-zero
    patch offset, from the same flax params and mask: the sum within 1e-5
    relative, the count exact;
  * ``RingPretrainer``: two steps on four ranks against JAX's on a 4-device
    mesh, from JAX's init and fed JAX's masks (rebuilt from its state's
    rng), with a 1e-5 clip so that the update depends on how the leaves'
    gradients compare: each loss within 1e-5 relative, the parameters
    within 1e-5 relative over the whole tree (||a - b|| / ||b||) and 1e-5
    max abs;
  * the gradient scale, which Adam and the clip do not see (a gradient n
    times too large or too small takes the same step): the gradients the
    four ranks hold after their sum are JAX's one-device gradients of the
    whole record, within 1e-5 relative over the tree;
  * the port's own masks have exactly ``n_mask`` ones per row, the same on
    every rank;
  * a run checkpointed every step and resumed from its newest checkpoint
    equals an uninterrupted run bit for bit, and pruning keeps the newest
    two step-tagged checkpoints.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.parallel import make_mesh as jax_mesh
from ecg_representation_learning_tpu.train.long_record import EcgMim as JaxEcgMim
from ecg_representation_learning_tpu.train.long_record import RingPretrainer as JaxRing
from ecg_representation_learning_tpu.train.long_record import _exact_count_mask as jax_mask
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models.port import mim_state_dict_from_flax
from ecg_representation_learning_tpu_torch.parallel import LocalRanks
from ecg_representation_learning_tpu_torch.train.long_record import EcgMim, _exact_count_mask

import test_torch_ring_pipeline_ranks as prog

RTOL = 1e-5
JCFG = JaxVitConfig.from_defined('debug', max_signal_length=512, patch_size=64, num_channels=4,
                                 use_flash_attention=False, ring_axis='data',
                                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
KW = dict(learning_rate=1e-4, grad_clip_norm=1e-5)   # the clip bites


@pytest.fixture(scope='module')
def ranks():
    with LocalRanks(4) as r:
        yield r


def _port_cfg(jcfg=JCFG):
    return VitConfig(**dataclasses.asdict(jcfg))


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / np.linalg.norm(np.asarray(b, np.float64)))


def test_ecg_mim_sum_and_count_match_jax():
    jcfg = dataclasses.replace(JCFG, ring_axis=None)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 256)).astype(np.float32)       # 4 of the 8 patches
    mask = (rng.uniform(size=(2, 4)) < 0.5).astype(np.float32)
    mask[:, 0] = 1.0
    params = JaxEcgMim(jcfg).init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask), 4)
    with jax.default_matmul_precision('highest'):
        want_sum, want_cnt = JaxEcgMim(jcfg).apply(params, jnp.asarray(x), jnp.asarray(mask), 4)
    model = EcgMim(_port_cfg(jcfg)).eval()
    model.load_state_dict(mim_state_dict_from_flax(jax.tree.map(np.asarray, params),
                                                   _port_cfg(jcfg)))
    with torch.no_grad():
        got_sum, got_cnt = model(torch.from_numpy(x), torch.from_numpy(mask), 4)
    assert float(got_cnt) == float(want_cnt)
    assert abs(float(got_sum) - float(want_sum)) <= RTOL * abs(float(want_sum))


@pytest.fixture(scope='module')
def jax_ring():
    """JAX ``RingPretrainer``, two steps on a 4-device mesh: (init params,
    the batches, the masks its steps draw, the losses, the final params)."""
    mesh = jax_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    tr = JaxRing(JCFG, JaxTrainConfig(**KW), mesh, seq_axis='data', total_steps=2)
    state = tr.init(seed=0)
    init = jax.tree.map(np.asarray, state.params)
    key, masks = state.rng, []
    n_mask = max(1, int(round(JCFG.num_patches * tr.mask_ratio)))
    for _ in range(2):
        key, mask_key = jax.random.split(key)
        masks.append(np.asarray(jax_mask(mask_key, 2, JCFG.num_patches, n_mask)))
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((2, 4, 512)).astype(np.float32) for _ in range(2)]
    with jax.default_matmul_precision('highest'):
        res = tr.train(iter(xs), steps=2)
    return init, xs, masks, res['losses'], jax.tree.map(np.asarray, tr.state.params)


def test_ring_pretrainer_steps_on_4_ranks_match_jax(ranks, jax_ring):
    init, xs, masks, losses, final = jax_ring
    cfg = _port_cfg()
    out = ranks.run(prog.ring_steps, cfg, TrainConfig(**KW), mim_state_dict_from_flax(init, cfg),
                    xs, [torch.tensor(m) for m in masks])
    got_losses, state = out[0]
    assert all(o[0] == got_losses for o in out)              # one loss on every rank
    np.testing.assert_allclose(got_losses, losses, rtol=RTOL)
    want = mim_state_dict_from_flax(final, cfg)
    assert set(state) == set(want)
    num = sum(float((state[k].double() - want[k].double()).square().sum()) for k in want)
    den = sum(float(want[k].double().square().sum()) for k in want)
    assert (num / den) ** 0.5 <= RTOL
    for k in want:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(), rtol=0, atol=RTOL,
                                   err_msg=k)
        assert all(torch.equal(o[1][k], state[k]) for o in out)   # replicated parameters


def test_ring_gradients_on_4_ranks_are_the_one_device_gradients(ranks, jax_ring):
    init, xs, masks, _, _ = jax_ring
    jcfg = dataclasses.replace(JCFG, ring_axis=None)

    def loss_fn(p):
        loss_sum, cnt = JaxEcgMim(jcfg).apply(p, jnp.asarray(xs[0]), jnp.asarray(masks[0]), 0)
        return loss_sum / jnp.maximum(cnt, 1.0)
    with jax.default_matmul_precision('highest'):
        want_loss, want_grads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, init))
    cfg = _port_cfg()
    want = mim_state_dict_from_flax(jax.tree.map(np.asarray, want_grads), cfg)
    out = ranks.run(prog.ring_grads, cfg, TrainConfig(**KW), mim_state_dict_from_flax(init, cfg),
                    xs[0], torch.tensor(masks[0]))
    got_loss, grads = out[0]
    assert abs(got_loss - float(want_loss)) <= RTOL * abs(float(want_loss))
    assert set(grads) == set(want)
    num = sum(float((grads[k].double() - want[k].double()).square().sum()) for k in want)
    den = sum(float(want[k].double().square().sum()) for k in want)
    assert (num / den) ** 0.5 <= RTOL
    for o in out[1:]:
        assert o[0] == got_loss and all(torch.equal(o[1][k], grads[k]) for k in want)


def test_masks_have_exactly_n_mask_ones_per_row(ranks):
    gen = torch.Generator().manual_seed(0)
    m = _exact_count_mask(gen, 64, 32, 16)
    assert m.shape == (64, 32) and torch.equal(m.sum(dim=1), torch.full((64,), 16.0))
    cfg = _port_cfg()
    out = ranks.run(prog.ring_masks, cfg, TrainConfig(**KW), 3, 2)
    for step in range(2):
        mask = out[0][step]
        assert torch.equal(mask.sum(dim=1), torch.full((3,), 4.0))   # round(8 * 0.5)
        assert all(torch.equal(o[step], mask) for o in out)
    assert not torch.equal(out[0][0], out[0][1])


def test_resume_equals_an_uninterrupted_run_and_pruning_keeps_two(ranks, tmp_path):
    cfg, tcfg = _port_cfg(), TrainConfig(**KW)
    whole = ranks.run(prog.ring_train, cfg, tcfg, 6, str(tmp_path / 'whole'))[0]
    first = ranks.run(prog.ring_train, cfg, tcfg, 3, str(tmp_path / 'cut'), 1)[0]
    assert first[2] == ['ckpt-step2', 'ckpt-step3']
    rest = ranks.run(prog.ring_train, cfg, tcfg, 6, str(tmp_path / 'cut'), 1, True)[0]
    assert rest[2] == ['ckpt-step5', 'ckpt-step6']
    assert first[0] + rest[0] == whole[0]
    for k, v in whole[1].items():
        assert torch.equal(rest[1][k], v), k
