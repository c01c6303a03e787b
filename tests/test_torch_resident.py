"""``TrainConfig.resident_dtype``: the resident split's signals stored in
float16/bfloat16 and cast to f32 right after the gather, labels in f32.

Held as ``tests/test_train.py::test_resident_dtype_trains_and_halves_storage``
holds the JAX trainer (storage dtype, f32 labels, eval loss within 2e-2
relative of the f32-resident run), and against the JAX trainer with the same
``resident_dtype='float16'`` step for step at the tolerance of
``tests/test_torch_train.py::test_loss_curve_matches_jax_step_for_step``
(rtol 1e-5): both sides round the f32 signals to f16 the same way (round to
nearest even), so both steps see the same inputs.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.data import get_ptbxl_splits as jax_splits
from ecg_representation_learning_tpu.data import synth_ptbxl
from ecg_representation_learning_tpu.train import Trainer as JaxTrainer
from ecg_representation_learning_tpu_torch.configs import MaeConfig, TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.data import get_ptbxl_splits
from ecg_representation_learning_tpu_torch.models.port import vit_state_dict_from_flax
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer
from ecg_representation_learning_tpu_torch.train.pretrain import MaeTrainer

torch.set_num_threads(2)
RTOL = 1e-5
KW = dict(num_train_epoch=2, train_batch_size=32, eval_batch_size=32, learning_rate=1e-3,
          log_to_console=False, save_final=False, ema_decay=0.9, grad_accum=2,
          resident_dtype='float16')


def _recording(tr):
    payloads, log = [], tr._log
    tr._log = lambda p: (payloads.append(p), log(p))
    return payloads


@pytest.fixture(scope='module')
def corpus():
    return synth_ptbxl(n=192, length=640)


@pytest.mark.parametrize('dtype', ['float16', 'bfloat16'])
def test_resident_dtype_trains_and_halves_storage(corpus, tmp_path, dtype):
    splits = get_ptbxl_splits(*corpus)
    cfg = VitConfig.from_defined('debug', max_signal_length=704, flash_min_seq=0)
    evals = {}
    for resident in (dtype, None):
        tr = Trainer(cfg, TrainConfig(num_train_epoch=1, train_batch_size=16,
                                      eval_batch_size=32, do_eval=False, save_final=False,
                                      log_to_console=False, resident_dtype=resident),
                     train_data=splits.train, eval_data=splits.eval,
                     output_dir=str(tmp_path), device='cpu')
        tr.train()
        sigs, labs = tr._split_arrays(tr.train_data)
        assert sigs.dtype == getattr(torch, resident or 'float32')
        assert labs.dtype == torch.float32                # labels stay exact
        assert sigs.nbytes == splits.train.signals.nbytes // (2 if resident else 1)
        evals[resident] = tr.evaluate(splits.eval)['loss']
        assert np.isfinite(evals[resident])
    np.testing.assert_allclose(evals[dtype], evals[None], rtol=2e-2)


def test_float16_storage_matches_jax_step_for_step(corpus, tmp_path):
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=704, hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0)
    js = jax_splits(*corpus)
    jtr = JaxTrainer(jcfg, JaxTrainConfig(**KW, prng_impl=jax.config.jax_default_prng_impl),
                     train_data=js.train, eval_data=js.eval, output_dir=str(tmp_path / 'jax'))
    jp = _recording(jtr)
    jtr.init_state()
    params = jax.tree.map(np.asarray, jtr.state.params)
    jtr.train()
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    ts = get_ptbxl_splits(*corpus)
    tr = Trainer(cfg, TrainConfig(**KW), train_data=ts.train, eval_data=ts.eval,
                 output_dir=str(tmp_path / 'port'), device='cpu')
    tp = _recording(tr)
    tr.set_params(vit_state_dict_from_flax(params, cfg))
    tr.train()
    # the same f16 bits resident on both sides
    want = np.asarray(jtr._split_arrays(js.train)[0])
    got = tr._split_arrays(ts.train)[0]
    assert want.dtype == np.float16 and got.numpy().tobytes() == want.tobytes()
    assert [sorted(p) for p in tp] == [sorted(p) for p in jp]
    assert sum('train/loss' in p for p in tp) == tr.step == 10
    for a, b in zip(jp, tp):
        assert (a['epoch'], a['step']) == (b['epoch'], b['step'])
        for key in ('train/loss', 'train/grad_norm', 'eval/loss'):
            if key in a:
                np.testing.assert_allclose(b[key], a[key], rtol=RTOL, err_msg=key)


def test_mae_resident_dtype(tmp_path):
    """tests/test_pretrain.py::test_mae_resident_dtype on the port's MaeTrainer."""
    sigs = np.random.default_rng(77).standard_normal((64, 12, 256)).astype(np.float32)
    model_cfg = VitConfig.from_defined('debug', max_signal_length=256, flash_min_seq=0)
    mae_cfg = MaeConfig(decoder_hidden_size=64, decoder_num_layers=1, decoder_num_heads=4,
                        decoder_intermediate_size=128)
    cfg = TrainConfig(num_train_epoch=1, train_batch_size=16, do_eval=False,
                      save_final=False, resident_dtype='float16', learning_rate=1e-3,
                      log_to_console=False)
    tr = MaeTrainer(model_cfg, mae_cfg, cfg, output_dir=str(tmp_path / 'f16'), device='cpu')
    tr.train_data = SplitData(sigs, np.zeros((64, 1), np.float32))
    res = tr.train()
    assert np.isfinite(res['loss'])
    assert tr._resident[id(tr.train_data)].dtype == torch.float16
