"""The JAX package's two supervised quality gates, run on the port's
``Trainer`` (on the CPU, its plain attention).

tests/test_train.py:269 (the marker corpus: 8 tone-marked classes,
macro-AUROC over them on the test split > 0.85) and :344 (the hard corpus:
overlapping bands, amplitude noise, windowed markers; the macro-AUROC must
land in the discriminating band 0.72-0.97), with the same corpora
(``synth_ptbxl``, the same seeds), model (debug ViT at 704 samples),
budgets and learning rates, and ``use_flash_attention=False``.
"""
import numpy as np
import torch

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.data import get_ptbxl_splits, synth_ptbxl
from ecg_representation_learning_tpu_torch.train import Trainer
from ecg_representation_learning_tpu_torch.train.metrics import roc_auc

torch.set_num_threads(2)
K = 8


def _macro_auroc(tmp_path, n, epochs, eval_batch_size, hard):
    signals, labels, folds = synth_ptbxl(n=n, length=640, n_marker_classes=K, hard=hard)
    splits = get_ptbxl_splits(signals, labels, folds)
    cfg = VitConfig.from_defined('debug', max_signal_length=704, use_flash_attention=False)
    tr = Trainer(cfg, TrainConfig(num_train_epoch=epochs, train_batch_size=32,
                                  eval_batch_size=eval_batch_size, learning_rate=2e-3,
                                  log_to_console=False),
                 train_data=splits.train, eval_data=splits.eval, output_dir=str(tmp_path),
                 device='cpu')
    tr.train()
    ev = tr.evaluate(splits.test, return_predictions=True)
    probs, labs = ev['predictions']['probs'], ev['predictions']['labels']
    aucs = [roc_auc(probs[:, j], labs[:, j]) for j in range(K)]
    return aucs


def test_multiclass_macro_auroc_on_marker_corpus(tmp_path):
    aucs = _macro_auroc(tmp_path, n=384, epochs=6, eval_batch_size=32, hard=False)
    assert np.mean(aucs) > 0.85, aucs


def test_hard_marker_corpus_discriminating_band(tmp_path):
    aucs = _macro_auroc(tmp_path, n=768, epochs=14, eval_batch_size=64, hard=True)
    macro = float(np.mean([a for a in aucs if a is not None]))
    assert 0.72 <= macro <= 0.97, (macro, aucs)
