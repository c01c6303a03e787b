"""End-to-end programmatic quickstart of the PyTorch port (the twin of
``examples/quickstart.py``).

Covers the full workflow on a synthetic PTB-XL-shaped corpus:
  1. build splits                     (data)
  2. supervised fine-tune + eval      (train.Trainer, macro-AUROC)
  3. MAE pretrain -> encoder transfer (train.pretrain)
  4. tokenize                         (models.tokenizer)
  5. attention rollout                (utils.rollout: the arrays, then the figure)

Run:  python examples/torch/quickstart.py [--platform cpu]
(On the GPU by default; --platform cpu runs the plain versions of the kernels.
With real data, swap synth_ptbxl for data.load_ptbxl_from_export.)

Each step is a function, so a test or a smoke run can call them one by one;
``main`` runs them in order.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np
import torch

from ecg_representation_learning_tpu_torch.configs import MaeConfig, TrainConfig, VitConfig


def build_splits(n: int, seed: int = 77):
    """Step 1: train/eval/test splits of ``n`` synthetic records of 10 s."""
    from ecg_representation_learning_tpu_torch.data import get_ptbxl_splits, synth_ptbxl
    signals, labels, folds = synth_ptbxl(n=n, length=2500, seed=seed)
    splits = get_ptbxl_splits(signals, labels, folds)
    print(f'splits: train={len(splits.train)} eval={len(splits.eval)} '
          f'test={len(splits.test)}')
    return splits


def train_config(epochs: int) -> TrainConfig:
    return TrainConfig(num_train_epoch=epochs, train_batch_size=32, eval_batch_size=64,
                       learning_rate=1e-3)


def supervised(splits, model_cfg: VitConfig, cfg: TrainConfig, device=None,
               out_dir: str = 'runs/quickstart'):
    """Step 2: train the classifier and score the test split.  Returns
    (trainer, train result, test metrics)."""
    from ecg_representation_learning_tpu_torch.train import Trainer
    tr = Trainer(model_cfg, cfg, train_data=splits.train, eval_data=splits.eval,
                 output_dir=out_dir, device=device)
    result = tr.train()
    test = tr.evaluate(splits.test)
    print('supervised: best eval loss %.4f, test macro-AUROC %s'
          % (result['best_eval_loss'], test['macro_auc']))
    return tr, result, test


def mae_transfer(splits, model_cfg: VitConfig, cfg: TrainConfig, device=None,
                 out_dir: str = 'runs/quickstart-mae'):
    """Step 3: MAE pretraining, then its trunk in a fresh classifier.
    Returns (pretrain result, the classifier's state_dict)."""
    from ecg_representation_learning_tpu_torch.models import create_vit
    from ecg_representation_learning_tpu_torch.train.pretrain import (MaeTrainer,
                                                                       transfer_encoder)
    mae = MaeTrainer(model_cfg, MaeConfig(), cfg, train_data=splits.train,
                     output_dir=out_dir, device=device)
    result = mae.train()
    print('mae pretrain loss %.4f' % result['loss'])
    _, vit_params = create_vit(model_cfg, torch.Generator().manual_seed(0))
    merged = transfer_encoder(mae.state_dict(), vit_params)
    print('pretrained encoder transferred into a fresh classifier')
    return result, merged


def tokenize(splits, device=None):
    """Step 4: fit the segment tokenizer and encode four test records.
    Returns (tokenizer, ids, rank-frequency report)."""
    from ecg_representation_learning_tpu_torch.models.tokenizer import EcgTokenizer
    from ecg_representation_learning_tpu_torch.runtime import default_device
    dev = default_device(device)
    tok = EcgTokenizer(k=8).fit(torch.as_tensor(splits.train.signals[:64], device=dev),
                                n_clusters=64, n_iter=32)
    ids, _ = tok(torch.as_tensor(splits.test.signals[:4], device=dev))
    rf = tok.rank_frequency()
    print('tokenizer: %d clusters, power-law exponent %.2f, ids %s'
          % (tok.centers.shape[0], rf['exponent'], ids.shape))
    return tok, ids, rf


def rollout_input(splits, model_cfg: VitConfig) -> np.ndarray:
    """The first test record, padded to whole patches and cut to the model's
    input length (what the rollout figure shows)."""
    sig = splits.test.signals[0]
    sig = np.pad(sig, [(0, 0), (0, model_cfg.patch_size - sig.shape[-1] % model_cfg.patch_size)])
    return np.ascontiguousarray(sig[:, :model_cfg.max_signal_length], np.float32)


def rollout_arrays(model: torch.nn.Module, sig: np.ndarray):
    """Step 5a: the per-layer attention maps (L, 1, H, T, T) of ``model``
    on ``sig`` (12, L), on the model's device, and their rollout (L, T - 1)."""
    from ecg_representation_learning_tpu_torch.utils.rollout import attention_rollout
    dev = next(model.parameters()).device
    model.eval()
    with torch.no_grad():
        maps = model(torch.as_tensor(sig[None], device=dev), return_attention=True).attention
    maps = maps.float().cpu().numpy()
    return maps, attention_rollout(maps)


def rollout_figure(model: torch.nn.Module, sig: np.ndarray, labels: np.ndarray) -> str:
    """Step 5b: the rollout figure (matplotlib and seaborn); returns its path."""
    import matplotlib
    matplotlib.use('Agg')
    from ecg_representation_learning_tpu_torch.utils import EcgVitVisualizer
    path = EcgVitVisualizer(model)(sig, labels, save=True)
    print('rollout figure:', path)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--platform', default=None, choices=['cuda', 'cpu'])
    ap.add_argument('--n', type=int, default=256)
    ap.add_argument('--epochs', type=int, default=2)
    args = ap.parse_args(argv)

    splits = build_splits(args.n)
    model_cfg = VitConfig.from_defined('tiny')
    cfg = train_config(args.epochs)
    tr, _, _ = supervised(splits, model_cfg, cfg, args.platform)
    mae_transfer(splits, model_cfg, cfg, args.platform)
    tokenize(splits, args.platform)
    sig = rollout_input(splits, model_cfg)
    model = tr.served_model()
    _, scores = rollout_arrays(model, sig)
    print('rollout scores:', scores.shape)
    rollout_figure(model, sig, splits.test.labels[0])


if __name__ == '__main__':
    main()
