"""Offline evaluation reports (the JAX package's ``train/evaluate.py``,
reference models/evaluate.py): ``evaluate_trained`` writes each split's
metrics as JSON (evaluate.py:18-28); ``pick_eval_eg`` picks the indices of
the lowest, median and highest per-sample losses of each split for a
qualitative look (evaluate.py:31-55)."""
from __future__ import annotations

import datetime
import json
import os
import pickle
from typing import Dict

import numpy as np


def evaluate_trained(trainer, splits: Dict[str, object],
                     out_dir: str = 'eval') -> Dict[str, Dict]:
    """splits: name -> SplitData.  Writes ``{out_dir}/evaluation, <ts>.json``
    and returns the per-split metrics (with ``'_path'``)."""
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for name, data in splits.items():
        m = trainer.evaluate(data)
        results[name] = {k: v for k, v in m.items()
                         if k not in ('per_sample_loss', 'predictions')}
    ts = datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')
    path = os.path.join(out_dir, f'evaluation, {ts}.json')
    with open(path, 'w') as f:
        json.dump(results, f, indent=2)
    results['_path'] = path
    return results


def pick_eval_eg(trainer, splits: Dict[str, object], n_each: int = 3,
                 out_dir: str = 'eval') -> Dict[str, Dict[str, list]]:
    """Indices of the ``n_each`` lowest, median and highest per-sample
    losses of each split (``trainer.evaluate(..., loss_reduction='none')``);
    pickled to ``{out_dir}/eval_edge_example_samples, <ts>.pkl``."""
    out: Dict[str, Dict[str, list]] = {}
    for name, data in splits.items():
        losses = trainer.evaluate(data, loss_reduction='none')['per_sample_loss']
        order = np.argsort(losses)
        mid0 = max(losses.size // 2 - n_each // 2, 0)
        out[name] = {'low': order[:n_each].tolist(),
                     'med': order[mid0:mid0 + n_each].tolist(),
                     'high': order[-n_each:].tolist()}
    os.makedirs(out_dir, exist_ok=True)
    ts = datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')
    with open(os.path.join(out_dir, f'eval_edge_example_samples, {ts}.pkl'), 'wb') as f:
        pickle.dump(out, f)
    return out
