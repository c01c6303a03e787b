"""Offline evaluation reports (the JAX package's ``train/evaluate.py``,
reference models/evaluate.py:18-28)."""
from __future__ import annotations

import datetime
import json
import os
from typing import Dict


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
