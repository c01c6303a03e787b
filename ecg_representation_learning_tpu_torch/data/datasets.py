"""PTB-XL labels and splits, and the synthetic PTB-XL-shaped corpus.

A copy of the numpy part of the JAX package's ``data/datasets.py`` (the port
imports nothing of that package): label parsing (every key of a record's
``scp_codes`` is a label, ptb_dataset.py:42-45), the official strat_fold
splits (1-8 train, 9 eval, 10 test), the train-split statistics and the
synthetic generators, which give byte-equal outputs for the same seed
(``tests/test_torch_data.py``).  The HDF5 readers and the on-device
generator are not ported: the GPU machine has no h5py.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..registry import N_LEADS, PTBXL_ID2CODE, PTBXL_N_CLASS, TARGET_FQS
from ..train.trainer import SplitData


def parse_scp_codes(scp: Union[str, Dict]) -> List[int]:
    """scp_codes dict/str -> sorted class-id list (ptb_dataset.py:42-45)."""
    if isinstance(scp, str):
        scp = ast.literal_eval(scp)
    code2id = {c: i for i, c in enumerate(PTBXL_ID2CODE)}
    return sorted(code2id[c] for c in scp.keys() if c in code2id)


def labels_to_multi_hot(labels: Sequence[Sequence[int]],
                        n_class: int = PTBXL_N_CLASS) -> np.ndarray:
    out = np.zeros((len(labels), n_class), np.float32)
    for i, lbs in enumerate(labels):
        out[i, list(lbs)] = 1.0
    return out


def compute_train_stats(signals: np.ndarray, strat_fold: np.ndarray
                        ) -> Dict[str, List[float]]:
    """Per-lead mean/std over the train split (folds 1-8) -- the generator of
    the registry's PTBXL_TRAIN_STATS (reference set_ptbxl_train_stats,
    config.py:296-308).  Run this after exporting a new corpus/type."""
    tr, _, _ = split_by_strat_fold(np.asarray(strat_fold))
    arr = np.asarray(signals[tr], np.float64)
    return {
        'mean': np.nanmean(arr, axis=(0, 2)).tolist(),
        'std': np.nanstd(arr, axis=(0, 2)).tolist(),
    }


@dataclasses.dataclass
class PtbxlSplits:
    """train/eval/test splits (reference PtbxlSplitDatasets namedtuple)."""
    train: SplitData
    eval: SplitData
    test: SplitData


def split_by_strat_fold(strat_fold: np.ndarray,
                        n_sample: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Official folds: train < 9, eval == 9, test == 10 (ptb_dataset.py:110)."""
    idx = np.arange(strat_fold.size)
    tr = idx[strat_fold < 9]
    vl = idx[strat_fold == 9]
    ts = idx[strat_fold == 10]
    if n_sample is not None:
        tr, vl, ts = tr[:n_sample], vl[:n_sample], ts[:n_sample]
    return tr, vl, ts


def get_ptbxl_splits(
    signals: np.ndarray,
    labels: Sequence[Sequence[int]],
    strat_fold: np.ndarray,
    n_sample: Optional[int] = None,
) -> PtbxlSplits:
    """Assemble SplitData triple from materialized arrays + label id lists
    (``signals`` may also be a torch tensor: its rows are gathered where it
    lies)."""
    multi_hot = labels_to_multi_hot(labels)
    tr, vl, ts = split_by_strat_fold(np.asarray(strat_fold), n_sample)
    if n_sample is None:
        assert tr.size + vl.size + ts.size == signals.shape[0]

    def mk(idx):
        if isinstance(signals, np.ndarray):
            sig = np.ascontiguousarray(signals[idx])
        else:
            sig = signals[idx]
        return SplitData(signals=sig, labels=multi_hot[idx])
    return PtbxlSplits(train=mk(tr), eval=mk(vl), test=mk(ts))


def synth_ecg(rng: np.random.Generator, n: int, n_lead: int = N_LEADS,
              length: int = 2500, fqs: int = TARGET_FQS) -> np.ndarray:
    """ECG-morphology-ish synthetic 12-lead signals (QRS train + P/T-ish bumps
    + wander + noise), vectorized.  Not physiological -- just shaped like the
    real corpus for pipeline/throughput work.

    Generated in float32 CHUNKS: the naive single-shot f64 version allocates
    five (n, 12, L) float64 temporaries -- at the PTB-XL dress-rehearsal scale
    (21,837 x 12 x 2500) that is ~26 GB of allocator traffic on one host core;
    chunked f32 halves the arithmetic and bounds peak memory.  The cost is
    numpy's exp/sin over ~7e9 transcendental evaluations at that scale, on
    one host core (chip_smoke.py measures it per record)."""
    out = np.empty((n, n_lead, length), np.float32)
    t = (np.arange(length, dtype=np.float32) / np.float32(fqs))  # (L,)
    f32 = np.float32
    for lo in range(0, n, 2048):
        hi = min(lo + 2048, n)
        m = hi - lo
        hr = rng.uniform(0.8, 1.8, (m, 1, 1)).astype(f32)        # beats/sec
        phase0 = rng.uniform(0, 1, (m, 1, 1)).astype(f32)
        lead_gain = (rng.uniform(0.4, 1.6, (m, n_lead, 1))
                     * np.sign(rng.uniform(-0.3, 1.0, (m, n_lead, 1)))).astype(f32)
        phase = (t[None, None, :] * hr + phase0) % f32(1.0)
        qrs = np.exp(-((phase - f32(0.5)) ** 2) / f32(2 * 0.0006))
        qrs += f32(0.25) * np.exp(-((phase - f32(0.72)) ** 2) / f32(2 * 0.004))
        qrs += f32(0.12) * np.exp(-((phase - f32(0.35)) ** 2) / f32(2 * 0.002))
        beat = qrs * lead_gain
        beat += (f32(0.15) * np.sin(f32(2 * np.pi * 0.3) * t[None, None, :]
                                    + rng.uniform(0, 6, (m, 1, 1)).astype(f32))
                 + f32(0.08) * np.sin(f32(2 * np.pi * 0.07) * t[None, None, :]
                                      + rng.uniform(0, 6, (m, 1, 1)).astype(f32)))
        beat += f32(0.03) * rng.standard_normal((m, n_lead, length),
                                                dtype=np.float32)
        out[lo:hi] = beat
    return out


def synth_ptbxl(n: int = 512, seed: int = 77, length: int = 2500,
                n_marker_classes: int = 0, hard: bool = False
                ) -> Tuple[np.ndarray, List[List[int]], np.ndarray]:
    """Synthetic (signals, label-id lists, strat_fold) shaped like PTB-XL.

    Labels correlate weakly with signal statistics so a model can actually
    learn above-chance AUROC on it (used by the training smoke tests).

    ``n_marker_classes > 0`` switches to a multi-class quality benchmark:
    each class ``j < n_marker_classes`` independently present with p=0.4 and
    marked by a distinct-frequency tone, so macro-AUROC over those classes is
    a meaningful end-to-end learning metric (the default scheme only carries
    markers for two classes, leaving macro-AUROC near chance by design).

    ``hard=True`` (with ``n_marker_classes``) is the DISCRIMINATING quality
    benchmark (round-3): pure tones saturate macro-AUROC at 1.000, so a sound
    model instead lands in ~0.80-0.95 here and regressions move the number.
    Hardness comes from overlap and partial observability, not label noise:
      * PTB-XL-like long-tailed prevalence (p ~ 0.32 * 0.78^j, floor 0.05);
      * overlapping frequency bands: class centers 1.2 Hz apart with +-0.7 Hz
        per-record jitter, so neighboring classes' markers overlap;
      * random amplitude (log-normal, some markers barely above the noise),
        random phase, random 4-10-lead support, random time window (markers
        cover 45-100% of the record);
      * label-correlated confounders: a present class also injects its
        NEIGHBOR class's band with p=0.2 (spurious feature, label absent);
      * heteroscedastic noise: per-record sigma in [0.05, 0.22].
    """
    rng = np.random.default_rng(seed)
    signals = synth_ecg(rng, n, length=length)
    if n_marker_classes:
        t = np.arange(length, dtype=np.float32) / 250.0
        k = n_marker_classes
        if hard:
            prevalence = np.clip(0.32 * 0.78 ** np.arange(k), 0.05, None)
            present = rng.uniform(size=(n, k)) < prevalence[None, :]
            # spurious neighbor bands (injected, label NOT set)
            confound = present & (rng.uniform(size=(n, k)) < 0.2)
            for j in range(k):
                inject = np.nonzero(present[:, j])[0]
                spur = np.nonzero(confound[:, (j - 1) % k])[0]
                rows = np.concatenate([inject, spur])
                if rows.size == 0:
                    continue
                m = rows.size
                freq = 3.2 + 1.2 * j + rng.uniform(-0.7, 0.7, (m, 1))
                amp = 0.34 * rng.lognormal(0.0, 0.5, (m, 1)).astype(np.float32)
                phase = rng.uniform(0, 2 * np.pi, (m, 1))
                tone = (amp * np.sin(2 * np.pi * freq * t[None, :] + phase)
                        ).astype(np.float32)                      # (m, L)
                # random time window: start anywhere, span 45-100%
                span = rng.uniform(0.45, 1.0, (m, 1))
                start = rng.uniform(0, 1.0 - span, (m, 1))
                frac = np.arange(length, dtype=np.float32)[None, :] / length
                window = ((frac >= start) & (frac < start + span)
                          ).astype(np.float32)
                # random lead support, 4-10 of 12 leads
                leads = (np.argsort(rng.uniform(size=(m, N_LEADS)), axis=1)
                         < rng.integers(4, 11, (m, 1)))
                signals[rows] += (tone * window)[:, None, :] \
                    * leads[:, :, None].astype(np.float32)
            sigma = rng.uniform(0.05, 0.22, (n, 1, 1)).astype(np.float32)
            for lo in range(0, n, 2048):  # chunked f32: the f64 single-shot
                hi = min(lo + 2048, n)    # draw is 5.2 GB at dress-corpus scale
                signals[lo:hi] += sigma[lo:hi] * rng.standard_normal(
                    (hi - lo, N_LEADS, length), dtype=np.float32)
        else:
            present = rng.uniform(size=(n, k)) < 0.4
            for j in range(k):
                freq = 3.0 + 4.0 * j        # 3, 7, 11, ... Hz (< Nyquist)
                tone = 0.3 * np.sin(2 * np.pi * freq * t).astype(np.float32)
                signals[present[:, j]] += tone[None, None, :]
        labels = [sorted(np.nonzero(present[i])[0].tolist())
                  or [n_marker_classes] for i in range(n)]
        strat_fold = rng.integers(1, 11, size=n)
        return signals, labels, strat_fold
    # inject class-conditional morphology markers so the labels GENERALIZE
    # (not just signal-statistic medians, which barely separate test folds):
    # 'NORM' carries a 17 Hz oscillation, class 1 a slow baseline drift
    t = np.arange(length, dtype=np.float32) / 250.0
    tone = 0.35 * np.sin(2 * np.pi * 17.0 * t)
    drift = 0.5 * np.sin(2 * np.pi * 0.7 * t)
    has_tone = rng.uniform(size=n) < 0.5
    has_drift = rng.uniform(size=n) < 0.5
    signals[has_tone] += tone[None, None, :]
    signals[has_drift] += drift[None, None, :]
    labels: List[List[int]] = []
    norm_id = PTBXL_ID2CODE.index('NORM')
    for i in range(n):
        lbs = set()
        if has_tone[i]:
            lbs.add(norm_id)
        if has_drift[i]:
            lbs.add(1)
        if rng.uniform() < 0.15:
            lbs.add(int(rng.integers(2, PTBXL_N_CLASS)))
        if not lbs:
            lbs.add(4)
        labels.append(sorted(lbs))
    strat_fold = rng.integers(1, 11, size=n)
    return signals, labels, strat_fold
