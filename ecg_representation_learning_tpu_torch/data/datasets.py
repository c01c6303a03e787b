"""PTB-XL labels and splits, the combined-HDF5 corpus, and the synthetic
PTB-XL-shaped corpora.

A copy of the JAX package's ``data/datasets.py`` (the port imports nothing
of that package):

  * ``EcgDataset`` (reference preprocess/dataset.py:22-99): one combined or
    denoised HDF5 of shape (N, C, L) with JSON attrs; asserts the stored
    250 Hz grid (dataset.py:42) and masks all-zero records of a partially
    denoised file (``idxs_processed``, dataset.py:53-58);
  * PTB-XL labels (ptb_dataset.py:28-50): every key of a record's
    ``scp_codes`` is a label (likelihoods ignored); ``export_ptbxl_labels``
    writes the ``ptb-xl-labels.csv`` index, ``load_ptbxl_from_export`` reads
    it with the HDF5 into the official strat_fold splits (1-8 train, 9 eval,
    10 test);
  * the synthetic generators, which give byte-equal outputs for the same
    seed (``tests/test_torch_data.py``), and ``synth_ptbxl_device``, the hard
    corpus generated on the device.

h5py is imported inside the functions that read or write HDF5, and the CSVs
go through the standard library's ``csv`` module: the GPU machine has
neither h5py nor pandas, and the port imports there.  The CSVs round-trip
with the JAX package's pandas readers and writers (``scp_codes`` are quoted
dict strings, ``labels`` is ``str(list)``, the label index keeps the
``ecg_id`` column).
"""
from __future__ import annotations

import ast
import csv
import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..registry import N_LEADS, PTBXL_ID2CODE, PTBXL_N_CLASS, TARGET_FQS
from ..runtime import default_device
from ..train.trainer import SplitData


# ---------------------------------------------------------------------------
# HDF5-backed dataset (reference EcgDataset)
# ---------------------------------------------------------------------------
class EcgDataset:
    """The ``{dnm}-combined/denoised.hdf5`` layout (data_export.py:221-230):
    dataset 'data' of (N, C, L) and JSON 'meta' attrs."""

    def __init__(self, path: str, fqs: int = TARGET_FQS):
        import h5py
        self.path = path
        self._file = h5py.File(path, 'r')
        self.dataset = self._file['data']
        self.attrs = json.loads(self._file.attrs['meta'])
        assert self.attrs['fqs'] == fqs, (self.attrs['fqs'], fqs)
        # partially-denoised tolerance: mask all-zero records (dataset.py:53-58)
        probe = np.asarray(self.dataset[:, 0, :8])  # cheap any-nonzero probe
        if np.any(probe != 0, axis=-1).all():
            self.is_full = True
            self.idxs_processed = np.arange(self.dataset.shape[0])
        else:
            full = np.asarray([np.any(self.dataset[i] != 0)
                               for i in range(self.dataset.shape[0])])
            self.is_full = bool(full.all())
            self.idxs_processed = np.nonzero(full)[0]

    def __len__(self):
        return self.dataset.shape[0] if self.is_full else self.idxs_processed.size

    def load(self, idxs=None) -> np.ndarray:
        """Rows as float32 (the HDF5 stores float32/64); by default the
        processed ones."""
        if idxs is None:
            idxs = self.idxs_processed if not self.is_full else slice(None)
        return np.asarray(self.dataset[idxs], np.float32)

    def close(self):
        self._file.close()


def write_combined_hdf5(path: str, signals: np.ndarray, dataset_name: str = 'PTB-XL',
                        fqs: int = TARGET_FQS) -> str:
    """Write the reference's combined-HDF5 layout (data_export.py:221-230):
    'data' dataset + JSON 'meta' attrs with dnm/fqs."""
    import h5py
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with h5py.File(path, 'w') as f:
        f.create_dataset('data', data=np.asarray(signals).astype(np.float32))
        f.attrs['meta'] = json.dumps({'dnm': dataset_name, 'fqs': fqs})
    return path


def parse_scp_codes(scp: Union[str, Dict]) -> List[int]:
    """scp_codes dict/str -> sorted class-id list (ptb_dataset.py:42-45)."""
    if isinstance(scp, str):
        scp = ast.literal_eval(scp)
    code2id = {c: i for i, c in enumerate(PTBXL_ID2CODE)}
    return sorted(code2id[c] for c in scp.keys() if c in code2id)


def _write_csv(path: str, header: Sequence[str], rows) -> str:
    """A CSV as pandas' ``to_csv`` writes it: minimal quoting, ``\n``."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w', newline='') as f:
        writer = csv.writer(f, lineterminator='\n')
        writer.writerow(header)
        writer.writerows(rows)
    return path


def export_ptbxl_labels(database_csv: str, out_csv: str) -> str:
    """Build the ``ptb-xl-labels.csv`` index (columns ecg_id, patient_id,
    strat_fold, labels) from ``ptbxl_database.csv`` (reference
    export_ptbxl_labels, ptb_dataset.py:28-50): every key of each record's
    ``scp_codes`` is a binary label; likelihoods are ignored."""
    with open(database_csv, newline='') as f:
        rows = [(int(r['ecg_id']), int(float(r['patient_id'])), int(r['strat_fold']),
                 str(parse_scp_codes(r['scp_codes']))) for r in csv.DictReader(f)]
    return _write_csv(out_csv, ['ecg_id', 'patient_id', 'strat_fold', 'labels'], rows)


def write_labels_csv(path: str, labels: Sequence[Sequence[int]],
                     strat_fold: np.ndarray) -> str:
    """The label table ``cli synth`` writes: columns strat_fold, labels (no
    index column)."""
    return _write_csv(path, ['strat_fold', 'labels'],
                      ((int(f), str(list(lbs))) for f, lbs in zip(strat_fold, labels)))


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


def load_ptbxl_from_export(h5_path: str, labels_csv: str,
                           n_sample: Optional[int] = None) -> PtbxlSplits:
    """The exported PTB-XL HDF5 and its label index (columns strat_fold and
    labels, reference ptb-xl-labels.csv, ptb_dataset.py:106-110) as the
    official splits.  Every row of the HDF5 is loaded, masked or not, as the
    reference does."""
    ds = EcgDataset(h5_path)
    try:
        signals = ds.load(slice(None))
    finally:
        ds.close()
    with open(labels_csv, newline='') as f:
        rows = list(csv.DictReader(f))
    labels = [ast.literal_eval(r['labels']) for r in rows]
    folds = np.asarray([int(r['strat_fold']) for r in rows], np.int64)
    return get_ptbxl_splits(signals, labels, folds, n_sample)


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


def synth_ptbxl_device(n: int = 512, seed: int = 77, length: int = 2500,
                       n_marker_classes: int = 16, chunk: int = 4096, device=None,
                       noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, List[List[int]], np.ndarray]:
    """The hard multi-class marker corpus (``synth_ptbxl(hard=True)``)
    generated on the device: (signals (n, 12, L) f32 tensor on ``device``,
    label-id lists, strat_fold).

    The host draws only the per-record parameters, with the JAX package's
    ``np.random.default_rng(seed)`` calls in its order, so labels and folds
    equal JAX's; the signals are computed on the device ``chunk`` records at
    a time in JAX's operation order.  The two white-noise fields (0.03 and
    the per-record sigma times a standard normal) come from a device
    ``torch.Generator`` seeded with ``seed``, one draw of each per chunk:
    their bits differ from ``jax.random``'s, so the corpus is the same
    distribution as JAX's, not the same bits.  ``noise`` replaces them with
    two given (n, 12, L) standard normal fields (a test replays JAX's)."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    k = n_marker_classes
    c = N_LEADS
    f32 = np.float32

    # host: per-record parameters (as synth_ecg draws them)
    hr = rng.uniform(0.8, 1.8, (n, 1, 1)).astype(f32)
    phase0 = rng.uniform(0, 1, (n, 1, 1)).astype(f32)
    lead_gain = (rng.uniform(0.4, 1.6, (n, c, 1))
                 * np.sign(rng.uniform(-0.3, 1.0, (n, c, 1)))).astype(f32)
    wander_ph = rng.uniform(0, 6, (n, 2, 1, 1)).astype(f32)

    # host: marker parameters (as synth_ptbxl(hard=True) draws them)
    prevalence = np.clip(0.32 * 0.78 ** np.arange(k), 0.05, None)
    present = rng.uniform(size=(n, k)) < prevalence[None, :]
    confound = present & (rng.uniform(size=(n, k)) < 0.2)
    # class j's band is injected where j is present or the (j-1) confound
    # fires (a spurious neighbour band, label not set)
    active = (present | np.roll(confound, 1, axis=1)).astype(f32)
    freq = (3.2 + 1.2 * np.arange(k)[None, :]
            + rng.uniform(-0.7, 0.7, (n, k))).astype(f32)
    amp = (0.34 * rng.lognormal(0.0, 0.5, (n, k))).astype(f32)
    mphase = rng.uniform(0, 2 * np.pi, (n, k)).astype(f32)
    span = rng.uniform(0.45, 1.0, (n, k)).astype(f32)
    start = (rng.uniform(0, 1, (n, k)) * (1.0 - span)).astype(f32)
    leads = (np.argsort(rng.uniform(size=(n, k, c)), axis=2)
             < rng.integers(4, 11, (n, k, 1))).astype(f32)
    sigma = rng.uniform(0.05, 0.22, (n, 1, 1)).astype(f32)
    labels = [sorted(np.nonzero(present[i])[0].tolist()) or [k] for i in range(n)]
    strat_fold = rng.integers(1, 11, size=n)

    # device: the (n, C, L) tensor, chunk by chunk
    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    t = (torch.arange(length, dtype=torch.float32, device=dev)
         / torch.tensor(TARGET_FQS, dtype=torch.float32, device=dev))
    frac = (torch.arange(length, dtype=torch.float32, device=dev)
            / torch.tensor(length, dtype=torch.float32, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty((n, c, length), dtype=torch.float32, device=dev)
    two_pi = 2 * math.pi
    for lo in range(0, n, chunk):
        sl = slice(lo, min(lo + chunk, n))
        m = sl.stop - lo
        if noise is None:
            white = torch.randn((m, c, length), generator=gen, device=dev)
            marker_noise = torch.randn((m, c, length), generator=gen, device=dev)
        else:
            white, marker_noise = (x[sl].to(dev, torch.float32) for x in noise)
        hr_, ph0, gain, wph, act, fr, am, mph, st, sp, ld, sg = (
            on_dev(a[sl]) for a in (hr, phase0, lead_gain, wander_ph, active, freq, amp,
                                    mphase, start, span, leads, sigma))
        phase = torch.remainder(t[None, None, :] * hr_ + ph0, 1.0)
        qrs = torch.exp(-torch.square(phase - 0.5) / (2 * 0.0006))
        qrs += 0.25 * torch.exp(-torch.square(phase - 0.72) / (2 * 0.004))
        qrs += 0.12 * torch.exp(-torch.square(phase - 0.35) / (2 * 0.002))
        beat = qrs * gain
        beat += (0.15 * torch.sin(two_pi * 0.3 * t[None, None, :] + wph[:, 0])
                 + 0.08 * torch.sin(two_pi * 0.07 * t[None, None, :] + wph[:, 1]))
        beat += 0.03 * white
        end = st + sp
        for j in range(k):
            tone = am[:, j, None] * torch.sin(two_pi * fr[:, j, None] * t[None, :]
                                              + mph[:, j, None])        # (m, L)
            window = (frac[None, :] >= st[:, j, None]) & (frac[None, :] < end[:, j, None])
            gate = act[:, j, None] * (tone * window)                    # (m, L)
            beat += gate[:, None, :] * ld[:, j, :, None]
        beat += sg * marker_noise
        out[sl] = beat
    return out, labels, strat_fold
