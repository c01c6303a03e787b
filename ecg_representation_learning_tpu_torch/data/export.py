"""Corpus export jobs (the JAX package's ``data/export.py``): raw corpora ->
unified 250 Hz HDF5, native-rate stream shards, the record index, and the
denoised pass.

Reference parity (preprocess/data_export.py + preprocess_matlab/DataExport.m):
  * ``export_combined``: per-dataset glob via the registry ``rec_fmt``
    (data_export.py:61-66), threaded host reads (191-193; the native batch
    reader for same-shape fmt-16 batches), FFT resample to 250 Hz (205-215)
    on the device, fixed-length (N, 12, L) float32 HDF5 with JSON attrs
    (221-230).  Signals shorter than the pad length are zero-padded at the
    end; longer ones are truncated.  ``resample_chunk`` is its per-batch body
    on numpy arrays;
  * ``export_shards``: the streaming-pretrain shards at the corpus's NATIVE
    rate with an int16 wire (``clip(round(x * scale))``) and self-describing
    metadata; ``wire_chunk`` is its per-shard body;
  * ``export_records_csv``: the labels index (dataset / record / path
    columns, data_export.py:46, 164-173), through the stdlib ``csv`` module;
  * ``export_denoised``: the MATLAB batch-denoise script (DataExport.m:12-66)
    as a checkpointed device job -- RESUMABLE by skipping rows already
    nonzero in the output (DataExport.m:28-44), with the broken-record rule:
    an all-zero input lead stays all-zero instead of becoming NaN (record
    12722's lead 11, DataExport.m:46-54).  ``denoise_chunk`` is its per-chunk
    body.

``h5py`` is imported only by the functions that read or write HDF5 (the GPU
machine has neither h5py nor pandas): the per-batch bodies run anywhere.
"""
from __future__ import annotations

import csv
import glob as globlib
import json
import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import PreprocessConfig
from ..ops.preprocess import zheng_denoise
from ..ops.resample import resample_to
from ..registry import DATASETS, TARGET_FQS
from ..runtime import default_device
from ..utils.logging import get_logger
from .readers import BulkHdf5Reader, read_csv_record, read_header, read_many, read_record


def get_rec_paths(dataset_key: str, data_root: str) -> List[str]:
    """Record files per the registry glob (reference get_rec_paths, ecg.py:178-182)."""
    meta = DATASETS[dataset_key]
    pattern = os.path.join(data_root, meta.dir_name, meta.rec_fmt)
    return sorted(globlib.iglob(pattern, recursive=True))


def _rec_paths_or_raise(dataset_key: str, data_root: str) -> List[str]:
    paths = get_rec_paths(dataset_key, data_root)
    if not paths:
        raise FileNotFoundError(f'no records matched for {dataset_key} under {data_root}')
    return paths


def _strip_ext(path: str, ext: Optional[str]) -> str:
    return path[:-len(ext)] if ext else path


def _wfdb_native_batch(paths: Sequence[str], ext: Optional[str],
                       n_workers: int) -> Optional[List[np.ndarray]]:
    """Threaded C++ path for a homogeneous fmt-16 batch (incl. the
    '16+offset' CinC .mat layout); None when not applicable -> numpy path."""
    from .native import native_available, read_records_16_batch
    if not native_available():
        return None
    hdrs = [read_header(_strip_ext(p, ext) + '.hea') for p in paths]
    h0 = hdrs[0]
    if not all(h.n_sig == h0.n_sig and h.n_samples == h0.n_samples for h in hdrs):
        return None
    specs = [s for h in hdrs for s in h.signals]
    if not all(s.fmt == 16 and s.samples_per_frame == 1 for s in specs):
        return None
    if any(len({s.file_name for s in h.signals}) != 1 for h in hdrs):
        return None   # multi-.dat records: generic path
    gains = np.array([[s.gain for s in h.signals] for h in hdrs], np.float64)
    baselines = np.array([[s.baseline for s in h.signals] for h in hdrs], np.int32)
    offsets = np.array([h.signals[0].byte_offset for h in hdrs], np.int64)
    files = [os.path.join(os.path.dirname(_strip_ext(p, ext)), h.signals[0].file_name)
             for p, h in zip(paths, hdrs)]
    batch = read_records_16_batch(files, h0.n_sig, h0.n_samples, gains, baselines,
                                  offsets=offsets, n_threads=n_workers)
    return None if batch is None else list(batch)


def _batch_reader(dataset_key: str, paths: Sequence[str], n_workers: int = 8
                  ) -> Tuple[int, Callable[[int, int], List[np.ndarray]]]:
    """(n_records, read_batch(i0, i1)) -- never materializes the full corpus."""
    meta = DATASETS[dataset_key]
    if meta.reader == 'hdf5_bulk':
        rd = BulkHdf5Reader(paths[0])
        return len(rd), lambda i0, i1: [rd[i] for i in range(i0, i1)]
    if meta.reader == 'csv':
        return len(paths), lambda i0, i1: read_many(paths[i0:i1], read_csv_record, n_workers)
    ext = meta.rec_ext

    def read_batch(i0: int, i1: int) -> List[np.ndarray]:
        fast = _wfdb_native_batch(paths[i0:i1], ext, n_workers)
        if fast is not None:
            return fast
        return read_many(paths[i0:i1], lambda p: read_record(_strip_ext(p, ext))[0],
                         n_workers)

    return len(paths), read_batch


def _probe_max_len(dataset_key: str, paths: Sequence[str]) -> int:
    """Longest record length WITHOUT reading signal payloads: WFDB headers
    carry n_samples, bulk HDF5 carries its shape, CSVs are line-counted."""
    meta = DATASETS[dataset_key]
    if meta.reader == 'hdf5_bulk':
        return BulkHdf5Reader(paths[0]).record_length
    if meta.reader == 'csv':
        mx = 0
        for p in paths:
            with open(p, 'rb') as f:
                n = sum(buf.count(b'\n') for buf in iter(lambda: f.read(1 << 20), b''))
            mx = max(mx, n - 1)  # minus the CSV header row
        return mx
    return max(read_header(_strip_ext(p, meta.rec_ext) + '.hea').n_samples for p in paths)


def resample_chunk(chunk: Sequence[np.ndarray], src_fqs: int, fqs: int, tgt_len: int,
                   device: Optional[Union[str, torch.device]] = None) -> np.ndarray:
    """``export_combined``'s per-batch body: records (C, L_i) at ``src_fqs``
    -> (B, C, tgt_len) float32 at ``fqs``.  NaNs become 0, equal-length
    records are resampled together (FFT) on ``device`` (default: the GPU),
    then truncated or zero-padded at the end; the result must be finite."""
    dev = default_device(device)
    by_len = {}
    for j, s in enumerate(chunk):
        by_len.setdefault(s.shape[-1], []).append(j)
    out = np.zeros((len(chunk), chunk[0].shape[0], tgt_len), np.float32)
    for length, idxs in by_len.items():
        arr = np.stack([np.nan_to_num(chunk[j]) for j in idxs]).astype(np.float32, copy=False)
        res = resample_to(torch.from_numpy(arr).to(dev), src_fqs, fqs, method='fft')
        res = res.cpu().numpy()
        keep = min(res.shape[-1], tgt_len)
        out[idxs, :, :keep] = res[..., :keep]
    if not np.isfinite(out).all():  # reference data_export.py:199-200
        raise ValueError('non-finite values after resampling')
    return out


def export_combined(
    dataset_key: str,
    data_root: str,
    out_dir: str,
    fqs: int = TARGET_FQS,
    pad_length: Optional[int] = None,
    batch: int = 256,
    n_workers: int = 8,
    device: Optional[Union[str, torch.device]] = None,
) -> str:
    """Raw corpus -> ``{key}-combined.hdf5`` on the unified grid.

    Streaming: records are read, resampled on ``device`` and written one
    batch at a time, so peak host RAM is O(batch x record), never O(corpus).
    """
    import h5py
    logger = get_logger('ECG Record Export')
    meta = DATASETS[dataset_key]
    paths = _rec_paths_or_raise(dataset_key, data_root)
    logger.info(f'Exporting {dataset_key}: {len(paths)} records @ {meta.fqs} Hz')

    src_fqs = meta.fqs
    n, read_batch = _batch_reader(dataset_key, paths, n_workers)
    tgt_len = pad_length or int(round(_probe_max_len(dataset_key, paths) * fqs / src_fqs))
    c = read_batch(0, 1)[0].shape[0]
    out_path = os.path.join(out_dir, f'{dataset_key}-combined.hdf5')
    os.makedirs(out_dir, exist_ok=True)
    with h5py.File(out_path, 'w') as f:
        dset = f.create_dataset('data', shape=(n, c, tgt_len), dtype=np.float32)
        for i0 in range(0, n, batch):
            chunk = read_batch(i0, min(i0 + batch, n))
            dset[i0:i0 + len(chunk)] = resample_chunk(chunk, src_fqs, fqs, tgt_len, device)
        f.attrs['meta'] = json.dumps({'dnm': dataset_key, 'fqs': fqs})
    logger.info(f'Wrote {out_path} ({n} x {c} x {tgt_len})')
    return out_path


def wire_chunk(chunk: Sequence[np.ndarray], tgt_len: int, wire_dtype: str = 'int16',
               wire_scale: float = 1000.0) -> np.ndarray:
    """``export_shards``' per-shard body: records (C, L_i) -> (B, C, tgt_len)
    at their own rate, NaNs as 0, truncated or zero-padded at the end; as
    int16 counts ``clip(round(x * wire_scale))`` or as float32."""
    out = np.zeros((len(chunk), chunk[0].shape[0], tgt_len), np.float32)
    for j, s in enumerate(chunk):
        keep = min(s.shape[-1], tgt_len)
        out[j, :, :keep] = np.nan_to_num(s[:, :keep])
    if wire_dtype == 'int16':
        return np.clip(np.round(out * wire_scale), -32768, 32767).astype(np.int16)
    return out


def export_shards(
    dataset_key: str,
    data_root: str,
    out_dir: str,
    records_per_shard: int = 256,
    wire_dtype: str = 'int16',
    wire_scale: float = 1000.0,
    pad_length: Optional[int] = None,
    n_workers: int = 8,
) -> List[str]:
    """Raw corpus -> streaming-pretrain shard files (BASELINE config 5).

    Unlike :func:`export_combined` (the supervised path: resampled to the
    unified 250 Hz grid, float32), shards stay at the corpus's NATIVE rate --
    the fused resample + filter + normalize runs on the device inside the
    pretrain step (train/pretrain.py build_stream_step) -- and ship int16
    ADC-style counts (``round(x * wire_scale)``), which halves host -> device
    traffic.  Each shard carries its own metadata (``fqs``, ``wire_scale``,
    ``wire_dtype``) so ``cli pretrain --stream`` needs no per-corpus flags.

    Returns the shard paths, ``{key}-shard-0000.hdf5`` ... under ``out_dir``.
    """
    import h5py
    if wire_dtype not in ('int16', 'float32'):
        raise ValueError(f'wire_dtype {wire_dtype!r}: int16 or float32')
    logger = get_logger('ECG Shard Export')
    meta = DATASETS[dataset_key]
    paths = _rec_paths_or_raise(dataset_key, data_root)
    n, read_batch = _batch_reader(dataset_key, paths, n_workers)
    tgt_len = pad_length or _probe_max_len(dataset_key, paths)
    os.makedirs(out_dir, exist_ok=True)
    logger.info(f'Sharding {dataset_key}: {n} records @ {meta.fqs} Hz native, '
                f'{records_per_shard}/shard, wire {wire_dtype}')
    out_paths = []
    attrs = {'dnm': dataset_key, 'fqs': meta.fqs, 'wire_dtype': wire_dtype,
             'wire_scale': wire_scale if wire_dtype == 'int16' else None}
    for si, i0 in enumerate(range(0, n, records_per_shard)):
        chunk = read_batch(i0, min(i0 + records_per_shard, n))
        path = os.path.join(out_dir, f'{dataset_key}-shard-{si:04d}.hdf5')
        with h5py.File(path, 'w') as f:
            f.create_dataset('data', data=wire_chunk(chunk, tgt_len, wire_dtype, wire_scale))
            f.attrs['meta'] = json.dumps(attrs)
        out_paths.append(path)
    logger.info(f'Wrote {len(out_paths)} shards under {out_dir}')
    return out_paths


def read_shard_meta(path: str) -> dict:
    """The per-shard metadata written by :func:`export_shards` (native fqs,
    wire dtype/scale); {} for shards without it (plain write_combined_hdf5)."""
    import h5py
    with h5py.File(path, 'r') as f:
        raw = f.attrs.get('meta')
        return json.loads(raw) if raw else {}


def export_records_csv(dataset_keys: Sequence[str], data_root: str, out_path: str) -> str:
    """The labels/record index (reference export_record_info,
    data_export.py:164-173): one row per record, columns dataset, record,
    path, no index -- the bytes pandas' ``to_csv(index=False)`` writes."""
    rows = [(key, os.path.splitext(os.path.basename(p))[0], p)
            for key in dataset_keys for p in get_rec_paths(key, data_root)]
    os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
    with open(out_path, 'w', newline='') as f:
        if rows:
            w = csv.writer(f, lineterminator='\n')
            w.writerow(('dataset', 'record', 'path'))
            w.writerows(rows)
        else:
            f.write('\n')   # pandas' output for a frame without columns
    return out_path


def denoise_chunk(chunk: np.ndarray, fqs: int, cfg: PreprocessConfig = PreprocessConfig(),
                  device: Optional[Union[str, torch.device]] = None) -> np.ndarray:
    """Denoise (B, C, L) records at ``fqs`` Hz on ``device`` (default: the
    GPU): the Zheng chain, then all-zero input leads back to all zeros, then
    ``nan_to_num``.  Returns float32 numpy."""
    chunk = np.ascontiguousarray(chunk, np.float32)
    x = torch.from_numpy(chunk).to(default_device(device))
    den = zheng_denoise(x, fqs=fqs, cfg=cfg).cpu().numpy()
    zero_leads = ~np.any(chunk != 0, axis=-1)                  # (B, C)
    den = np.where(zero_leads[..., None], 0.0, den)
    return np.nan_to_num(den)


def export_denoised(
    combined_path: str,
    out_path: Optional[str] = None,
    cfg: PreprocessConfig = PreprocessConfig(),
    batch: int = 64,
    resume: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> str:
    """Combined -> denoised HDF5 via the device Zheng chain; resumable."""
    import h5py
    logger = get_logger('ECG Denoise Export')
    if out_path is None:
        if '-combined' in combined_path:
            out_path = combined_path.replace('-combined', '-denoised')
        else:
            base, ext = os.path.splitext(combined_path)
            out_path = f'{base}-denoised{ext}'
    if os.path.abspath(out_path) == os.path.abspath(combined_path):
        raise ValueError(f'the denoised output would overwrite its input {combined_path}')
    with h5py.File(combined_path, 'r') as src:
        data = src['data']
        attrs = json.loads(src.attrs['meta'])
        n, c, length = data.shape
        fqs = attrs['fqs']
        mode = 'r+' if (resume and os.path.exists(out_path)) else 'w'
        with h5py.File(out_path, mode) as dst:
            if 'data' not in dst:
                dst.create_dataset('data', shape=(n, c, length), dtype=np.float32)
                dst.attrs['meta'] = json.dumps({**attrs, 'denoised': True})
            out = dst['data']
            for i0 in range(0, n, batch):
                i1 = min(i0 + batch, n)
                if resume:  # skip rows already denoised (DataExport.m:28-44)
                    existing = out[i0:i1]
                    todo = ~np.any(existing != 0, axis=(1, 2))
                    if not todo.any():
                        continue
                else:
                    todo = np.ones(i1 - i0, bool)
                den = denoise_chunk(data[i0:i1], fqs, cfg, device)
                out[i0:i1] = np.where(todo[:, None, None], den, out[i0:i1])
                logger.info(f'denoised rows [{i0}, {i1})')
    return out_path
