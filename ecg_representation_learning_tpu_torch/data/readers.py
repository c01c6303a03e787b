"""Host-side record readers: WFDB (.hea/.dat), Chapman CSV, CODE-TEST bulk HDF5
(the JAX package's ``data/readers.py``).

The reference reads records through the ``wfdb`` package plus pandas/h5py
(util/ecg.py:202-217 ``fnm2sigs``: wfdb.rdsamp for the six WFDB corpora,
pd.read_csv for CHAP-SHAO, a bulk 'tracings' HDF5 for CODE-TEST).  Here:

  * ``.hea`` header parsing (record line + per-signal lines: file, format,
    samples-per-frame, gain(baseline)/units, adc res/zero, initial value);
  * signal formats 16 (int16 LE), 212 (packed 12-bit pairs -- INCART), 80
    (offset int8), 32 (int32 LE), 24; digital -> physical conversion
    ``(raw - baseline) / gain`` with WFDB's format-specific NaN sentinels;
  * multi-file (one .dat per record) layouts used by the registry corpora;
  * CHAP-SHAO CSVs through the stdlib ``csv`` module (the GPU machine has no
    pandas), with pandas' default NA strings; BulkHdf5Reader imports h5py
    when it is built.

Pure numpy and the standard library.  ``_decode_fmt`` takes the native
decoder (data/native.py) when it is available; the numpy decoders here are
its plain versions, equal bit for bit.  A threaded batch loader (the
reference's ``batched_conc_map`` file-reading concurrency, util/util.py:110-144)
feeds the export jobs.
"""
from __future__ import annotations

import concurrent.futures as cf
import csv
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class WfdbSignalSpec:
    file_name: str
    fmt: int
    samples_per_frame: int
    gain: float
    baseline: int
    units: str
    adc_res: int
    adc_zero: int
    init_value: int
    description: str
    byte_offset: int = 0
    checksum: Optional[int] = None   # signed 16-bit sum of digital samples


@dataclasses.dataclass
class WfdbHeader:
    record_name: str
    n_sig: int
    fs: float
    n_samples: int
    signals: List[WfdbSignalSpec]


_SIG_LINE = re.compile(
    r'^(?P<file>\S+)\s+(?P<fmt>\d+)(?:x(?P<spf>\d+))?(?::\d+)?(?:\+(?P<offset>\d+))?'
    r'(?:\s+(?P<gain>[-\d.e+]+)(?:\((?P<baseline>-?\d+)\))?(?:/(?P<units>\S+))?)?'
    r'(?:\s+(?P<adcres>-?\d+))?(?:\s+(?P<adczero>-?\d+))?(?:\s+(?P<initval>-?\d+))?'
    r'(?:\s+(?P<checksum>-?\d+))?(?:\s+(?P<blocksize>-?\d+))?(?:\s+(?P<desc>.*))?$'
)


def read_header(hea_path: str) -> WfdbHeader:
    """Parse a .hea header.

    Note: some G12EC headers carry a record name that differs from the file
    name (the reference ships a repair shim for this, data_export.py:18-30);
    this parser keys everything off the actual file paths, so the mismatch is
    harmless here -- no repair pass needed.
    """
    with open(hea_path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith('#')]
    rec = lines[0].split()
    name = rec[0].split('/')[0]
    n_sig = int(rec[1])
    fs = float(rec[2].split('/')[0]) if len(rec) > 2 else 250.0
    n_samples = int(rec[3]) if len(rec) > 3 else 0
    sigs = []
    for ln in lines[1:1 + n_sig]:
        m = _SIG_LINE.match(ln)
        if not m:
            raise ValueError(f'unparseable signal line in {hea_path}: {ln!r}')
        gain = float(m.group('gain') or 200.0)
        if gain == 0:
            gain = 200.0  # WFDB convention: 0 means default gain
        adc_zero = int(m.group('adczero') or 0)
        baseline = int(m.group('baseline')) if m.group('baseline') is not None else adc_zero
        sigs.append(WfdbSignalSpec(
            file_name=m.group('file'),
            fmt=int(m.group('fmt')),
            samples_per_frame=int(m.group('spf') or 1),
            gain=gain,
            baseline=baseline,
            units=m.group('units') or 'mV',
            adc_res=int(m.group('adcres') or 12),
            adc_zero=adc_zero,
            init_value=int(m.group('initval') or 0),
            description=(m.group('desc') or '').strip(),
            byte_offset=int(m.group('offset') or 0),
            checksum=(int(m.group('checksum'))
                      if m.group('checksum') is not None else None),
        ))
    return WfdbHeader(record_name=name, n_sig=n_sig, fs=fs,
                      n_samples=n_samples, signals=sigs)


def _decode_fmt212(raw: bytes, n_values: int) -> np.ndarray:
    """Unpack WFDB format 212: 2 12-bit samples per 3 bytes.

    An odd sample count leaves a trailing 2-byte group (the file holds
    ``ceil(1.5 * n)`` bytes, signal(5)); pad to a full triplet so the final
    sample is decoded instead of silently dropped."""
    b = np.frombuffer(raw, np.uint8)
    if b.size % 3:
        b = np.concatenate([b, np.zeros(3 - b.size % 3, np.uint8)])
    n_triplets = b.size // 3
    b = b[:n_triplets * 3].reshape(-1, 3).astype(np.int32)
    first = ((b[:, 1] & 0x0F) << 8) | b[:, 0]
    second = ((b[:, 1] & 0xF0) << 4) | b[:, 2]
    out = np.empty(n_triplets * 2, np.int32)
    out[0::2] = first
    out[1::2] = second
    out = np.where(out > 2047, out - 4096, out)  # sign-extend 12-bit
    return out[:n_values]


def _decode_fmt(raw: bytes, fmt: int, n_values: int) -> np.ndarray:
    from .native import decode_fmt as native_decode
    nd = native_decode(raw, fmt, n_values)
    if nd is not None:
        return nd
    if fmt == 16:
        return np.frombuffer(raw, '<i2', count=n_values).astype(np.int32)
    if fmt == 212:
        return _decode_fmt212(raw, n_values)
    if fmt == 80:
        return np.frombuffer(raw, np.uint8, count=n_values).astype(np.int32) - 128
    if fmt == 32:
        return np.frombuffer(raw, '<i4', count=n_values).astype(np.int32)
    if fmt == 24:
        b = np.frombuffer(raw, np.uint8)
        b = b[:n_values * 3].reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        return np.where(v >= 1 << 23, v - (1 << 24), v)
    raise NotImplementedError(f'WFDB format {fmt}')


# per-format invalid-sample sentinel (maps to NaN, WFDB convention)
_NAN_SENTINEL = {16: -32768, 212: -2048, 80: -128, 32: -(1 << 31), 24: -(1 << 23)}


def read_record(path_no_ext: str, physical: bool = True,
                verify_checksum: bool = False) -> Tuple[np.ndarray, WfdbHeader]:
    """Read one WFDB record -> ((n_sig, n_samples) array, header).

    Physical units: (digital - baseline) / gain, like wfdb.rdsamp's p_signal
    (transposed to leads-first as the reference's fnm2sigs does).

    ``verify_checksum=True`` additionally checks each signal's header
    checksum field (the signed 16-bit sum of its digital samples, header(5))
    against the decoded data and raises ``ValueError`` on mismatch -- an
    end-to-end guard over the byte decode.

    Handles the full signal-line dtype spec the registry corpora use
    (reference path: wfdb.rdsamp at util/ecg.py:202-217):

      * ``fmt+offset`` byte-offset payloads -- the CinC-style ``.mat`` records
        of G12EC / CSPC-CinC / CSPC-Extra-CinC are ``16+24`` (24-byte MATLAB
        Level-4 header before the int16 samples);
      * ``fmtxN`` samples-per-frame > 1 (multi-frequency records): each frame
        carries N consecutive samples for that signal; they are averaged down
        to the frame rate, matching wfdb.rdsamp's default smooth_frames=True.
    """
    hdr = read_header(path_no_ext + '.hea')
    base_dir = os.path.dirname(path_no_ext)
    # group signals by the .dat file they live in (usually one file, interleaved)
    by_file: Dict[str, List[int]] = {}
    for i, s in enumerate(hdr.signals):
        by_file.setdefault(s.file_name, []).append(i)
    out = np.empty((hdr.n_sig, hdr.n_samples), np.float32 if physical else np.int32)
    for fname, idxs in by_file.items():
        fmt = hdr.signals[idxs[0]].fmt
        offset = hdr.signals[idxs[0]].byte_offset
        if any(hdr.signals[i].fmt != fmt for i in idxs):
            raise ValueError(f'mixed formats within {fname}')
        if any(hdr.signals[i].byte_offset != offset for i in idxs):
            raise ValueError(f'mixed byte offsets within {fname}')
        spfs = [hdr.signals[i].samples_per_frame for i in idxs]
        frame_width = sum(spfs)  # samples per frame across this file's signals
        with open(os.path.join(base_dir, fname), 'rb') as f:
            if offset:
                f.seek(offset)
            raw = f.read()
        vals = _decode_fmt(raw, fmt, frame_width * hdr.n_samples)
        frames = vals.reshape(hdr.n_samples, frame_width)
        sentinel = _NAN_SENTINEL.get(fmt)
        col = 0
        for spf, sig_idx in zip(spfs, idxs):
            spec = hdr.signals[sig_idx]
            d = frames[:, col:col + spf]  # (n_frames, spf)
            col += spf
            if verify_checksum and spec.checksum is not None:
                got = int(d.astype(np.int64).sum()) & 0xFFFF
                want = spec.checksum & 0xFFFF
                if got != want:
                    raise ValueError(
                        f'{path_no_ext}: checksum mismatch on signal '
                        f'{sig_idx} ({spec.description!r}): header '
                        f'{spec.checksum} vs decoded sum {got} (mod 2^16)')
            if physical:
                p = (d.astype(np.float32) - spec.baseline) / spec.gain
                if sentinel is not None:
                    p = np.where(d == sentinel, np.nan, p)
                out[sig_idx] = p.mean(axis=1) if spf > 1 else p[:, 0]
            else:
                out[sig_idx] = (np.round(d.mean(axis=1)).astype(np.int32)
                                if spf > 1 else d[:, 0])
    return out, hdr


# ---------------------------------------------------------------------------
# Non-WFDB corpus readers (reference fnm2sigs branches, util/ecg.py:202-217)
# ---------------------------------------------------------------------------
# pandas.read_csv's default NA strings (its ``na_values`` default)
_NA_STRINGS = frozenset({
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan', '1.#IND',
    '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a', 'nan', 'null'})


def _csv_value(v: str) -> float:
    return float('nan') if v in _NA_STRINGS else float(v)


def read_csv_record(path: str) -> np.ndarray:
    """CHAP-SHAO: one CSV per record, a header row of lead names, columns =
    leads -> (12, L) float32; the values of ``pd.read_csv(path).to_numpy().T``
    (blank lines skipped, pandas' NA strings as NaN), parsed correctly
    rounded to float64, then cast."""
    with open(path, newline='') as f:
        header, *rows = [r for r in csv.reader(f) if r]
    vals = np.array([[_csv_value(v) for v in r] for r in rows], np.float64)
    return vals.reshape(len(rows), len(header)).T.astype(np.float32)


class BulkHdf5Reader:
    """CODE-TEST: one HDF5 with all tracings; index by record number."""

    def __init__(self, path: str, dataset: str = 'tracings'):
        import h5py
        self._file = h5py.File(path, 'r')
        self._data = self._file[dataset]

    def __len__(self):
        return self._data.shape[0]

    @property
    def record_length(self) -> int:
        """Time-axis length (stored (N, L, 12) or (N, 12, L); L is the
        larger trailing dim, mirroring __getitem__'s orientation fix)."""
        return max(self._data.shape[1], self._data.shape[2])

    def __getitem__(self, idx: int) -> np.ndarray:
        arr = np.asarray(self._data[idx], np.float32)
        if arr.ndim == 2 and arr.shape[0] > arr.shape[1]:
            arr = arr.T  # stored (L, 12) -> (12, L)
        return arr


def read_many(paths: Sequence[str], reader, n_workers: int = 8) -> List[np.ndarray]:
    """Thread-pool batch read (the reference's conc_map/batched_conc_map role,
    util/util.py:110-144 -- file I/O releases the GIL)."""
    with cf.ThreadPoolExecutor(max_workers=n_workers) as ex:
        return list(ex.map(reader, paths))
