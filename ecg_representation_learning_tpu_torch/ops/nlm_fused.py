"""Fused 1-D non-local means, with a hand-written Hopper kernel.

Counterpart of the JAX package's ``ops/nlm_pallas.py`` (the Pallas
``_nlm_kernel``, here ``csrc/nlm.cu``).  Same semantics as :func:`.nlm.nlm`
(the reference Darbon/Zheng algorithm, data_preprocessor.py:83-148, with the
``0 < i+shift < n`` target guard and edge passthrough), in the kernel's form:
each step takes the pair {+s, -s} of one shift magnitude s < sch_wd, one SSD,
one (2*patch_wd+1)-tap box sum and one exp serving both directions through
the identity d_{-s}[i] = d_s[i-s], and multiplies by 1/h where the scan form
divides by h.

The kernel is bound by the operations each needed weight costs (SSD, box
sum, an accurate exp, the accumulations).  It splits a row's shifts over the
blocks of a thread block cluster, whose size it chooses from the card's SMs
(``cluster_size`` reports it), and sums their partials in a fixed order (no
atomics: the same bits every call); at pw = 10 and rows of up to 4096 a
thread forms 11 consecutive weights per shift in registers with an add-only
box sum, and the -s term reads the weights from a shared row (one barrier per
shift); other widths and longer rows take a generic, segmented branch
(``csrc/nlm.cu``'s header has the design).

``nlm_rows`` launches the kernel for a CUDA tensor (``nlm_rows_kernel``, one
launch per call) and runs the plain ``nlm_rows_reference`` for a CPU tensor.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .nlm import est_noise_std

EPS = float(np.finfo(np.float64).eps)  # sys.float_info.epsilon parity
# the kernel's switches, each on in nlm_rows: the box sum, the exp, the -s
# term, the masked accumulation (tools/nlm_sol_probe.py turns them off)
FLAGS = ('boxtree', 'exp', 'mirror', 'accum')


def nlm_rows_reference(x2: torch.Tensor, h2: torch.Tensor, sch_wd: int, patch_wd: int,
                       *, boxtree: bool = True, exp: bool = True, mirror: bool = True,
                       accum: bool = True, eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x2 (R, L) rows, h2 (R,) bandwidths.

    One step per shift magnitude s < sch_wd: ssd = (x - x[k+s])^2 masked where
    k+s >= L, a direct box sum over [i - patch_wd, i + patch_wd] (taps outside
    the row count 0), w = exp(-dist * (1/h)); the +s term where i+s < L and
    the -s term, w[i-s] x[i-s], where i-s > 0; num/(z + eps) on the interior
    patch_wd+1 <= i < L-patch_wd, x elsewhere.  With switches off it is the
    matching attribution variant of ``tools/nlm_sol_probe.py``.
    """
    r, n = x2.shape
    pw = patch_wd
    hinv = (1.0 / h2)[:, None]
    pos = torch.arange(n, device=x2.device)
    interior = (pos >= pw + 1) & (pos < n - pw)
    xpad = F.pad(x2, (0, sch_wd))
    num = torch.zeros_like(x2)
    z = torch.zeros_like(x2)
    for s in range(sch_wd):
        xs = xpad[:, s:s + n]                                  # x[k+s], 0 past the end
        valid_tail = pos + s < n
        ssd = torch.where(valid_tail, (x2 - xs) ** 2, 0.0)
        dist = F.pad(ssd, (pw, pw)).unfold(-1, 2 * pw + 1, 1).sum(-1) if boxtree else ssd
        w = torch.exp(-dist * hinv) if exp else dist * hinv
        if not accum:
            num = num + w
            z = z + w
            continue
        wp = torch.where(interior & valid_tail, w, 0.0)
        num = num + wp * xs
        z = z + wp
        if mirror and 0 < s < n:
            wm = F.pad(w[:, :n - s], (s, 0))                   # w[i-s]
            xm = F.pad(x2[:, :n - s], (s, 0))                  # x[i-s]
            wmv = torch.where(interior & (pos - s > 0), wm, 0.0)
            num = num + wmv * xm
            z = z + wmv
    den = num / (z + eps)
    return torch.where(interior, den, x2)


_P, _I = ctypes.c_void_p, ctypes.c_int
# ``csrc/nlm.cu``'s entries: nlm_rows(x, hinv, out, rows, n, sch, pw, stream),
# nlm_variant (the four switches before the stream), nlm_rows_cluster
ARGTYPES = {'nlm_rows': [_P] * 3 + [_I] * 4 + [_P],
            'nlm_variant': [_P] * 3 + [_I] * (4 + len(FLAGS)) + [_P],
            'nlm_rows_cluster': [_I] * 4}
NLM = _build.CtypesLibrary('nlm', ARGTYPES)


def nlm_rows_kernel(x2: torch.Tensor, hinv: torch.Tensor, sch_wd: int, patch_wd: int,
                    flags: Optional[dict] = None) -> torch.Tensor:
    """One launch of ``nlm_rows``, or with ``flags`` of its attribution
    variant ``nlm_variant``, counted under the entry's name: rows ``x2``
    (R, L) f32 and ``hinv`` (R,) f32, both contiguous on one CUDA device;
    returns the (R, L) output."""
    if x2.dim() != 2 or x2.dtype != torch.float32 or not x2.is_contiguous():
        raise ValueError(f'x2 must be a contiguous (R, L) float32 tensor, got '
                         f'{tuple(x2.shape)} {x2.dtype}')
    if (hinv.shape != x2.shape[:1] or hinv.dtype != torch.float32
            or hinv.device != x2.device or not hinv.is_contiguous()):
        raise ValueError(f'hinv must be ({x2.shape[0]},) contiguous float32 on '
                         f'{x2.device}, got {tuple(hinv.shape)} {hinv.dtype} '
                         f'{hinv.device}')
    if x2.device.type != 'cuda':
        raise ValueError(f'nlm kernel takes CUDA tensors, got {x2.device}')
    if sch_wd < 1 or patch_wd < 0:
        raise ValueError(f'need sch_wd >= 1 and patch_wd >= 0, got {sch_wd}, {patch_wd}')
    out = torch.empty_like(x2)
    entry = 'nlm_rows' if flags is None else 'nlm_variant'
    switches = [] if flags is None else [int(flags.get(k, True)) for k in FLAGS]
    NLM.launch(entry, entry, x2.device, (x2.data_ptr(), hinv.data_ptr(), out.data_ptr(),
                                         x2.shape[0], x2.shape[1], sch_wd, patch_wd,
                                         *switches))
    return out


def cluster_size(rows: int, n: int, sch_wd: int, patch_wd: int) -> int:
    """The thread block cluster size (blocks that split a row's shifts)
    that ``nlm_rows`` launches with for these arguments on the current CUDA
    device; the kernel chooses it from the card's SMs."""
    c = NLM.value('nlm_rows_cluster', rows, n, sch_wd, patch_wd)
    if c < 1:
        raise RuntimeError(f'nlm_rows_cluster failed: CUDA error {-c}')
    return c


def nlm_rows(x2: torch.Tensor, h2: torch.Tensor, sch_wd: int, patch_wd: int) -> torch.Tensor:
    """NLM of the rows ``x2`` (R, L) with bandwidths ``h2`` (R,): one kernel
    launch for CUDA tensors, the plain version for CPU tensors."""
    dev = x2.device.type
    if dev == 'cuda':
        return nlm_rows_kernel(x2.contiguous(), (1.0 / h2).contiguous(), sch_wd, patch_wd)
    if dev == 'cpu':
        return nlm_rows_reference(x2, h2, sch_wd, patch_wd)
    raise RuntimeError(f'no nlm for device {x2.device}')


def nlm_fused(
    x: torch.Tensor,
    scale: float = 1.5,
    sch_wd: Optional[int] = None,
    patch_wd: int = 10,
) -> torch.Tensor:
    """Drop-in fast path for :func:`.nlm.nlm` (same signature and semantics):
    the counterpart of the JAX ``nlm_pallas``, whose TPU tiling arguments
    (``block_rows``, ``interpret``) have no meaning here and are dropped."""
    n = x.shape[-1]
    if sch_wd is None:
        sch_wd = n
    h = nlm_bandwidth(x, scale, patch_wd)
    out = nlm_rows(x.reshape(-1, n).float(), h.reshape(-1).float(), int(sch_wd),
                   int(patch_wd))
    return out.reshape(x.shape)


def nlm_bandwidth(x: torch.Tensor, scale: float = 1.5, patch_wd: int = 10) -> torch.Tensor:
    """h = 2 (2 patch_wd + 1) (scale sigma)^2 per row, sigma from
    :func:`.nlm.est_noise_std`; shape ``x.shape[:-1]``."""
    return 2.0 * (2 * patch_wd + 1) * (scale * est_noise_std(x)) ** 2


def needed_weights(n: int, sch_wd: int, patch_wd: int) -> int:
    """Number of (position, s) pairs whose weight one row's NLM needs: for
    each s, the span from the first to the last position that a +s term
    (interior i with i+s < n) or a -s term (p = i-s > 0) reads.  The kernel
    forms these and a few more: its register branch every weight of a
    thread's 11-position run that meets the span, its generic branch the span
    of each segment (and, for a row split into segments, the -s window before
    it, formed again by that segment's block).  chip_smoke.py counts the
    operations the rows need from this number, not what the kernel forms."""
    lo, hi = patch_wd + 1, n - patch_wd
    total = 0
    for s in range(min(sch_wd, n)):
        plus = (lo, min(hi, n - s))
        minus = (max(lo - s, 1), hi - s) if s > 0 else (0, 0)
        spans = [iv for iv in (plus, minus) if iv[0] < iv[1]]
        if spans:
            a = min(iv[0] for iv in spans)
            b = max(iv[1] for iv in spans)
            total += b - a
    return total
