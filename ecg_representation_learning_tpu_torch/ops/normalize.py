"""Per-lead normalization schemes (the JAX ``ops/normalize``).

Reference ``preprocess/transform.py``: fixed-stat ``Normalize``
(transform.py:18-35) and the ``DynamicNormalize`` family (transform.py:38-137)
with schemes 'global' (min/max), 'std' (mean / k*std), 'norm' (a percentile
range from a normal quantile) and 'none', chainable.  Statistics are fitted
once in numpy (f64) over an (N, C, L) array; the resulting (subtract,
divide) pairs are elementwise ops on the device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch


def _per_lead(values, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=x.dtype, device=x.device).reshape(-1, 1)


@dataclasses.dataclass(frozen=True)
class NormStats:
    """A single (subtract, divide) normalization, per lead.  Shapes (C,)."""
    sub: Tuple[float, ...]
    div: Tuple[float, ...]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (x - _per_lead(self.sub, x)) / _per_lead(self.div, x)


def normalize_fixed(x: torch.Tensor, mean: Union[Sequence[float], torch.Tensor],
                    std: Union[Sequence[float], torch.Tensor]) -> torch.Tensor:
    """Fixed per-lead (x - mean) / std of ``x`` (..., C, L) (reference
    Normalize, transform.py:29-35)."""
    return (x - _per_lead(mean, x)) / _per_lead(std, x)


NormScheme = Union[str, Tuple[str, float]]


def fit_dynamic_norm(arr: np.ndarray, schemes: Union[NormScheme, List[NormScheme]]
                     ) -> List[NormStats]:
    """Fit a (chain of) dynamic normalization(s) on an (N, C, L) array: each
    scheme's stats are computed after the previous schemes are applied
    (``DynamicNormalize``, transform.py:109-134).  Scheme arguments default
    to std -> 1, norm -> 2 (transform.py:57-59)."""
    from scipy.stats import norm as _norm
    if isinstance(schemes, (str, tuple)):   # one scheme; a list is a chain
        schemes = [schemes]
    out: List[NormStats] = []
    a = np.asarray(arr, np.float64)
    for sch in schemes:
        if isinstance(sch, str):
            name, arg = sch, None
        else:
            name, arg = sch[0], (sch[1] if len(sch) > 1 else None)
        if name == 'none':
            sub, div = np.zeros(a.shape[1]), np.ones(a.shape[1])
        elif name == 'global':
            mi, ma = np.nanmin(a, axis=(0, 2)), np.nanmax(a, axis=(0, 2))
            sub, div = mi, ma - mi
        elif name == 'std':
            arg = 1.0 if arg is None else float(arg)
            sub = np.nanmean(a, axis=(0, 2))
            div = np.nanstd(a, axis=(0, 2)) * arg
        elif name == 'norm':
            arg = 2.0 if arg is None else float(arg)
            p = _norm().cdf(arg) * 100.0
            lo = np.nanpercentile(a, 100 - p, axis=(0, 2))
            hi = np.nanpercentile(a, p, axis=(0, 2))
            sub, div = lo, hi - lo
        else:
            raise ValueError(f'Unknown normalization scheme {name!r}')
        out.append(NormStats(tuple(sub.astype(np.float32).tolist()),
                             tuple(div.astype(np.float32).tolist())))
        a = (a - sub.reshape((1, -1, 1))) / div.reshape((1, -1, 1))
    return out


def apply_norms(x: torch.Tensor, norms: List[NormStats]) -> torch.Tensor:
    for nrm in norms:
        x = nrm(x)
    return x
