"""The serving cell's traffic from its seed, in numpy alone (the load
generator's process imports nothing else): the records a client sends and
the open-loop schedule of requests.

Every seed sends the same number of requests with the same set of gaps
between arrivals and the same number of long records; the seed orders them
and makes the records' values.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List

import numpy as np

GAPS_SEED = 0x6A95   # the fixed set of inter-arrival gaps that every seed reorders


def ecg_waves(rng: np.random.Generator, n: int, leads: int, length: int,
              fqs: float) -> np.ndarray:
    """(n, leads, length) ECG-like signals in mV (see ``inputs.ecg_waves``)."""
    t = np.arange(length) / fqs
    hr = 0.8 + rng.random((n, 1, 1))
    phase = 2 * math.pi * rng.random((n, 1, 1))
    gain = (0.4 + 1.2 * rng.random((n, leads, 1))) * np.where(
        rng.random((n, leads, 1)) < 0.2, -1.0, 1.0)
    x = np.zeros((n, leads, length))
    for k, a in enumerate((0.6, 0.35, 0.2, 0.12, 0.07), start=1):
        x += a * np.sin(2 * math.pi * k * hr * t + k * phase)
    x *= gain
    x += 0.1 * np.sin(2 * math.pi * 0.2 * t + 6 * rng.random((n, 1, 1)))
    return x + 0.03 * rng.standard_normal((n, leads, length))


def pools(traffic: dict, leads: int, seed: int) -> Dict[str, np.ndarray]:
    """The records requests draw from: ``rest`` (pool_rest, leads,
    rest_samples) and ``long`` (pool_long, leads, long_samples), rounded to
    the decimals a client sends, in float64 as they are written."""
    rng = np.random.default_rng([seed, 1])
    d = traffic['decimals']
    return {'rest': ecg_waves(rng, traffic['pool_rest'], leads, traffic['rest_samples'],
                              250.0).round(d),
            'long': ecg_waves(rng, traffic['pool_long'], leads, traffic['long_samples'],
                              250.0).round(d)}


def bodies(traffic: dict, leads: int, seed: int) -> Dict[str, List[bytes]]:
    """Each pool record as the JSON body of a batch-1 ``/predict`` request."""
    out = {}
    for kind, recs in pools(traffic, leads, seed).items():
        out[kind] = [json.dumps({'signals': [r.tolist()], 'top_k': 5}).encode() for r in recs]
    return out


def schedule(traffic: dict, seed: int, rate: float, seconds: float) -> Dict[str, np.ndarray]:
    """The requests of an open loop at ``rate`` per second over ``seconds``:
    ``due`` (s from the start), ``long`` (bool) and ``record`` (index into
    its kind's pool)."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(GAPS_SEED).exponential(1.0, n)
    gaps *= seconds / gaps.sum()            # the n arrivals span the window
    rng = np.random.default_rng([seed, 2])
    order = rng.permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(order)[:-1]])
    n_long = int(round(traffic['long_share'] * n))
    is_long = rng.permutation(np.arange(n) < n_long)
    record = np.where(is_long, rng.integers(0, traffic['pool_long'], n),
                      rng.integers(0, traffic['pool_rest'], n))
    return {'due': due, 'long': is_long, 'record': record}


def check_sample(sched: Dict[str, np.ndarray], size: int, seed: int) -> np.ndarray:
    """Indices of the requests whose answers the check compares: every long
    request (up to half the sample) and the rest drawn at random."""
    rng = np.random.default_rng([seed, 3])
    longs = np.flatnonzero(sched['long'])
    longs = rng.permutation(longs)[:size // 2]
    rest = np.flatnonzero(~sched['long'])
    rest = rng.permutation(rest)[:size - len(longs)]
    return np.sort(np.concatenate([longs, rest]))
