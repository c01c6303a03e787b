"""The port's DSP modules against the JAX package on the same numpy inputs:
``ops/filter``, ``ops/loess``, ``ops/nlm`` (noise estimate and the scan form)
and ``ops/resample``.

Both sides compute in float32 on the CPU.  Tolerances: exact where the two
run the same host code (scipy designs) or the same comparisons (the bisection
median); 1e-5 of the output's scale where the two sum the same products in a
different order (the framed Toeplitz products, the scan); 5e-5 for LOESS,
whose 3x3 Cramer solve cancels (each side alone is up to 1.6e-5 off a float64
run of the same code); the JAX package's own rtol 1e-4 for the noise estimate.
"""
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal, stats

# the JAX ops package re-exports functions under the modules' names, so the
# modules come from sys.modules
import ecg_representation_learning_tpu.ops.filter  # noqa: F401
import ecg_representation_learning_tpu.ops.loess  # noqa: F401
import ecg_representation_learning_tpu.ops.nlm  # noqa: F401
import ecg_representation_learning_tpu.ops.resample  # noqa: F401
from ecg_representation_learning_tpu_torch.ops import filter as tfilter
from ecg_representation_learning_tpu_torch.ops import loess as tloess
from ecg_representation_learning_tpu_torch.ops import nlm as tnlm
from ecg_representation_learning_tpu_torch.ops import resample as tresample

jfilter, jloess, jnlm, jresample = (sys.modules[f'ecg_representation_learning_tpu.ops.{m}']
                                    for m in ('filter', 'loess', 'nlm', 'resample'))

SUM_ORDER = 1e-5   # relative to max |output|: f32 sums taken in another order
LOESS = 5e-5       # relative to max |output|: the Cramer solve's cancellation


def both(fn_jax, fn_torch, x: np.ndarray, *args, **kwargs):
    """(JAX, port) outputs of one function on the same float32 input."""
    x = np.asarray(x, np.float32)
    want = np.asarray(fn_jax(jnp.asarray(x), *args, **kwargs))
    got = fn_torch(torch.from_numpy(x.copy()), *args, **kwargs).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    return want, got


def assert_close(got, want, rel=SUM_ORDER):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def ecgish(rng, shape, fs=500.0):
    """QRS-like spike train + baseline wander + noise + a 55 Hz hum."""
    n = shape[-1]
    t = np.arange(n) / fs
    hr = 1.0 + 0.3 * rng.standard_normal(shape[:-1] + (1,))
    phase = (t * hr) % 1.0
    qrs = 800 * np.exp(-((phase - 0.5) ** 2) / (2 * 0.0004))
    wander = (150 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6, shape[:-1] + (1,)))
              + 80 * np.sin(2 * np.pi * 0.05 * t))
    hum = 30 * np.sin(2 * np.pi * 55.0 * t)
    return (qrs + wander + hum + 20 * rng.standard_normal(shape)).astype(np.float32)


def numpy_est_noise_std(arr):
    """The reference formula (data_preprocessor.py:75-80) with its in-place
    update, in float64 numpy (as tests/test_ops_nlm.py has it)."""
    res = arr.astype(np.float64).copy()
    for i in range(1, arr.size - 1):
        res[i] = (2 * res[i] - res[i - 1] - res[i + 1]) / math.sqrt(6)
    return stats.median_abs_deviation(1.4826 * (res - np.median(res)))


# ---------------------------------------------------------------------------
# ops/filter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('fs', [500.0, 250.0, 257.0])
def test_butter_lowpass_design_equals_jax(fs):
    b, a = tfilter.butter_lowpass_design(fs)
    jb, ja = jfilter.butter_lowpass_design(fs)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(a, ja)
    key = (tuple(b.tolist()), tuple(a.tolist()))
    np.testing.assert_array_equal(tfilter.filtfilt_fir_taps(*key),
                                  jfilter.filtfilt_fir_taps(*key))


@pytest.mark.parametrize('pad', [1, 7, 49])
def test_odd_ext_matches_jax(rng, pad):
    want, got = both(jfilter.odd_ext, tfilter.odd_ext, rng.standard_normal((2, 3, 50)), pad)
    np.testing.assert_array_equal(got, want)


def test_lfilter_matches_jax_and_scipy(rng):
    x = ecgish(rng, (3, 800))
    b, a = tfilter.butter_lowpass_design()
    want, got = both(lambda v: jfilter.lfilter(b, a, v), lambda v: tfilter.lfilter(b, a, v), x)
    assert_close(got, want)
    np.testing.assert_allclose(got, signal.lfilter(b, a, x, axis=-1), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize('shape', [(3, 800), (2, 2, 40)])
def test_filtfilt_scan_matches_jax(rng, shape):
    x = ecgish(rng, shape)
    b, a = tfilter.butter_lowpass_design()
    want, got = both(lambda v: jfilter.filtfilt_scan(b, a, v),
                     lambda v: tfilter.filtfilt_scan(b, a, v), x)
    assert_close(got, want)
    np.testing.assert_allclose(got, signal.filtfilt(b, a, x, axis=-1, padlen=min(
        3 * len(a), shape[-1] - 1)), rtol=1e-4, atol=5e-2)


@pytest.mark.parametrize('shape,fs', [((3, 2500), 500.0), ((2, 12, 1000), 250.0),
                                      ((1, 4, 300), 250.0)])
def test_filtfilt_fir_matches_jax(rng, shape, fs):
    x = ecgish(rng, shape, fs)
    b, a = tfilter.butter_lowpass_design(fs)
    want, got = both(lambda v: jfilter.filtfilt_fir(b, a, v),
                     lambda v: tfilter.filtfilt_fir(b, a, v), x)
    assert_close(got, want)


@pytest.mark.parametrize('method', ['fir', 'scan'])
@pytest.mark.parametrize('fs', [500.0, 250.0])
def test_butterworth_low_pass_matches_jax(rng, method, fs):
    x = ecgish(rng, (2, 3, 700), fs)
    want, got = both(jfilter.butterworth_low_pass, tfilter.butterworth_low_pass, x,
                     fs=fs, method=method)
    assert_close(got, want)


@pytest.mark.parametrize('stride,block', [(1, 256), (2, 256), (4, 64), (1, 16)])
def test_fir_correlate_matmul_matches_jax(rng, stride, block):
    x = rng.standard_normal((2, 3, 1100))
    taps = rng.standard_normal(37)
    want, got = both(jfilter.fir_correlate_matmul, tfilter.fir_correlate_matmul, x, taps,
                     stride=stride, block=block)
    assert got.shape[-1] == (1100 - 37) // stride + 1
    assert_close(got, want)
    ref = np.stack([np.correlate(row, taps, 'valid')[::stride]
                    for row in x.astype(np.float32).reshape(-1, 1100)])
    np.testing.assert_allclose(got.reshape(ref.shape), ref, atol=SUM_ORDER * np.abs(ref).max())


@pytest.mark.parametrize('length,block', [(1000, 256), (300, 64)])
def test_fir_correlate_matmul_multi_matches_jax(rng, length, block):
    x = rng.standard_normal((4, length))
    taps = rng.standard_normal((5, 41))
    want, got = both(jfilter.fir_correlate_matmul_multi, tfilter.fir_correlate_matmul_multi,
                     x, taps, block=block)
    assert got.shape == (4, length - 40, 5)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# ops/loess
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('shape', [(7, 101), (3, 4, 250), (5, 2500), (2, 1), (6, 64)])
def test_median_last_axis_bit_equal_to_jax_and_numpy(rng, shape):
    r = rng.standard_normal(shape).astype(np.float32) * 50
    want, got = both(jloess.median_last_axis, tloess.median_last_axis, r)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.median(r, axis=-1).astype(np.float32))


@pytest.mark.parametrize('values', [np.full((4, 64), 3.5), np.repeat(np.arange(5.0), 20)[None]])
def test_median_last_axis_ties(values):
    r = np.asarray(values, np.float32)
    want, got = both(jloess.median_last_axis, tloess.median_last_axis, r)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.median(r, axis=-1).astype(np.float32))


@pytest.mark.parametrize('iters', [5, 2, 0])
def test_rloess_matches_jax(rng, iters):
    x = ecgish(rng, (2, 3, 800), 250.0)
    want, got = both(jloess.rloess, tloess.rloess, x, n=250, robust_iters=iters)
    assert_close(got, want, rel=LOESS)


# a window larger than the signal, one that forced-odd pushes past an even
# length, one below the 5-point minimum (passthrough), an even window
@pytest.mark.parametrize('length,window', [(64, 500), (40, 41), (10, 3), (101, 100)])
def test_rloess_window_against_signal_length(rng, length, window):
    x = ecgish(rng, (2, length), 250.0)
    want, got = both(jloess.rloess, tloess.rloess, x, n=window)
    assert_close(got, want, rel=LOESS)


def test_remove_baseline_matches_jax(rng):
    x = ecgish(rng, (1, 12, 1000), 250.0)
    want, got = both(jloess.remove_baseline, tloess.remove_baseline, x, fqs=250)
    assert_close(got, want, rel=LOESS)


# ---------------------------------------------------------------------------
# ops/nlm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('n', [30, 35, 36, 500, 2500])
def test_est_noise_std_matches_jax_and_the_reference_formula(rng, n):
    # n - 1 <= 34 takes the log-depth scan, longer signals the 32-tap FIR
    t = np.arange(n) / 250.0
    x = (50 * np.sin(2 * np.pi * 3.0 * t)[None] + 4.0 * rng.standard_normal((3, n)))
    want, got = both(jnlm.est_noise_std, tnlm.est_noise_std, x)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    golden = [numpy_est_noise_std(row) for row in x.astype(np.float32)]
    np.testing.assert_allclose(got, golden, rtol=1e-4)


def test_est_noise_std_of_a_zero_lead_is_zero():
    x = np.zeros((2, 500), np.float32)
    want, got = both(jnlm.est_noise_std, tnlm.est_noise_std, x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize('shape,sw,pw', [
    ((2, 3, 150), 32, 10),
    ((1, 1, 120), None, 5),   # full search
    ((4, 2, 200), 64, 7),
])
def test_nlm_scan_matches_jax(rng, shape, sw, pw):
    x = rng.standard_normal(shape).astype(np.float32) * 10
    want, got = both(jnlm.nlm, tnlm.nlm, x, sch_wd=sw, patch_wd=pw)
    assert_close(got, want, rel=2e-6)


# ---------------------------------------------------------------------------
# ops/resample
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('n,num', [(5000, 2500), (2570, 2500), (4000, 2500), (1000, 1300),
                                   (999, 500)])
def test_resample_fft_matches_jax_and_scipy(rng, n, num):
    x = rng.standard_normal((3, n))
    want, got = both(jresample.resample_fft, tresample.resample_fft, x, num)
    assert_close(got, want)
    ref = signal.resample(x.astype(np.float32), num, axis=-1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * np.abs(ref).max() + 1e-8)


# the registry's corpus rates: 500->250, 1000->250, 257->250, 400->250
@pytest.mark.parametrize('up,down', [(1, 2), (1, 4), (250, 257), (5, 8), (2, 1)])
def test_resample_poly_matches_jax_and_scipy(rng, up, down):
    x = rng.standard_normal((2, 3, 2000))
    want, got = both(jresample.resample_poly, tresample.resample_poly, x, up, down)
    assert_close(got, want)
    ref = signal.resample_poly(x.astype(np.float32), up, down, axis=-1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('method', ['fft', 'poly'])
@pytest.mark.parametrize('fqs', [500, 1000, 257, 400, 250])
def test_resample_to_matches_jax(rng, fqs, method):
    x = rng.standard_normal((1, 12, fqs * 2))
    want, got = both(jresample.resample_to, tresample.resample_to, x, fqs, 250,
                     method=method)
    assert got.shape[-1] == 500
    assert_close(got, want)
