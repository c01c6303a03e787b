"""A numpy model of the NLM kernel's blocks (ops/csrc/nlm.cu), written after the
CUDA source, against the plain version, the JAX package's Pallas kernel
(``_nlm_pallas_2d``) and the JAX probe's ``_variant_kernel``, both run in
interpret mode.

The kernel runs only on the GPU; this model pins its index logic on the CPU:
the launch plan (branch, threads, segments, shared memory, and the cluster
size chosen from the card's SMs), the cluster's interleaved split of the
shift axis, each thread's run of K positions with its halo window and the
bank of every stride-K shared access, the add-only box sums (the register
branch's suffix + core + prefix, the generic branch's blockwise prefix and
exclusive-suffix scans), the batches of SHIFTS weight rows per barrier in
two sets with the -s term's reads of w_s[i-s], the s = 0 term added after
the sums, the conditions under which a thread runs a step unmasked, the
segmented path for long rows, and the fixed-order reduction of the blocks'
partials.  Weight rows and SSD buffers start each step as NaN in the model,
so a read of an entry no thread wrote shows as a NaN in the output.

Tolerance: 2e-6 of max |x|, chip_smoke.py's NLM_LIMIT and the JAX package's
own bar between its kernel and the scan (tests/test_nlm_pallas.py): the box
sums and accumulations are taken in another order.
"""
import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ecg_representation_learning_tpu.ops.nlm_pallas import _nlm_pallas_2d
from ecg_representation_learning_tpu_torch.ops import nlm_fused
from tools.nlm_sol_probe import _variant_kernel

torch.set_num_threads(2)

# constants of nlm.cu
PW = 10                      # kPW: the register branch's patch half-width
K = 11                       # kK: positions per thread
WIN = K + 2 * PW             # kWin
RES_MAX = 4096               # kResMax
RES_THREADS = 384            # kResThreads
GEN_PER = 8                  # kGenPer
GEN_THREADS = 512            # kGenThreads
SHIFTS = 1                   # kShifts: shifts per barrier, register branch
MAX_CLUSTER = 8              # kMaxCluster
H100_SMS = 132
SMEM_LIMIT = 232448          # bytes of shared memory a block can use on the H100
EPS_ROWS = np.float32(np.finfo(np.float64).eps)
EPS_VARIANT = np.float32(1e-12)
TOL = 2e-6
F32 = np.float32
ALL_ON = {'boxtree': True, 'exp': True, 'mirror': True, 'accum': True}


def choose_cluster(blocks, sms, cmax):
    """choose_cluster: the smallest c in [1, cmax] whose cost
    ceil(blocks c / sms) / c is within 5 % of the least."""
    waves = {c: -(-(blocks * c) // sms) for c in range(1, cmax + 1)}
    best = min(waves, key=lambda c: (waves[c] / c, c))
    return next(c for c in waves if waves[c] * best * 20 <= waves[best] * c * 21)


def plan(rows, n, sch, pw, accum=True, cluster=0, sms=H100_SMS):
    """Plan<>: the branch, block shape, shared memory and the cluster size
    (``cluster`` forces one, as the kernel never does, to model others)."""
    steps_sch = min(sch, max(n - pw - 1, 0)) if accum else sch
    res = pw == PW and n <= RES_MAX
    if res:
        threads = -(-(-(-n // K)) // 32) * 32
        seg, segs = threads * K, 1
        blocks = rows
        floats = 2 * PW + seg + 1 + 2 * SHIFTS * seg
    else:
        threads = min(GEN_THREADS, max(32, -(-(-(-n // GEN_PER)) // 32) * 32))
        seg = threads * GEN_PER
        segs = -(-n // seg)
        blocks = rows * segs
        floats = (2 * (seg + 2 * pw) + seg) * (2 if segs > 1 else 1)
    c = cluster or choose_cluster(blocks, sms, max(1, min(MAX_CLUSTER, steps_sch)))
    c = max(1, min(c, steps_sch))
    return {'branch': 'register' if res else 'generic', 'threads': threads, 'seg': seg,
            'segs': segs, 'sch': steps_sch, 'C': c, 'smem': 4 * floats, 'grid': blocks * c}


def needed(n, pw, s, mirror, accum):
    """needed<>: the hull of positions whose weight step s reads."""
    lo, hi = pw + 1, n - pw
    if not accum:
        return lo, hi
    hi = min(hi, n - s)
    if mirror and s > 0:
        lo = max(1, pw + 1 - s)
        hi = max(hi, n - pw - s)
    return lo, hi


def fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F32)


def weight(d, hinv, use_exp):
    with np.errstate(invalid='ignore', over='ignore'):
        return np.exp(-d * hinv) if use_exp else d * hinv


def box_core(ssd):
    """plus_step's box sum over each thread's window ssd (T, WIN): K windows of
    2pw+1 taps as suffix of [c, K-2] + core [K-1, 2pw] + prefix of
    [2pw+1, c+2pw], adds only."""
    w = 2 * PW + 1
    core = ssd[:, K - 1]
    for j in range(K, w):
        core = core + ssd[:, j]
    suf = [None] * K
    for c in range(K - 2, -1, -1):
        suf[c] = ssd[:, c] if c == K - 2 else ssd[:, c] + suf[c + 1]
    pre = [None] * K
    for c in range(1, K):
        pre[c] = ssd[:, w] if c == 1 else pre[c - 1] + ssd[:, c + w - 1]
    out = []
    for c in range(K):
        d = suf[c] + core if c < K - 1 else core
        out.append(d + pre[c] if c > 0 else d)
    return np.stack(out, axis=1)


def fast_plus(i0, s, n):
    return i0 >= PW + 1 and i0 + K + PW + s <= n


def fast_minus(i0, s, n):
    return i0 - s >= 1 and i0 >= PW + 1 and i0 + K <= n - PW


def res_block(x, hinv, p, rank, f):
    """nlm_res_kernel, block `rank` of a row's cluster: partial (num, z) of
    positions [0, n) over its shifts s = rank, rank + C, ... (s > 0), thread
    t owning positions [K t, K t + K)."""
    n, tk, c_ = x.shape[0], p['seg'], p['C']
    xs = np.zeros(tk + 2 * PW + 1, F32)            # xs[PW + k] = x[k]
    xs[PW:PW + n] = x
    i0 = np.arange(p['threads']) * K
    k = i0[:, None] - PW + np.arange(WIN)
    i = i0[:, None] + np.arange(K)
    interior = (i >= PW + 1) & (i < n - PW)
    xk = xs[PW + k]
    num = np.zeros((p['threads'], K), F32)
    z = np.zeros((p['threads'], K), F32)
    wbuf = np.full((2, SHIFTS, tk), np.nan, F32)
    buf = 0
    for s0 in range(rank, p['sch'], SHIFTS * c_):
        batch = [(b, s0 + b * c_) for b in range(SHIFTS) if 0 < s0 + b * c_ < p['sch']]
        wbuf[buf] = np.nan                 # an entry not written this batch reads as NaN
        for b, s in batch:
            lo, hi = needed(n, PW, s, f['mirror'], f['accum'])
            act = ((i0 < hi) & (i0 + K > lo))[:, None]
            xv = xs[PW + np.minimum(k + s, n)]
            ssd = np.where((k >= 0) & (k + s < n), (xk - xv) * (xk - xv), F32(0))
            dist = box_core(ssd) if f['boxtree'] else ssd[:, PW:PW + K]
            w = weight(dist, hinv, f['exp'])
            if f['accum'] and f['mirror']:
                sel = np.nonzero(act[:, 0])[0]
                wbuf[buf, b][i[sel]] = w[sel]
            if not f['accum']:
                m = act & interior
                num = np.where(m, num + w, num)
                z = np.where(m, z + w, z)
            else:
                m = act & interior & (i + s < n)
                num = np.where(m, fma(w, xv[:, PW:PW + K], num), num)
                z = np.where(m, z + w, z)
        if f['accum'] and f['mirror']:     # after the batch's barrier
            for b, s in batch:
                m = interior & (i - s > 0)
                qi = np.where(m, i - s, 0)
                wm = np.where(m, wbuf[buf, b][qi], F32(0))
                num = np.where(m, fma(wm, xs[PW + qi], num), num)
                z = np.where(m, z + wm, z)
            buf ^= 1
    keep = i.reshape(-1) < n
    out_num, out_z = np.zeros(n, F32), np.zeros(n, F32)
    out_num[i.reshape(-1)[keep]] = num.reshape(-1)[keep]
    out_z[i.reshape(-1)[keep]] = z.reshape(-1)[keep]
    return out_num, out_z


def scan_blocks(buf, jlo, jhi, w):
    """scan_blocks: over buf[jlo, jhi) cut at multiples of w, the exclusive
    suffix sums (0 at a block's first entry) and the prefix sums from the
    block's first entry (or jlo); entries outside [jlo, jhi) stay NaN."""
    pre = np.full_like(buf, np.nan)
    suf = np.full_like(buf, np.nan)
    for m in range(jlo // w, (jhi - 1) // w + 1):
        b = m * w
        st, en = max(b, jlo), min(b + w, jhi)
        acc = F32(0)
        for j in range(en - 1, st - 1, -1):
            acc = acc + buf[j]
            suf[j] = 0.0 if j == b else acc
        acc = F32(0)
        for j in range(st, en):
            acc = acc + buf[j]
            pre[j] = acc
    return pre, suf


def gen_block(x, hinv, pw, p, seg_idx, rank, f):
    """nlm_gen_kernel for (segment, rank): partial (num, z) of positions
    [a, a+T), thread t's c-th position at a + c*threads + t."""
    n, t_ = x.shape[0], p['seg']
    a = seg_idx * t_
    span = t_ + 2 * pw
    own_lo, own_hi = max(a, pw + 1), min(a + t_, n - pw)
    r = pw if f['boxtree'] else 0
    num = np.zeros(t_, F32)
    z = np.zeros(t_, F32)
    i = a + np.arange(t_)
    mine = (i >= own_lo) & (i < own_hi)

    def ssd_of(klo, khi, base, s):
        out = np.full(span, np.nan, F32)
        kk = np.arange(klo, khi)
        valid = (kk >= 0) & (kk + s < n)
        d = np.where(valid, x[np.clip(kk, 0, n - 1)] - x[np.clip(kk + s, 0, n - 1)], F32(0))
        out[kk - base] = np.where(valid, d * d, F32(0))
        return out

    def weights(ssd, plo, phi, base, jlo, jhi):
        w = np.full(t_, np.nan, F32)
        if plo >= phi:
            return w
        j0 = np.arange(plo, phi) - base
        if f['boxtree']:
            pre, suf = scan_blocks(ssd, jlo, jhi, 2 * pw + 1)
            d = suf[j0] + pre[j0 + 2 * pw]
        else:
            d = ssd[j0 + pw]
        w[j0] = weight(d, hinv, f['exp'])
        return w

    for s in range(rank, p['sch'], p['C']):
        if s == 0:
            continue                                  # reduce_store adds s = 0
        mirror = f['accum'] and f['mirror']
        lo, hi, mlo, mhi = math.inf, -math.inf, 0, 0
        spans = [(own_lo, min(own_hi, n - s))] if f['accum'] else [(own_lo, own_hi)]
        if mirror:
            spans.append((max(max(own_lo - s, 1), a), own_hi - s))
            mlo, mhi = max(own_lo - s, 1), min(own_hi - s, a)
        for u, v in spans:
            if u < v:
                lo, hi = min(lo, u), max(hi, v)
        w_own = np.full(t_, np.nan, F32)
        w_mir = np.full(t_, np.nan, F32)
        if lo < hi:
            ssd = ssd_of(lo - r, hi + r, a - pw, s)
            w_own = weights(ssd, lo, hi, a, lo - a, hi + 2 * pw - a)
        if mlo < mhi:
            ssd = ssd_of(mlo - r, mhi + r, a - s - pw, s)
            w_mir = weights(ssd, mlo, mhi, a - s, mlo - a + s, mhi + 2 * pw - a + s)
        if not f['accum']:
            w = np.where(mine, w_own, F32(0))
            num, z = num + w, z + w
            continue
        m = mine & (i + s < n)
        w = np.where(m, w_own, F32(0))
        num = np.where(m, fma(w, x[np.clip(i + s, 0, n - 1)], num), num)
        z = np.where(m, z + w, z)
        if mirror:
            m = mine & (i - s > 0)
            qi = np.clip(i - s, 0, n - 1)
            w = np.where(qi >= a, w_own[np.clip(qi - a, 0, t_ - 1)],
                         w_mir[np.clip(qi - (a - s), 0, t_ - 1)])
            w = np.where(m, w, F32(0))
            num = np.where(m, fma(w, x[qi], num), num)
            z = np.where(m, z + w, z)
    return num, z


def model_rows(x2, h2, sch, pw, flags=None, eps=EPS_ROWS, cluster=0):
    """The kernel's output for rows x2 (R, n) with bandwidths h2 (R,)."""
    f = dict(ALL_ON, **(flags or {}))
    x2 = np.asarray(x2, F32)
    rows, n = x2.shape
    p = plan(rows, n, sch, pw, f['accum'], cluster)
    with np.errstate(divide='ignore'):
        hinv = (F32(1) / np.asarray(h2, F32)).astype(F32)
    out = np.empty_like(x2)
    for r in range(rows):
        num_row, z_row = np.zeros(n, F32), np.zeros(n, F32)
        for g in range(p['segs']):
            a = g * p['seg']
            parts = [res_block(x2[r], hinv[r], p, q, f) if p['branch'] == 'register'
                     else gen_block(x2[r], hinv[r], pw, p, g, q, f) for q in range(p['C'])]
            keep = min(p['seg'], n - a)
            num, z = np.zeros(keep, F32), np.zeros(keep, F32)
            for pn, pz in parts:                      # reduce_store: rank order
                num, z = num + pn[:keep], z + pz[:keep]
            num_row[a:a + keep], z_row[a:a + keep] = num, z
        out[r] = finish(num_row, z_row, x2[r], hinv[r], pw, eps, f, p['sch'] > 0)
    return out


def finish(num, z, x, hinv, pw, eps, f, any_shift):
    """reduce_store's output: the s = 0 term added last (weight w0 of d = 0),
    then num / (z + eps) on the interior, x elsewhere."""
    if any_shift:
        w0 = weight(F32(0), hinv, f['exp'])
        num = fma(np.full_like(x, w0), x, num) if f['accum'] else num + w0
        z = z + w0
    i = np.arange(x.shape[0])
    interior = (i >= pw + 1) & (i < x.shape[0] - pw)
    with np.errstate(invalid='ignore', divide='ignore'):
        return np.where(interior, num / (z + eps), x)


def bandwidths(x2, pw):
    return nlm_fused.nlm_bandwidth(torch.from_numpy(x2), 1.5, pw).numpy()


def reference(x2, h2, sch, pw, flags=None, eps=nlm_fused.EPS):
    return nlm_fused.nlm_rows_reference(torch.from_numpy(x2), torch.from_numpy(h2), sch, pw,
                                        eps=eps, **(flags or {})).numpy()


def assert_close(got, want, x):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(x).max())


def rows_with_spikes(rng, rows, n, spike=True):
    """Noise rows with a smooth beat and, in row 0, QRS-sized spikes (~1e3 x the
    noise-level SSDs around them)."""
    t = np.arange(n)
    x = (0.05 * rng.standard_normal((rows, n)) + np.sin(2 * np.pi * t / 97)).astype(F32)
    if spike and n > 40:
        x[0, n // 3] += 40.0
        x[0, n // 3 + 1] -= 25.0
        x[0, 2 * n // 3] += 60.0
    return x


# ---------------------------------------------------------------- launch plan

@pytest.mark.parametrize('rows,n,sch,pw,branch,threads,segs,c', [
    (768, 2500, 2500, 10, 'register', 256, 1, 1),     # the chain, full search
    (768, 2500, 128, 10, 'register', 256, 1, 1),      # search 128
    (192, 2500, 2500, 10, 'register', 256, 1, 2),     # --batch 16
    (77, 1999, 64, 7, 'generic', 256, 1, 5),          # ragged pw: generic branch
    (24, 9000, 5000, 10, 'generic', 512, 3, 5),       # longer than the staging limit
    (2, 70000, 64, 10, 'generic', 512, 18, 7),        # longer than shared memory holds
    (6, 4096, 300, 10, 'register', 384, 1, 8),
    (6, 4097, 300, 10, 'generic', 512, 2, 8),
    (3, 12, 20, 10, 'register', 32, 1, 1),            # no interior: no step
])
def test_launch_plan(rows, n, sch, pw, branch, threads, segs, c):
    p = plan(rows, n, sch, pw)
    assert (p['branch'], p['threads'], p['segs'], p['C']) == (branch, threads, segs, c)
    assert p['threads'] <= (RES_THREADS if branch == 'register' else GEN_THREADS)
    assert p['smem'] <= SMEM_LIMIT
    assert p['seg'] * p['segs'] >= n
    assert p['grid'] % p['C'] == 0 and 1 <= p['C'] <= MAX_CLUSTER


@pytest.mark.parametrize('blocks,sms,cmax,c', [
    (768, 132, 8, 1),     # 6 blocks per SM at every C: the smallest
    (192, 132, 8, 2),     # C = 2 evens out 192 rows over 132 SMs
    (72, 132, 8, 5),      # 0.6 waves per rank, within 5 % of C = 7's 0.571
    (1, 132, 8, 8),       # one row: every rank on an SM of its own
    (1, 132, 3, 3),       # no more ranks than shifts
    (10_000, 132, 8, 1),
])
def test_cluster_size_from_the_sms(blocks, sms, cmax, c):
    assert choose_cluster(blocks, sms, cmax) == c


@pytest.mark.parametrize('blocks', [1, 5, 24, 72, 131, 132, 133, 192, 300, 768, 1000])
@pytest.mark.parametrize('sms', [66, 114, 132])
def test_cluster_size_is_the_smallest_near_the_least_cost(blocks, sms):
    cost = {c: -(-(blocks * c) // sms) / c for c in range(1, MAX_CLUSTER + 1)}
    c = choose_cluster(blocks, sms, MAX_CLUSTER)
    assert cost[c] <= 1.05 * min(cost.values()) + 1e-12
    assert all(cost[d] > 1.05 * min(cost.values()) + 1e-12 for d in range(1, c))


@pytest.mark.parametrize('name,value', [('kPW', PW), ('kK', K), ('kResMax', RES_MAX),
                                        ('kGenPer', GEN_PER), ('kGenThreads', GEN_THREADS),
                                        ('kShifts', SHIFTS), ('kMaxCluster', MAX_CLUSTER)])
def test_model_constants_are_the_sources(name, value):
    src = (Path(nlm_fused.__file__).parent / 'csrc' / 'nlm.cu').read_text()
    assert re.search(rf'constexpr int {name} = (\d+);', src).group(1) == str(value)


def test_register_branch_limits():
    assert RES_THREADS == -(-RES_MAX // K) // 32 * 32 + 32 >= -(-RES_MAX // K)
    # every row the branch takes fits two blocks per SM at the chain's length
    assert 2 * plan(1, 2500, 2500, 10)['smem'] <= SMEM_LIMIT
    assert plan(1, RES_MAX, 10, 10)['smem'] <= SMEM_LIMIT


@pytest.mark.parametrize('sch', [1, 2, 3, 64, 2500])
@pytest.mark.parametrize('c', [1, 2, 3, 8])
def test_cluster_deals_each_shift_once_and_evenly(sch, c):
    n, pw = 2500, 10
    p = plan(768, n, sch, pw, cluster=c)
    got, work = [0], []                       # s = 0: added by reduce_store
    for rank in range(p['C']):
        mine = [s for s in range(rank, p['sch'], p['C']) if s > 0]
        got += mine
        work.append(sum(n - s for s in mine))
    assert sorted(got) == list(range(max(1, min(sch, n - pw - 1))))
    # shifts interleaved over the ranks: the shares differ by at most one row
    assert max(work) - min(work) <= n


@pytest.mark.parametrize('offset', range(-40, 60, 7))
def test_stride_k_shared_accesses_hit_32_banks(offset):
    # thread t of a warp reads xs[t*K + j + s] (x window, +s reads), writes
    # wrow[t*K + c] and reads wrow[t*K + c - s]: stride K, K odd
    lanes = np.arange(32)
    for base in (0, 5 * 32 * K):
        addr = base + lanes * K + offset
        assert len(set(addr % 32)) == 32


# ---------------------------------------------------------------- add-only box sums

def direct_windows(ssd, w):
    ssd = ssd.astype(np.float64)
    return np.stack([ssd[:, c:c + w].sum(1) for c in range(ssd.shape[1] - w + 1)], 1)


def test_register_box_sum_is_add_only_after_a_spike(rng):
    # a QRS-sized SSD among noise-level SSDs: every window is within a few
    # ulp of its own exact sum, small or large; a running sum that subtracts
    # the tap leaving the window is not
    ssd = (1e-4 * rng.random((64, WIN))).astype(F32)
    ssd[::2, 3] = 1e3
    ssd[1::2, 18] = 4e2
    got = box_core(ssd).astype(np.float64)
    want = direct_windows(ssd, 2 * PW + 1)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    run = np.zeros_like(ssd[:, :K])
    acc = ssd[:, :2 * PW + 1].sum(1, dtype=F32)
    run[:, 0] = acc
    for c in range(1, K):
        acc = acc + ssd[:, c + 2 * PW] - ssd[:, c - 1]
        run[:, c] = acc
    small = want < 1.0
    assert (np.abs(run - want)[small] / want[small]).max() > 1e-2


@pytest.mark.parametrize('pw', [0, 1, 3, 7, 10, 12])
@pytest.mark.parametrize('jlo', [0, 1, 6, 15])
def test_generic_scans_give_every_needed_window(rng, pw, jlo):
    w = 2 * pw + 1
    jhi = jlo + 5 * w + 3
    buf = np.full(jhi + 2, np.nan, F32)
    buf[jlo:jhi] = (1e-4 * rng.random(jhi - jlo)).astype(F32)
    buf[jlo + 2] = 1e3
    pre, suf = scan_blocks(buf, jlo, jhi, w)
    for j0 in range(jlo, jhi - 2 * pw):
        got = np.float64(suf[j0] + pre[j0 + 2 * pw])
        want = buf[j0:j0 + w].astype(np.float64).sum()
        assert np.isfinite(got) and abs(got - want) <= 4e-7 * want, (j0, got, want)


# ---------------------------------------------------------------- masks

@pytest.mark.parametrize('n', [22, 40, 301, 2500, 4096])
def test_unmasked_steps_need_no_mask(n):
    # plus_step<false> / minus_step<false> run only where every SSD, term and
    # read they make is inside the row and the interior
    for t in range(-(-n // K)):
        i0 = t * K
        k = np.arange(i0 - PW, i0 + K + PW)
        i = np.arange(i0, i0 + K)
        for s in list(range(0, 40)) + list(range(n - 60, n)):
            if s < 0:
                continue
            if fast_plus(i0, s, n):
                assert (k >= 0).all() and (k + s < n).all()
                assert ((i >= PW + 1) & (i < n - PW) & (i + s < n)).all()
            if s > 0 and fast_minus(i0, s, n):
                assert ((i >= PW + 1) & (i < n - PW) & (i - s > 0)).all()


# ---------------------------------------------------------------- the model

CASES = [
    # (rows, n, search, pw, cluster): register branch
    (3, 300, 300, 10, 0),      # full search
    (3, 300, 64, 10, 3),
    (2, 301, 500, 10, 8),      # search wider than the row
    (2, 23, 30, 10, 0),        # one interior position
    (2, 12, 20, 10, 0),        # shorter than one thread's run: no interior
    (2, 353, 97, 10, 2),       # crosses a warp's 352 positions
    # generic branch
    (3, 199, 64, 7, 0),        # the ragged case's pw
    (2, 64, 64, 0, 4),         # pw = 0
    (2, 70, 90, 3, 0),
    (2, 7, 9, 1, 0),           # shorter than one thread's run
    (2, 4200, 12, 10, 0),      # split into segments: the -s window before the segment
    (1, 4100, 700, 2, 8),      # segments with the cluster split
]


@pytest.mark.parametrize('rows,n,sch,pw,cluster', CASES)
def test_model_matches_plain_version(rng, rows, n, sch, pw, cluster):
    x2 = rows_with_spikes(rng, rows, n)
    h2 = bandwidths(x2, pw)
    got = model_rows(x2, h2, sch, pw, cluster=cluster)
    want = reference(x2, h2, sch, pw)
    assert np.isfinite(got).all()
    assert_close(got, want, x2)


@pytest.mark.parametrize('rows,n,sch,pw', [(3, 300, 64, 10), (13, 199, 64, 7), (2, 64, 64, 0),
                                           (2, 150, 150, 10)])
def test_model_matches_the_jax_kernel(rng, rows, n, sch, pw):
    x2 = rows_with_spikes(rng, rows, n)
    h2 = bandwidths(x2, pw)
    want = np.asarray(_nlm_pallas_2d(jnp.asarray(x2), jnp.asarray(h2), sch, pw, block_rows=8,
                                     interpret=True))
    got = model_rows(x2, h2, sch, pw)
    assert_close(got, want, x2)


@pytest.mark.parametrize('n,pw', [(120, 10), (120, 5)])
def test_all_zero_row_is_nan_inside(rng, n, pw):
    x2 = rows_with_spikes(rng, 3, n, spike=False)
    x2[1] = 0.0
    h2 = bandwidths(x2, pw)
    got = model_rows(x2, h2, 40, pw)
    assert np.isnan(got[1, pw + 1:n - pw]).all()
    np.testing.assert_array_equal(got[1, :pw + 1], 0.0)
    np.testing.assert_array_equal(got[1, n - pw:], 0.0)
    keep = [0, 2]
    assert_close(got[keep], reference(x2, h2, 40, pw)[keep], x2)


def test_cluster_sizes_agree(rng):
    x2 = rows_with_spikes(rng, 2, 300)
    h2 = bandwidths(x2, 10)
    outs = [model_rows(x2, h2, 300, 10, cluster=c) for c in (1, 2, 5, 8)]
    for o in outs[1:]:
        assert_close(o, outs[0], x2)


VARIANTS = [
    ('full', {}),
    ('-mirror', {'mirror': False}),
    ('-exp', {'exp': False}),
    ('-boxtree', {'boxtree': False}),
    ('-accum(mirror too)', {'accum': False}),
]


def jax_variant(x2, h2, sch_wd, patch_wd, flags, block_rows=8):
    """The JAX probe's ``_variant_kernel`` in interpret mode, with
    ``_run_variant``'s grid and block specs."""
    r, n = x2.shape
    lp = -(-(n + patch_wd) // 128) * 128
    rp = -(-r // block_rows) * block_rows
    xp = jnp.pad(x2, ((0, rp - r), (0, lp - n)))
    hp = jnp.broadcast_to(
        jnp.pad(1.0 / h2, (0, rp - r), constant_values=1.0).reshape(rp, 1), (rp, 128))
    f = dict(ALL_ON, **flags)
    kernel = functools.partial(
        _variant_kernel, n_real=n, n_pairs=sch_wd, patch_wd=patch_wd, lp=lp,
        boxtree=f['boxtree'], use_exp=f['exp'], mirror=f['mirror'], accum=f['accum'])
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((rp, lp), jnp.float32),
        grid=(rp // block_rows, sch_wd),
        in_specs=[pl.BlockSpec((block_rows, lp), lambda rb, si: (rb, 0)),
                  pl.BlockSpec((block_rows, 128), lambda rb, si: (rb, 0))],
        out_specs=pl.BlockSpec((block_rows, lp), lambda rb, si: (rb, 0)),
        scratch_shapes=[pltpu.VMEM((block_rows, lp), jnp.float32),
                        pltpu.VMEM((block_rows, lp), jnp.float32)],
        compiler_params=pltpu.CompilerParams(dimension_semantics=('parallel', 'arbitrary')),
        interpret=True,
    )(xp, hp)
    return np.asarray(out[:r, :n])


@pytest.mark.parametrize('pw', [10, 7])
@pytest.mark.parametrize('name,flags', VARIANTS, ids=[v[0] for v in VARIANTS])
def test_variant_model_matches_the_jax_probe_kernel(rng, name, flags, pw):
    # the probe's inputs: N(0, 1) rows with h = 1; pw 10 runs the register
    # branch, pw 7 the generic one
    x2 = rng.standard_normal((4, 300)).astype(F32)
    h2 = np.ones(4, F32)
    want = jax_variant(jnp.asarray(x2), jnp.asarray(h2), 32, pw, flags)
    got = model_rows(x2, h2, 32, pw, flags, eps=EPS_VARIANT)
    assert np.isfinite(got).all()
    assert_close(got, want, x2)
    assert_close(got, reference(x2, h2, 32, pw, flags, eps=1e-12), x2)


@pytest.mark.parametrize('n,pw', [(120, 10), (120, 4)])
def test_variants_without_accumulation_take_every_shift(rng, n, pw):
    # without the masked accumulation shifts past the row still add w
    x2 = rng.standard_normal((2, n)).astype(F32)
    h2 = np.ones(2, F32)
    for flags in ({'accum': False}, {'accum': False, 'exp': False, 'boxtree': False}):
        assert plan(2, n, n + 30, pw, accum=False)['sch'] == n + 30
        got = model_rows(x2, h2, n + 30, pw, flags, eps=EPS_VARIANT)
        assert_close(got, reference(x2, h2, n + 30, pw, flags, eps=1e-12), x2)
