"""A numpy model of the blocked backward kernels' blocks (ops/csrc/flash_bwd.cu),
written line by line after the CUDA source, against the plain versions and the
JAX package's Pallas kernels run in interpret mode.

The kernels run only on the GPU; this model pins their index logic on the CPU:
the accumulator fragment map of S = Q K^T (dQ) and of the transposed
S^T = K Q^T (dK/dV), where a thread's columns are queries and so select the
lse and delta it reads from the staged tile; the A operands packed from those
fragments; the wgmma descriptors that read each swizzled tile K-major for one
product and MN-major for the next; the ragged-T and ragged-D zero fill and
masks; the dropout hash at each fragment's (qpos, kpos); the rounding points
(dS to bf16, and p_eff to bf16 for the dV product); the f32 path's 48-row
tiles for short heads; and the ring stages against the card's shared memory.
The fragment and descriptor helpers are the forward's
(tests/test_torch_flash_tiling.py); the chip run (chip_smoke.py) is what shows
the hardware agrees.

Tolerances, over max(1, max |reference|) as chip_smoke.py's BWD_LIMITS.
f32: 2e-5; the model, the plain versions and the Pallas kernels differ only in
the order of f32 sums and in exp2 vs exp, a few ulp of each term of sums over
up to 130 keys or queries.  bf16: 2e-2; all three round ds and the outputs to
bf16 (8 significant bits, 2^-8 relative), the model also p_eff before the dV
product (2^-9 relative per term) where the plain version keeps it in f32, and
a ds that lands on the other side of a rounding boundary moves an output by an
ulp.
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu_torch.ops import attention as tattn
from test_torch_flash_tiling import (BLOCK_K, acc_fragment_map, bf16_warps, dropout_hash,
                                     gmma_desc, padded_d, read_operand, swizzled_tile,
                                     to_bf16)

jattn = importlib.import_module('ecg_representation_learning_tpu.ops.attention')

torch.set_num_threads(2)

# constants of flash_bwd.cu
BLOCK = BLOCK_K              # kBlock: rows of a walked tile, and of a warpgroup
F32_THREADS = 256            # kF32Threads: 16 x 16
P_PITCH = BLOCK + 16         # kPPitch: f32 dS / p_eff row pitch (floats)
SMEM_LIMIT = 232448          # bytes of shared memory a block may use (227 KB)
SMEM_PER_SM = 233472         # bytes of one SM (228 KB), 1 KB of it reserved per block
LOG2E = np.float32(1.4426950408889634)
LIMITS = {'float32': 2e-5, 'bfloat16': 2e-2}


def f32_groups(t):
    """run_f32: 16-row groups per tile side, 3 for a head of at most 48 rows."""
    return 3 if t <= 48 else 4


def ring_stages(t, two_fit=True):
    """ring_stages: one stage when the walk is a single tile."""
    return 2 if t > BLOCK and two_fit else 1


def smem_bytes(kernel, dtype, dp, t, nw=None):
    """The dynamic shared memory run_bf16 / run_f32_g ask for."""
    if dtype == 'bfloat16':
        rows = 16 * nw
        stages = ring_stages(t)
        tiles = (2 * rows + stages * 2 * BLOCK) * dp * 2 + 1024
        return tiles if kernel == 'dq' else tiles + stages * 2 * BLOCK * 4
    r = 16 * f32_groups(t)
    tile = r * (dp + 4)
    if kernel == 'dq':
        return (2 * tile + r * P_PITCH + ring_stages(t) * 2 * tile) * 4
    return (2 * tile + 2 * r * P_PITCH + ring_stages(t, dp == 64) * (2 * tile + 2 * r)) * 4


def f32_score_map(g):
    """f32 score tile (16g x 16g): thread (ty, tx) holds rows ty + 16i, columns
    tx + 16jj."""
    out = []
    for tid in range(F32_THREADS):
        ty, tx = tid >> 4, tid & 15
        for i in range(g):
            for jj in range(g):
                out.append((tid, ty + 16 * i, tx + 16 * jj))
    return tuple(np.array(x) for x in zip(*out))


# ------------------------------------------------------------ ownership maps

@pytest.mark.parametrize('nw', [4, 8])
def test_transposed_fragment_map_reads_lse_by_column(nw):
    """S^T's fragments: s[4nb + e] of warp w, lane (g, tq) is key 16w + g +
    8(e/2), query 8nb + 2tq + e%2.  Each (key, query) of the tile is held
    once; a thread holds 16 queries, each for both of its keys, and the
    index the kernel reads lse and delta at, (i >> 2) * 8 + 2tq + (i & 1),
    is the fragment's query."""
    thread, _, key, query = acc_fragment_map(nw)
    counts = np.zeros((16 * nw, BLOCK), int)
    np.add.at(counts, (key, query), 1)
    assert (counts == 1).all()
    for tid in range(32 * nw):
        lane = tid & 31
        tq = lane & 3
        mine = thread == tid
        slots = np.arange(32)
        np.testing.assert_array_equal(query[mine], (slots >> 2) * 8 + 2 * tq + (slots & 1))
        np.testing.assert_array_equal(key[mine], 16 * (tid >> 5) + (lane >> 2)
                                      + 8 * ((slots >> 1) & 1))
        assert len(set(query[mine])) == 16


@pytest.mark.parametrize('nw', [4, 8])
def test_packed_operands_follow_the_fragments(nw):
    """The kernels pack elements i = 8kk + 2a + e (e = 0, 1) into A register
    a of k16 step kk, forming each element's dropout position from the row
    8(a & 1) and column (i >> 2) * 8 + 2tq + e: those are the fragment's
    (row, column), and the RS A layout wants (g, 2tq), (g + 8, 2tq),
    (g, 2tq + 8), (g + 8, 2tq + 8) of the step."""
    thread, _, row, col = acc_fragment_map(nw)
    for tid in range(32 * nw):
        lane = tid & 31
        g, tq = lane >> 2, lane & 3
        rows, cols = row[thread == tid] % 16, col[thread == tid]
        for kk in range(BLOCK // 16):
            for a in range(4):
                for e in range(2):
                    i = 8 * kk + 2 * a + e
                    assert (rows[i], cols[i]) == (g + 8 * (a & 1), (i >> 2) * 8 + 2 * tq + e)
                    assert (rows[i], cols[i]) == (g + 8 * (a & 1),
                                                  16 * kk + 2 * tq + 8 * (a >> 1) + e)


@pytest.mark.parametrize('g', [3, 4])
def test_f32_maps_cover_each_score_once(g):
    _, row, col = f32_score_map(g)
    counts = np.zeros((16 * g, 16 * g), int)
    np.add.at(counts, (row, col), 1)
    assert (counts == 1).all()


@pytest.mark.parametrize('t,want', [(1, 3), (41, 3), (48, 3), (49, 4), (130, 4), (2049, 4)])
def test_f32_group_rule(t, want):
    assert f32_groups(t) == want


# --------------------------------------------- shared layout and descriptors

@pytest.mark.parametrize('nw', [4, 8])
@pytest.mark.parametrize('dp', [64, 128])
def test_dq_descriptors_select_the_operands(dp, nw):
    """dQ kernel: S = Q K^T (Q K-major at the warpgroup's rows, K K-major),
    dP = dO V^T (the same forms), dQ += dS K (K read MN-major from the same
    tile: n = column of D, k = key)."""
    bq = 16 * nw
    panel_q, panel_k = bq * 128, BLOCK * 128
    q_tile, kv_tile = swizzled_tile(bq, dp), swizzled_tile(BLOCK, dp)
    x, k = np.meshgrid(np.arange(64), np.arange(16), indexing='ij')
    for wg in range(nw // 4):
        for kk in range(dp // 16):                  # Q and dO: m = row, k = d
            desc = gmma_desc(wg * 64 * 128 + (kk >> 2) * panel_q + (kk & 3) * 32, 16, 1024)
            np.testing.assert_array_equal(read_operand(q_tile, desc, False),
                                          (64 * wg + x) * dp + 16 * kk + k)
    for kk in range(dp // 16):                      # K and V: n = key, k = d
        desc = gmma_desc((kk >> 2) * panel_k + (kk & 3) * 32, 16, 1024)
        np.testing.assert_array_equal(read_operand(kv_tile, desc, False), x * dp + 16 * kk + k)
    for kk in range(BLOCK // 16):                   # K of dS K: n = d column, k = key
        for pn in range(dp // 64):
            desc = gmma_desc(pn * panel_k + kk * 2048, panel_k, 1024)
            np.testing.assert_array_equal(read_operand(kv_tile, desc, True),
                                          (16 * kk + k) * dp + 64 * pn + x)


@pytest.mark.parametrize('nw', [4, 8])
@pytest.mark.parametrize('dp', [64, 128])
def test_dkv_descriptors_read_one_tile_both_ways(dp, nw):
    """dK/dV kernel: S^T = K Q^T and dP^T = V dO^T read K (V) K-major at the
    warpgroup's keys and Q (dO) K-major; dK += dS^T Q and dV += P_eff^T dO
    read the same Q (dO) tile MN-major (n = column of D, k = query)."""
    bk = 16 * nw
    panel_k, panel_q = bk * 128, BLOCK * 128
    kv_tile, q_tile = swizzled_tile(bk, dp), swizzled_tile(BLOCK, dp)
    x, k = np.meshgrid(np.arange(64), np.arange(16), indexing='ij')
    for wg in range(nw // 4):
        for kk in range(dp // 16):                  # K and V: m = key, k = d
            desc = gmma_desc(wg * 64 * 128 + (kk >> 2) * panel_k + (kk & 3) * 32, 16, 1024)
            np.testing.assert_array_equal(read_operand(kv_tile, desc, False),
                                          (64 * wg + x) * dp + 16 * kk + k)
    for kk in range(dp // 16):                      # Q and dO as B of S^T: n = query
        desc = gmma_desc((kk >> 2) * panel_q + (kk & 3) * 32, 16, 1024)
        np.testing.assert_array_equal(read_operand(q_tile, desc, False), x * dp + 16 * kk + k)
    for kk in range(BLOCK // 16):                   # Q and dO as B of dK, dV
        for pn in range(dp // 64):
            desc = gmma_desc(pn * panel_q + kk * 2048, panel_q, 1024)
            np.testing.assert_array_equal(read_operand(q_tile, desc, True),
                                          (16 * kk + k) * dp + 64 * pn + x)


@pytest.mark.parametrize('kernel', ['dq', 'dkv'])
@pytest.mark.parametrize('dp', [64, 128])
@pytest.mark.parametrize('t', [1, 41, 64, 65, 1024, 2049])
def test_ring_fits_shared_memory(t, dp, kernel):
    """Every launch fits one block's 227 KB; two stages would fit everywhere
    but f32 dK/dV at D > 64 with 64-row tiles, which keeps one; at T = 41,
    D = 64 two f32 blocks share an SM."""
    for dtype, nw in (('bfloat16', 4), ('bfloat16', 8), ('float32', None)):
        assert smem_bytes(kernel, dtype, dp, t, nw) <= SMEM_LIMIT
    r = 16 * f32_groups(t)
    tile = r * (dp + 4)
    if kernel == 'dq':
        two = (2 * tile + r * P_PITCH + 2 * 2 * tile) * 4
    else:
        two = (2 * tile + 2 * r * P_PITCH + 2 * (2 * tile + 2 * r)) * 4
    assert (two > SMEM_LIMIT) == (dp == 128 and kernel == 'dkv' and r == BLOCK)
    if t == 41 and dp == 64:
        assert 2 * (smem_bytes(kernel, 'float32', dp, t) + 1024) <= SMEM_PER_SM


# -------------------------------------------------------------- block models

def _tile(x, r0, rows, dp):
    """load_tile_*: rows [r0, r0 + rows) of x, zeros past T and past D."""
    t, d = x.shape
    s = np.zeros((rows, dp), np.float32)
    n = max(0, min(rows, t - r0))
    s[:n, :d] = x[r0:r0 + n]
    return s


def _rows(x, r0, rows):
    """lse or delta of rows [r0, r0 + rows), zeros past T."""
    s = np.zeros(rows, np.float32)
    n = max(0, min(rows, len(x) - r0))
    s[:n] = x[r0:r0 + n]
    return s


def _keep(seed, bh, qpos, kpos, rate):
    thresh = np.uint32(tattn._dropout_threshold(rate))
    return (dropout_hash(seed, bh, qpos, kpos) & np.uint32(0xFFFFFF)) >= thresh


def _maps(nw, g):
    """(row, col) of every fragment slot of a score tile: the wgmma map of
    nw warps (bf16) or the f32 map of g groups."""
    if nw is not None:
        _, _, row, col = acc_fragment_map(nw)
    else:
        _, row, col = f32_score_map(g)
    return row, col


def model_dq_block(h, bh, q0, nw, scale, seed, rate):
    """One block of bwd_dq_bf16 (nw warps) or bwd_dq_f32 (nw None) for head
    bh and the query tile at q0: dQ rows < T, columns < D (f32)."""
    q, k, v, do, lse, delta = h
    t, d = q.shape
    dp = padded_d(d)
    g = f32_groups(t)
    rows = 16 * nw if nw is not None else 16 * g
    walk = BLOCK if nw is not None else 16 * g
    frow, fcol = _maps(nw, g) if nw is not None else _maps(None, g)
    sl2 = np.float32(scale) * LOG2E
    inv = np.float32(1.0 / (1.0 - rate))
    q_s, do_s = _tile(q, q0, rows, dp), _tile(do, q0, rows, dp)
    nl = -_rows(lse, q0, rows) * LOG2E               # 0 past t: rows not stored
    dl = _rows(delta, q0, rows)
    acc = np.zeros((rows, dp), np.float32)
    for k0 in range(0, t, walk):
        k_s, v_s = _tile(k, k0, walk, dp), _tile(v, k0, walk, dp)
        s = (q_s @ k_s.T).astype(np.float32)
        dpv = (do_s @ v_s.T).astype(np.float32)
        p = np.exp2(s * sl2 + nl[:, None]).astype(np.float32)
        p[:, k0 + np.arange(walk) >= t] = 0.0        # keys >= t
        if rate > 0.0:
            keep = np.zeros_like(p, bool)
            keep[frow, fcol] = _keep(seed, bh, q0 + frow, k0 + fcol, rate)
            dpv = np.where(keep, dpv * inv, np.float32(0.0))
        ds = p * (dpv - dl[:, None])
        if nw is not None:
            ds = to_bf16(ds)                         # the A operand of dQ += dS K
        acc += (ds @ k_s).astype(np.float32)
    n = min(rows, t - q0)
    return (acc * np.float32(scale))[:n, :d]


def model_dkv_block(h, bh, k0, nw, scale, seed, rate):
    """One block of bwd_dkv_bf16 or bwd_dkv_f32 for head bh and the key tile
    at k0: (dK, dV) rows < T, columns < D (f32)."""
    q, k, v, do, lse, delta = h
    t, d = q.shape
    dp = padded_d(d)
    g = f32_groups(t)
    rows = 16 * nw if nw is not None else 16 * g
    walk = BLOCK if nw is not None else 16 * g
    # S^T's fragments: row = key, column = query (lse and delta per column)
    frow, fcol = _maps(nw, g)
    sl2 = np.float32(scale) * LOG2E
    inv = np.float32(1.0 / (1.0 - rate))
    k_s, v_s = _tile(k, k0, rows, dp), _tile(v, k0, rows, dp)
    acc_k = np.zeros((rows, dp), np.float32)
    acc_v = np.zeros((rows, dp), np.float32)
    for q0 in range(0, t, walk):
        q_s, do_s = _tile(q, q0, walk, dp), _tile(do, q0, walk, dp)
        lse_s, dl_s = _rows(lse, q0, walk), _rows(delta, q0, walk)
        s = (k_s @ q_s.T).astype(np.float32)
        dpv = (v_s @ do_s.T).astype(np.float32)
        p = np.exp2(s * sl2 + (-lse_s * LOG2E)[None, :]).astype(np.float32)
        p[:, q0 + np.arange(walk) >= t] = 0.0        # padded queries contribute 0
        pe = p
        if rate > 0.0:
            keep = np.zeros_like(p, bool)
            keep[frow, fcol] = _keep(seed, bh, q0 + fcol, k0 + frow, rate)
            pe = np.where(keep, p * inv, np.float32(0.0))
            dpv = np.where(keep, dpv * inv, np.float32(0.0))
        ds = p * (dpv - dl_s[None, :])
        if nw is not None:                           # both A operands in bf16
            pe, ds = to_bf16(pe), to_bf16(ds)
        acc_v += (pe @ do_s).astype(np.float32)
        acc_k += (ds @ q_s).astype(np.float32)
    n = min(rows, t - k0)
    return (acc_k * np.float32(scale))[:n, :d], acc_v[:n, :d]


def model_backward(q, k, v, do, lse, delta, nw, seed=0, rate=0.0):
    """The kernels' grids: every (bh, owned tile) block of both kernels.
    Arrays (B, H, T, D) f32 (bf16 values when nw, the bf16 blocks' warps, is
    given) and (B, H, T).  Returns (dQ, dK, dV) as f32 in the stored dtype."""
    b, hh, t, d = q.shape
    rows = 16 * nw if nw is not None else 16 * f32_groups(t)
    scale = 1.0 / np.sqrt(d)
    flat = [x.reshape(b * hh, t, -1) for x in (q, k, v, do)]
    rows_in = [x.reshape(b * hh, t) for x in (lse, delta)]
    outs = [np.zeros((b * hh, t, d), np.float32) for _ in range(3)]
    for bh in range(b * hh):
        head = [x[bh] for x in flat] + [x[bh] for x in rows_in]
        for r0 in range(0, t, rows):
            dq = model_dq_block(head, bh, r0, nw, scale, seed, rate)
            dk, dv = model_dkv_block(head, bh, r0, nw, scale, seed, rate)
            for out, blk in zip(outs, (dq, dk, dv)):
                out[bh, r0:r0 + len(blk)] = blk
    if nw is not None:
        outs = [to_bf16(x) for x in outs]            # stored in the input dtype
    return [x.reshape(b, hh, t, d) for x in outs]


# -------------------------------------------------------------------- tests

def _inputs(seed, shape, is_bf16):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    return [to_bf16(x) for x in xs] if is_bf16 else xs


@functools.lru_cache(maxsize=None)
def _reference(t, d, dtype, rate):
    """Inputs (q, k, v, dO, lse, delta) from the Pallas forward, and the
    plain versions' and the Pallas kernels' (dQ, dK, dV)."""
    is_bf16 = dtype == 'bfloat16'
    q, k, v, do = _inputs(7 * t + d, (1, 2, t, d), is_bf16)
    scale = float(1.0 / np.sqrt(d))
    jdt = jnp.bfloat16 if is_bf16 else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    out, lse = jattn._flash_forward(jq, jk, jv, 1234, scale, 128, 128, interpret=True,
                                    return_lse=True, dropout_rate=rate)
    lse = np.array(lse, np.float32)
    delta = (do * np.asarray(out, np.float32)).sum(-1, dtype=np.float32)
    pallas = jattn._flash_backward_blocked(jq, jk, jv, out, jnp.asarray(lse), jdo, 1234, scale,
                                           128, 128, interpret=True, dropout_rate=rate)
    tdt = torch.bfloat16 if is_bf16 else torch.float32
    plain = tattn.flash_backward_blocked_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v, do)), torch.from_numpy(lse),
        torch.from_numpy(delta), seed=1234, dropout_rate=rate)
    return ((q, k, v, do, lse, delta),
            [[x.float().numpy() for x in plain], [np.asarray(x, np.float32) for x in pallas]])


@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('dtype,nw', [('float32', None), ('bfloat16', 4), ('bfloat16', 8)])
@pytest.mark.parametrize('d', [16, 40, 64, 128])
@pytest.mark.parametrize('t', [1, 41, 64, 65, 130])
def test_block_models_match_plain_versions_and_pallas(t, d, dtype, nw, rate):
    inputs, wants = _reference(t, d, dtype, rate)
    got = model_backward(*inputs, nw, seed=1234, rate=rate)
    for want in wants:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=LIMITS[dtype] * max(1.0, float(np.abs(b).max())))


def test_bf16_width_rule_is_the_forwards():
    """run<> of flash_bwd.cu picks the block width by the forward's rule: the
    serving/training head takes 64-row blocks, T = 256 at 120 heads 128."""
    assert bf16_warps(768, 41) == 4 and bf16_warps(24, 1024) == 4
    assert bf16_warps(120, 256) == 8 and bf16_warps(96, 128) == 8
