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


# --------------------------------------- the warp-specialised route (TMA)
#
# bwd_dq_bf16_ws / bwd_dkv_bf16_ws, which aligned bf16 calls take: a
# producer warpgroup loads the owned tiles once and the walked tiles into a
# ring of stages by TMA from 3-D tensor maps (d, t, rows) in boxes of 64
# columns x 64 rows, each stage guarded by a full and an empty mbarrier; two
# consumer warpgroups (8 warps) take turns issuing their score products.

MAX_STAGES = 8               # kMaxStages
WS_THREADS = {4: 4 * 32 + 128, 8: 8 * 32 + 128}
WS_MIN_BLOCKS = {4: 2, 8: 1}  # __launch_bounds__'s blocks an SM
WS_BUDGET = {4: SMEM_PER_SM // 2 - 1024, 8: SMEM_LIMIT}
PRODUCER_REGS = 24
CONSUMER_REGS = {4: 232, 8: 240}
REGS_PER_SM = 65536


def ws_smem(nw, dp, kernel, stages):
    """ws_smem: alignment slack, the owned tiles, each stage's walked tiles
    (and for dK/dV its lse and delta), the mbarriers."""
    stage = 2 * BLOCK * dp * 2 + (2 * BLOCK * 4 if kernel == 'dkv' else 0)
    return 1024 + 2 * 16 * nw * dp * 2 + stages * stage + (2 * stages + 1) * 8


def ws_stages(nw, dp, kernel):
    """ws_stages: the deepest ring (up to MAX_STAGES) within the block's share."""
    s = MAX_STAGES
    while s > 1 and ws_smem(nw, dp, kernel, s) > WS_BUDGET[nw]:
        s -= 1
    return s


def tma_box(x, c0, c1, c2, rows=BLOCK):
    """A 3-D TMA load of x (heads, T, D): the box of `rows` rows x 64 columns
    at column c0, row c1 of head c2; zeros where a coordinate is at or past
    its dimension (the next head's rows are never read)."""
    _, t, d = x.shape
    box = np.zeros((rows, 64), x.dtype)
    r, c = np.arange(c1, c1 + rows), np.arange(c0, c0 + 64)
    box[np.ix_(r < t, c < d)] = x[c2][np.ix_(r[r < t], c[c < d])]
    return box


def tma_write(smem, at, box):
    """The box written at element offset `at` (1024-byte aligned) with
    CU_TENSOR_MAP_SWIZZLE_128B: row r at byte 128 r, its 16-byte chunk j at
    the chunk j XOR bits 7-9 of the byte address."""
    for r in range(box.shape[0]):
        for j in range(8):
            byte = 2 * at + 128 * r + 16 * j
            byte ^= ((byte >> 7) & 7) << 4
            smem[byte // 2:byte // 2 + 8] = box[r, 8 * j:8 * j + 8]


def tma_owned(x, r0, head, nw, dp):
    """tma_owned: the owned tile of 16 nw rows, a box a 64-column panel and
    a warpgroup's 64 rows."""
    rows = 16 * nw
    smem = np.full(rows * dp, -1, x.dtype)
    for pn in range(dp // 64):
        for h in range(nw // 4):
            tma_write(smem, pn * rows * 64 + h * 64 * 64, tma_box(x, 64 * pn, r0 + 64 * h, head))
    return smem


def tma_walked(x, r0, head, dp):
    """tma_walked: a walked tile of 64 rows, a box a panel."""
    smem = np.full(BLOCK * dp, -1, x.dtype)
    for pn in range(dp // 64):
        tma_write(smem, pn * BLOCK * 64, tma_box(x, 64 * pn, r0, head))
    return smem


def unswizzle(smem, rows, dp):
    """The (rows, DP) tile the descriptors read from a swizzled tile."""
    r, c = np.meshgrid(np.arange(rows), np.arange(dp), indexing='ij')
    at = (c >> 6) * rows * 64 + r * 64 + (((c >> 3) & 7) ^ (r & 7)) * 8 + (c & 7)
    return smem[at]


@pytest.mark.parametrize('side', ['owned4', 'owned8', 'walked'])
@pytest.mark.parametrize('dp', [64, 128])
def test_tma_boxes_write_the_swizzled_tile(dp, side):
    """The boxes the producer issues, written in the 128-byte swizzle, lay
    a tile out as load_tile_bf16 does (swizzled_tile), which the unchanged
    descriptors read."""
    rows = {'owned4': 64, 'owned8': 128, 'walked': BLOCK}[side]
    ids = (np.arange(rows)[:, None] * dp + np.arange(dp)[None, :]).astype(np.int64)[None]
    smem = (tma_walked(ids, 0, 0, dp) if side == 'walked'
            else tma_owned(ids, 0, 0, rows // 16, dp))
    np.testing.assert_array_equal(smem, swizzled_tile(rows, dp))


@pytest.mark.parametrize('d', [64, 80, 128])
@pytest.mark.parametrize('t', [41, 200, 1000, 2049])
def test_tma_reads_zeros_past_t_and_d(t, d):
    """A 3-D map's rows >= T and columns >= D read zeros, as the cp.async
    zero fill (_tile): every owned and walked tile of the middle head of
    three, at ragged T and D, never a neighbouring head's rows."""
    dp = padded_d(d)
    x = np.random.default_rng(t + d).standard_normal((3, t, d)).astype(np.float32) + 5.0
    for r0 in range(0, t, BLOCK):
        got = unswizzle(tma_walked(x, r0, 1, dp), BLOCK, dp)
        np.testing.assert_array_equal(got, _tile(x[1], r0, BLOCK, dp))
    for nw in (4, 8):
        rows = 16 * nw
        for r0 in range(0, t, rows):
            got = unswizzle(tma_owned(x, r0, 1, nw, dp), rows, dp)
            np.testing.assert_array_equal(got, _tile(x[1], r0, rows, dp))


@pytest.mark.parametrize('kernel', ['dq', 'dkv'])
@pytest.mark.parametrize('dp', [64, 128])
@pytest.mark.parametrize('t', [1, 41, 64, 65, 1024, 2049])
def test_ws_ring_fits_shared_memory(t, dp, kernel):
    """The owned tiles, the ring and its mbarriers fit each block width's
    share of an SM (227 KB at 8 warps; two blocks an SM at 4), with at
    least 2 stages at D 128 and 3 at D 64; the register split (producer 24,
    consumers 240 or 232) fits the registers the launch bounds give the
    block.  Neither depends on T."""
    for nw in (4, 8):
        stages = ws_stages(nw, dp, kernel)
        assert stages >= (2 if dp == 128 else 3)
        assert ws_smem(nw, dp, kernel, stages) <= WS_BUDGET[nw] <= SMEM_LIMIT
        assert WS_MIN_BLOCKS[nw] * (ws_smem(nw, dp, kernel, stages) + 1024) <= SMEM_PER_SM
        entry = REGS_PER_SM // (WS_THREADS[nw] * WS_MIN_BLOCKS[nw]) // 8 * 8
        assert 128 * PRODUCER_REGS + 32 * nw * CONSUMER_REGS[nw] <= WS_THREADS[nw] * entry
    assert ws_stages(8, dp, kernel) == {(64, 'dq'): 8, (64, 'dkv'): 8, (128, 'dq'): 5,
                                        (128, 'dkv'): 4}[dp, kernel]


# ------------------------------ the ring's protocol under the turn-taking

def key_tiles(causal, window, q0, q1, t, width=BLOCK):
    """flash_mask.cuh key_tiles."""
    lo = 0 if window < 0 else max(q0 - window, 0)
    hi = min(q1, t) if causal else t
    return lo // width, -(-hi // width)


def query_tiles(causal, window, k0, k1, t, width=BLOCK):
    """flash_mask.cuh query_tiles."""
    lo = k0 if causal else 0
    hi = t if window < 0 else min(k1 + window, t)
    return lo // width, -(-hi // width)


def parent_walk(kernel, nw, t, heads, kv_heads, causal, window, row, tile):
    """The walked tiles of the parent's bf16 loops, in order: dQ, block
    (query row, tile), the key tiles j0 .. j1; dK/dV, block (KV row, tile),
    each query head of the group, then its band's query tiles."""
    rows = 16 * nw
    if kernel == 'dq':
        j0, j1 = key_tiles(causal, window, tile * rows, tile * rows + rows, t)
        kvr = (row // heads) * kv_heads + (row % heads) // (heads // kv_heads)
        return [(kvr, j * BLOCK) for j in range(j0, j1)]
    i0, i1 = query_tiles(causal, window, tile * rows, tile * rows + rows, t)
    grp = heads // kv_heads
    first = (row // kv_heads) * heads + (row % kv_heads) * grp
    return [(first + g, i * BLOCK) for g in range(grp) for i in range(i0, i1)]


class _MBar:
    """An mbarrier: a phase completes after `count` arrivals and once its
    expected bytes have landed; try_wait.parity(x) passes once the phase of
    parity x has completed."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        self._complete()

    def land(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        assert self.pending >= 0 and self.tx >= 0
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passed(self, parity):
        return (self.phase & 1) != parity


class _Named:
    """A named barrier over both consumer warpgroups (256 threads): one
    warpgroup's bar.sync and the other's bar.arrive complete it."""

    def __init__(self):
        self.arrived, self.gen = 0, 0

    def arrive(self):
        self.arrived += 1
        if self.arrived == 2:
            self.arrived, self.gen = 0, self.gen + 1

    def sync(self):
        gen = self.gen
        self.arrive()
        while self.gen == gen:
            yield


def simulate_ring(kernel, nw, dp, walk, seed):
    """The producer's and consumers' loops of bwd_*_bf16_ws, line by line,
    with TMA loads and cp.async copies landing at random times and the agents
    run in a random order.  Returns each warpgroup's consumed tiles, in
    order, and the order in which the warpgroups issued their score
    products; asserts no stage is loaded while a warpgroup may still read it
    and no named barrier is left with an arrival."""
    rng = np.random.default_rng(seed)
    stages, n, nwg = ws_stages(nw, dp, kernel), len(walk), nw // 4
    lanes = 32 if kernel == 'dkv' else 0
    full = [_MBar(1 + lanes) for _ in range(stages)]
    empty = [_MBar(nwg) for _ in range(stages)]
    owned = _MBar(1)
    turn = [_Named(), _Named()]
    ring = [None] * stages                  # the tile each stage holds (Q/dO or K/V)
    rows = [None] * stages                  # dK/dV: the tile whose lse and delta it holds
    reading = [set() for _ in range(stages)]
    in_flight = []                          # copies issued, not landed: callables
    consumed = [[] for _ in range(nwg)]
    issued = []
    tile_bytes = 2 * BLOCK * dp * 2

    def producer():
        owned.arrive(2 * 16 * nw * dp * 2)
        in_flight.append(lambda: owned.land(2 * 16 * nw * dp * 2))
        st, ph = 0, 0
        for f in range(n):
            if f >= stages:
                while not empty[st].passed(ph ^ 1):
                    yield
            assert not reading[st], 'a stage is loaded while a warpgroup reads it'
            full[st].arrive(tile_bytes)

            def tma(st=st, f=f):
                ring[st] = walk[f]
                full[st].land(tile_bytes)
            in_flight.append(tma)
            for _ in range(lanes):          # each lane's cp.asyncs, then its arrival

                def lane(st=st, f=f):
                    rows[st] = walk[f]
                    full[st].arrive()
                in_flight.append(lane)
            st, ph = (0, ph ^ 1) if st + 1 == stages else (st + 1, ph)
            yield

    def consumer(wg):
        if nwg == 2 and wg == 1:
            turn[0].arrive()                # warpgroup 0 takes the first turn
        while not owned.passed(0):
            yield
        st, ph = 0, 0
        for f in range(n):
            while not full[st].passed(ph):
                yield
            reading[st].add(wg)
            assert ring[st] == walk[f] and (not lanes or rows[st] == walk[f])
            if nwg == 2:
                yield from turn[wg].sync()
            issued.append(wg)               # the score products, in this turn
            if nwg == 2 and (wg == 0 or f + 1 < n):
                turn[wg ^ 1].arrive()
            yield                           # p, dS and the packed operands
            assert ring[st] == walk[f] and (not lanes or rows[st] == walk[f])
            consumed[wg].append(ring[st])   # the last products read it
            reading[st].discard(wg)         # ... and are in: the stage is freed
            empty[st].arrive()
            st, ph = (0, ph ^ 1) if st + 1 == stages else (st + 1, ph)
            yield

    agents = [producer()] + [consumer(wg) for wg in range(nwg)]
    for _ in range(200 * (n + 4) * (lanes + 4)):
        if not agents and not in_flight:
            break
        if in_flight and rng.random() < 0.3:
            in_flight.pop(int(rng.integers(len(in_flight))))()
            continue
        if not agents:
            continue
        i = int(rng.integers(len(agents)))
        try:
            next(agents[i])
        except StopIteration:
            agents.pop(i)
    assert not agents and not in_flight, 'the ring deadlocked'
    assert turn[0].arrived == turn[1].arrived == 0
    return consumed, issued


WALK_CASES = [  # (T, heads, kv_heads, causal, window)
    (41, 12, 12, False, -1), (200, 8, 2, True, 100), (1000, 4, 1, True, -1),
    (2049, 2, 2, False, -1), (777, 16, 4, True, 255)]


@pytest.mark.parametrize('nw', [4, 8])
@pytest.mark.parametrize('kernel', ['dq', 'dkv'])
@pytest.mark.parametrize('case', WALK_CASES)
def test_ws_walk_order_equals_the_parents(case, kernel, nw):
    """Under the ring and the turn-taking, each consumer warpgroup takes
    the walked tiles in the parent's order (the key tiles for dQ; the
    group's heads, then the band's query tiles, for dK/dV), every tile
    intact from its score products to its last product; at 8 warps the
    warpgroups issue their score products in turns, warpgroup 0 first."""
    t, heads, kv_heads, causal, window = case
    dp = 128 if kernel == 'dkv' else 64
    rows = 16 * nw
    n_tiles = -(-t // rows)
    n_rows = heads if kernel == 'dq' else kv_heads
    for row in (0, n_rows - 1):
        for tile in sorted({0, n_tiles // 2, n_tiles - 1}):
            walk = parent_walk(kernel, nw, t, heads, kv_heads, causal, window, row, tile)
            consumed, issued = simulate_ring(kernel, nw, dp, walk, seed=7 * row + tile)
            assert all(c == walk for c in consumed)
            if nw == 8:
                assert issued == [0, 1] * len(walk)
