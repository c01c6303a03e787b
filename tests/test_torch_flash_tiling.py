"""A numpy model of the flash forward kernel's block (ops/csrc/flash_fwd.cu),
written line by line after the CUDA source, against the plain version and the
JAX package's Pallas kernel run in interpret mode.

The kernel runs only on the GPU; this model pins its index logic on the CPU:
the tile constants and the choice of block width, the map from each thread's
accumulator fragments to (row, column) of a tile, the swizzled
shared-memory layout and the wgmma matrix descriptors that read the
tensor-core operands from it, the ragged-T and ragged-D zero fill and key
mask, the online-softmax rescale by alpha, the per-thread partial sums of the
raw p reduced by the kernel's shuffles, the dropout hash at each fragment's
(qpos, kpos), the bf16 rounding point of the unnormalized p, the output
staging and the row log-sum-exp.

The descriptor model follows the canonical 128-byte-swizzle layouts of the
Hopper tensor cores for 2-byte types (PTX ISA, wgmma matrix descriptors;
CUTLASS's GmmaDescriptor): K-major, rows 128 bytes apart in groups of 8 at
the stride offset; MN-major, 64 elements along MN per 128-byte row, the K
rows 128 bytes apart in groups of 8 at the stride offset and the next 64 MN
elements at the leading offset; the 16-byte chunk index XORed with bits 7-9
of the byte address.  The chip run (chip_smoke.py) is what shows the
hardware agrees.

Tolerances.  f32: 1e-5 absolute, as chip_smoke.py holds the kernel to its
plain version; the model, the plain version and the Pallas kernel differ only
in the order of f32 sums and in exp2 vs exp (a few ulp of an O(1) output).
bf16: 2e-2 absolute, chip_smoke.py's bf16 limit; the model (as the kernel and
the Pallas kernel) rounds the unnormalized p to bf16 before the PV product,
the plain version the normalized p, and the output is bf16 (8 significant
bits, 2^-8 relative).  lse: 1e-5 in both dtypes (f32 sums of exact bf16
products).
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu_torch.ops import attention as tattn

jattn = importlib.import_module('ecg_representation_learning_tpu.ops.attention')

torch.set_num_threads(2)

# tile constants of flash_fwd.cu
BLOCK_K = 64                 # kBlockK: keys per staged K/V tile
F32_ROWS = 64                # kF32Rows: query rows of an f32 block
F32_THREADS = 256            # kF32Threads: 16 x 16
P_PITCH = BLOCK_K + 16       # kPPitch: f32 P row pitch (floats)
H100_SMS = 132
NEG_INF = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
LIMITS = {'float32': 1e-5, 'bfloat16': 2e-2}
LSE_LIMIT = 1e-5


def bf16_warps(bh, t, sms=H100_SMS):
    """run<>: 8 warps (128 query rows sharing each K/V tile) unless 4-warp
    blocks leave fewer rows on the busiest SM."""
    narrow, wide = bh * -(-t // 64), bh * -(-t // 128)
    return 8 if 128 * -(-wide // sms) <= 64 * -(-narrow // sms) else 4


def padded_d(d):
    """The kernels' DP: D padded to 64 or 128."""
    return 64 if d <= 64 else 128


# ------------------------------------------------------------ ownership maps

def acc_fragment_map(nw):
    """bf16 score tile (16 nw rows x 64 keys), the wgmma m64n64 accumulator:
    warp w of a block holds rows 16w.., and its d[4nb + e] is row
    16w + g + 8(e/2), key 8nb + 2q + e%2 with g = lane/4, q = lane%4.
    Returns (thread, slot, row, col) arrays; slot is the quad position q over
    which a row's partial sums are reduced."""
    out = []
    for w in range(nw):
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            for i in range(32):
                nb, e = i >> 2, i & 3
                out.append((32 * w + lane, q, 16 * w + g + 8 * (e >> 1),
                            8 * nb + 2 * q + (e & 1)))
    return tuple(np.array(x) for x in zip(*out))


def f32_score_map():
    """f32 score tile (64 x 64): thread (ty, tx) = (tid / 16, tid % 16) holds
    rows ty + 16i, keys tx + 16jj; slot tx."""
    out = []
    for tid in range(F32_THREADS):
        ty, tx = tid >> 4, tid & 15
        for i in range(4):
            for jj in range(4):
                out.append((tid, tx, ty + 16 * i, tx + 16 * jj))
    return tuple(np.array(x) for x in zip(*out))


def f32_output_map(dp):
    """f32 output tile (64 x DP): rows ty + 16i, columns 4tx + 64c + e."""
    out = []
    for tid in range(F32_THREADS):
        ty, tx = tid >> 4, tid & 15
        for i in range(4):
            for c in range(dp // 64):
                for e in range(4):
                    out.append((ty + 16 * i, 4 * tx + 64 * c + e))
    return tuple(np.array(x) for x in zip(*out))


# --------------------------------------------- shared layout and descriptors

def swz(r, c, rows):
    """Element offset of 16-byte chunk c of row r in a swizzled bf16 tile of
    `rows` rows: 64-column panels of [rows][64], chunk XOR r % 8."""
    return (c >> 3) * rows * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3)


def swizzled_tile(rows, dp):
    """Shared memory after load_tile_bf16 of a tile whose element (r, col)
    holds the id r * DP + col."""
    smem = np.full(rows * dp, -1, np.int64)
    for r in range(rows):
        for col in range(dp):
            smem[swz(r, col >> 3, rows) + (col & 7)] = r * dp + col
    return smem


def gmma_desc(addr, lbo, sbo):
    """gmma_desc of flash_fwd.cu: start address, leading and stride byte
    offsets in 16-byte units, layout type 1 (128-byte swizzle) in bits 62-63."""
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32) | (1 << 62)


def read_operand(smem, desc, mn_major):
    """The 64 x 16 (MN x K) bf16 operand a descriptor selects from a tile at
    shared address 0 (1024-byte aligned): element ids, shape (64, 16)."""
    assert desc >> 62 == 1
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    x, k = np.meshgrid(np.arange(64), np.arange(16), indexing='ij')
    if mn_major:
        addr = start + (x % 64) * 2 + (x // 64) * lbo + (k % 8) * 128 + (k // 8) * sbo
    else:
        addr = start + (x % 8) * 128 + (x // 8) * sbo + k * 2
    addr = addr ^ (((addr >> 7) & 7) << 4)               # the 128-byte swizzle
    return smem[addr // 2]


# -------------------------------------------------------------- block model

def dropout_hash(seed, bh, qpos, kpos):
    """dropout_hash of flash_fwd.cu in uint32 arithmetic (wraps mod 2^32)."""
    u = np.uint32
    h = (np.array([seed], u) * u(0x9E3779B9) + np.array([bh], u) * u(0x85EBCA6B)
         + np.asarray(qpos, u) * u(0xC2B2AE35) + np.asarray(kpos, u) * u(0x27D4EB2F))
    h ^= h >> u(16)
    h *= u(0x7FEB352D)
    h ^= h >> u(15)
    h *= u(0x846CA68B)
    h ^= h >> u(16)
    return h


def to_bf16(x):
    """Round f32 to bf16 (nearest even), held in f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def model_block(qh, kh, vh, bh, q0, nw, scale, seed, rate):
    """One block of flash_fwd_f32 (nw None) or flash_fwd_bf16 with nw warps
    for head bh and the query tile at q0: (out rows, lse rows) for the
    tile's rows < T, columns < D."""
    t, d = qh.shape
    dp = padded_d(d)
    is_bf16 = nw is not None
    bq = 16 * nw if is_bf16 else F32_ROWS
    thread, slot, frow, fcol = acc_fragment_map(nw) if is_bf16 else f32_score_map()
    n_slot = slot.max() + 1
    thresh = np.uint32(tattn._dropout_threshold(rate))
    inv_keep = np.float32(1.0 / (1.0 - rate))
    scale = np.float32(scale)

    def tile(x, r0, rows):           # load_tile_*: zeros past T and past D
        s = np.zeros((rows, dp), np.float32)
        n = max(0, min(rows, t - r0))
        s[:n, :d] = x[r0:r0 + n]
        return s

    q_s = tile(qh, q0, bq)
    m = np.full(bq, NEG_INF, np.float32)
    lp = np.zeros((bq, n_slot), np.float32)      # each thread's raw-p sums
    acc = np.zeros((bq, dp), np.float32)
    for j in range(-(-t // BLOCK_K)):
        k0 = j * BLOCK_K
        k_s, v_s = tile(kh, k0, BLOCK_K), tile(vh, k0, BLOCK_K)
        x = (q_s @ k_s.T).astype(np.float32) * scale
        x[:, k0 + np.arange(BLOCK_K) >= t] = NEG_INF
        mx = np.maximum(m, x.max(axis=1))
        alpha = np.exp2((m - mx) * LOG2E)
        m = mx
        lp *= alpha[:, None]
        acc *= alpha[:, None]
        p = np.exp2(x * LOG2E + (-mx * LOG2E)[:, None])
        np.add.at(lp, (frow, slot), p[frow, fcol])   # l sums the raw p
        if rate > 0.0:
            keep = np.zeros_like(p, bool)
            keep[frow, fcol] = ((dropout_hash(seed, bh, q0 + frow, k0 + fcol)
                                 & np.uint32(0xFFFFFF)) >= thresh)
            p = np.where(keep, p * inv_keep, np.float32(0.0))
        if is_bf16:
            p = to_bf16(p)                        # unnormalized p in v's dtype
        acc += (p @ v_s).astype(np.float32)
    off = 1
    while off < n_slot:                           # the shuffle butterfly
        lp = lp + lp[:, np.arange(n_slot) ^ off]
        off <<= 1
    l = lp[:, 0]
    out = acc * (np.float32(1.0) / l)[:, None]
    lse = m + np.log(np.maximum(l, np.float32(1e-30)))
    n = min(bq, t - q0)
    return out[:n, :d], lse[:n]


def model_forward(q, k, v, nw, seed=0, rate=0.0):
    """The kernel's grid: every (bh, query tile) block.  q, k, v: (B, H, T, D)
    f32 arrays (bf16 values when nw, the bf16 block's warps, is given).
    Returns (out f32, lse)."""
    b, h, t, d = q.shape
    bq = 16 * nw if nw else F32_ROWS
    scale = 1.0 / np.sqrt(d)
    qf, kf, vf = (x.reshape(b * h, t, d) for x in (q, k, v))
    out = np.zeros((b * h, t, d), np.float32)
    lse = np.zeros((b * h, t), np.float32)
    for bh in range(b * h):
        for q0 in range(0, t, bq):
            o_blk, l_blk = model_block(qf[bh], kf[bh], vf[bh], bh, q0, nw, scale, seed, rate)
            out[bh, q0:q0 + len(o_blk)] = o_blk
            lse[bh, q0:q0 + len(l_blk)] = l_blk
    if nw:
        out = to_bf16(out)                        # stored in the input dtype
    return out.reshape(b, h, t, d), lse.reshape(b, h, t)


# -------------------------------------------------------------------- tests

@pytest.mark.parametrize('bh,t,want', [
    (768, 41, 4),        # the serving shape: one 64-row tile per head
    (24, 1024, 4),       # 192 wide blocks: 256 rows on some SMs; narrow: 192
    (120, 256, 8),       # 256 rows on the busiest SM either way: share K/V
    (48, 4096, 8),
    (96, 128, 8),
    (15, 200, 4),
    (1, 1, 4),
])
def test_block_width_rule(bh, t, want):
    assert bf16_warps(bh, t) == want


@pytest.mark.parametrize('nw', [4, 8])
def test_acc_fragment_map_covers_each_score_once(nw):
    thread, slot, row, col = acc_fragment_map(nw)
    counts = np.zeros((16 * nw, BLOCK_K), int)
    np.add.at(counts, (row, col), 1)
    assert (counts == 1).all()
    # a row lives in one quad of one warp: 4 threads, 16 keys each
    for r in range(16 * nw):
        owners = np.unique(thread[row == r])
        assert len(owners) == 4 and len(np.unique(owners >> 5)) == 1
        assert set(slot[row == r]) == {0, 1, 2, 3}
    # P's accumulator fragments are the RS-form A operand: k16 step kk takes
    # d[8kk..8kk+7] as a0 (g, 2q..), a1 (g+8, 2q..), a2 (g, 2q+8..), a3 (g+8, 2q+8..)
    for kk in range(BLOCK_K // 16):
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            ids = [8 * kk + 2 * a for a in range(4)]
            got = [(row[lane * 32 + i] % 16, col[lane * 32 + i]) for i in ids]
            assert got == [(g, 16 * kk + 2 * q), (g + 8, 16 * kk + 2 * q),
                           (g, 16 * kk + 2 * q + 8), (g + 8, 16 * kk + 2 * q + 8)]


def test_f32_maps_cover_each_score_and_output_once():
    thread, slot, row, col = f32_score_map()
    counts = np.zeros((F32_ROWS, BLOCK_K), int)
    np.add.at(counts, (row, col), 1)
    assert (counts == 1).all()
    # a row's 16 threads sit in one half-warp: the xor-8..1 shuffles stay in it
    for r in range(F32_ROWS):
        owners = thread[row == r]
        assert len(np.unique(owners)) == 16 and len(np.unique(owners >> 4)) == 1
    for dp in (64, 128):
        orow, ocol = f32_output_map(dp)
        counts = np.zeros((F32_ROWS, dp), int)
        np.add.at(counts, (orow, ocol), 1)
        assert (counts == 1).all()


@pytest.mark.parametrize('dp', [64, 128])
def test_swizzle_is_a_permutation_and_spreads_banks(dp):
    smem = swizzled_tile(128, dp)
    assert (np.sort(smem) == np.arange(128 * dp)).all()
    # the 8 rows of one logical chunk fall in 8 distinct 16-byte bank groups
    for r0 in range(0, 128, 8):
        for c in range(dp // 8):
            assert len({(swz(r0 + r, c, 128) * 2 // 16) % 8 for r in range(8)}) == 8


@pytest.mark.parametrize('nw', [4, 8])
@pytest.mark.parametrize('dp', [64, 128])
def test_descriptors_select_the_operands(dp, nw):
    """The kernel's descriptors for Q (A of S, K-major), K (B of S, K-major)
    and V (B of P V, MN-major) select, at every k16 step, the elements the
    products need from the swizzled tiles."""
    bq = 16 * nw
    panel_q, panel_k = bq * 128, BLOCK_K * 128
    q_tile, kv_tile = swizzled_tile(bq, dp), swizzled_tile(BLOCK_K, dp)
    x, k = np.meshgrid(np.arange(64), np.arange(16), indexing='ij')
    for wg in range(nw // 4):
        for kk in range(dp // 16):
            desc = gmma_desc(wg * 64 * 128 + (kk >> 2) * panel_q + (kk & 3) * 32, 16, 1024)
            np.testing.assert_array_equal(read_operand(q_tile, desc, False),
                                          (64 * wg + x) * dp + 16 * kk + k)
    for kk in range(dp // 16):                      # K: n = key, k = d
        desc = gmma_desc((kk >> 2) * panel_k + (kk & 3) * 32, 16, 1024)
        np.testing.assert_array_equal(read_operand(kv_tile, desc, False), x * dp + 16 * kk + k)
    for kk in range(BLOCK_K // 16):                 # V: n = d column, k = key
        for pn in range(dp // 64):
            desc = gmma_desc(pn * panel_k + kk * 2048, panel_k, 1024)
            np.testing.assert_array_equal(read_operand(kv_tile, desc, True),
                                          (16 * kk + k) * dp + 64 * pn + x)


@pytest.mark.parametrize('nw', [4, 8])
@pytest.mark.parametrize('dp', [64, 128])
def test_output_staging_covers_each_output_once(dp, nw):
    """The epilogue: thread (warp, g, q) writes acc[pn][i], acc[pn][i+1]
    (i even) as one bf16 pair at swz(16w + g + 8h, 8pn + i/4) + 2q; the 16
    rows x DP of each warp are written once, each at its own column, and read
    back by the 16-byte stores at swz(16w + r, c)."""
    bq = 16 * nw
    smem = np.full(bq * dp, -1, np.int64)
    for w in range(nw):
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            for pn in range(dp // 64):
                for i in range(0, 32, 2):
                    h = (i >> 1) & 1
                    r, col = 16 * w + g + 8 * h, 64 * pn + 8 * (i >> 2) + 2 * q
                    at = swz(r, 8 * pn + (i >> 2), bq) + 2 * q
                    assert (smem[at:at + 2] == -1).all()
                    smem[at:at + 2] = [r * dp + col, r * dp + col + 1]
    for r in range(bq):
        for c in range(dp // 8):
            at = swz(r, c, bq)
            np.testing.assert_array_equal(smem[at:at + 8], r * dp + 8 * c + np.arange(8))


@pytest.mark.parametrize('dp', [64, 128])
def test_f32_shared_reads_and_writes_are_conflict_free(dp):
    """K rows read as float4 by 8 consecutive tx (one quarter-warp) at pitch
    DP + 4 fall in 8 distinct 16-byte bank groups; the P tile written by one
    warp (2 rows x 16 keys) at pitch kPPitch hits 32 distinct banks."""
    pitch = dp + 4
    for tx0 in (0, 8):
        assert len({((tx0 + tx) * pitch // 4) % 8 for tx in range(8)}) == 8
    for ty0 in range(0, 16, 2):
        banks = {((ty0 + dy) * P_PITCH + tx) % 32 for dy in range(2) for tx in range(16)}
        assert len(banks) == 32


def _qkv(seed, shape, is_bf16):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    return [to_bf16(x) for x in xs] if is_bf16 else xs


@functools.lru_cache(maxsize=None)
def _reference(t, d, dtype, rate):
    """(q, k, v) and the plain version's and the Pallas kernel's (out, lse)."""
    is_bf16 = dtype == 'bfloat16'
    q, k, v = _qkv(100 * t + d, (1, 2, t, d), is_bf16)
    tdt = torch.bfloat16 if is_bf16 else torch.float32
    plain = tattn.flash_attention_forward_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), seed=1234, dropout_rate=rate,
        return_lse=True)
    jdt = jnp.bfloat16 if is_bf16 else jnp.float32
    pallas = jattn._flash_forward(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), 1234, float(1.0 / np.sqrt(d)), 128, 128,
        interpret=True, return_lse=True, dropout_rate=rate)
    return ((q, k, v), [(plain[0].float().numpy(), plain[1].numpy()),
                        (np.asarray(pallas[0], np.float32), np.asarray(pallas[1]))])


@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('dtype,nw', [('float32', None), ('bfloat16', 4), ('bfloat16', 8)])
@pytest.mark.parametrize('d', [16, 40, 64, 128])
@pytest.mark.parametrize('t', [1, 41, 64, 65, 130])
def test_block_model_matches_plain_version_and_pallas(t, d, dtype, nw, rate):
    (q, k, v), wants = _reference(t, d, dtype, rate)
    got, got_lse = model_forward(q, k, v, nw, seed=1234, rate=rate)
    for want, want_lse in wants:
        np.testing.assert_allclose(got, want, atol=LIMITS[dtype], rtol=0)
        np.testing.assert_allclose(got_lse, want_lse, atol=LSE_LIMIT, rtol=0)
