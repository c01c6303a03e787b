"""A numpy model of the FusedAdamW tail's kernels (ops/csrc/adamw.cu), written
after the CUDA source, against the plain version (``adamw_update_reference``,
``global_norm``, ``tail_scalars_reference``), the JAX package's Pallas
``adamw_update_leaf`` in interpret mode, its ``FusedAdamW`` and
``optax.global_norm``.

The kernels run only on the GPU; this model pins their work plan on the CPU.
The leaves live in one byte-addressed memory at the addresses a device would
give them; the port's own ``block_table`` (the host half of the kernels)
cuts the parameters and moments into rows of kChunk elements (the
gradients' addresses come per step, one per leaf), and the model walks those
rows as the kernels do: the vector path (each thread's kUnroll groups of
four elements, every load before any store), the scalar tail of count % 4
elements per block, the one-element-per-thread path of a leaf whose p, mu or
nu is not aligned, a gradient read a float at a time when it is not; the
norm's f64 partial per block of kNormRows rows (each thread's additions in
the kernel's order, the butterfly within warps, the warps' sums), the last
block found by a ticket that sums the partials in index order and leaves
the ticket at 0; and the scalars and counter written from the norm.  Leaves of
1, 3 and 71 elements, exactly one block, one block plus one, and views at a
16-byte and at a 4-byte offset into a larger buffer.

Tolerances: the update bit for bit against the plain version (the kernel
repeats its IEEE operations in order); against JAX, tests/test_torch_optim.py's
bars (rtol 2e-5, atol 1e-7: XLA may contract a multiply-add; a bf16 mu one
bf16 ulp, rtol 2**-7); the norm rtol 1e-6 against optax
(``test_global_norm_matches_optax``'s bar); the scalars and counter bit for
bit against the plain version and JAX's expressions.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecg_representation_learning_tpu.ops.adamw_pallas import adamw_update_leaf
from ecg_representation_learning_tpu.train import optim as joptim
from ecg_representation_learning_tpu_torch.ops import adamw

torch.set_num_threads(2)

# constants of adamw.cu
THREADS = 256                 # kThreads
UNROLL = 4                    # kUnroll: groups of 4 elements per thread
CHUNK = THREADS * 4 * UNROLL  # kChunk
WARPS = THREADS // 32
NORM_ROWS = 4                 # kNormRows: block-table rows per norm block
SUM_BATCH = 8                 # kSumBatch
HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)
BASE = 0x7F3A00000000         # where the model's memory starts (512-byte aligned)
F32 = np.float32
# (clip scale, lr, bc1, bc2, finite): a plain step, the clip engaged, a
# non-finite step (g zeroed by select)
STEPS = {'plain': (1.0, 3e-4, 0.1, 0.001, 1.0), 'clip': (0.37, 1e-3, 0.19, 0.002, 1.0),
         'nonfinite': (1.0, 3e-4, 0.271, 0.003, 0.0)}
# leaf sizes: 1, 3, the 71-wide head bias, one block, one block + 1, a ragged
# multi-block leaf
SIZES = [1, 3, 71, CHUNK, CHUNK + 1, 3 * CHUNK + 770]


def _source() -> str:
    return (Path(adamw.__file__).parent / 'csrc' / 'adamw.cu').read_text()


@pytest.mark.parametrize('name,value', [('kThreads', THREADS), ('kUnroll', UNROLL),
                                        ('kNormRows', NORM_ROWS), ('kSumBatch', SUM_BATCH)])
def test_model_constants_are_the_sources(name, value):
    assert re.search(rf'constexpr int {name} = (\d+);', _source()).group(1) == str(value)


def test_chunk_and_row_layout_are_the_sources():
    """kChunk from the constants; a block-table row is the Block struct:
    p, mu, nu, start as int64, then leaf and count, vec and pad as int32
    pairs, which block_table packs low half first."""
    src = _source()
    assert 'constexpr int kChunk = kThreads * 4 * kUnroll;' in src
    fields = re.search(r'struct Block \{(.*?)\};', src, re.S).group(1)
    assert re.findall(r'(long long|int) ([\w, ]+);', fields) == [
        ('long long', 'p, mu, nu'), ('long long', 'start'), ('int', 'leaf, count'),
        ('int', 'vec, pad')]
    assert adamw._BLOCK_COLS == 6


# --- memory ---------------------------------------------------------------

class Memory:
    """One byte-addressed buffer; ``place`` puts an array at an address."""

    def __init__(self, nbytes: int):
        self.buf = np.zeros(nbytes, np.uint8)
        self.next = 0

    def place(self, arr: np.ndarray, offset: int = 0) -> int:
        """Put ``arr`` at the next 512-byte boundary plus ``offset`` bytes
        (a device allocation, or a view ``offset`` bytes into one)."""
        start = -(-self.next // 512) * 512 + offset
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        self.buf[start:start + raw.size] = raw
        self.next = start + raw.size
        return BASE + start

    def read(self, addr: int, n: int, dtype) -> np.ndarray:
        item = np.dtype(dtype).itemsize
        off = addr - BASE
        return self.buf[off:off + n * item].copy().view(dtype)

    def write(self, addr: int, values: np.ndarray) -> None:
        raw = np.ascontiguousarray(values).view(np.uint8).reshape(-1)
        off = addr - BASE
        self.buf[off:off + raw.size] = raw


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits, rounded to nearest even (``__float2bfloat16``)."""
    u = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(F32)


def make_leaves(rng, sizes, mu_dtype, nan_at=None):
    """Numpy p, g, mu, nu per leaf (mu as f32 values that are exact in
    ``mu_dtype``), and ``nan_at`` = (leaf, element) set to NaN in g."""
    leaves = []
    for i, n in enumerate(sizes):
        g = rng.standard_normal(n).astype(F32)
        if nan_at is not None and nan_at[0] == i:
            g[nan_at[1]] = np.nan
        mu = (0.1 * rng.standard_normal(n)).astype(F32)
        if mu_dtype == 'bfloat16':
            mu = bf16_to_f32(bf16_bits(mu))
        leaves.append({'p': rng.standard_normal(n).astype(F32), 'g': g, 'mu': mu,
                       'nu': rng.uniform(1e-4, 1e-2, n).astype(F32)})
    return leaves


def place_leaves(leaves, mu_dtype, offsets=None):
    """The leaves in one Memory: (memory, (leaves, 4) addresses of p, g, mu,
    nu)."""
    mu_bytes = 2 if mu_dtype == 'bfloat16' else 4
    total = sum(l['p'].size * (12 + mu_bytes) for l in leaves) + 4 * 600 * len(leaves) + 4096
    mem = Memory(total)
    ptrs = []
    for i, l in enumerate(leaves):
        off = (offsets or {}).get(i, {})
        mu = bf16_bits(l['mu']) if mu_bytes == 2 else l['mu']
        ptrs.append([mem.place(l['p'], off.get('p', 0)), mem.place(l['g'], off.get('g', 0)),
                     mem.place(mu, off.get('mu', 0)), mem.place(l['nu'], off.get('nu', 0))])
    return mem, np.array(ptrs, np.int64)


# --- the kernels ------------------------------------------------------------

def thread_elements(count: int, vec: int):
    """The elements of a block each thread touches, in the order it adds
    them in the norm: (vector groups: (threads, kUnroll * 4) element indices
    or -1 past the end; tail: (threads,) index or -1) for the vector path,
    else (threads, ceil(count / threads)) for the one-per-thread path."""
    t = np.arange(THREADS)
    if not vec:
        k = max(1, -(-count // THREADS))
        e = t[:, None] + THREADS * np.arange(k)[None, :]
        return np.where(e < count, e, -1), None
    n4 = count >> 2
    q = np.arange(UNROLL)[None, :] * THREADS + t[:, None]            # (threads, unroll)
    groups = np.where(q < n4, q, -1)
    e = np.where(groups[:, :, None] >= 0, 4 * groups[:, :, None] + np.arange(4), -1)
    tail = 4 * n4 + t
    return e.reshape(THREADS, 4 * UNROLL), np.where(tail < count, tail, -1)


def covered(count: int, vec: int) -> np.ndarray:
    body, tail = thread_elements(count, vec)
    idx = body[body >= 0]
    if tail is not None:
        idx = np.concatenate([idx, tail[tail >= 0]])
    return idx


def sqrt_f32(x: np.ndarray) -> np.ndarray:
    """The square root of the plain version on this device: PyTorch's CPU
    sqrt is not correctly rounded for every input (the card's __fsqrt_rn and
    PyTorch's CUDA sqrt are), so the model takes the device's, and the update
    is bit for bit against the plain version on one device."""
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def adam_f32(g, mu, nu, p, s):
    """``adam`` in adamw.cu: the plain version's f32 operations in order."""
    scale, lr, bc1, bc2, finite = (F32(v) for v in s)
    b1, b2 = F32(HYPER['b1']), F32(HYPER['b2'])
    omb1, omb2 = F32(1.0 - HYPER['b1']), F32(1.0 - HYPER['b2'])
    gi = g * scale if finite > 0 else np.zeros_like(g)
    m = b1 * mu + omb1 * gi
    v = b2 * nu + omb2 * (gi * gi)
    upd = (m / bc1) / (sqrt_f32(v / bc2) + F32(HYPER['eps']))
    upd = upd + F32(HYPER['wd']) * p
    return m, v, p - lr * upd


def table(ptrs: np.ndarray, sizes, mu_bytes: int):
    """The port's block table for leaves at ``ptrs`` (p, g, mu, nu), and the
    gradients' addresses (gptrs) that reach the kernels each step."""
    return adamw.block_table(ptrs[:, [0, 2, 3]], sizes, mu_bytes, CHUNK), ptrs[:, 1]


def unpack(row):
    """A Block: (p, mu, nu, start, leaf, count, vec)."""
    p, mu, nu, start, packed, vec = (int(v) for v in row)
    return p, mu, nu, start, packed & 0xFFFFFFFF, packed >> 32, vec & 0xFFFFFFFF


def update_model(mem: Memory, rows: np.ndarray, gptrs: np.ndarray, s, mu_bf16: bool) -> None:
    """adamw_update_kernel over every row: each block loads all its elements
    (the vector groups, then the tail -- they are disjoint; g at gptrs[leaf]
    + start, as float4 or, unaligned, one float at a time: the same
    elements), computes, stores."""
    with np.errstate(invalid='ignore', over='ignore'):
        for row in rows:
            pa, ma, na, start, leaf, count, vec = unpack(row)
            idx = covered(count, vec)
            if idx.size == 0:
                continue
            g = mem.read(int(gptrs[leaf]) + 4 * start, count, F32)[idx]
            nu = mem.read(na, count, F32)[idx]
            p = mem.read(pa, count, F32)[idx]
            mu = (bf16_to_f32(mem.read(ma, count, np.uint16)) if mu_bf16
                  else mem.read(ma, count, F32))[idx]
            m, v, q = adam_f32(g, mu, nu, p, s)
            for addr, new in ((pa, q), (na, v)):
                arr = mem.read(addr, count, F32)
                arr[idx] = new
                mem.write(addr, arr)
            arr = mem.read(ma, count, np.uint16 if mu_bf16 else F32)
            arr[idx] = bf16_bits(m) if mu_bf16 else m
            mem.write(ma, arr)


def butterfly(x: np.ndarray) -> np.ndarray:
    """__shfl_xor_sync sums over offsets 16 .. 1 within each warp of ``x``
    (warps, 32): every lane ends with its warp's sum, in the same bits."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[:, lanes ^ off]
    return x


def block_sum(acc: np.ndarray) -> np.float64:
    """block_sum: the butterfly per warp, then warp 0 over the warps' sums."""
    warp_sums = butterfly(acc.reshape(WARPS, 32))[:, 0]
    lane = np.zeros((1, 32))
    lane[0, :WARPS] = warp_sums
    return butterfly(lane)[0, 0]


def take(g: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """g at idx, clipped into range (callers mask the entries past the end)."""
    return g[np.clip(idx, 0, len(g) - 1)] if len(g) else np.zeros(idx.shape, F32)


def sq_sum(acc: np.ndarray, vals: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Each thread adds the exact f64 square of its value where ``valid``."""
    v = np.where(valid, vals, 0.0).astype(np.float64)
    return np.where(valid, acc + v * v, acc)


def norm_block_partial(parts) -> np.float64:
    """One block of adamw_norm_kernel over its rows ``parts`` = [(g of the
    row's chunk, count, g aligned)]: each thread adds its vector groups'
    squares for every row in row order (a group past the end, or every group
    of an unaligned row, is 0 and adds nothing), then each row's count % 4
    tail, or all of an unaligned row one element per thread; then block_sum."""
    t = np.arange(THREADS)
    acc = np.zeros(THREADS)
    for g, count, vec in parts:
        n4 = count >> 2 if vec else 0
        for u in range(UNROLL):
            q = u * THREADS + t
            for j in range(4):
                acc = sq_sum(acc, take(g, 4 * q + j), q < n4)
    for g, count, vec in parts:
        if vec:
            e = 4 * (count >> 2) + t
            acc = sq_sum(acc, take(g, e), e < count)
        else:
            for k in range(-(-count // THREADS)):
                e = k * THREADS + t
                acc = sq_sum(acc, take(g, e), e < count)
    return block_sum(acc)


def finish(norm: np.float32, clip, zero_nonfinite: bool, count_in: int):
    """``finish`` in adamw.cu: (scale, finite flag, count_out)."""
    finite = bool(np.isfinite(norm))
    scale = F32(1.0)
    if clip is not None:
        m = F32(1e-16) if norm < F32(1e-16) else norm
        with np.errstate(invalid='ignore', divide='ignore'):
            r = F32(clip) / m
        scale = F32(1.0) if r > F32(1.0) else r
    flag = F32(1.0)
    if zero_nonfinite:
        if not finite:
            scale = F32(1.0)
        flag = F32(1.0 if finite else 0.0)
    return scale, flag, count_in + (0 if finite else 1)


def norm_model(mem: Memory, rows: np.ndarray, gptrs: np.ndarray, order=None):
    """adamw_norm_kernel: ceil(rows / NORM_ROWS) blocks of NORM_ROWS rows
    each, run in ``order`` (the order they finish), each writing its partial
    and taking a ticket; the one that takes the last ticket sums the
    partials (thread t: partials t, t + 256, ... in order -- the kernel loads
    SUM_BATCH of them at a time and adds 0 past the end; then block_sum) and
    resets the ticket.  Returns (f32 norm, ticket after)."""
    n = -(-len(rows) // NORM_ROWS)
    partials = np.full(n, np.nan)
    ticket, norm = 0, None
    for b in (range(n) if order is None else order):
        parts = []
        for row in rows[b * NORM_ROWS:(b + 1) * NORM_ROWS]:
            _, _, _, start, leaf, count, _ = unpack(row)
            g_addr = int(gptrs[leaf])
            parts.append((mem.read(g_addr + 4 * start, count, F32), count, g_addr % 16 == 0))
        partials[b] = norm_block_partial(parts)
        mine, ticket = ticket, ticket + 1
        if mine == n - 1:
            acc = np.zeros(THREADS)
            for i in range(0, n, THREADS):
                chunk = partials[i:i + THREADS]
                acc[:chunk.size] = acc[:chunk.size] + chunk
            with np.errstate(invalid='ignore'):
                norm = F32(np.sqrt(block_sum(acc)))
            ticket = 0
    return norm, ticket


# --- helpers -----------------------------------------------------------------

def torch_leaves(leaves, mu_dtype):
    mu_t = torch.bfloat16 if mu_dtype == 'bfloat16' else torch.float32
    return ([torch.from_numpy(l['p'].copy()) for l in leaves],
            [torch.from_numpy(l['g'].copy()) for l in leaves],
            [torch.from_numpy(l['mu'].copy()).to(mu_t) for l in leaves],
            [torch.from_numpy(l['nu'].copy()) for l in leaves])


def read_leaves(mem, ptrs, sizes, mu_bf16):
    out = []
    for (pa, _, ma, na), n in zip(ptrs, sizes):
        mu = (bf16_to_f32(mem.read(int(ma), n, np.uint16)) if mu_bf16
              else mem.read(int(ma), n, F32))
        out.append({'p': mem.read(int(pa), n, F32), 'mu': mu, 'nu': mem.read(int(na), n, F32)})
    return out


def bits(x) -> np.ndarray:
    return np.asarray(x, F32).view(np.uint32)


# --- tests -------------------------------------------------------------------

@pytest.mark.parametrize('n', SIZES + [0, 2 * CHUNK, CHUNK - 1])
@pytest.mark.parametrize('vec', [1, 0])
def test_each_block_covers_its_elements_once(n, vec):
    rows, _ = table(np.zeros((1, 4), np.int64), [n], 4)
    assert len(rows) == max(1, -(-n // CHUNK))
    for b, row in enumerate(rows):
        p, mu, nu, start, leaf, count, _ = unpack(row)
        assert (p, mu, nu, start, leaf) == (4 * b * CHUNK, 4 * b * CHUNK, 4 * b * CHUNK,
                                            b * CHUNK, 0)
        assert count == min(CHUNK, n - b * CHUNK)
        idx = covered(count, vec)
        assert np.array_equal(np.sort(idx), np.arange(count)), (b, count)


def test_rows_of_several_leaves():
    """Blocks in leaf order, each leaf's from its own first element; mu's
    addresses step by its element size."""
    sizes = [3, CHUNK + 1, 71]
    ptrs = np.array([[1 << 20, 0, 2 << 20, 3 << 20], [4 << 20, 0, 5 << 20, 6 << 20],
                     [7 << 20, 0, 8 << 20, 9 << 20]], np.int64)
    rows, _ = table(ptrs, sizes, 2)
    got = [unpack(r) for r in rows]
    assert [r[4] for r in got] == [0, 1, 1, 2] and [r[5] for r in got] == [3, CHUNK, 1, 71]
    assert got[2][:4] == (ptrs[1, 0] + 4 * CHUNK, ptrs[1, 2] + 2 * CHUNK,
                          ptrs[1, 3] + 4 * CHUNK, CHUNK)


def test_vector_path_reads_whole_groups_and_loads_before_stores():
    """A thread's groups are 16-byte aligned runs of 4, neighbouring threads
    on neighbouring groups; the tail is count % 4 elements, one per thread."""
    body, tail = thread_elements(CHUNK - 3, 1)
    groups = body.reshape(THREADS, UNROLL, 4)
    valid = groups[:, :, 0] >= 0
    assert (groups[valid][:, 0] % 4 == 0).all()
    assert (np.diff(groups[valid], axis=1) == 1).all()
    assert (np.diff(groups[:, 0, 0]) == 4).all()          # coalesced across threads
    assert (tail >= 0).sum() == (CHUNK - 3) % 4 and tail[0] == 4 * ((CHUNK - 3) // 4)
    src = _source()
    body_src = src[src.index('adamw_update_kernel('):src.index('// sum over the block')]
    loads, compute = body_src.index('every load first'), body_src.index('Mu4<MuT>::get')
    assert loads < compute and '__stcs' not in body_src[loads:compute]


@pytest.mark.parametrize('mu_dtype,offsets,vec,g_vec', [
    ('float32', {}, 1, 1),
    ('float32', {'p': 16, 'g': 32, 'mu': 16, 'nu': 48}, 1, 1),   # 16-byte offset views
    ('float32', {'g': 4}, 1, 0),          # a 4-byte offset of g: g one float at a time
    ('float32', {'p': 4}, 0, 1),          # of p: the leaf one element per thread
    ('float32', {'mu': 8}, 0, 1),
    ('bfloat16', {'mu': 8}, 1, 1),        # 4 bf16 = 8 bytes
    ('bfloat16', {'mu': 2}, 0, 1),
])
def test_alignment_rule(mu_dtype, offsets, vec, g_vec):
    """The row's flag covers p, mu, nu; the kernels test g's address, which
    comes each step, themselves."""
    leaves = make_leaves(np.random.default_rng(0), [71, CHUNK + 1], mu_dtype)
    _, ptrs = place_leaves(leaves, mu_dtype, {1: offsets})
    rows, gptrs = table(ptrs, [71, CHUNK + 1], 2 if mu_dtype == 'bfloat16' else 4)
    assert rows[0, 5] == 1 and (rows[1:, 5] == vec).all()
    assert gptrs[0] % 16 == 0 and (gptrs[1] % 16 == 0) == g_vec
    src = _source()
    assert src.count('(g_addr & 15) == 0') == 2   # the update's g loads and the norm


@pytest.mark.parametrize('step', list(STEPS))
@pytest.mark.parametrize('mu_dtype', ['float32', 'bfloat16'])
def test_update_model_matches_plain_bit_for_bit(mu_dtype, step):
    rng = np.random.default_rng(len(step) + (mu_dtype == 'bfloat16'))
    leaves = make_leaves(rng, SIZES, mu_dtype,
                         nan_at=(2, 5) if step == 'nonfinite' else None)
    # 16-byte views; a leaf with an unaligned nu (one element per thread); an
    # unaligned g in the vector path
    offsets = {4: {'p': 16, 'g': 16, 'nu': 16, 'mu': 16 if mu_dtype == 'float32' else 8},
               3: {'nu': 4}, 5: {'g': 4}}
    mem, ptrs = place_leaves(leaves, mu_dtype, offsets)
    mu_bytes = 2 if mu_dtype == 'bfloat16' else 4
    rows, gptrs = table(ptrs, SIZES, mu_bytes)
    assert rows[:, 5].min() == 0 and rows[:, 5].max() == 1   # both paths run
    assert (gptrs % 16 != 0).any()
    update_model(mem, rows, gptrs, STEPS[step], mu_bytes == 2)
    p, g, mu, nu = torch_leaves(leaves, mu_dtype)
    adamw.adamw_update_reference(p, g, mu, nu, torch.tensor(STEPS[step]), **HYPER)
    for got, tp, tmu, tnu in zip(read_leaves(mem, ptrs, SIZES, mu_bytes == 2), p, mu, nu):
        assert np.array_equal(bits(got['p']), bits(tp.numpy()))
        assert np.array_equal(bits(got['nu']), bits(tnu.numpy()))
        assert np.array_equal(bits(got['mu']), bits(tmu.float().numpy()))
        assert np.isfinite(got['p']).all()


@pytest.mark.parametrize('shape', [(768,), (256, 128), (41, 768)])
def test_update_model_matches_pallas_interpret(shape):
    """Lane-multiple leaves, the ones the JAX package sends to its kernel."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(n)
    leaves = make_leaves(rng, [n], 'float32')
    mem, ptrs = place_leaves(leaves, 'float32')
    s = STEPS['clip']
    update_model(mem, *table(ptrs, [n], 4), s, False)
    l = leaves[0]
    want = adamw_update_leaf(*(jnp.asarray(l[k].reshape(shape)) for k in ('g', 'mu', 'nu', 'p')),
                             jnp.asarray([s], jnp.float32), interpret=True, **HYPER)
    got = read_leaves(mem, ptrs, [n], False)[0]
    for k, w in zip(('mu', 'nu', 'p'), want):
        np.testing.assert_allclose(got[k], np.asarray(w).reshape(-1), rtol=2e-5, atol=1e-7)


def test_update_model_with_bf16_mu_matches_jax_fused_adamw():
    """JAX's FusedAdamW (the jnp leaf) with a bf16 first moment, one step
    with the clip engaged."""
    rng = np.random.default_rng(11)
    sizes = [71, CHUNK + 1, 768]
    leaves = make_leaves(rng, sizes, 'bfloat16')
    for l in leaves:
        l['nu'][:] = 0.0
    mem, ptrs = place_leaves(leaves, 'bfloat16')
    tree = lambda k: {f'l{i}': jnp.asarray(l[k]) for i, l in enumerate(leaves)}
    jopt = joptim.FusedAdamW(3e-4, weight_decay=1e-2, clip_norm=1.0, mu_dtype='bfloat16')
    state = jopt.init(tree('p'))
    state = state._replace(mu={k: v.astype(jnp.bfloat16) for k, v in tree('mu').items()})
    jp, jstate = jax.jit(jopt.apply)(tree('g'), state, tree('p'))
    jmu = jstate.mu
    norm = F32(optax.global_norm(tree('g')))
    scale, flag, _ = finish(norm, 1.0, False, 0)
    s = (scale, 3e-4, F32(1) - F32(0.9), F32(1) - F32(0.999), flag)
    update_model(mem, *table(ptrs, sizes, 2), s, True)
    for i, got in enumerate(read_leaves(mem, ptrs, sizes, True)):
        np.testing.assert_allclose(got['p'], np.asarray(jp[f'l{i}']), rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(got['mu'], np.asarray(jmu[f'l{i}'], np.float32),
                                   rtol=2 ** -7, atol=1e-9)


@pytest.mark.parametrize('offsets', [{}, {1: {'g': 16}, 4: {'g': 4}}])
def test_norm_model_matches_optax_and_plain(offsets):
    rng = np.random.default_rng(5)
    leaves = make_leaves(rng, SIZES, 'float32')
    mem, ptrs = place_leaves(leaves, 'float32', offsets)
    norm, ticket = norm_model(mem, *table(ptrs, SIZES, 4))
    want = float(optax.global_norm([jnp.asarray(l['g']) for l in leaves]))
    np.testing.assert_allclose(norm, want, rtol=1e-6)
    plain = float(adamw.global_norm([torch.from_numpy(l['g']) for l in leaves]))
    np.testing.assert_allclose(norm, plain, rtol=1e-6)
    exact = np.sqrt(sum(float(np.sum(l['g'].astype(np.float64) ** 2)) for l in leaves))
    np.testing.assert_allclose(norm, exact, rtol=2 ** -23)   # f64 sums: one f32 ulp
    assert ticket == 0


def test_norm_is_the_same_bits_whichever_block_finishes_last():
    rng = np.random.default_rng(6)
    sizes = [CHUNK * 3 + 5] * 300 + [1, 71]     # more than one partial per thread
    leaves = make_leaves(rng, sizes, 'float32')
    mem, ptrs = place_leaves(leaves, 'float32', {7: {'g': 4}})
    rows, gptrs = table(ptrs, sizes, 4)
    assert -(-len(rows) // NORM_ROWS) > THREADS
    first, _ = norm_model(mem, rows, gptrs)
    for seed in range(3):
        order = np.random.default_rng(seed).permutation(-(-len(rows) // NORM_ROWS))
        again, ticket = norm_model(mem, rows, gptrs, order)
        assert bits(again) == bits(first) and ticket == 0


def test_a_nan_gradient_gives_a_nan_norm():
    leaves = make_leaves(np.random.default_rng(7), SIZES, 'float32', nan_at=(5, 4000))
    mem, ptrs = place_leaves(leaves, 'float32')
    norm, ticket = norm_model(mem, *table(ptrs, SIZES, 4))
    assert np.isnan(norm) and ticket == 0


@pytest.mark.parametrize('zero_nonfinite', [True, False])
@pytest.mark.parametrize('clip', [None, 1.0, 0.25])
@pytest.mark.parametrize('norm', [0.0, 1e-20, 0.5, 1.0, 3.7, 9258.3, np.inf, np.nan])
def test_scalars_and_counter_match_plain_and_jax(norm, clip, zero_nonfinite):
    norm = F32(norm)
    scale, flag, count = finish(norm, clip, zero_nonfinite, 4)
    lr_bc = (3e-4, 0.1, 0.001)
    want = adamw.tail_scalars_reference(torch.tensor(norm), lr_bc, clip_norm=clip,
                                        zero_nonfinite=zero_nonfinite)
    assert np.array_equal(bits([scale, *lr_bc, flag]), bits(want.numpy()))
    _, t_count = adamw.adamw_tail_reference(
        [torch.zeros(1)], [torch.zeros(1)], [torch.zeros(1)], [torch.zeros(1)], lr_bc,
        torch.tensor(4, dtype=torch.int32), clip_norm=clip, zero_nonfinite=zero_nonfinite,
        g_norm=torch.tensor(norm), **HYPER)
    assert count == int(t_count) == 4 + (not np.isfinite(norm))
    # JAX's FusedAdamW.apply expressions
    j = jnp.float32(norm)
    jscale = jnp.asarray(1.0, jnp.float32)
    if clip is not None:
        jscale = jnp.minimum(1.0, clip / jnp.maximum(j, 1e-16))
    if zero_nonfinite:
        jscale = jnp.where(jnp.isfinite(j), jscale, 1.0)
    assert bits(scale) == bits(np.asarray(jscale, F32))
