"""Flash kernels #1-#4 with a band and grouped KV heads on the card.

Every test here needs a CUDA device and skips without one; on a machine with
a card run them with ``python -m pytest --noconftest -p no:cacheprovider -m
card tests/test_torch_flash_window_card.py`` (this file imports no JAX).

  * the forward with and without lse (#2, #1), dQ (#3) and dK/dV (#4) match
    their plain versions (``ops/attention.py``'s ``*_reference``, dense
    masked softmax over k and v expanded to q's heads) at the Trinity cell's
    attention -- q (2, 32, 8192, 128), k and v (2, 4, 8192, 128) bf16, causal,
    with no window and with 2,047 keys -- at ViT-base's long records (2, 12,
    2048, 64), and at small shapes that reach every branch: T not a multiple
    of a tile, T <= 48 (the f32 48-row tiles), D not a multiple of 16 bytes,
    W = 0, W >= T, a bidirectional window, H_kv = 1 and H_kv = H, dropout.
    The limits are chip_smoke.py's for #1-#4: f32 1e-5 on the output and
    2e-5 (of max(1, max |plain|)) on the gradients, bf16 2e-2 on both (8
    significant bits), the lse 1e-5; besides, a bf16 output and each bf16
    gradient within REL_LIMIT of the plain one by the norm of the error over
    the plain result's norm, since at T = 8,192 an output element is about
    0.03 and 2e-2 of abs would pass a wrong key; the plain versions run a KV
    group at a time at the cell's shape (its T x T probabilities are 2 GB a
    head group);
  * the same check fails kernels whose window is one key off the plain
    versions' (the plain versions given window_left + 1);
  * a banded call of ``flash_attention`` and its gradient counts one launch
    of #2, #3 and #4 under their names in the launch registry.

The default calls' bits against another checkout's kernels are held by
``python -m ecg_representation_learning_tpu_torch.tools.flash_band_probe
--other ROOT``, which chip_smoke.py's ``--flash-other ROOT`` runs.
"""
import pytest
import torch

from ecg_representation_learning_tpu_torch.ops import _build
from ecg_representation_learning_tpu_torch.ops import attention as attn

OUT_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRAD_LIMIT = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_LIMIT = 1e-5
# bf16: |got - plain| / |plain| over the whole output or gradient (an RMS of
# 1e-3 at least: ``flash_band_probe.REL_FLOOR``); bf16 rounds p, ds and the
# results to 8 significant bits: the sound kernels read <= 3.2e-3, a window
# one key off 1.3e-2 at the cell's shape and 2.6e-2 at ViT-base's
REL_LIMIT = 6e-3
BF16, F32 = torch.bfloat16, torch.float32
# (B, H, H_kv, T, D, dtype, causal, window_left, dropout rate)
CELL = [(2, 32, 4, 8192, 128, BF16, True, -1, 0.0), (2, 32, 4, 8192, 128, BF16, True, 2047, 0.0)]
CASES = [(2, 12, 12, 2048, 64, BF16, False, -1, 0.0), (2, 12, 12, 2048, 64, BF16, True, 511, 0.0),
         (2, 8, 2, 300, 64, F32, True, 100, 0.0), (2, 8, 2, 300, 64, BF16, True, 100, 0.1),
         (1, 4, 1, 130, 128, F32, True, -1, 0.0), (1, 4, 4, 130, 128, BF16, True, 0, 0.0),
         (3, 6, 3, 200, 80, BF16, False, 50, 0.0), (1, 2, 1, 41, 64, F32, True, 7, 0.1),
         (2, 4, 2, 41, 64, BF16, True, 64, 0.0), (1, 4, 2, 1000, 128, F32, True, 2000, 0.0),
         (2, 16, 4, 777, 128, BF16, True, 255, 0.1)]


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _inputs(case, dev, seed: int = 0):
    b, h, hk, t, d, dtype, *_ = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((b, h, t, d), generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, hk, t, d), generator=g, device=dev).to(dtype) for _ in range(2))
    return q, k, v, do


def _errors(case, dev, plain_window=None):
    from ecg_representation_learning_tpu_torch.tools import flash_band_probe
    return flash_band_probe.band_errors(case, dev, plain_window=plain_window)


def _over_rel(err, dtype):
    """The bf16 results whose norm-relative error passes REL_LIMIT."""
    if dtype != BF16:
        return []
    return [n for n in ('out', 'dq', 'dk', 'dv') if err[f'{n}_rel'] > REL_LIMIT]


def _check(case, dev):
    dtype = case[5]
    err = _errors(case, dev)
    assert err['fwd_is_lse_fwd'] and err['finite'], err      # #1 gives #2's output
    assert err['out'] <= OUT_LIMIT[dtype] and err['lse'] <= LSE_LIMIT, err
    assert max(err['dq'], err['dk'], err['dv']) <= GRAD_LIMIT[dtype], err
    assert not _over_rel(err, dtype), err


@pytest.mark.card
@pytest.mark.parametrize('case', CELL, ids=['cell_full', 'cell_window'])
def test_band_kernels_match_plain_at_the_cell(card, case):
    _check(case, card)


@pytest.mark.card
@pytest.mark.parametrize('case', CASES)
def test_band_kernels_match_plain(card, case):
    _check(case, card)


@pytest.mark.card
@pytest.mark.parametrize('case', [CELL[1], CASES[1]], ids=['cell_window', 'vitb_window'])
def test_a_window_one_key_off_fails_the_check(card, case):
    err = _errors(case, card, plain_window=case[7] + 1)
    assert _over_rel(err, case[5]) == ['out', 'dq', 'dk', 'dv'], err


@pytest.mark.card
def test_banded_calls_count_under_the_kernels_names(card):
    case = (1, 8, 2, 1024, 64, BF16, True, 255, 0.0)
    q, k, v, do = _inputs(case, card)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = _build.launch_counts()
    out = attn.flash_attention(q, k, v, causal=True, window_left=255)
    out.backward(do)
    after = _build.launch_counts()
    moved = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    assert moved == {'flash_fwd_lse': 1, 'flash_bwd_dq': 1, 'flash_bwd_dkv': 1}
    assert k.grad.shape == k.shape and v.grad.shape == v.shape

