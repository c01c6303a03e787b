"""Toy-size runs of the long-record cells on the CPU (``trinity_ep16_t8k_k4``
and ``vitb_long_mae_t2048``): the result line, the check's verdict on the
unbroken program, the new per-layer metrics of a traced run, and the check
catching a planted fault.  Toy sizes come through ``harness.Run.overrides``:
AFMoE at hidden 64, 4 query and 2 KV heads of 16, 32 tokens, a window of 8
keys, layers S S S F with 2 dense, 8 experts top-3 with 4 held; the
masked-signal trunk at hidden 64 over 128 patches with the blocked backward
(``BLOCKED_BWD_MIN_SEQ`` 0)."""
from __future__ import annotations

import time

import pytest
import torch

from port_bench import harness

TOY = {
    'trinity_ep16_t8k_k4': (
        {'hidden_size': 64, 'num_attention_heads': 4, 'num_key_value_heads': 2, 'head_dim': 16,
         'intermediate_size': 96, 'moe_intermediate_size': 32, 'num_hidden_layers': 4,
         'num_dense_layers': 2, 'num_experts': 4, 'num_experts_published': 8,
         'num_experts_per_tok': 3, 'sliding_window': 8, 'max_signal_length': 2048,
         'dtype': 'float32'},
        {'train_records': 32, 'record_samples': 2048, 'reference_chunk': 8}),
    'vitb_long_mae_t2048': (
        {'hidden_size': 64, 'num_hidden_layers': 2, 'num_attention_heads': 4,
         'intermediate_size': 128, 'dtype': 'float32'},
        {'train_records': 32, 'batch_size': 4, 'record_samples': 128 * 64}),
}


def _run(cell: str, trace: bool = False, seed: int = 2 ** 31 + 11):
    torch.manual_seed(0)
    config, traffic = TOY[cell]
    r = harness.Run(workload=cell, seed=seed, seconds=1.0, trace=trace,
                    device=torch.device('cpu'), t_process=time.perf_counter(),
                    overrides={'config': config, 'traffic': traffic})
    return harness.execute(r), r


@pytest.fixture(autouse=True)
def blocked_backward(monkeypatch):
    from ecg_representation_learning_tpu_torch.ops import attention
    monkeypatch.setattr(attention, 'BLOCKED_BWD_MIN_SEQ', 0)


@pytest.mark.parametrize('cell', sorted(TOY))
def test_toy_run_is_correct(cell):
    out, r = _run(cell)
    assert out['correct'] is True, out['checks']
    assert out['attempted'] > 0 and out['failed'] == 0
    e2e, _ = harness.metric_lists(cell)
    assert set(out['metrics']) == {m['name'] for m in e2e}
    assert out['metrics']['train_samples_per_s']['value'] > 0


def test_trinity_traced_run_reads_the_attention_regions():
    out, _ = _run('trinity_ep16_t8k_k4', trace=True)
    m = out['metrics']
    assert m['attn_window_ms.attn']['value'] > 0 and m['attn_full_ms.attn']['value'] > 0
    assert 'step_forward_ms.train' in m and 'moe_load_max.moe' in m


@pytest.mark.parametrize('cell', sorted(TOY))
def test_half_batch_fault_is_caught(cell, monkeypatch):
    if cell == 'vitb_long_mae_t2048':
        from ecg_representation_learning_tpu_torch.train import long_record
        inner = long_record.EcgMim.forward

        def forward(self, x, mask, pos_offset=0):
            n = x.shape[0] // 2
            return inner(self, x[:n], mask[:n], pos_offset)
        monkeypatch.setattr(long_record.EcgMim, 'forward', forward)
    else:
        # a microbatch is one record: the step's loss over the first half of
        # its microbatches (each step runs them in order, one call each)
        from ecg_representation_learning_tpu_torch.models import vit
        inner, calls = vit.bce_with_logits, []

        def bce(logits, labels, **kw):
            calls.append(1)
            return inner(logits, labels, **kw) * (2.0 if len(calls) % 4 in (1, 2) else 0.0)
        monkeypatch.setattr(vit, 'bce_with_logits', bce)
    out, _ = _run(cell)
    assert out['correct'] is False, out['checks']
