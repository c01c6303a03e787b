"""The MoE cell and the data-parallel cell at toy sizes on the CPU: their
files resolve, their configuration keeps the catalog row's numbers but for
the keys it lists as reduced, their readers read what a run records and
nothing where it records nothing, and the data-parallel driver's window
(barriers, rank 0's flag, every rank's samples) runs on two gloo ranks."""
from __future__ import annotations

import json
import os
import time

import pytest
import torch

from port_bench import harness, moe_readers

MOE, DP = 'moonlight_ep8_cls_k4', 'vitb_cls_dp4'
TOY_MOE = {'hidden_size': 64, 'num_hidden_layers': 3, 'num_attention_heads': 4,
           'intermediate_size': 128, 'kv_lora_rank': 32, 'qk_nope_head_dim': 16,
           'qk_rope_head_dim': 16, 'v_head_dim': 16, 'moe_intermediate_size': 32,
           'n_routed_experts_published': 8, 'n_routed_experts': 4, 'num_experts_per_tok': 3,
           'dtype': 'float32'}
TOY_VIT = {'hidden_size': 64, 'num_hidden_layers': 2, 'num_attention_heads': 4,
           'intermediate_size': 128, 'dtype': 'float32'}
# Moonlight-16B-A3B's config.json as the model-configs catalog copies it
CATALOG = {'attention_bias': False, 'ep_size': 1, 'first_k_dense_replace': 1,
           'hidden_act': 'silu', 'hidden_size': 2048, 'intermediate_size': 11264,
           'kv_lora_rank': 512, 'max_position_embeddings': 8192, 'model_type': 'deepseek_v3',
           'moe_intermediate_size': 1408, 'moe_layer_freq': 1, 'n_group': 1,
           'n_routed_experts': 64, 'n_shared_experts': 2, 'norm_topk_prob': True,
           'num_attention_heads': 16, 'num_experts_per_tok': 6, 'num_hidden_layers': 27,
           'num_key_value_heads': 16, 'num_nextn_predict_layers': 0, 'q_lora_rank': None,
           'qk_nope_head_dim': 128, 'qk_rope_head_dim': 64, 'rms_norm_eps': 1e-05,
           'rope_theta': 50000, 'routed_scaling_factor': 2.446, 'scoring_func': 'sigmoid',
           'seq_aux': True, 'tie_word_embeddings': False, 'topk_group': 1,
           'topk_method': 'noaux_tc', 'v_head_dim': 128, 'vocab_size': 163840}


def test_moonlight_config_keeps_the_catalog_but_its_reduced_keys():
    entry = next(c for c in harness.benchmark()['configs']
                 if c['name'] == 'moonlight-16b-a3b-ep8-ptbxl')
    with open(os.path.join(harness.ROOT, entry['file'])) as f:
        body = json.load(f)
    assert body['reduced'] == entry['reduced']
    changed = {k for k, v in CATALOG.items() if body.get(k, object()) != v}
    assert changed == set(entry['reduced'])
    assert body['n_routed_experts_published'] == 64 and body['n_routed_experts'] == 8


def _toy(workload: str, config: dict, traffic: dict, trace: bool, chips: int = 1):
    r = harness.Run(workload=workload, seed=2 ** 31 + 11, seconds=1.0, trace=trace,
                    device=torch.device('cpu'), t_process=time.perf_counter(),
                    overrides={'config': config, 'traffic': traffic})
    _, r.cell, cfg, trf = harness.resolve(workload)
    r.config, r.traffic, r.chips = {**cfg, **config}, {**trf, **traffic}, chips
    return r


def test_moe_cell_runs_and_its_readers_read(tmp_path, monkeypatch):
    import tempfile
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    r = _toy(MOE, TOY_MOE, {'train_records': 120, 'batch_size': 8, 'reference_chunk': 4}, True)
    from port_bench.drivers import train_moe
    train_moe.run(r)
    assert all(v <= lim for _, v, lim in r.checks) and len(r.checks) == 4
    assert r.window['moe_held_rows'] > 0 and r.window['trace_held_rows'] > 0
    from ecg_representation_learning_tpu_torch.utils import tracing
    assert tracing.snapshot()['spans']['dispatch']['count'] >= 2   # a gap to read on the card
    assert moe_readers.experts_ms(r) > 0 and moe_readers.route_ms(r) > 0
    assert 1.0 <= moe_readers.load_max(r) <= 4.0
    assert moe_readers.gemm_roofline(r) is None          # no device trace on the CPU
    assert moe_readers.allreduce_ms(r) is None           # one device: no all-reduce


def test_readers_find_nothing_in_a_run_without_the_layer():
    r = _toy(MOE, TOY_MOE, {}, False)
    from ecg_representation_learning_tpu_torch.utils import tracing
    tracing.reset()
    assert all(f(r) is None for f in (moe_readers.experts_ms, moe_readers.route_ms,
                                      moe_readers.load_max, moe_readers.gemm_roofline,
                                      moe_readers.allreduce_ms))


@pytest.mark.parametrize('trace', [False, True])
def test_dp_driver_window_on_two_gloo_ranks(tmp_path, monkeypatch, trace):
    import tempfile
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    r = _toy(DP, TOY_VIT, {'train_records': 200, 'batch_size': 16}, trace, chips=2)
    from port_bench.drivers import train_dp
    train_dp.run(r)
    assert all(v <= lim for _, v, lim in r.checks) and len(r.checks) == 3
    w = r.window
    assert w['ranks'] == 2 and w['samples'] == w['steps'] * 16 and w['steps'] >= 1
    assert r.e2e['train_samples_per_s'] == pytest.approx(w['samples'] / w['seconds'])
    if trace:
        assert r.tr is not None and r.tr.units >= 4
        assert moe_readers.allreduce_ms(r) > 0


def test_dp_reference_without_the_exchange_fails_a_limit():
    """The planted fault of the data-parallel cell that leaves the gradient
    exchange out (rank 0 steps on its own rows) reads past a limit."""
    from port_bench import checks, inputs
    from port_bench.drivers import train, train_dp
    r = _toy(DP, TOY_VIT, {'train_records': 200, 'batch_size': 16}, False, chips=2)
    rows = train.check_rows(r)
    sig, lab = inputs.ptbxl_split(r.traffic['train_records'], r.config['num_channels'],
                                  r.config['record_samples'], r.config['num_class'], r.seed,
                                  r.device)
    sig, lab = sig[rows].clone(), lab[rows].clone()
    steps, total = len(rows) // 16, 100
    base = train_dp.follow(r, sig, lab, steps, total, 'f32', 2)
    same = checks.gaps(train_dp.follow(r, sig, lab, steps, total, 'f32', 2), base)
    alone = checks.gaps(train_dp.follow(r, sig, lab, steps, total, 'f32', 2, exchange=False),
                        base)
    limits = r.cell['limits']
    assert all(same[k] <= lim for k, lim in limits.items())
    assert any(alone[k] > lim for k, lim in limits.items())


@pytest.mark.parametrize('cell,fault', [(MOE, 'unchanged_state'), (MOE, 'half_batch'),
                                        (DP, 'half_batch')])
def test_fault_makes_the_new_cells_incorrect(tmp_path, monkeypatch, cell, fault):
    """The faults of ``test_port_bench_runs.py`` planted under the new
    cells' timed path fail their checks at toy size.  On the data-parallel
    cell the fault reaches rank 0 alone, so only the half-batch loss, which
    keeps every rank's collectives, is planted there (an unchanged state
    reads ``delta_gap`` 1 on any cell)."""
    import tempfile
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    from test_port_bench_runs import _half_batch, _unchanged_state
    from port_bench.drivers import train_dp, train_moe
    if fault == 'unchanged_state':
        _unchanged_state(monkeypatch)
    else:
        _half_batch(monkeypatch, cell)
    if cell == MOE:
        r = _toy(MOE, TOY_MOE, {'train_records': 120, 'batch_size': 8, 'reference_chunk': 4},
                 False)
        train_moe.run(r)
    else:
        r = _toy(DP, TOY_VIT, {'train_records': 200, 'batch_size': 16}, False, chips=2)
        train_dp.run(r)
    assert r.checks and not all(v <= lim for _, v, lim in r.checks), r.checks
