"""DeepSeek-V3's block on the port's training path (``DeepseekConfig``,
``models/mla.py``, ``models/moe.py``'s ``DeepseekMoe``) against the plain f32
reference of the benchmark (``port_bench/reference/moonlight.py``), at a small
size on the CPU: hidden 64, 4 heads, rotary 16, latent 32, 8 routed experts
top-3 with 4 held, 2 shared, 1 dense + 2 MoE layers.

Tolerances: the program and the reference both compute in f32 here, with the
same equations in another order of operations, so they agree to ~1e-6
relative; the limits below (LOGIT_ATOL, GRAD_RTOL) leave two orders of
magnitude for that, and ``test_bf16_program_fails_the_tolerance`` shows a
bf16 program (a precision below f32, the configuration's own) outside them.
"""
import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig  # noqa: E402
from ecg_representation_learning_tpu_torch.models import mla  # noqa: E402
from ecg_representation_learning_tpu_torch.models.moe import (  # noqa: E402
    DeepseekMoe, deepseek_layers, grouped_mm, routed_counters)
from ecg_representation_learning_tpu_torch.models.vit import EcgVit  # noqa: E402
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer  # noqa: E402
from port_bench.drivers import train_moe  # noqa: E402
from port_bench.reference import moonlight as ml  # noqa: E402

torch.set_num_threads(2)
LOGIT_ATOL = 1e-4      # logits are O(1): f32 reorderings give ~1e-6, bf16 ~1e-2
GRAD_RTOL = 1e-3       # each leaf's gradient, relative to the leaf's norm
SMALL = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=128,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
             moe_intermediate_size=32, n_routed_experts_published=8, n_routed_experts=4,
             num_experts_per_tok=3, max_signal_length=320, record_samples=300,
             dtype='float32')


def bench_config(**over) -> dict:
    """The benchmark's configuration at the small size (a dict, as the
    reference reads it)."""
    import json
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        'port_bench', 'configs', 'moonlight-16b-a3b-ep8-ptbxl.json')
    with open(path) as f:
        cfg = json.load(f)
    return {**cfg, **SMALL, **over}


def _model(cfg: dict, seed: int = 3):
    """The program's EcgVit with the reference's seeded weights, and those weights."""
    w = train_moe.weights(cfg, seed, torch.device('cpu'))
    model = EcgVit(train_moe.vit_config(cfg))
    model.load_state_dict(w)
    return model, w


def _inputs(n: int = 4, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 12, 320, generator=g), (torch.rand(n, 71, generator=g) < 0.3).float()


def _program_grads(model, cfg: dict, x, y):
    model.train()
    out = model(x, labels=y)
    obj = out.loss + cfg['seq_aux_weight'] * out.aux_loss
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(obj, [p for _, p in model.named_parameters()])
    return out, dict(zip(names, grads))


def _reference(cfg: dict, w, x, y, chunk: int):
    biases = {k: w[k].clone() for k in ml.bias_names(cfg)}
    p = {k: v.clone().requires_grad_(True) for k, v in train_moe.params_only(w, cfg).items()}
    logits, aux, loads, chosen = ml.forward(p, biases, x, cfg)
    loss, grads, loads2, _ = ml.batch_grads(p, biases, x, y, cfg, 'f32', chunk)
    return logits, aux, loss, grads, loads2, chosen


def test_model_matches_the_reference_in_logits_loss_and_every_gradient():
    cfg = bench_config()
    model, w = _model(cfg)
    x, y = _inputs()
    out, grads = _program_grads(model, cfg, x, y)
    logits, aux, loss, ref_grads, _, _ = _reference(cfg, w, x, y, chunk=4)
    assert torch.allclose(out.logits, logits, atol=LOGIT_ATOL, rtol=0)
    assert abs(out.loss.item() - loss) < 1e-5 * loss
    assert abs(out.aux_loss.item() - aux.item()) < 1e-5 * aux.item()
    assert set(grads) == set(ref_grads)
    for k, g in grads.items():
        scale = max(float(ref_grads[k].norm()), 1e-12)
        assert float((g - ref_grads[k]).norm()) <= GRAD_RTOL * scale, k


def test_reference_in_record_chunks_equals_the_whole_batch():
    """Routing is per token, so the chunked reference is exact; only the
    balance counts sum across chunks."""
    cfg = bench_config()
    _, w = _model(cfg)
    x, y = _inputs()
    *_, l1, g1, loads1, _ = _reference(cfg, w, x, y, chunk=4)
    *_, l2, g2, loads2, _ = _reference(cfg, w, x, y, chunk=1)
    assert abs(l1 - l2) < 1e-6
    assert all(torch.equal(a, b) for a, b in zip(loads1, loads2))
    for k in g1:
        assert torch.allclose(g1[k], g2[k], atol=1e-6, rtol=1e-4), k


def test_bf16_program_fails_the_tolerance():
    """The tolerances separate the f32 program from the configuration's own
    bf16: at bf16 the logits leave LOGIT_ATOL."""
    cfg = bench_config()
    model, w = _model(cfg)
    bf16, _ = _model(bench_config(dtype='bfloat16'))
    x, _ = _inputs()
    with torch.no_grad():
        a, b = model.eval()(x).logits, bf16.eval()(x).logits
    assert float((a - b).abs().max()) > LOGIT_ATOL


@pytest.mark.parametrize('slices', [[(0, 8)], [(0, 4), (4, 4)], [(0, 2), (2, 2), (4, 2), (6, 2)],
                                    [(i, 1) for i in range(8)]])
def test_held_shares_sum_to_the_uncut_layer(slices):
    """Every device of the deployment computes its held experts' share and
    the shared experts alike; the shares, with the shared experts counted
    once, add up to the layer with every expert held."""
    torch.manual_seed(0)
    base = VitConfig.from_preset('moonlight-16b-a3b-ep8', hidden_size=64, num_attention_heads=4,
                                 moe_intermediate_size=32, moe_num_experts=8, moe_top_k=3,
                                 dtype='float32')
    full = DeepseekMoe(dataclasses.replace(base, moe_held=(0, 8)), torch.float32)
    with torch.no_grad():
        for p in full.parameters():
            p.normal_(0.0, 0.3)
    x = torch.randn(2, 7, 64)
    want, _ = full(x)
    shared = full.shared_experts(x.reshape(-1, 64)).reshape(2, 7, 64)
    total = torch.zeros_like(want)
    for first, count in slices:
        part = DeepseekMoe(dataclasses.replace(base, moe_held=(first, count)), torch.float32)
        sd = {k: v for k, v in full.state_dict().items()}
        sd['experts.gate_up'] = sd['experts.gate_up'][first:first + count]
        sd['experts.down'] = sd['experts.down'][first:first + count]
        part.load_state_dict(sd)
        total += part(x)[0]
    total -= (len(slices) - 1) * shared
    assert torch.allclose(total, want, atol=1e-5)


def test_dropless_when_every_token_routes_to_the_held_experts():
    """A correction bias that sends every token to held experts 0-2 fills
    the buffer to its bound (T * min(k, held) rows): nothing is dropped, and
    the layer equals the reference's."""
    cfg = bench_config()
    model, w = _model(cfg)
    for name in ml.bias_names(cfg):
        w[name][:3] = 10.0
    model.load_state_dict(w)
    x, y = _inputs()
    out, grads = _program_grads(model, cfg, x, y)
    logits, _, loss, ref_grads, loads, chosen = _reference(cfg, w, x, y, chunk=4)
    tokens = 4 * 6
    assert all(sorted(c.unique().tolist()) == [0, 1, 2] for c in chosen)
    assert routed_counters(model)['held_rows'] == 2 * tokens * 3
    assert torch.allclose(out.logits, logits, atol=LOGIT_ATOL, rtol=0)
    for k in ('encoder.blocks.1.mlp.experts.gate_up', 'encoder.blocks.2.mlp.experts.down'):
        assert float((grads[k] - ref_grads[k]).norm()) <= GRAD_RTOL * float(ref_grads[k].norm())


def test_rows_past_the_last_offset_never_reach_the_result():
    """The plain grouped product leaves NaN in the rows past the last offset
    (the GPU kernel leaves them unwritten); the layer and its gradient stay
    finite."""
    a = torch.randn(10, 8)
    out = grouped_mm(a, torch.randn(2, 5, 8), torch.tensor([3, 6], dtype=torch.int32))
    assert torch.isnan(out[6:]).all() and not torch.isnan(out[:6]).any()
    cfg = bench_config()
    model, _ = _model(cfg)
    out, grads = _program_grads(model, cfg, *_inputs())
    assert torch.isfinite(out.logits).all()
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_bias_update_moves_against_the_load():
    """b_i += rate * sign(mean load - load_i): an overloaded expert's bias
    falls, an underloaded one's rises, and the load is zeroed."""
    cfg = bench_config()
    model, _ = _model(cfg)
    model.train()
    model(_inputs()[0])
    layer = deepseek_layers(model)[0]
    load = layer.load.clone()
    assert float(load.sum()) == 4 * 6 * 3
    layer.update_bias(0.01)
    bias = layer.gate.e_score_correction_bias
    assert torch.equal(bias, 0.01 * torch.sign(load.mean() - load))
    assert bool((bias[load > load.mean()] < 0).all()) and bool((bias[load < load.mean()] > 0).all())
    assert float(layer.load.abs().sum()) == 0.0


def _trainer(cfg: dict, tmp_path, k: int, signals, labels):
    tr = Trainer(train_moe.vit_config(cfg),
                 TrainConfig(train_batch_size=4, num_train_epoch=1, do_eval=False,
                             save_final=False, log_to_console=False, steps_per_dispatch=k,
                             seed=5),
                 train_data=SplitData(signals, labels), output_dir=str(tmp_path / str(k)),
                 device='cpu')
    tr.set_params(train_moe.weights(cfg, 3, torch.device('cpu')))
    return tr


def test_k4_tape_equals_four_single_steps(tmp_path):
    """Four steps through the step tape (one dispatch) give the per-step
    loop's routing, correction biases and parameters, bit for bit."""
    cfg = bench_config()
    rng = np.random.default_rng(0)
    sig = rng.standard_normal((16, 12, 300)).astype(np.float32)
    lab = (rng.random((16, 71)) < 0.3).astype(np.float32)
    takes = np.arange(16).reshape(4, 4)
    from ecg_representation_learning_tpu_torch.train.dispatch import Dispatcher
    one, four = _trainer(cfg, tmp_path, 1, sig, lab), _trainer(cfg, tmp_path, 4, sig, lab)
    layers = deepseek_layers(one.model) + deepseek_layers(four.model)
    with train_moe.recorded_choices(layers, 4) as rec:
        for t in takes:
            one.train_step(one.train_data, t)
        Dispatcher(four, 4, scan=False).run(takes)
    n = len(layers) // 2
    for a, b, ca, cb in zip(layers[:n], layers[n:], rec[:n], rec[n:]):
        assert len(ca) == len(cb) == 4 and all(torch.equal(x, y) for x, y in zip(ca, cb))
        assert torch.equal(a.gate.e_score_correction_bias, b.gate.e_score_correction_bias)
        assert float(a.gate.e_score_correction_bias.abs().sum()) > 0
    for (k, p), (_, q) in zip(one.model.named_parameters(), four.model.named_parameters()):
        assert torch.equal(p, q), k


def test_latent_attention_takes_the_plain_path_and_refuses_128_tokens(monkeypatch):
    cfg = train_moe.vit_config(bench_config())
    attn = mla.LatentAttention(cfg, torch.float32)
    seen = []
    real = mla.attention
    monkeypatch.setattr(mla, 'attention', lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    x = torch.randn(2, 41, 64)
    attn(x, x)
    assert seen == [{'use_flash': False}]
    with pytest.raises(ValueError, match='fewer than 128 tokens'):
        attn(torch.randn(1, 128, 64), torch.randn(1, 128, 64))


def test_cli_train_reaches_the_preset(monkeypatch):
    from ecg_representation_learning_tpu_torch import cli
    args = types.SimpleNamespace(size='base', bf16=True, patch_norm=True, moe_experts=0,
                                 moe_every=2, model_preset='moonlight-16b-a3b-ep8')
    cfg = cli._model_cfg_for(args)
    assert cfg == VitConfig.from_preset('moonlight-16b-a3b-ep8')
    assert (cfg.block, cfg.num_hidden_layers, cfg.moe_held, cfg.moe_top_k) == \
        ('deepseek', 13, (0, 8), 6)


def _refused_sites():
    from ecg_representation_learning_tpu_torch.models import export_artifact, port, quantize
    from ecg_representation_learning_tpu_torch.parallel import mesh
    from ecg_representation_learning_tpu_torch.train import long_record, pipeline_vit
    cfg = train_moe.vit_config(bench_config())
    stub = types.SimpleNamespace(cfg=cfg, model_cfg=cfg)
    return {
        'jax_conversion': lambda: port.vit_state_dict_from_flax({}, cfg),
        'export_artifact': lambda: export_artifact.export_model(stub, '/nonexistent'),
        'int8': lambda: quantize.int8_weights(stub, {}, {}).__enter__(),
        'sharded_model': lambda: mesh.shard_params(stub, None),
        'ring_attention': lambda: long_record.EcgMim(cfg),
        'gpipe': lambda: pipeline_vit.PipelineVitTrainer(cfg, TrainConfig(mesh_stage=2)),
    }


@pytest.mark.parametrize('site', ['jax_conversion', 'export_artifact', 'int8', 'sharded_model',
                                  'ring_attention', 'gpipe'])
def test_unserved_paths_refuse_the_deepseek_block(site):
    with pytest.raises(ValueError, match="does not serve the 'deepseek' block"):
        _refused_sites()[site]()


def test_moe_region_marks_under_the_profiler(tmp_path):
    """A profiled step records the MoE layer's region marks as phases of
    their own (counting no step), beside the step's phases."""
    from torch.profiler import ProfilerActivity, profile
    from ecg_representation_learning_tpu_torch.utils import tracing
    cfg = bench_config()
    rng = np.random.default_rng(0)
    tr = _trainer(cfg, tmp_path, 1, rng.standard_normal((8, 12, 300)).astype(np.float32),
                  (rng.random((8, 71)) < 0.3).astype(np.float32))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train_step(tr.train_data, np.arange(4))
    phases = tracing.snapshot()['phases']
    tracing.reset()
    regions = ('moe.route', 'moe.permute', 'moe.experts', 'moe.combine', 'moe.shared')
    assert all(phases[p]['device_s'] > 0 and phases[p]['steps'] == 0 for p in regions)
    assert phases['forward']['steps'] == 1
    assert sum(phases[p]['device_s'] for p in regions) < phases['forward']['device_s']
