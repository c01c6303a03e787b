"""Arcee's AFMoE block (Trinity) on the port's training path (``AfmoeConfig``,
``models/afmoe.py``, ``DeepseekMoe``) against the plain f32 reference of the
benchmark (``port_bench/reference/trinity.py``), at a small size on the CPU:
hidden 64, 4 query and 2 KV heads of 16, 32 tokens, a window of 8 keys (the
query and the 7 before it), layers sliding, sliding, sliding, full with the
first 2 dense, 8 routed experts top-3 with 4 held, 1 shared.  And the plain
versions of flash kernels #1-#4 with a band and grouped KV heads against a
dense masked softmax.

Tolerances: the program and the reference both compute in f32 here, with the
same equations in another order of operations, so they agree to ~1e-6
relative; the limits below (LOGIT_ATOL, GRAD_RTOL) leave two orders of
magnitude for that, and ``test_bf16_program_fails_the_tolerance`` shows a
bf16 program (a precision below f32, the configuration's own) outside them.
The plain attention versions are held to the dense softmax at ATTN_TOL: both
are f32 of the same products, summed in another order.
"""
import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig  # noqa: E402
from ecg_representation_learning_tpu_torch.models.moe import (  # noqa: E402
    DeepseekMoe, deepseek_layers)
from ecg_representation_learning_tpu_torch.models.vit import EcgVit  # noqa: E402
from ecg_representation_learning_tpu_torch.ops import attention as attn  # noqa: E402
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer  # noqa: E402
from port_bench.drivers import train_afmoe, train_moe  # noqa: E402
from port_bench.reference import trinity as tm  # noqa: E402

torch.set_num_threads(2)
LOGIT_ATOL = 1e-4      # logits are O(1): f32 reorderings give ~1e-6, bf16 ~1e-2
GRAD_RTOL = 1e-3       # each leaf's gradient, relative to the leaf's norm
ATTN_TOL = 1e-5        # plain attention vs the dense softmax, f32, values O(1)
SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=4,
             num_dense_layers=2, num_experts=4, num_experts_published=8, num_experts_per_tok=3,
             sliding_window=8, max_signal_length=2048, dtype='float32')
PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'port_bench',
                    'configs', 'trinity-mini-ep16-ecg8k.json')


def bench_config(**over) -> dict:
    with open(PATH) as f:
        cfg = json.load(f)
    return {**cfg, **SMALL, **over}


def _model(cfg: dict, seed: int = 3):
    w = train_afmoe.weights(cfg, seed, torch.device('cpu'))
    model = EcgVit(train_afmoe.vit_config(cfg))
    model.load_state_dict(w)
    return model, w


def _inputs(n: int = 3, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 12, 2048, generator=g), (torch.rand(n, 71, generator=g) < 0.3).float()


def _reference(cfg: dict, w, x, y):
    biases = {k: w[k].clone() for k in tm.bias_names(cfg)}
    p = {k: v.clone().requires_grad_(True) for k, v in train_afmoe.params_only(w, cfg).items()}
    logits, _, chosen = tm.forward(p, biases, x, cfg, chunk=8)
    loss, grads, loads, _ = tm.batch_grads(p, biases, x, y, cfg, 'f32', chunk=8)
    return logits, loss, grads, loads, chosen


def test_model_matches_the_reference_in_logits_loss_and_every_gradient():
    cfg = bench_config()
    model, w = _model(cfg)
    x, y = _inputs()
    model.train()
    out = model(x, labels=y)
    names = [k for k, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(out.loss, list(model.parameters()))))
    logits, loss, ref_grads, _, _ = _reference(cfg, w, x, y)
    assert torch.allclose(out.logits, logits, atol=LOGIT_ATOL, rtol=0)
    assert abs(out.loss.item() - loss) < 1e-5 * loss
    assert set(grads) == set(ref_grads)
    for k, g in grads.items():
        scale = max(float(ref_grads[k].norm()), 1e-12)
        assert float((g - ref_grads[k]).norm()) <= GRAD_RTOL * scale, k


def test_bf16_program_fails_the_tolerance():
    """The tolerances separate the f32 program from the configuration's own
    bf16: at bf16 the logits leave LOGIT_ATOL."""
    model, _ = _model(bench_config())
    bf16, _ = _model(bench_config(dtype='bfloat16'))
    x, _ = _inputs()
    with torch.no_grad():
        a, b = model.eval()(x).logits, bf16.eval()(x).logits
    assert float((a - b).abs().max()) > LOGIT_ATOL


def test_window_and_causality_reach_the_logits():
    """The band is part of the result: a future sample moves no earlier
    token of a causal layer, and the logits move when the window widens."""
    cfg = bench_config()
    model, w = _model(cfg)
    wide, _ = _model(bench_config(sliding_window=32))
    x, _ = _inputs()
    with torch.no_grad():
        assert not torch.allclose(model.eval()(x).logits, wide.eval()(x).logits, atol=LOGIT_ATOL)
        h = model.encoder(x)[0]
        x2 = x.clone()
        x2[..., -64:] += 1.0          # the last token's samples
        h2 = model.encoder(x2)[0]
    assert torch.equal(h[:, :-1], h2[:, :-1]) and not torch.equal(h[:, -1], h2[:, -1])


def _dense(q, k, v, causal, window):
    """softmax over the visible keys, dense, f64."""
    h = q.shape[1]
    k, v = (x.double().repeat_interleave(h // x.shape[1], dim=1) for x in (k, v))
    s = q.double() @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    t = q.shape[2]
    i, j = torch.arange(t)[:, None], torch.arange(t)[None, :]
    vis = torch.ones(t, t, dtype=torch.bool)
    if causal:
        vis &= j <= i
    if window >= 0:
        vis &= j >= i - window
    return torch.softmax(s.masked_fill(~vis, float('-inf')), -1) @ v


@pytest.mark.parametrize('t,window,h,hk,causal', [
    (70, 7, 4, 2, True), (37, 100, 4, 1, True), (65, 0, 4, 4, True), (33, -1, 6, 2, True),
    (50, -1, 4, 4, False), (41, 12, 8, 1, False), (64, 63, 2, 1, True)])
def test_plain_kernels_match_a_dense_masked_softmax(t, window, h, hk, causal):
    """#1/#2's plain forward, #3/#4's plain backward (with the lse and delta
    of the forward), the recompute gradient and the dispatcher's plain path,
    each against autograd through the dense softmax: T not a multiple of a
    tile, W >= T, W = 0, one KV head and one a query head, bidirectional."""
    g = torch.Generator().manual_seed(t + h)
    q = torch.randn(2, h, t, 16, generator=g, dtype=torch.float32)
    k, v = (torch.randn(2, hk, t, 16, generator=g) for _ in range(2))
    do = torch.randn(2, h, t, 16, generator=g)
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    want = _dense(*leaves, causal, window)
    wq, wk, wv = torch.autograd.grad(want, leaves, do.double())
    band = dict(causal=causal, window_left=window)
    out, lse = attn.flash_attention_forward_reference(q, k, v, return_lse=True, **band)
    assert (out - want).abs().max() <= ATTN_TOL
    delta = (do * out).sum(-1)
    got = attn.flash_backward_blocked_reference(q, k, v, do, lse, delta, **band)
    rec = attn.flash_backward_recompute(q, k, v, do, **band)
    for a, b, c in zip(got, rec, (wq, wk, wv)):
        assert a.shape == c.shape and (a - c).abs().max() <= ATTN_TOL
        assert (b - c).abs().max() <= ATTN_TOL
    plain = attn.attention(q, k, v, min_seq=t + 1, **band)
    assert (plain - want).abs().max() <= ATTN_TOL


def test_held_shares_sum_to_the_uncut_layer_at_top_8():
    """Every card of the deployment computes its held experts' share and the
    shared expert alike; the shares, the shared expert counted once, add up
    to the layer with every expert held."""
    torch.manual_seed(0)
    base = VitConfig.from_preset('trinity-mini-ep16', hidden_size=64, moe_intermediate_size=32,
                                 moe_num_experts=16, dtype='float32')
    assert base.moe_top_k == 8 and base.moe_routed_scale == 2.826
    full = DeepseekMoe(dataclasses.replace(base, moe_held=(0, 16)), torch.float32)
    with torch.no_grad():
        for p in full.parameters():
            p.normal_(0.0, 0.3)
    x = torch.randn(2, 7, 64)
    want, _ = full(x)
    shared = full.shared_experts(x.reshape(-1, 64)).reshape(2, 7, 64)
    total = torch.zeros_like(want)
    slices = [(0, 8), (8, 8)]
    for first, count in slices:
        part = DeepseekMoe(dataclasses.replace(base, moe_held=(first, count)), torch.float32)
        sd = dict(full.state_dict())
        sd['experts.gate_up'] = sd['experts.gate_up'][first:first + count]
        sd['experts.down'] = sd['experts.down'][first:first + count]
        part.load_state_dict(sd)
        total += part(x)[0]
    total -= (len(slices) - 1) * shared
    assert torch.allclose(total, want, atol=1e-5)


def _trainer(cfg: dict, tmp_path, k: int, signals, labels):
    tr = Trainer(train_afmoe.vit_config(cfg),
                 TrainConfig(train_batch_size=4, grad_accum=2, num_train_epoch=1, do_eval=False,
                             save_final=False, log_to_console=False, steps_per_dispatch=k,
                             seed=5),
                 train_data=SplitData(signals, labels), output_dir=str(tmp_path / str(k)),
                 device='cpu')
    tr.set_params(train_afmoe.weights(cfg, 3, torch.device('cpu')))
    return tr


def test_k4_tape_equals_four_single_steps(tmp_path):
    """Four steps of two microbatches through the step tape (one dispatch)
    give the per-step loop's routing, correction biases and parameters, bit
    for bit."""
    cfg = bench_config()
    rng = np.random.default_rng(0)
    sig = rng.standard_normal((16, 12, 2000)).astype(np.float32)
    lab = (rng.random((16, 71)) < 0.3).astype(np.float32)
    takes = np.arange(16).reshape(4, 4)
    from ecg_representation_learning_tpu_torch.train.dispatch import Dispatcher
    one, four = _trainer(cfg, tmp_path, 1, sig, lab), _trainer(cfg, tmp_path, 4, sig, lab)
    layers = deepseek_layers(one.model) + deepseek_layers(four.model)
    with train_moe.recorded_choices(layers, 8) as rec:
        for t in takes:
            one.train_step(one.train_data, t)
        Dispatcher(four, 4, scan=False).run(takes)
    n = len(layers) // 2
    for a, b, ca, cb in zip(layers[:n], layers[n:], rec[:n], rec[n:]):
        assert len(ca) == len(cb) == 8 and all(torch.equal(x, y) for x, y in zip(ca, cb))
        assert torch.equal(a.gate.e_score_correction_bias, b.gate.e_score_correction_bias)
        assert float(a.gate.e_score_correction_bias.abs().sum()) > 0
    for (k, p), (_, q) in zip(one.model.named_parameters(), four.model.named_parameters()):
        assert torch.equal(p, q), k


def test_a_record_of_the_whole_input_keeps_its_patches(tmp_path):
    """A record of ``max_signal_length`` samples (2,048 here, 524,288 in the
    cell) reaches the model whole at 32 patches: the zero patch that the
    always-pad quirk adds to an aligned record is cropped off."""
    from ecg_representation_learning_tpu_torch.ops.normalize import normalize_fixed
    from ecg_representation_learning_tpu_torch.train.trainer import _prep_batch
    cfg = bench_config()
    rng = np.random.default_rng(1)
    sig = rng.standard_normal((8, 12, 2048)).astype(np.float32)
    tr = _trainer(cfg, tmp_path, 1, sig, (rng.random((8, 71)) < 0.3).astype(np.float32))
    seen = []
    hook = tr.model.register_forward_pre_hook(lambda m, a: seen.append(tuple(a[0].shape)))
    tr.train_step(tr.train_data, np.arange(4))
    hook.remove()
    assert seen == [(2, 12, 2048)] * 2
    x = torch.from_numpy(sig[:2])
    assert torch.equal(_prep_batch(x, tr.mean, tr.std, 64, max_len=2048),
                       normalize_fixed(x, tr.mean, tr.std))


def test_cli_train_reaches_the_preset():
    from ecg_representation_learning_tpu_torch import cli
    from ecg_representation_learning_tpu_torch.models.vit import param_count
    args = types.SimpleNamespace(size='base', bf16=True, patch_norm=True, moe_experts=0,
                                 moe_every=2, model_preset='trinity-mini-ep16')
    cfg = cli._model_cfg_for(args)
    assert cfg == VitConfig.from_preset('trinity-mini-ep16')
    assert (cfg.block, cfg.num_hidden_layers, cfg.moe_held, cfg.moe_top_k, cfg.num_patches,
            cfg.pool) == ('afmoe', 16, (0, 8), 8, 8192, 'mean')
    assert [cfg.sliding(i) for i in range(4)] == [True, True, True, False]
    with torch.device('meta'):
        model = EcgVit(cfg)
    assert round(param_count(model) / 1e9, 2) == 1.31
    assert param_count(model) == sum(int(np.prod(s)) for s in tm.trinity_shapes(
        json.load(open(PATH))).values())


def _refused_sites():
    from ecg_representation_learning_tpu_torch.configs import ContrastiveConfig
    from ecg_representation_learning_tpu_torch.models import (contrastive, export_artifact, mae,
                                                              port, quantize)
    from ecg_representation_learning_tpu_torch.parallel import mesh
    from ecg_representation_learning_tpu_torch.train import long_record, pipeline_vit
    cfg = train_afmoe.vit_config(bench_config())
    stub = types.SimpleNamespace(cfg=cfg, model_cfg=cfg)
    return {
        'jax_conversion': lambda: port.vit_state_dict_from_flax({}, cfg),
        'export_artifact': lambda: export_artifact.export_model(stub, '/nonexistent'),
        'int8': lambda: quantize.int8_weights(stub, {}, {}).__enter__(),
        'megatron_fsdp': lambda: mesh.shard_params(stub, None),
        'ring_attention': lambda: long_record.EcgMim(cfg),
        'gpipe': lambda: pipeline_vit.PipelineVitTrainer(cfg, TrainConfig(mesh_stage=2)),
        'mae': lambda: mae.EcgMae(cfg),
        'contrastive': lambda: contrastive.EcgContrastive(cfg, ContrastiveConfig()),
    }


@pytest.mark.parametrize('site', ['jax_conversion', 'export_artifact', 'int8', 'megatron_fsdp',
                                  'ring_attention', 'gpipe', 'mae', 'contrastive'])
def test_unserved_paths_refuse_the_afmoe_block(site):
    with pytest.raises(ValueError, match="does not serve the 'afmoe' block"):
        _refused_sites()[site]()


def test_attention_region_marks_under_the_profiler(tmp_path):
    """A profiled step records the attention cores' region marks by layer
    kind, beside the MoE's and the step's phases."""
    from torch.profiler import ProfilerActivity, profile
    from ecg_representation_learning_tpu_torch.utils import tracing
    cfg = bench_config()
    rng = np.random.default_rng(0)
    tr = _trainer(cfg, tmp_path, 1, rng.standard_normal((8, 12, 2000)).astype(np.float32),
                  (rng.random((8, 71)) < 0.3).astype(np.float32))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train_step(tr.train_data, np.arange(4))
    phases = tracing.snapshot()['phases']
    tracing.reset()
    assert all(phases[p]['device_s'] > 0 and phases[p]['steps'] == 0
               for p in ('attn.window', 'attn.full', 'moe.experts'))
    assert phases['forward']['steps'] == 1
