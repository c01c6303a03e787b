"""DeepSeek-V3's block and the data-parallel captured dispatch on the card.

Every test here needs CUDA devices and skips without them; on a machine with
a card run them with ``python -m pytest --noconftest -p no:cacheprovider -m
card tests/test_torch_moonlight_card.py`` (this file imports no JAX).

  * latent attention and the dropless MoE layer at the published widths of
    ``moonlight-16b-a3b-ep8-ptbxl`` (one dense and one MoE layer, 4
    records), against the f32 reference: the f32 program within 1e-3 of the
    logits' scale (f32 reorderings on the card, TF32 off), the bf16 program
    within 0.1 of logits of scale ~3 (bf16's 8-bit significand through two
    2,048-wide layers and the 8 held experts' grouped GEMMs; an H100 reads
    ~0.05), and the choices of experts the reference's: all of the f32
    program's, 98 % of the bf16 program's (an H100 reads ~99.2 %: near-ties
    of the 6th and 7th score flip on bf16 rounding);
  * K = 4 graph replays against the per-step loop at a small size, bit for
    bit, for the deepseek block and for the ViT, in one dispatcher's calls
    and through ``Trainer.train()``'s epochs with leftover steps (one-step
    graphs in the K-step graph's memory pool, replayed between K-step
    replays);
  * the 4-rank captured data-parallel dispatch against the eager mesh steps
    (``tools/dp_graph_check.py``): DDP's bucketed all-reduce and the tape's
    one flat all-reduce sum each gradient over the ranks in other orders, so
    within 1e-4 of each leaf, loss and gradient norm (f32 rounding of the
    sums, carried through 12 steps; a missing exchange would leave each
    rank's leaves on its own rows' gradients).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig  # noqa: E402
from ecg_representation_learning_tpu_torch.models.moe import deepseek_layers  # noqa: E402
from ecg_representation_learning_tpu_torch.models.vit import EcgVit  # noqa: E402
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer  # noqa: E402
from ecg_representation_learning_tpu_torch.train.dispatch import Dispatcher  # noqa: E402
from port_bench.drivers import train_moe  # noqa: E402
from port_bench.reference import moonlight as ml  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _published(**over) -> dict:
    with open(os.path.join(ROOT, 'port_bench', 'configs',
                           'moonlight-16b-a3b-ep8-ptbxl.json')) as f:
        return {**json.load(f), 'num_hidden_layers': 2, **over}


@pytest.mark.card
@pytest.mark.parametrize('dtype,atol', [('float32', 1e-3), ('bfloat16', 0.1)])
def test_published_widths_match_the_reference(card, dtype, atol):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _published(dtype=dtype)
    w = train_moe.weights(cfg, 7, card)
    with torch.device(card):
        model = EcgVit(train_moe.vit_config(cfg))
    model.load_state_dict(w)
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(4, 12, 2560, device=card, generator=g)
    with torch.no_grad(), train_moe.recorded_choices(deepseek_layers(model)[:1], 1) as rec:
        got = model.eval()(x).logits
        biases = {k: w[k] for k in ml.bias_names(cfg)}
        want, _, _, chosen = ml.forward(train_moe.params_only(w, cfg), biases, x, cfg)
    gap = float((got - want).abs().max())
    print(f'{dtype}: logits max abs gap {gap:.3e} (scale {float(want.abs().max()):.3f})')
    assert gap <= atol
    agree = 1.0 - train_moe.route_gap(rec[0], chosen, cfg['n_routed_experts_published'])
    print(f'{dtype}: choices agreeing with the reference {agree:.4f}')
    assert agree >= (1.0 if dtype == 'float32' else 0.98)


def _small_moe() -> VitConfig:
    return VitConfig.from_preset('moonlight-16b-a3b-ep8', hidden_size=128, num_attention_heads=4,
                                 qk_nope_head_dim=32, qk_rope_head_dim=32, v_head_dim=32,
                                 kv_lora_rank=64, intermediate_size=256,
                                 moe_intermediate_size=64, moe_num_experts=16, moe_top_k=4,
                                 moe_held=(0, 8), num_hidden_layers=3, max_signal_length=640)


@pytest.mark.card
@pytest.mark.parametrize('kind', ['deepseek', 'vit'])
def test_k4_graph_replays_equal_the_per_step_loop(card, kind, tmp_path):
    cfg = (_small_moe() if kind == 'deepseek'
           else VitConfig.from_defined('debug', hidden_size=128, dtype='bfloat16',
                                       max_signal_length=640))
    rng = np.random.default_rng(0)
    sig = rng.standard_normal((256, 12, 600)).astype(np.float32)
    lab = (rng.random((256, 71)) < 0.3).astype(np.float32)
    takes = np.arange(12 * 16).reshape(12, 16)
    runs = []
    for k in (1, 4):
        tr = Trainer(cfg, TrainConfig(train_batch_size=16, num_train_epoch=1, do_eval=False,
                                      save_final=False, log_to_console=False,
                                      steps_per_dispatch=k, seed=5),
                     train_data=SplitData(sig, lab), output_dir=str(tmp_path / str(k)),
                     device=card)
        tr.init_state(5)
        if k == 1:
            for t in takes:
                tr.train_step(tr.train_data, t)
        else:
            disp = Dispatcher(tr, 4, scan=False)
            for c in range(3):
                disp.run(takes[4 * c:4 * c + 4])
            assert disp.info()['route'] == 'graph' and disp.info()['replays'] == 2
        runs.append(tr)
    one, four = runs
    for (name, p), (_, q) in zip(one.model.named_parameters(), four.model.named_parameters()):
        assert torch.equal(p, q), name
    for a, b in zip(deepseek_layers(one.model), deepseek_layers(four.model)):
        assert torch.equal(a.gate.e_score_correction_bias, b.gate.e_score_correction_bias)


def _two_epochs(cfg: VitConfig, k: int, device, out: str, losses: list) -> Trainer:
    """``train()`` over two epochs of ten steps (160 records, batch 16),
    ``k`` steps a dispatch; each step's loss appended to ``losses``."""
    rng = np.random.default_rng(1)
    sig = rng.standard_normal((160, 12, 600)).astype(np.float32)
    lab = (rng.random((160, 71)) < 0.3).astype(np.float32)
    tr = Trainer(cfg, TrainConfig(train_batch_size=16, num_train_epoch=2, do_eval=False,
                                  save_final=False, log_to_console=False,
                                  steps_per_dispatch=k, seed=5),
                 train_data=SplitData(sig, lab), output_dir=out, device=device)
    tr.init_state(5)
    if k == 1:
        step = tr.train_step
        tr.train_step = lambda *a: (lambda m: (losses.append(float(m['loss'])), m)[1])(step(*a))
    else:
        make = tr._dispatcher

        def dispatcher():
            disp = make()
            run = disp.run
            disp.run = lambda takes: (lambda o: (losses.extend(o[0].tolist()), o)[1])(run(takes))
            return disp
        tr._dispatcher = dispatcher
    tr.train()
    return tr


@pytest.mark.card
@pytest.mark.parametrize('kind', ['deepseek', 'vit'])
def test_epochs_with_leftover_steps_equal_the_per_step_loop(card, kind, tmp_path):
    """Each epoch at K = 4: two K-step dispatches, then two leftover steps
    as one-step graphs captured into the K-step graph's pool; the next
    epoch replays the K-step graph after them.  Parameters, correction
    biases and every step's loss equal the per-step loop's bit for bit."""
    cfg = (_small_moe() if kind == 'deepseek'
           else VitConfig.from_defined('debug', hidden_size=128, dtype='bfloat16',
                                       max_signal_length=640))
    losses = {1: [], 4: []}
    one, four = (_two_epochs(cfg, k, card, str(tmp_path / str(k)), losses[k]) for k in (1, 4))
    # replays: epoch 1 K (capture), K, 1 (capture), 1; epoch 2 K, K, 1, 1
    assert four.dispatch_info['route'] == 'graph' and four.dispatch_info['replays'] == 7
    assert len(losses[1]) == 20 and losses[1] == losses[4]
    for (name, p), (_, q) in zip(one.model.named_parameters(), four.model.named_parameters()):
        assert torch.equal(p, q), name
    for a, b in zip(deepseek_layers(one.model), deepseek_layers(four.model)):
        assert torch.equal(a.gate.e_score_correction_bias, b.gate.e_score_correction_bias)


@pytest.mark.card
def test_dp4_captured_dispatch_equals_the_eager_mesh_steps(card):
    if torch.cuda.device_count() < 4:
        pytest.skip(f'needs 4 CUDA devices; found {torch.cuda.device_count()}')
    out = subprocess.run([sys.executable, '-m',
                          'ecg_representation_learning_tpu_torch.tools.dp_graph_check',
                          '--ranks', '4'], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    print(res)
    assert res['route'] == 'graph' and res['replays'] == 1 and res['data_ranks'] == 4
    assert max(res['leaf_rel_gap'], res['loss_rel_gap'], res['grad_norm_rel_gap']) <= 1e-4
