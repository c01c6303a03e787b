"""Kernel #5 with the compute copies on the card (``ops/csrc/adamw.cu``).

Every test here needs a CUDA device and skips without one; on a machine
with a card run them with ``python -m pytest --noconftest -p no:cacheprovider
-m card tests/test_torch_adamw_card.py`` (this file imports no JAX).

  * at Moonlight-16B-A3B's leaf sizes (its dense and first MoE layer, the
    patch embedding and the head, 0.21 B parameters) with its f32 leaves
    (router, norms, head) among them: the tail on each copied leaf's bf16
    microbatch gradients at accum 1 and 2 -- and on f32 gradients that are
    views into one flat buffer, each segment padded to 4 elements, as a
    data-parallel tape step hands them over -- is bit-equal to the tail on
    f32 gradients already averaged, (f32(g_1) + f32(g_2)) / 2, as the cast
    route gives them: parameters, moments, norm and counter; each copy is
    the updated parameter's ``to(bfloat16)``;
  * a K = 4 graph replay of the DeepSeek block at accum 2 equals four eager
    steps, bit for bit, copies included.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig  # noqa: E402
from ecg_representation_learning_tpu_torch.ops import adamw  # noqa: E402
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer  # noqa: E402
from ecg_representation_learning_tpu_torch.train.dispatch import Dispatcher  # noqa: E402
from port_bench.reference import moonlight as ml  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYPER = dict(b1=0.9, b2=0.999, eps=1e-6, wd=1e-4)
# the leaves whose layers compute in f32: no copy, one f32 gradient
F32_KINDS = ('norm', 'gate.weight', 'head.', 'cls_token', 'layernorm')


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _moonlight_shapes() -> dict:
    with open(os.path.join(ROOT, 'port_bench', 'configs',
                           'moonlight-16b-a3b-ep8-ptbxl.json')) as f:
        cfg = {**json.load(f), 'num_hidden_layers': 2}
    return ml.moonlight_shapes(cfg)


def _leaves(device, accum: int, flat: bool):
    """Two identical sets of leaves at Moonlight's sizes: the cast route's
    (f32 gradients already averaged) and the copy route (bf16 microbatch
    parts for the copied leaves, the f32 leaves' summed gradient; with
    ``flat`` every gradient an f32 view into one flat buffer)."""
    gen = torch.Generator(device=device).manual_seed(3)
    names, shapes = zip(*_moonlight_shapes().items())
    copied = [not any(k in n for k in F32_KINDS) for n in names]
    p = [torch.randn(s, device=device, generator=gen) * 0.02 for s in shapes]
    mu = [torch.randn(s, device=device, generator=gen) * 1e-3 for s in shapes]
    nu = [torch.rand(s, device=device, generator=gen) * 1e-5 for s in shapes]
    new = []
    for x, c in zip(p, copied):
        parts = tuple(torch.randn(x.shape, device=device, generator=gen).to(torch.bfloat16)
                      for _ in range(accum))
        new.append(parts if c and not flat else
                   parts[0].float() if accum == 1 else parts[0].float() + parts[1].float())
    if flat:   # views into one flat buffer, each segment padded to 4 elements
        #          (parallel/mesh.py's sync_grads), the 71-wide head bias's too
        pad = [-g.numel() % 4 for g in new]
        buf = torch.cat([x for g, k in zip(new, pad)
                         for x in (g.reshape(-1), torch.zeros(k, device=device))])
        views = buf.split([n for g, k in zip(new, pad) for n in (g.numel(), k)])[::2]
        new = [v.view(g.shape) for v, g in zip(views, new)]
        assert all(v.data_ptr() % 16 == 0 for v in new)
    mean = adamw.mean_grads(new, accum)
    copies = [torch.zeros_like(x, dtype=torch.bfloat16) if c else None
              for x, c in zip(p, copied)]
    old = {'p': [x.clone() for x in p], 'mu': [x.clone() for x in mu],
           'nu': [x.clone() for x in nu], 'g': mean}
    return old, {'p': p, 'mu': mu, 'nu': nu, 'g': new, 'copies': copies}, copied


@pytest.mark.card
@pytest.mark.parametrize('accum,flat', [(1, False), (2, False), (2, True)])
def test_copy_route_equals_the_f32_route_at_moonlight_sizes(card, accum, flat):
    old, new, copied = _leaves(card, accum, flat)
    assert any(copied) and not all(copied)
    kw = dict(clip_norm=1.0, zero_nonfinite=True, **HYPER)
    count = torch.zeros((), dtype=torch.int32, device=card)
    for step in range(2):
        lr_bc = (3e-4, 0.1 * (step + 1), 0.001 * (step + 1))
        n_old, c_old = adamw.adamw_tail(old['p'], old['g'], old['mu'], old['nu'], lr_bc, count,
                                        **kw)
        n_new, c_new = adamw.adamw_tail(new['p'], new['g'], new['mu'], new['nu'], lr_bc, count,
                                        accum=accum, copies=new['copies'], **kw)
        torch.cuda.synchronize()
        assert torch.equal(n_old, n_new) and torch.equal(c_old, c_new)
        for k in ('p', 'mu', 'nu'):
            for i, (a, b) in enumerate(zip(old[k], new[k])):
                assert torch.equal(a, b), (k, i)
        for x, c in zip(new['p'], new['copies']):
            if c is not None:
                assert torch.equal(c, x.to(torch.bfloat16))
    print(f'accum {accum} flat {flat}: {sum(copied)} copied leaves of {len(copied)}, '
          f'norm {float(n_new):.6f}')


def _small_moe() -> VitConfig:
    return VitConfig.from_preset('moonlight-16b-a3b-ep8', hidden_size=128, num_attention_heads=4,
                                 qk_nope_head_dim=32, qk_rope_head_dim=32, v_head_dim=32,
                                 kv_lora_rank=64, intermediate_size=256,
                                 moe_intermediate_size=64, moe_num_experts=16, moe_top_k=4,
                                 moe_held=(0, 8), num_hidden_layers=3, max_signal_length=640)


@pytest.mark.card
def test_k4_graph_replay_with_copies_equals_four_eager_steps(card, tmp_path):
    rng = np.random.default_rng(0)
    sig = rng.standard_normal((256, 12, 600)).astype(np.float32)
    lab = (rng.random((256, 71)) < 0.3).astype(np.float32)
    takes = np.arange(12 * 16).reshape(12, 16)
    runs = []
    for k in (1, 4):
        tr = Trainer(_small_moe(), TrainConfig(train_batch_size=16, grad_accum=2,
                                               num_train_epoch=1, do_eval=False,
                                               save_final=False, log_to_console=False,
                                               steps_per_dispatch=k, seed=5),
                     train_data=SplitData(sig, lab), output_dir=str(tmp_path / str(k)),
                     device=card)
        tr.init_state(5)
        assert tr._copies is not None and tr._copies.copies
        if k == 1:
            for t in takes:
                tr.train_step(tr.train_data, t)
        else:
            disp = Dispatcher(tr, 4, scan=False)
            for c in range(3):
                disp.run(takes[4 * c:4 * c + 4])
            info = disp.info()
            assert info['route'] == 'graph' and info['replays'] == 2
            assert info['graph_launches']['param_cast'] == 0
        runs.append(tr)
    one, four = runs
    for (name, p), (_, q) in zip(one.model.named_parameters(), four.model.named_parameters()):
        assert torch.equal(p, q), name
    for tr in runs:
        for name, c in tr._copies.copies.items():
            assert torch.equal(c, tr.model.get_parameter(name).detach().to(torch.bfloat16)), name
