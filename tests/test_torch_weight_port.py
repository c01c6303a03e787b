"""The port's vit-pytorch 0.33.2 porter against the JAX package's.

The reference checkpoint layout comes from ``tests/test_weight_port.py``'s
replica of the reference wrapper (``TorchEcgVit``, vit-pytorch 0.33.2).  The
port maps a state_dict through the flax tree, so its result must equal
``vit_state_dict_from_flax`` of the JAX porter's tree bit for bit; the
ported model's logits must match the replica's to 1e-4 (the JAX test's bar,
both in f32 on the CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.models import port as jport
from ecg_representation_learning_tpu_torch.configs import VitConfig
from ecg_representation_learning_tpu_torch.models import port
from ecg_representation_learning_tpu_torch.models.vit import EcgVit
from test_weight_port import TINY as JAX_TINY
from test_weight_port import TorchEcgVit

TINY = VitConfig(**dataclasses.asdict(JAX_TINY))


def _replica(seed=0, cfg=JAX_TINY):
    torch.manual_seed(seed)
    return TorchEcgVit(cfg).eval()


def test_porter_equals_the_jax_mapping_bit_for_bit():
    sd = _replica().state_dict()
    want = port.vit_state_dict_from_flax(jport.port_vit_pytorch_state_dict(sd, JAX_TINY), TINY)
    got = port.port_vit_pytorch_state_dict(sd, TINY)
    assert set(got) == set(want) == set(EcgVit(TINY).state_dict())
    assert all(got[k].dtype == torch.float32 and torch.equal(got[k], want[k]) for k in want)
    # the patch projection is permuted (time-major -> channel-major), not only transposed
    w = sd['vit.to_patch_embedding.1.weight']
    assert not torch.equal(got['encoder.patch_embed.proj.weight'], w)
    c, p = TINY.num_channels, TINY.patch_size
    assert torch.equal(got['encoder.patch_embed.proj.weight'],
                       w.reshape(-1, p, c).permute(0, 2, 1).reshape(-1, c * p))


@pytest.mark.parametrize('flash', [False, True])
def test_ported_logits_match_the_reference_replica(flash):
    tm = _replica(1)
    cfg = dataclasses.replace(TINY, use_flash_attention=flash, flash_min_seq=0)
    model = EcgVit(cfg).eval()
    model.load_state_dict(port.port_vit_pytorch_state_dict(tm.state_dict(), cfg))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, cfg.num_channels, cfg.max_signal_length)).astype(np.float32))
    with torch.no_grad():
        want = tm(x)
        got = model(x).logits
    assert (got - want).abs().max().item() < 1e-4


def test_wrapper_prefix_and_state_dict_wrappers(tmp_path):
    sd = _replica().state_dict()
    bare = port.strip_wrapper_prefix(sd)
    assert all(not k.startswith('vit.') for k in bare) and len(bare) == len(sd)
    assert bare == jport.strip_wrapper_prefix(sd)
    want = port.port_vit_pytorch_state_dict(sd, TINY)
    got = port.port_vit_pytorch_state_dict(bare, TINY)
    assert all(torch.equal(got[k], want[k]) for k in want)
    for i, payload in enumerate((sd, {'state_dict': sd})):
        path = tmp_path / f'ref{i}.pt'
        torch.save(payload, path)
        model, state, cfg = port.load_reference_checkpoint(
            str(path), 'ecg-vit-debug', max_signal_length=256, patch_size=32, num_class=7,
            use_flash_attention=False)
        assert cfg == dataclasses.replace(TINY, hidden_dropout_prob=0.1,
                                          attention_probs_dropout_prob=0.1)
        assert not cfg.patch_norm and cfg.dtype == 'float32'
        assert all(torch.equal(state[k], want[k]) and torch.equal(model.state_dict()[k],
                                                                  want[k]) for k in want)


def test_missing_keys_wrong_shapes_and_patch_norm_are_refused():
    sd = dict(_replica().state_dict())
    with pytest.raises(ValueError, match='patch_norm'):
        port.port_vit_pytorch_state_dict(sd, dataclasses.replace(TINY, patch_norm=True))
    with pytest.raises(ValueError, match='patch_norm'):
        port.export_vit_pytorch_state_dict(EcgVit(TINY).state_dict(),
                                           dataclasses.replace(TINY, patch_norm=True))
    bad = dict(sd)
    bad['vit.mlp_head.1.weight'] = torch.zeros(3, TINY.hidden_size)
    with pytest.raises(ValueError, match='mlp_head.1.weight: expected shape'):
        port.port_vit_pytorch_state_dict(bad, TINY)
    missing = dict(sd)
    del missing['vit.transformer.layers.1.0.fn.to_qkv.weight']
    with pytest.raises(KeyError, match='transformer.layers.1.0.fn.to_qkv.weight'):
        port.port_vit_pytorch_state_dict(missing, TINY)


@pytest.mark.parametrize('prefix', [True, False])
def test_export_round_trip(prefix):
    sd = _replica(2).state_dict()
    ported = port.port_vit_pytorch_state_dict(sd, TINY)
    out = port.export_vit_pytorch_state_dict(ported, TINY, wrapper_prefix=prefix)
    want = sd if prefix else port.strip_wrapper_prefix(sd)
    assert set(out) == set(want)
    assert all(isinstance(v, np.ndarray) and np.array_equal(v, want[k].numpy())
               for k, v in out.items())
    jax_out = jport.export_vit_pytorch_state_dict(
        jport.port_vit_pytorch_state_dict(sd, JAX_TINY), JAX_TINY, wrapper_prefix=prefix)
    assert all(out[k].tobytes() == np.asarray(jax_out[k]).tobytes() for k in out)
    if prefix:
        replica = TorchEcgVit(JAX_TINY)
        replica.load_state_dict({k: torch.from_numpy(v) for k, v in out.items()}, strict=True)
