"""The port's optimizer (ops/adamw.py, train/optim.py) against the JAX package's.

The plain AdamW update against the Pallas ``adamw_update_leaf`` in interpret
mode; ``FusedAdamW`` against the JAX ``FusedAdamW`` over 5 steps with the
clip engaged, a non-finite step and a bf16 first moment, and continuing from
a JAX mid-run state carried over by ``fused_adamw_state_from_flax``;
``make_schedule`` against optax at every step; the update tail (norm,
scalars, non-finite counter, update) through ``loop.finish_update`` against
the JAX package's over 5 steps.  The CUDA kernels run only on the GPU
(chip_smoke.py holds them against the plain version there, the update bit
for bit); here their wrapper's input checks are covered, and
tests/test_torch_adamw_tiling.py models their work plan.

Tolerances: the update as tests/test_fused_optim.py holds the JAX paths to
each other (rtol 2e-5, atol 1e-7: XLA may contract a multiply-add into an
FMA where PyTorch's CPU kernels round twice); a bf16 first moment agrees to
one bf16 ulp (rtol 2**-7); schedules to rtol 1e-6 (both compute in f32,
but numpy's and XLA's f32 cosine differ in the last bit, and 1 + cos near
the end of the decay cancels, which measured up to 4e-7 relative; where
the rate has decayed to ~1e-12, atol 1e-6 of the peak covers it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models import vit as jvit
from ecg_representation_learning_tpu.ops.adamw_pallas import adamw_update_leaf
from ecg_representation_learning_tpu.train import loop as jloop
from ecg_representation_learning_tpu.train import optim as joptim
from ecg_representation_learning_tpu.train.trainer import TrainState
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models.port import (
    fused_adamw_state_from_flax, vit_state_dict_from_flax)
from ecg_representation_learning_tpu_torch.ops import _build, adamw
from ecg_representation_learning_tpu_torch.train import loop, optim

torch.set_num_threads(2)
HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)


def _close(got, want, rtol=2e-5, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize('scalars', [(0.73, 3e-4, 0.1, 0.001, 1.0),
                                     (1.0, 1e-3, 0.5, 0.2, 0.0)])
@pytest.mark.parametrize('shape', [(768,), (256, 128), (41, 768)])
def test_plain_update_matches_pallas_interpret(shape, scalars):
    rng = np.random.default_rng(sum(shape))
    g = rng.standard_normal(shape).astype(np.float32)
    mu = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    nu = rng.uniform(0.001, 0.1, shape).astype(np.float32)
    p = rng.standard_normal(shape).astype(np.float32)
    want = adamw_update_leaf(*map(jnp.asarray, (g, mu, nu, p)),
                             jnp.asarray([scalars], jnp.float32), interpret=True, **HYPER)
    tp, tmu, tnu = (torch.from_numpy(x.copy()) for x in (p, mu, nu))
    adamw.adamw_update([tp], [torch.from_numpy(g)], [tmu], [tnu],
                       torch.tensor(scalars, dtype=torch.float32), **HYPER)
    for a, b in zip((tmu, tnu, tp), want):
        _close(a.numpy(), b, rtol=1e-5)


def test_plain_update_covers_the_head_bias_and_bf16_mu():
    """The 71-wide leaf the Pallas kernel sends to jnp, and a bf16 mu."""
    rng = np.random.default_rng(9)
    g, p = (rng.standard_normal(71).astype(np.float32) for _ in range(2))
    nu = rng.uniform(0.001, 0.1, 71).astype(np.float32)
    mu = (0.1 * rng.standard_normal(71)).astype(np.float32)
    scale, lr, bc1, bc2 = 0.5, 3e-4, 0.19, 0.002
    tmu = torch.from_numpy(mu).to(torch.bfloat16)
    g32 = g * scale
    mu_ref = 0.9 * tmu.float().numpy() + 0.1 * g32
    nu_ref = 0.999 * nu + 0.001 * g32 * g32
    p_ref = p - lr * ((mu_ref / bc1) / (np.sqrt(nu_ref / bc2) + 1e-8) + 1e-2 * p)
    tp, tnu = torch.from_numpy(p.copy()), torch.from_numpy(nu.copy())
    adamw.adamw_update([tp], [torch.from_numpy(g)], [tmu], [tnu],
                       torch.tensor([scale, lr, bc1, bc2, 1.0]), **HYPER)
    assert tmu.dtype == torch.bfloat16
    _close(tmu.float().numpy(), mu_ref, rtol=2 ** -7, atol=1e-9)
    _close(tnu.numpy(), nu_ref, rtol=1e-5)
    _close(tp.numpy(), p_ref, rtol=1e-5)


def _tree(rng, scale=1.0):
    return {'dense': {'kernel': (rng.standard_normal((16, 8)) * scale).astype(np.float32),
                      'bias': (rng.standard_normal(8) * scale).astype(np.float32)},
            'norm': {'scale': (rng.standard_normal(16) * scale).astype(np.float32)}}


def _flat(tree):
    return {f'{a}.{b}': torch.from_numpy(np.array(v))
            for a, sub in tree.items() for b, v in sub.items()}


@pytest.mark.parametrize('case', ['clip', 'no_clip_adam', 'nonfinite', 'mu_bf16'])
def test_fused_adamw_matches_jax_over_five_steps(case):
    rng = np.random.default_rng(['clip', 'no_clip_adam', 'nonfinite', 'mu_bf16'].index(case))
    wd = 0.0 if case == 'no_clip_adam' else 1e-2
    gscale = 0.05 if case == 'no_clip_adam' else 10.0      # 10: ||g|| > 1, the clip engages
    mu_dtype = 'bfloat16' if case == 'mu_bf16' else None
    kw = dict(weight_decay=wd, clip_norm=1.0, zero_nonfinite=case == 'nonfinite',
              mu_dtype=mu_dtype)
    sched_cfg = dict(learning_rate=3e-4, warmup_ratio=0.1, schedule='cosine')
    jfused = joptim.FusedAdamW(joptim.make_schedule(JaxTrainConfig(**sched_cfg), 50), **kw)
    tfused = optim.FusedAdamW(optim.make_schedule(TrainConfig(**sched_cfg), 50), **kw)
    params = _tree(rng)
    jp, js = jax.tree.map(jnp.asarray, params), jfused.init(jax.tree.map(jnp.asarray, params))
    tp = _flat(params)
    ts = tfused.init(tp)
    japply = jax.jit(jfused.apply)
    for step in range(5):
        grads = _tree(rng, gscale)
        if case == 'nonfinite' and step == 2:
            grads['dense']['kernel'][0, 0] = np.nan
        jp, js = japply(jax.tree.map(jnp.asarray, grads), js, jp)
        ts = tfused.apply(_flat(grads), ts, tp)
        for k, v in _flat(jax.tree.map(np.asarray, jp)).items():
            _close(tp[k].numpy(), v.numpy())
    assert ts.count == int(js.count) == 5
    mu_tol = 2 ** -7 if mu_dtype else 2e-5
    for k, v in _flat(jax.tree.map(lambda a: np.asarray(a, np.float32), js.mu)).items():
        assert ts.mu[k].dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        _close(ts.mu[k].float().numpy(), v.numpy(), rtol=mu_tol, atol=1e-9)
    for k, v in _flat(jax.tree.map(np.asarray, js.nu)).items():
        _close(ts.nu[k].numpy(), v.numpy())
    assert all(torch.isfinite(v).all() for v in tp.values())


@pytest.mark.parametrize('mu_dtype', [None, 'bfloat16'])
def test_continues_from_a_jax_mid_run_state(mu_dtype):
    """Three JAX steps on the debug ViT, the state carried over with
    fused_adamw_state_from_flax and vit_state_dict_from_flax, then two more
    steps on each side from it."""
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=320)
    _, params = jvit.create_vit(jcfg, jax.random.PRNGKey(0))
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    kw = dict(weight_decay=1e-2, clip_norm=1.0, mu_dtype=mu_dtype)
    jfused, tfused = joptim.FusedAdamW(1e-3, **kw), optim.FusedAdamW(1e-3, **kw)
    rng = np.random.default_rng(3)

    def grads():
        return jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32) * 0.01), params)
    japply = jax.jit(jfused.apply)
    state = jfused.init(params)
    for _ in range(3):
        params, state = japply(grads(), state, params)
    tp = vit_state_dict_from_flax(jax.tree.map(np.asarray, params), cfg)
    ts = fused_adamw_state_from_flax(jax.tree.map(np.asarray, state), cfg)
    assert ts.count == 3 and set(ts.mu) == set(tp) == set(ts.nu)
    assert ts.mu['head.weight'].dtype == (torch.bfloat16 if mu_dtype else torch.float32)
    for _ in range(2):
        g = grads()
        params, state = japply(g, state, params)
        ts = tfused.apply(vit_state_dict_from_flax(jax.tree.map(np.asarray, g), cfg), ts, tp)
    want = vit_state_dict_from_flax(jax.tree.map(np.asarray, params), cfg)
    # a bf16 mu that rounds the other way (its f32 value one ulp apart) moves
    # the next update by lr * 2^-8 * |mu_hat / sqrt(nu_hat)|, under lr * 2^-7
    atol = 1e-3 * 2 ** -7 if mu_dtype else 1e-7
    for k in want:
        _close(tp[k].numpy(), want[k].numpy(), atol=atol)


@pytest.mark.parametrize('total', [1, 2, 10, 97, 1000])
@pytest.mark.parametrize('warmup_ratio', [0.0, 0.05, 0.3])
@pytest.mark.parametrize('schedule', ['cosine', 'constant'])
def test_make_schedule_matches_optax_at_every_step(schedule, warmup_ratio, total):
    kw = dict(schedule=schedule, warmup_ratio=warmup_ratio, learning_rate=3e-4)
    want = joptim.make_schedule(JaxTrainConfig(**kw), total)
    got = optim.make_schedule(TrainConfig(**kw), total)
    steps = np.arange(total + 3)
    np.testing.assert_allclose([got(int(s)) for s in steps],
                               [float(want(jnp.int32(s))) for s in steps],
                               rtol=1e-6, atol=1e-6 * 3e-4)


def test_make_optimizer_follows_the_config():
    opt, sched = optim.make_optimizer(TrainConfig(optimizer='Adam', adam_mu_dtype='bfloat16',
                                                  debug_nans=False), 100)
    assert opt.weight_decay == 0.0 and opt.mu_dtype == torch.bfloat16
    assert opt.clip_norm == 1.0 and not opt.zero_nonfinite and sched(5) == opt.lr_at(5)
    opt, _ = optim.make_optimizer(TrainConfig(), 100)
    assert opt.weight_decay == 1e-2 and opt.zero_nonfinite and opt.mu_dtype is None
    with pytest.raises(ValueError, match='optimizer'):
        optim.make_optimizer(TrainConfig(optimizer='SGD'), 10)


def test_global_norm_matches_optax():
    tree = _tree(np.random.default_rng(4))
    want = float(joptim.optax.global_norm(jax.tree.map(jnp.asarray, tree)))
    np.testing.assert_allclose(float(optim.global_norm(list(_flat(tree).values()))), want,
                               rtol=1e-6)


def test_train_config_loads_a_jax_config_and_refuses_unported_fields():
    jcfg = JaxTrainConfig(prng_impl='threefry2x32', jax_debug_nans=True, ema_decay=0.9,
                          loss_weight=(0.3, 2.0))
    cfg = TrainConfig(**dataclasses.asdict(jcfg))
    assert cfg.ema_decay == 0.9 and cfg.prng_impl == 'threefry2x32'
    assert cfg.steps_per_epoch(130) == jcfg.steps_per_epoch(130) == 2
    assert cfg.total_steps(130) == jcfg.total_steps(130)
    assert [f.name for f in dataclasses.fields(TrainConfig)] == \
        [f.name for f in dataclasses.fields(JaxTrainConfig)]
    for field, value in [('epoch_scan', True), ('steps_per_dispatch', 4)]:   # ported
        assert getattr(TrainConfig(**{field: value}), field) == value
    assert TrainConfig(mesh_stage=2).mesh_stage == 2          # the pipeline is ported
    cfg = TrainConfig(mesh_data=2, mesh_model=2, fsdp=True)   # the mesh is ported
    assert (cfg.mesh_data, cfg.mesh_model, cfg.fsdp) == (2, 2, True)
    assert TrainConfig(resident_dtype='bfloat16').resident_dtype == 'bfloat16'   # ported
    assert TrainConfig(async_checkpoint=True).async_checkpoint                   # ported


def _leaves(**bad):
    p = [torch.zeros(3, 4), torch.zeros(71)]
    out = dict(params=p, grads=[torch.zeros_like(x) for x in p],
               mus=[torch.zeros_like(x) for x in p], nus=[torch.zeros_like(x) for x in p],
               scalars=torch.ones(5))
    out.update(bad)
    return out


@pytest.mark.parametrize('bad,err', [
    (dict(grads=[torch.zeros(3, 4)]), ValueError),                       # lengths
    (dict(params=[torch.zeros(3, 4, dtype=torch.float16), torch.zeros(71)]), TypeError),
    (dict(mus=[torch.zeros(3, 4), torch.zeros(71, dtype=torch.bfloat16)]), TypeError),
    (dict(mus=[torch.zeros(3, 4, dtype=torch.float16)] * 2), TypeError),
    (dict(nus=[torch.zeros(4, 3), torch.zeros(71)]), ValueError),        # shape
    (dict(grads=[torch.zeros(4, 3).t(), torch.zeros(71)]), ValueError),  # strided
    (dict(scalars=torch.ones(4)), ValueError),
    (dict(), ValueError),                                                # CPU tensors
])
def test_adamw_wrapper_rejects_what_the_kernel_cannot_take(bad, err):
    a = _leaves(**bad)
    with pytest.raises(err):
        adamw.adamw_kernel(a['params'], a['grads'], a['mus'], a['nus'], a['scalars'],
                           **HYPER)


def test_adamw_on_cpu_runs_the_plain_version():
    before = _build.launch_counts()
    a = _leaves(grads=[torch.ones(3, 4), torch.ones(71)])
    adamw.adamw_update(a['params'], a['grads'], a['mus'], a['nus'],
                       torch.tensor([1.0, 0.1, 0.1, 0.001, 1.0]), **HYPER)
    assert _build.launch_counts() == before
    assert all(torch.allclose(p, torch.full_like(p, -0.1)) for p in a['params'])


@pytest.mark.parametrize('mu_dtype', [None, 'bfloat16'])
def test_finish_update_fused_tail_matches_jax_over_five_steps(mu_dtype):
    """The tail's plain version (global_norm + tail_scalars_reference +
    adamw_update_reference, what the kernels compute) through
    ``loop.finish_update`` against the JAX package's ``finish_update``:
    step 1 under the clip, steps 2-5 above it (||g|| > 1, the clip engaged),
    step 3 with a NaN gradient (zeroed, counted, params unpoisoned)."""
    rng = np.random.default_rng(21)
    kw = dict(learning_rate=1e-3, warmup_ratio=0.2, adam_mu_dtype=mu_dtype, debug_nans=True)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jopt, _ = joptim.make_optimizer(jcfg, 10)
    topt, _ = optim.make_optimizer(tcfg, 10)
    assert isinstance(topt, optim.FusedAdamW) and topt.zero_nonfinite and topt.clip_norm == 1.0
    params = jax.tree.map(jnp.asarray, _tree(rng))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=jopt.init(params), rng=jax.random.PRNGKey(0), ema_params=None)
    tp = _flat(params)
    ts = topt.init(tp)
    j_bad, t_bad = jnp.zeros((), jnp.int32), torch.zeros((), dtype=torch.int32)
    finish = jax.jit(lambda st, g, bad: jloop.finish_update(jopt, jcfg, st, g, st.rng, bad))
    for step in range(5):
        grads = _tree(rng, 0.05 if step == 0 else 10.0)
        if step == 2:
            grads['dense']['kernel'][0, 0] = np.nan
        state, j_norm, j_bad = finish(state, jax.tree.map(jnp.asarray, grads), j_bad)
        ts, t_norm, t_bad = loop.finish_update(topt, tcfg, ts, tp, _flat(grads), t_bad)
        assert (float(j_norm) < 1.0) == (step == 0) or step == 2
        if step == 2:
            assert np.isnan(float(j_norm)) and np.isnan(float(t_norm))
        else:
            np.testing.assert_allclose(float(t_norm), float(j_norm), rtol=1e-6)
        assert int(t_bad) == int(j_bad) == (1 if step >= 2 else 0)
        for k, v in _flat(jax.tree.map(np.asarray, state.params)).items():
            _close(tp[k].numpy(), v.numpy())
            assert torch.isfinite(tp[k]).all()
    assert ts.count == int(state.opt_state.count) == 5
    mu_tol = 2 ** -7 if mu_dtype else 2e-5
    js = state.opt_state
    for k, v in _flat(jax.tree.map(lambda a: np.asarray(a, np.float32), js.mu)).items():
        _close(ts.mu[k].float().numpy(), v.numpy(), rtol=mu_tol, atol=1e-9)
    for k, v in _flat(jax.tree.map(np.asarray, js.nu)).items():
        _close(ts.nu[k].numpy(), v.numpy())


def test_fused_tail_on_cpu_runs_the_plain_version():
    before = (_build.launch_counts(), adamw.adamw_kernel.table_builds)
    a = _leaves(grads=[torch.full((3, 4), 3.0), torch.full((71,), 3.0)])
    norm, bad = adamw.adamw_tail(a['params'], a['grads'], a['mus'], a['nus'], (0.1, 0.1, 0.001),
                                 torch.zeros((), dtype=torch.int32), clip_norm=1.0,
                                 zero_nonfinite=True, **HYPER)
    assert (_build.launch_counts(), adamw.adamw_kernel.table_builds) == before
    np.testing.assert_allclose(float(norm), 3.0 * np.sqrt(83), rtol=1e-6)
    assert int(bad) == 0
    assert all(torch.allclose(p, torch.full_like(p, -0.1)) for p in a['params'])


@pytest.mark.parametrize('call', ['tail', 'norm_scalars'])
def test_fused_tail_kernel_refuses_cpu_tensors(call):
    """No fallback: the kernels' entries raise on what they cannot take."""
    a = _leaves()
    with pytest.raises(ValueError, match='CUDA'):
        getattr(adamw.adamw_kernel, call)(a['params'], a['grads'], a['mus'], a['nus'],
                                          (0.1, 0.1, 0.001), clip_norm=1.0,
                                          zero_nonfinite=True,
                                          **(HYPER if call == 'tail' else {}))
