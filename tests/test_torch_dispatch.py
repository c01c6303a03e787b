"""K train steps, or a whole epoch, per dispatch (``steps_per_dispatch``,
``epoch_scan``; train/dispatch.py) on the CPU, where the step tape runs its
steps eagerly -- the plain version the GPU's CUDA graphs are held to.

  * each mode against the port's per-step loop, bit for bit: params, Adam
    moments, EMA and both generators' states, over dropout impl x {dense,
    Switch-MoE} x remat x grad_accum x fused optimizer, with TimeOut on;
  * against the JAX trainer's same mode from the same init, dropout off:
    the payloads' keys, epochs and steps equal, and the losses and gradient
    norms to rtol 5e-4 for K steps (the JAX package's own K-step tolerance,
    tests/test_train.py:420-423: XLA may fuse across the unrolled steps) and
    1e-5 for epoch_scan (tests/test_torch_train.py's RTOL: JAX's scan is
    bit-identical to its loop);
  * a checkpoint taken after a K-step epoch resumes as the per-step run's;
  * the plain versions of kernels #1-#4 and the hashed dropout with a 0-d
    int32 tensor seed (a tape slot), bit-equal to the int seed;
  * the non-resident fallback, the mesh route (eager steps through the
    tape on two gloo ranks) and the CLI flags.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.data import get_ptbxl_splits as jax_splits
from ecg_representation_learning_tpu.data import synth_ptbxl
from ecg_representation_learning_tpu.train import Trainer as JaxTrainer
from ecg_representation_learning_tpu.train import trainer as jtrainer
from ecg_representation_learning_tpu.utils import logging as jlogging
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.data import get_ptbxl_splits
from ecg_representation_learning_tpu_torch.models.port import vit_state_dict_from_flax
from ecg_representation_learning_tpu_torch.models.vit import seeds_per_forward
from ecg_representation_learning_tpu_torch.ops import attention as attn
from ecg_representation_learning_tpu_torch.ops.dropout import _masked
from ecg_representation_learning_tpu_torch.parallel import LocalRanks
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer
from ecg_representation_learning_tpu_torch.train import trainer as ttrainer
from ecg_representation_learning_tpu_torch.train.dispatch import StepTape, step_scalars
from ecg_representation_learning_tpu_torch.utils import logging as tlogging

import test_torch_parallel_ranks as prog

torch.set_num_threads(2)
K_RTOL, SCAN_RTOL = 5e-4, 1e-5
# n = 160 -> a train split of 132 rows: 8 steps an epoch at bs 16, so K = 3
# gives two dispatches and two leftover steps (tests/test_train.py:401)
BASE = dict(num_train_epoch=2, train_batch_size=16, eval_batch_size=16, learning_rate=1e-3,
            log_to_console=False, save_final=False, do_eval=False)


@pytest.fixture(scope='module')
def corpus():
    signals, labels, folds = synth_ptbxl(n=160, length=640)
    return (signals, labels, folds), get_ptbxl_splits(signals, labels, folds)


def _cfg(impl='hash', moe=False, remat=False, **kw) -> VitConfig:
    extra = dict(moe_num_experts=2, moe_every=1) if moe else {}
    return VitConfig.from_defined('debug', max_signal_length=704, num_hidden_layers=2,
                                  flash_min_seq=0, dropout_impl=impl, remat=remat,
                                  **extra, **kw)


def _train(splits, cfg: VitConfig, tmp_path, **kw) -> Trainer:
    tcfg = TrainConfig(**{**BASE, 'augment_timeout': True, 'ema_decay': 0.9, **kw})
    tr = Trainer(cfg, tcfg, train_data=splits.train, output_dir=str(tmp_path), device='cpu')
    tr.train()
    return tr


def _assert_same_state(a: Trainer, b: Trainer) -> None:
    for name, get in (('params', lambda t: t.model.state_dict()), ('ema', lambda t: t.ema),
                      ('mu', lambda t: t.opt_state.mu), ('nu', lambda t: t.opt_state.nu)):
        x, y = get(a), get(b)
        assert all(torch.equal(x[k], y[k]) for k in x), name
    assert torch.equal(a.rng.host.get_state(), b.rng.host.get_state())
    assert torch.equal(a.rng.device.get_state(), b.rng.device.get_state())
    assert (a.step, a.epoch, a.opt_state.count) == (b.step, b.epoch, b.opt_state.count)


_REFERENCE = {}


def _per_step(corpus, tmp_path_factory, key) -> Trainer:
    """The per-step loop's run of configuration ``key``, once per module."""
    if key not in _REFERENCE:
        impl, moe, remat, accum, fused = key
        _REFERENCE[key] = _train(corpus[1], _cfg(impl, moe, remat),
                                 tmp_path_factory.mktemp('ref'), grad_accum=accum,
                                 fused_optimizer=fused)
    return _REFERENCE[key]


GRID = [(impl, moe, remat, accum, fused) for impl in ('flax', 'hash') for moe in (False, True)
        for remat in (False, True) for accum in (1, 2) for fused in (True, False)]
IDS = ['{}-{}-{}-accum{}-{}'.format(impl, 'moe' if moe else 'dense', 'remat' if remat else 'plain',
                                    accum, 'fused' if fused else 'chain')
       for impl, moe, remat, accum, fused in GRID]


@pytest.mark.parametrize('key', GRID, ids=IDS)
def test_steps_per_dispatch_equals_the_per_step_loop(corpus, tmp_path, tmp_path_factory, key):
    impl, moe, remat, accum, fused = key
    ref = _per_step(corpus, tmp_path_factory, key)
    tr = _train(corpus[1], _cfg(impl, moe, remat), tmp_path, grad_accum=accum,
                fused_optimizer=fused, steps_per_dispatch=3)
    assert tr.steps_per_epoch == 8 and tr.dispatch_info['route'] == 'eager'
    _assert_same_state(tr, ref)


@pytest.mark.parametrize('key', GRID, ids=IDS)
def test_epoch_scan_equals_the_per_step_loop(corpus, tmp_path, tmp_path_factory, key):
    impl, moe, remat, accum, fused = key
    ref = _per_step(corpus, tmp_path_factory, key)
    tr = _train(corpus[1], _cfg(impl, moe, remat), tmp_path, grad_accum=accum,
                fused_optimizer=fused, epoch_scan=True, steps_per_dispatch=3)
    assert tr.dispatch_info['scan'] and tr.dispatch_info['steps'] == 8   # scan wins
    _assert_same_state(tr, ref)


def test_the_tape_holds_every_seed_a_step_takes(corpus, tmp_path):
    """``seeds_per_forward`` counts the seeds of a forward (a step checks
    the count), for both impls, scan_blocks and the ring-free attention."""
    for cfg in (_cfg('hash'), _cfg('flax'), _cfg('hash', scan_blocks=True),
                _cfg('hash', hidden_dropout_prob=0.0),
                _cfg('flax', attention_probs_dropout_prob=0.0)):
        tr = _train(corpus[1], cfg, tmp_path, num_train_epoch=1, steps_per_dispatch=4)
        assert tr.dispatcher is None and tr.step == 8
    assert seeds_per_forward(_cfg('hash')) == 1 + 2 * 4
    assert seeds_per_forward(_cfg('flax')) == 2
    assert seeds_per_forward(_cfg('flax', attention_probs_dropout_prob=0.0)) == 0


def test_falls_back_when_the_split_is_not_resident(corpus, tmp_path, monkeypatch):
    said = []
    monkeypatch.setattr(Trainer, '_info', lambda self, msg: said.append(msg))
    for mode in (dict(epoch_scan=True), dict(steps_per_dispatch=3)):
        tr = _train(corpus[1], _cfg(), tmp_path, device_resident=False, **mode)
        assert tr.dispatch_info is None and tr.step == 2 * tr.steps_per_epoch
    assert sum('falling back to the per-step loop' in m for m in said) == 2


def _recording(monkeypatch, module):
    """Every payload ``module``'s trainer prints and every TensorBoard
    scalar its writer takes."""
    payloads, scalars = [], []
    pretty = module.pretty_log_dict
    monkeypatch.setattr(module, 'pretty_log_dict', lambda p: (payloads.append(dict(p)),
                                                              pretty(p))[1])
    return payloads, scalars


def _tb(monkeypatch, writer_cls, scalars):
    log = writer_cls.log
    monkeypatch.setattr(writer_cls, 'log', lambda self, p, step: (
        scalars.append((step, dict(p))), log(self, p, step)))


@pytest.fixture(scope='module')
def jax_init(corpus):
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=704, num_hidden_layers=2,
                                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return jcfg, VitConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize('mode', ['steps_per_dispatch', 'epoch_scan'])
def test_dispatch_modes_match_the_jax_trainer(corpus, jax_init, tmp_path, monkeypatch, mode):
    raw, splits = corpus
    jcfg, cfg = jax_init
    kw = dict(BASE, ema_decay=0.9, log_per_epoch=False,
              **({'steps_per_dispatch': 3} if mode == 'steps_per_dispatch'
                 else {'epoch_scan': True}))
    jpay, jtb = _recording(monkeypatch, jtrainer)
    _tb(monkeypatch, jlogging.TbWriter, jtb)
    jtr = JaxTrainer(jcfg, JaxTrainConfig(**kw, prng_impl=jax.config.jax_default_prng_impl),
                     train_data=jax_splits(*raw).train, output_dir=str(tmp_path / 'jax'))
    jtr.init_state()
    params = jax.tree.map(np.asarray, jtr.state.params)
    jtr.train()
    tpay, ttb = _recording(monkeypatch, ttrainer)
    _tb(monkeypatch, tlogging.TbWriter, ttb)
    tr = Trainer(cfg, TrainConfig(**kw), train_data=splits.train,
                 output_dir=str(tmp_path / 'port'), device='cpu')
    tr.set_params(vit_state_dict_from_flax(params, cfg))
    tr.train()
    assert tr.step == jtr._host_step == 16
    assert [sorted(p) for p in tpay] == [sorted(p) for p in jpay]
    assert [(p['epoch'], p['step']) for p in tpay] == [(p['epoch'], p['step']) for p in jpay]
    rtol = K_RTOL if mode == 'steps_per_dispatch' else SCAN_RTOL
    if mode == 'steps_per_dispatch':   # one payload per dispatch and leftover step
        assert [p['step'] for p in tpay] == [3, 6, 7, 8, 11, 14, 15, 16]
    else:                              # one payload per epoch, the curve in TensorBoard
        assert [p['step'] for p in tpay] == [8, 16]
        assert [s for s, _ in ttb] == [s for s, _ in jtb] == list(range(1, 17))
        for (_, a), (_, b) in zip(ttb, jtb):
            for key in ('train/loss', 'train/grad_norm'):
                np.testing.assert_allclose(a[key], b[key], rtol=rtol, err_msg=key)
    for a, b in zip(tpay, jpay):
        for key in ('train/loss', 'train/grad_norm', 'train/loss_epoch_mean'):
            if key in b:
                np.testing.assert_allclose(a[key], b[key], rtol=rtol, err_msg=key)


def test_k_step_log_per_epoch_payload(corpus, tmp_path, monkeypatch):
    """With ``log_per_epoch`` one payload an epoch, its loss mean over the
    dispatched steps (the JAX rule), its step the host step."""
    payloads, _ = _recording(monkeypatch, ttrainer)
    tr = _train(corpus[1], _cfg(), tmp_path, steps_per_dispatch=3, log_per_epoch=True)
    assert [(p['epoch'], p['step']) for p in payloads] == [(1, 8), (2, 16)]
    assert all(set(p) == {'train/loss', 'train/grad_norm', 'train/learning_rate',
                          'train/loss_epoch_mean', 'epoch', 'step'} for p in payloads)
    assert tr.step == 16


def test_resume_after_a_k_step_epoch_continues_as_the_per_step_run(corpus, tmp_path):
    """A checkpoint after a K-step epoch holds the per-step run's state, so
    training resumed from it (as K steps or per step) continues bit for bit
    as training resumed from the per-step run's checkpoint, and its next step
    equals the unbroken trainer's next step."""
    splits = corpus[1]
    cfg = _cfg('hash')
    one = dict(num_train_epoch=1, save_final=True)
    k = _train(splits, cfg, tmp_path / 'k', steps_per_dispatch=3, **one)
    p = _train(splits, cfg, tmp_path / 'p', **one)
    _assert_same_state(k, p)

    def resumed(path, **kw):
        tcfg = TrainConfig(**{**BASE, 'augment_timeout': True, 'ema_decay': 0.9, **kw})
        tr = Trainer(cfg, tcfg, train_data=splits.train, output_dir=str(tmp_path / 'r'),
                     device='cpu')
        tr.train(resume=path)
        return tr
    from_k = resumed(str(tmp_path / 'k' / 'ckpt-final'), steps_per_dispatch=3)
    from_p = resumed(str(tmp_path / 'p' / 'ckpt-final'))
    from_k_per_step = resumed(str(tmp_path / 'k' / 'ckpt-final'))
    _assert_same_state(from_k, from_p)
    _assert_same_state(from_k_per_step, from_p)
    restored = Trainer(cfg, k.cfg, train_data=splits.train, device='cpu')
    restored.load_checkpoint(str(tmp_path / 'k' / 'ckpt-final'))
    take = np.arange(16)
    assert float(k.train_step(splits.train, take)['loss']) == \
        float(restored.train_step(splits.train, take)['loss'])
    _assert_same_state(k, restored)


SEEDS = [0, 1, 4321, 2 ** 31 - 1]


@pytest.mark.parametrize('seed', SEEDS)
def test_plain_kernels_take_a_tensor_seed_with_the_int_seeds_bits(seed):
    """Kernels #1-#4's plain versions, the keep mask and the hashed dropout
    with a 0-d int32 tensor seed (a tape slot) give the int seed's bits."""
    g = torch.Generator().manual_seed(seed % 1000)
    q, k, v, do = (torch.randn(2, 3, 41, 16, generator=g) for _ in range(4))
    t = torch.tensor(seed, dtype=torch.int32)
    assert torch.equal(attn.keep_full(seed, 2, 3, 41, 0.1), attn.keep_full(t, 2, 3, 41, 0.1))
    def same(a, b):
        a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    for lse in (False, True):
        assert same(attn.flash_attention_forward_reference(q, k, v, seed, None, 0.1,
                                                           return_lse=lse),
                    attn.flash_attention_forward_reference(q, k, v, t, None, 0.1,
                                                           return_lse=lse))
    out, lse = attn.flash_attention_forward_reference(q, k, v, seed, None, 0.1, return_lse=True)
    delta = (do * out).sum(-1)
    for fn in (attn.flash_bwd_dq_reference, attn.flash_bwd_dkv_reference,
               attn.flash_backward_blocked_reference):
        assert same(fn(q, k, v, do, lse, delta, seed, None, 0.1),
                    fn(q, k, v, do, lse, delta, t, None, 0.1))
    assert same(attn.flash_backward_recompute(q, k, v, do, seed, None, 0.1),
                attn.flash_backward_recompute(q, k, v, do, t, None, 0.1))
    for dtype in (torch.float32, torch.bfloat16):
        x = q.to(dtype)
        assert torch.equal(_masked(x, seed, 0.1, 3), _masked(x, t, 0.1, 3))
    # the autograd path, as a training forward runs it
    grads = []
    for s in (seed, t):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        attn.flash_attention(qq, kk, vv, s, None, 0.1).sum().backward()
        grads.append((qq.grad, kk.grad, vv.grad))
    assert all(torch.equal(x, y) for x, y in zip(*grads))


def test_step_tape_rows_and_scalars():
    """A tape row's views give back what was filled, and the scalars are
    the optimizers' own values from the count."""
    tape = StepTape(3, 5, 7, torch.device('cpu'))
    takes = np.arange(15).reshape(3, 5)
    seeds = np.random.default_rng(0).integers(0, 2 ** 31, (3, 7))
    tr_cfg = TrainConfig(learning_rate=1e-3)
    from ecg_representation_learning_tpu_torch.train.optim import make_optimizer
    for fused in (True, False):
        opt, _ = make_optimizer(dataclasses.replace(tr_cfg, fused_optimizer=fused), 100)
        scal = np.stack([step_scalars(opt, c) for c in (0, 1, 2)])
        tape.fill(takes, seeds, scal)
        for i in range(3):
            idx, s, sc = tape.views(tape.dev[i])
            assert idx.tolist() == takes[i].tolist() and s.tolist() == seeds[i].tolist()
            assert sc.tolist() == [*opt.lr_bc(i), -opt.lr_at(i)]
    with pytest.raises(ValueError, match='non-negative int32'):
        tape.fill(takes, seeds - 2 ** 31, scal)


def test_mesh_route_runs_eager_steps_through_the_tape(corpus, tmp_path):
    """On a mesh the K steps run eagerly through the tape's seeds: two gloo
    ranks with K = 3 equal their per-step run (hashed dropout, TimeOut)."""
    splits = corpus[1]
    cfg = _cfg('hash')
    tcfg = TrainConfig(**{**BASE, 'augment_timeout': True, 'num_train_epoch': 1})
    data = (splits.train.signals, splits.train.labels)
    with LocalRanks(2) as ranks:
        runs = [ranks.run(prog.train_run, 'sup', cfg, dataclasses.replace(tcfg, **kw), (2, 1),
                          SplitData(*data), None, str(tmp_path / name))
                for name, kw in (('per_step', {}), ('k3', {'steps_per_dispatch': 3}))]
    per_step, k = (r[0] for r in runs)
    assert all(torch.equal(per_step['state'][n], k['state'][n]) for n in per_step['state'])
    assert len(k['losses']) == 2 + 2 and per_step['losses'][-1] == k['losses'][-1]


def test_cli_train_dispatch_flags_reach_train_config(monkeypatch):
    seen = []
    monkeypatch.setattr(ttrainer, 'default_device', lambda device=None: torch.device('cpu'))

    class Stop(Exception):
        pass

    def stop(self, resume=False):
        seen.append(self.cfg)
        raise Stop
    monkeypatch.setattr(Trainer, 'train', stop)
    for argv, want in ((['--steps-per-dispatch', '2'], (False, 2)),
                       (['--epoch-scan'], (True, 1)), ([], (False, 1))):
        with pytest.raises(Stop):
            cli.main(['train', '--size', 'debug', '--synth-n', '96', '--no-bf16', *argv])
        assert (seen[-1].epoch_scan, seen[-1].steps_per_dispatch) == want
