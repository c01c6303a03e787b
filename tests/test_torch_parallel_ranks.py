"""Rank programs of the mesh tests, and the tests of the local launcher.

The functions here run on gloo CPU ranks (``parallel.LocalRanks``), one
process per rank with one thread; they import torch and the port only, so a
rank starts without JAX.  The tests that hold them against the JAX package
are ``tests/test_torch_parallel_{rules,steps,pretrain}.py``; the tests in this
file check the launcher and the helpers that need no JAX.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ecg_representation_learning_tpu_torch.configs import (ContrastiveConfig, MaeConfig,
                                                           TrainConfig, VitConfig)
from ecg_representation_learning_tpu_torch.models.port import state_dict_from_flax
from ecg_representation_learning_tpu_torch.ops import adamw
from ecg_representation_learning_tpu_torch.parallel import (LocalRanks, make_mesh,
                                                            process_local_batch_slice, spmd)
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer
from ecg_representation_learning_tpu_torch.train.contrastive import ContrastiveTrainer
from ecg_representation_learning_tpu_torch.train.pretrain import MaeTrainer

MAE = MaeConfig(decoder_hidden_size=32, decoder_num_layers=1, decoder_num_heads=2,
                decoder_intermediate_size=64)
CON = ContrastiveConfig(proj_hidden_size=32, proj_dim=8)


# ------------------------------------------------------------------ programs
def rank_info():
    return dist.get_rank(), dist.get_world_size(), os.environ['RANK']


def fail_on(rank: int):
    if dist.get_rank() == rank:
        raise ValueError(f'rank {rank} fails')
    return dist.get_rank()


def crash_on(rank: int):
    """Rank ``rank`` dies without a result; the others wait for it."""
    if dist.get_rank() == rank:
        os._exit(3)
    dist.barrier()
    return dist.get_rank()


def build(kind: str, cfg: VitConfig, tcfg: TrainConfig, mesh, data=None, out=None):
    """A trainer of ``kind`` ('sup', 'mae', 'con') on the CPU (on ``mesh``)."""
    kw = dict(train_data=data, eval_data=data, device='cpu', mesh=mesh, output_dir=out)
    if kind == 'sup':
        return Trainer(cfg, tcfg, **kw)
    if kind == 'mae':
        return MaeTrainer(cfg, MAE, tcfg, **kw)
    return ContrastiveTrainer(cfg, CON, tcfg, **kw)


def model_of(kind: str, cfg: VitConfig) -> torch.nn.Module:
    """The unsharded model of a trainer of ``kind``, on the meta device."""
    from ecg_representation_learning_tpu_torch.models.contrastive import EcgContrastive
    from ecg_representation_learning_tpu_torch.models.mae import EcgMae
    from ecg_representation_learning_tpu_torch.models.vit import EcgVit
    with torch.device('meta'):
        if kind == 'sup':
            return EcgVit(cfg)
        return EcgMae(cfg, MAE) if kind == 'mae' else EcgContrastive(cfg, CON)


def train_run(kind, cfg, tcfg, shape, data, flax_params, out):
    """``train()`` on a (n_data, n_model) mesh (``shape`` None: one device,
    no process group needed) from the flax weights: (logged train losses, the
    result, the full state_dict, the local leaves' shapes)."""
    mesh = None if shape is None else make_mesh(*shape, device='cpu')
    tr = build(kind, cfg, tcfg, mesh, data, out)
    tr.init_state()
    if flax_params is not None:
        tr.set_params(state_dict_from_flax(flax_params, model_of(kind, cfg)))
    logged = []
    log = tr._log
    tr._log = lambda p: (logged.append(p), log(p))
    result = tr.train()
    losses = [p.get('train/loss', p.get('pretrain/loss')) for p in logged
              if 'train/loss' in p or 'pretrain/loss' in p]
    history = result.get('history')
    return {'losses': losses, 'history': [h['loss'] for h in history] if history else None,
            'state': tr.state_dict(),
            'local_shapes': {k: tuple(v.shape) for k, v in tr._leaves().items()},
            'mu_shapes': {k: tuple(v.shape) for k, v in tr.opt_state.mu.items()}}


def ddp_then_tape_run(cfg, tcfg, shape, data, out, mixed):
    """Four steps on a (n_data, 1) mesh: ``train_step`` each, or (``mixed``)
    an eager step (DDP), a dispatch of two tape steps after ``drop_ddp`` (as
    a capture drops it) and an eager step again.  Returns the full state and
    whether a parameter's gradient accumulator outlived its backward under
    the DDP wrapper and after the drop, and whether the trainer keeps #5's
    compute copies."""
    from ecg_representation_learning_tpu_torch.train.dispatch import Dispatcher
    tr = build('sup', cfg, tcfg, make_mesh(*shape, device='cpu'), data, out)
    tr.init_state()
    takes = np.arange(4 * tcfg.train_batch_size).reshape(4, -1)
    p = next(iter(tr.model.parameters()))

    def kept() -> bool:   # a node's metadata lives as long as the node
        node = p.view_as(p).grad_fn.next_functions[0][0]
        was = 'probe' in node.metadata
        node.metadata['probe'] = True
        return was
    if not mixed:
        for t in takes:
            tr.train_step(tr.train_data, t)
        return {'state': tr.state_dict()}
    tr.train_step(tr.train_data, takes[0])
    kept()
    held = kept()
    tr.sharded.drop_ddp()
    freed = not kept()
    Dispatcher(tr, 2, scan=False).run(takes[1:3])
    tr.train_step(tr.train_data, takes[3])
    return {'state': tr.state_dict(), 'held': held, 'freed': freed,
            'copies': tr._copies is not None}


def replay_steps(kind, cfg, tcfg, shape, data, flax_params, steps):
    """``len(steps)`` train steps fed the given randomness (each step: MAE
    noise per microbatch, or the two views' draws, for the global batch; the
    rank keeps its rows): per step the global loss and the full state after
    it."""
    mesh = None if shape is None else make_mesh(*shape, device='cpu')
    tr = build(kind, cfg, tcfg, mesh, data)
    tr.init_state()
    tr.set_params(state_dict_from_flax(flax_params, model_of(kind, cfg)))
    n_data = 1 if mesh is None else mesh.shape['data']
    out = []
    for k, draws in enumerate(steps):
        if kind == 'mae':
            queue = list(draws)

            def forward(x, rng=None, _fwd=type(tr.model).forward, _m=tr.model):
                noise = queue.pop(0)
                rows = process_local_batch_slice(noise.shape[0], mesh) if n_data > 1 else \
                    slice(None)
                return _fwd(_m, x, rng, noise=noise[rows])
            tr.model.forward = forward
        else:
            def views(sig, gen, draws=draws, prep=None):
                rows = process_local_batch_slice(draws[0]['shift'].shape[0], mesh) \
                    if n_data > 1 else slice(None)
                mine = tuple({k: v[rows] for k, v in d.items()} for d in draws)
                return ContrastiveTrainer._views(tr, sig, gen, draws=mine, prep=prep)
            tr._views = views
        bs = tcfg.train_batch_size
        m = tr.train_step(data, np.arange(bs * k, bs * (k + 1)))
        out.append((float(m['loss']), float(m['grad_norm']), tr.state_dict()))
    return out


def save_and_eval(kind, cfg, tcfg, shape, data, out):
    """Train one epoch on the mesh, save ``ckpt-final``; (eval loss, path)."""
    mesh = make_mesh(*shape, device='cpu')
    tr = build(kind, cfg, tcfg, mesh, data, out)
    tr.train()
    ev = tr.evaluate(data)
    return (ev if isinstance(ev, float) else ev['loss']), tr.latest_checkpoint()


def restore_and_eval(kind, cfg, tcfg, shape, data, path):
    """Eval loss of the checkpoint ``path`` restored onto a mesh (``shape``)
    or one device (None)."""
    mesh = None if shape is None else make_mesh(*shape, device='cpu')
    tr = build(kind, cfg, tcfg, mesh, data)
    tr.load_checkpoint(path)
    ev = tr.evaluate(data)
    return ev if isinstance(ev, float) else ev['loss']


def dp_steps(cfg, tcfg, data, shape, steps: int = 2):
    """``steps`` train steps of a ``Trainer`` from its seeded init, on one
    device (``shape`` None) or a mesh: (global losses, the full state, the
    first state of the Bernoulli mask generator)."""
    mesh = None if shape is None else make_mesh(*shape, device='cpu')
    tr = build('sup', cfg, tcfg, mesh, data)
    tr.init_state()
    mask = None if tr.rng.mask is None else tr.rng.mask.get_state()
    bs = tcfg.train_batch_size
    losses = [float(tr.train_step(data, np.arange(bs * k, bs * (k + 1)))['loss'])
              for k in range(steps)]
    return losses, tr.state_dict(), mask


def mesh_norm(grads_full, shards, clip, poison_rank=None):
    """FusedAdamW's step on this rank's pieces of ``grads_full`` (a list of
    full gradients; ``shards[i]`` the leaf's dim sharded over the ranks, or
    None for a replicated leaf), with the mesh-wide norm: (grad_norm,
    nonfinite count, the updated local params).  ``poison_rank`` puts a NaN
    into that rank's first leaf."""
    r, n = dist.get_rank(), dist.get_world_size()
    grads, weights = [], []
    for g, dim in zip(grads_full, shards):
        if dim is None:
            grads.append(g.clone())
            weights.append(1.0 / n)
        else:
            grads.append(g.chunk(n, dim)[r].contiguous())
            weights.append(1.0)
    if poison_rank == r:
        grads[0].view(-1)[0] = float('nan')
    params = [torch.ones_like(g) for g in grads]
    mus = [torch.zeros_like(g) for g in grads]
    nus = [torch.zeros_like(g) for g in grads]
    count = torch.zeros((), dtype=torch.int32)
    norm, count = adamw.adamw_tail(params, grads, mus, nus, (1e-2, 0.1, 0.001), count,
                                   clip_norm=clip, zero_nonfinite=True, b1=0.9, b2=0.999,
                                   eps=1e-8, wd=0.0, reduce=adamw.NormReduce(weights))
    return float(norm), int(count), params


def int8_serving(cfg, tcfg, shape, flax_params, signals, split, train_steps=0):
    """int8 inference of a ``Trainer`` on a (n_data, n_model) mesh
    (``shape`` None: one device, no process group needed) from the flax
    weights, after ``train_steps`` steps on ``split``: (predict_long of
    ``signals``, eval loss, eval macro-AUROC) sharded before, in int8, and
    sharded after ``disable_int8_inference``; the size summary, the full
    served state, the shapes of the int8 snapshot's float leaves and the
    bytes of the replicated model's own storage."""
    mesh = None if shape is None else make_mesh(*shape, device='cpu')
    tr = build('sup', cfg, tcfg, mesh, split)
    tr.init_state()
    if flax_params is not None:
        tr.set_params(state_dict_from_flax(flax_params, model_of('sup', cfg)))
    bs = tcfg.train_batch_size
    for k in range(train_steps):
        tr.train_step(split, np.arange(bs * k, bs * (k + 1)))

    def serve():
        ev = tr.evaluate(split)
        return tr.predict_long(signals), ev['loss'], ev['macro_auc']
    before = serve()
    summary = tr.enable_int8_inference()
    q8 = serve()
    model = tr._int8.get('model')
    own = 0 if model is None else sum(p.numel() * p.element_size() for p in model.parameters())
    rest = {k: tuple(v.shape) for k, v in tr._int8['rest'].items()}
    tr.disable_int8_inference()
    after = serve()
    return {'before': before, 'int8': q8, 'after': after, 'summary': summary,
            'served': tr._full_state(tr._served_state()), 'rest_shapes': rest,
            'model_bytes': own}


def serve_on_mesh(cfg, tcfg, shape, flax_params, requests):
    """``serving.serve`` of an int8 ``Trainer`` on a mesh: rank 0 answers the
    ``requests`` (one concurrent HTTP client each) and returns each
    client's probabilities and the service's health; the other ranks
    ``follow`` and return the number of batches they ran."""
    import json
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from ecg_representation_learning_tpu_torch.serving import follow, serve
    mesh = make_mesh(*shape, device='cpu')
    tr = build('sup', cfg, tcfg, mesh)
    tr.init_state()
    tr.set_params(state_dict_from_flax(flax_params, model_of('sup', cfg)))
    tr.enable_int8_inference()
    if dist.get_rank() != 0:
        return follow(tr)
    httpd = serve(tr, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{httpd.server_address[1]}/predict'

    def post(sig):
        req = urllib.request.Request(url, data=json.dumps({'signals': sig.tolist()}).encode(),
                                     headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return np.asarray(json.loads(resp.read())['probs'], np.float32)
    try:
        with ThreadPoolExecutor(len(requests)) as ex:
            probs = list(ex.map(post, requests))
        health = httpd.service.health()
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()
    return probs, health


def serve_past_a_failing_batch(cfg, tcfg, shape, params, bad, good):
    """``serving.serve`` of an int8 ``Trainer`` on a mesh whose
    ``predict_long`` raises on every rank for records of ``bad``'s length (a
    batch that fails the same way everywhere): rank 0 posts ``bad``, then
    ``good``, and returns (``bad``'s HTTP status, ``good``'s probabilities,
    the service's health); the other ranks ``follow`` and return the number
    of batches they ran."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from ecg_representation_learning_tpu_torch.serving import follow, serve
    tr = build('sup', cfg, tcfg, make_mesh(*shape, device='cpu'))
    tr.init_state()
    tr.set_params(params)
    tr.enable_int8_inference()
    predict_long = tr.predict_long

    def failing(signals, **kw):
        if signals.shape[-1] == bad.shape[-1]:
            raise ValueError(f'no records of {signals.shape[-1]} samples')
        return predict_long(signals, **kw)
    tr.predict_long = failing
    if dist.get_rank() != 0:
        return follow(tr)
    httpd = serve(tr, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{httpd.server_address[1]}/predict'

    def post(sig):
        req = urllib.request.Request(url, data=json.dumps({'signals': sig.tolist()}).encode(),
                                     headers={'Content-Type': 'application/json'})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, np.asarray(json.loads(resp.read())['probs'], np.float32)
        except urllib.error.HTTPError as e:
            return e.code, None
    try:
        status, _ = post(bad)
        _, probs = post(good)
        health = httpd.service.health()
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()
    return status, probs, health


# --------------------------------------------------------------------- tests
@pytest.fixture(scope='module')
def ranks():
    with LocalRanks(2) as r:
        yield r


def test_local_ranks_share_one_group(ranks):
    assert ranks.run(rank_info) == [(0, 2, '0'), (1, 2, '1')]


def test_a_failing_rank_raises_with_its_traceback(ranks):
    with pytest.raises(RuntimeError, match='rank 1 fails'):
        ranks.run(fail_on, 1)
    assert ranks.run(rank_info)[1][0] == 1     # the group is still usable


def test_spawn_ranks_ends_when_a_rank_crashes(monkeypatch):
    import time
    from ecg_representation_learning_tpu_torch.parallel import distributed, spawn_ranks
    monkeypatch.setattr(distributed, 'SPAWN_GRACE_S', 2.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r'rank\(s\) \[1\] gave no result'):
        spawn_ranks(2, crash_on, 1)
    assert time.monotonic() - t0 < 60
    assert spawn_ranks(2, crash_on, 5) == [0, 1]


def test_spmd_helpers_are_identities_without_a_mesh():
    x = torch.arange(6.0).reshape(3, 2)
    assert spmd.current() is None
    for fn in (spmd.copy_to_model, spmd.reduce_from_model, spmd.gather_from_model,
               spmd.all_reduce_data, spmd.gather_rows, spmd.mean_over_data):
        assert fn(x) is x
    assert spmd.all_gather_data(x) == [x]
    assert spmd.batch_frame(3) is None and spmd.frame((3, 2)) is None
    assert spmd.global_draw(3, lambda n: torch.arange(n)).tolist() == [0, 1, 2]
    assert spmd.data_index() == (0, 1) and spmd.model_index() == (0, 1)


def test_trainer_without_a_group_is_the_one_device_trainer():
    tr = Trainer(VitConfig.from_defined('debug'), TrainConfig(), device='cpu')
    assert tr.mesh is None and tr.sharded is None
    with pytest.raises(RuntimeError, match='process group'):
        Trainer(VitConfig.from_defined('debug'), TrainConfig(mesh_model=2), device='cpu')


def _corpus(n=32, length=256):
    rng = np.random.default_rng(9)
    return SplitData((0.5 * rng.standard_normal((n, 12, length))).astype(np.float32),
                     (rng.uniform(size=(n, 71)) < 0.2).astype(np.float32))


def test_dp2_with_hashed_dropout_equals_the_one_device_step(ranks):
    """Both ranks take 8 of each 16 rows; the attention kernel's masks (its
    plain version here) hash the global bh (``bh_offset``), the hidden
    dropout the global index (``frame``), and TimeOut is drawn for the global
    batch: two steps equal the one-device steps on the same 16 rows."""
    cfg = VitConfig.from_defined('debug', max_signal_length=320, dropout_impl='hash',
                                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                                 flash_min_seq=0)
    tcfg = TrainConfig(train_batch_size=16, eval_batch_size=16, augment_timeout=True,
                       learning_rate=1e-3, log_to_console=False, save_final=False)
    data = _corpus()
    want_losses, want, _ = dp_steps(cfg, tcfg, data, None)
    out = ranks.run(dp_steps, cfg, tcfg, data, (2, 1))
    for losses, state, _ in out:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
        num = sum(float((state[k].double() - want[k].double()).square().sum()) for k in want)
        den = sum(float(want[k].double().square().sum()) for k in want)
        assert (num / den) ** 0.5 <= 1e-6
    # the dropout is on: without it the first loss differs
    plain, _, _ = dp_steps(dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                                               attention_probs_dropout_prob=0.0),
                           tcfg, data, None, 1)
    assert abs(plain[0] - want_losses[0]) > 1e-4


def test_flax_dropout_masks_come_from_a_generator_per_data_rank(ranks):
    cfg = VitConfig.from_defined('debug', max_signal_length=320, dropout_impl='flax',
                                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.0)
    tcfg = TrainConfig(train_batch_size=16, eval_batch_size=16, log_to_console=False,
                       save_final=False)
    out = ranks.run(dp_steps, cfg, tcfg, _corpus(), (2, 1), 1)
    assert not torch.equal(out[0][2], out[1][2])            # decorrelated masks
    assert all(np.isfinite(o[0][0]) for o in out) and out[0][0] == out[1][0]
