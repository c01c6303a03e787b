"""Process-group set-up (the JAX package's ``parallel/distributed.py``).

JAX runs one controller per host and ``jax.distributed.initialize`` wires the
hosts together; the port runs one process per device (``torchrun``) and
``initialize_distributed`` makes the default ``torch.distributed`` process
group from the variables ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``): NCCL when the
process owns a CUDA device, gloo on the CPU, never one in place of the
other.  A single process needs no group and gets none.

``spawn_ranks`` starts N CPU ranks on this host (``cli --platform cpu
--host-devices N``, ``tools/dryrun_multichip.py``); ``LocalRanks`` keeps N
ranks alive and runs functions on all of them (the tests).  Both
rendezvous through a ``FileStore`` in a fresh temporary directory, never a
TCP port, so runs side by side cannot collide.
"""
from __future__ import annotations

import io
import multiprocessing
import os
import shutil
import tempfile
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def local_device(backend: Optional[str] = None) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (modulo the visible
    devices) under NCCL, else the CPU."""
    backend = backend or (dist.get_backend() if dist.is_initialized() else None)
    if backend == 'nccl':
        return torch.device('cuda', (_int_env('LOCAL_RANK') or 0) % torch.cuda.device_count())
    return torch.device('cpu')


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Optional[str] = None) -> dict:
    """Join the process group when launched as one of several processes.

    The arguments default to ``torchrun``'s variables: ``coordinator_address``
    ``host:port`` to ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` to
    ``WORLD_SIZE``, ``process_id`` to ``RANK``.  ``device`` 'cuda' (the
    default when a GPU is visible) takes NCCL and ``cuda:LOCAL_RANK``; 'cpu'
    takes gloo.  No-op for one process and when the group exists already.
    Returns the JAX summary ``{process_id, num_processes, local_devices,
    devices}``: one device per process, so ``local_devices`` is 1."""
    num_processes = num_processes or _int_env('WORLD_SIZE') or 1
    process_id = process_id if process_id is not None else (_int_env('RANK') or 0)
    if num_processes > 1 and not dist.is_initialized():
        want = device or ('cuda' if torch.cuda.is_available() else 'cpu')
        if want == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('initialize_distributed(device="cuda") but no GPU is visible')
        backend = 'nccl' if want == 'cuda' else 'gloo'
        if backend == 'nccl':
            torch.cuda.set_device(local_device('nccl'))
        addr = coordinator_address or '{}:{}'.format(os.environ.get('MASTER_ADDR', 'localhost'),
                                                     os.environ.get('MASTER_PORT', '29500'))
        dist.init_process_group(backend, init_method=f'tcp://{addr}',
                                world_size=num_processes, rank=process_id)
    if dist.is_initialized():
        return {'process_id': dist.get_rank(), 'num_processes': dist.get_world_size(),
                'local_devices': 1, 'devices': dist.get_world_size()}
    return {'process_id': 0, 'num_processes': 1, 'local_devices': 1, 'devices': 1}


def process_local_batch_slice(global_batch: int, mesh=None) -> slice:
    """The slice of a global batch this process feeds: contiguous, by process
    index (by the index on the mesh's 'data' axis when ``mesh`` is given, so
    the ranks of one model group take the same rows)."""
    if mesh is not None:
        count, index = mesh.shape['data'], mesh.index('data')
    elif dist.is_initialized():
        count, index = dist.get_world_size(), dist.get_rank()
    else:
        count, index = 1, 0
    per = global_batch // count
    return slice(per * index, per * index + per)


def init_local_group(rank: int, world: int, store_dir: str, backend: str = 'gloo') -> None:
    """Join a group of ``world`` processes on this host through a
    ``FileStore`` under ``store_dir`` (made by the launcher)."""
    store = dist.FileStore(os.path.join(store_dir, 'store'), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)


def _pack(value) -> bytes:
    """A rank's result as bytes (tensors by value: the rank may exit before
    the parent reads them)."""
    buf = io.BytesIO()
    torch.save(value, buf)
    return buf.getvalue()


def _unpack(data: bytes):
    return torch.load(io.BytesIO(data), weights_only=False)


def _rank_main(rank: int, world: int, store_dir: str, fn: Callable, args, queue) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    init_local_group(rank, world, store_dir)
    try:
        queue.put((rank, True, _pack(fn(*args))))
    except BaseException:   # handed to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# seconds ``spawn_ranks`` waits for the other ranks once one has failed
SPAWN_GRACE_S = 30.0


def spawn_ranks(n: int, fn: Callable, *args, timeout: float = 1200.0) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` gloo CPU ranks (new processes, one thread
    each) and return the results by rank; raise if a rank failed.  ``fn``
    must be importable by name (a module-level function).  A rank that
    fails, or exits without a result (a crash), ends the run
    ``SPAWN_GRACE_S`` seconds later: the ranks still waiting for it in a
    collective are killed and the error names every rank that gave no
    result; so does a run longer than ``timeout`` seconds."""
    import queue as queue_mod
    import time
    ctx = multiprocessing.get_context('spawn')
    results_q = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix='ecg-ranks-')
    procs = [ctx.Process(target=_rank_main, args=(r, n, store_dir, fn, args, results_q))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        results: List[Any] = [None] * n
        errors, done = [], set()
        deadline = time.monotonic() + timeout
        while len(done) < n and time.monotonic() < deadline:
            try:
                rank, ok, value = results_q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead and not errors:
                    errors.append(f'rank(s) {dead} exited with codes '
                                  f'{[procs[r].exitcode for r in dead]} and no result')
                    deadline = min(deadline, time.monotonic() + SPAWN_GRACE_S)
                continue
            done.add(rank)
            if ok:
                results[rank] = _unpack(value)
            else:
                errors.append(f'rank {rank}:\n{value}')
                deadline = min(deadline, time.monotonic() + SPAWN_GRACE_S)
        missing = sorted(set(range(n)) - done)
        if missing:
            errors.append(f'rank(s) {missing} gave no result')
        if errors:
            raise RuntimeError('a rank failed:\n' + '\n'.join(errors))
        for p in procs:
            p.join(timeout)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(store_dir, ignore_errors=True)


def _worker_loop(rank: int, world: int, store_dir: str, tasks, results) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    init_local_group(rank, world, store_dir)
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            fn, args = task
            try:
                results.put((rank, True, _pack(fn(*args))))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class LocalRanks:
    """``n`` gloo CPU ranks kept alive between calls: ``run(fn, *args)`` runs
    ``fn(*args)`` on every rank and returns the results by rank.  When a rank
    fails, the others may wait in a collective for it: ``run`` then raises
    with the failed ranks' tracebacks, after ``grace`` seconds for the rest,
    and starts a fresh group for the next call."""

    def __init__(self, n: int, grace: float = 10.0):
        self.n, self.grace = n, grace
        self._start()

    def _start(self) -> None:
        ctx = multiprocessing.get_context('spawn')
        self._store_dir = tempfile.mkdtemp(prefix='ecg-ranks-')
        self._tasks = [ctx.SimpleQueue() for _ in range(self.n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_worker_loop,
                                   args=(r, self.n, self._store_dir, self._tasks[r],
                                         self._results), daemon=True)
                       for r in range(self.n)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, timeout: float = 600.0) -> List[Any]:
        import queue as queue_mod
        for q in self._tasks:
            q.put((fn, args))
        out: List[Any] = [None] * self.n
        errors, done = [], 0
        while done < self.n:
            try:
                rank, ok, value = self._results.get(timeout=self.grace if errors else timeout)
            except queue_mod.Empty:
                break
            done += 1
            if ok:
                out[rank] = _unpack(value)
            else:
                errors.append(f'rank {rank}:\n{value}')
        if done < self.n:          # ranks left waiting: start over
            self._stop(kill=True)
            self._start()
            errors.append(f'{self.n - done} rank(s) gave no result')
        if errors:
            raise RuntimeError('a rank failed:\n' + '\n'.join(errors))
        return out

    def _stop(self, kill: bool = False) -> None:
        if not kill:
            for q in self._tasks:
                q.put(None)
        for p in self._procs:
            if kill:
                p.kill()
            p.join(30)
            if p.is_alive():
                p.kill()
        shutil.rmtree(self._store_dir, ignore_errors=True)

    def close(self) -> None:
        self._stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
