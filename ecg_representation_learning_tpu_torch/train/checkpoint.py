"""Checkpoints of the full train state as torch files.

Counterpart of the JAX package's ``train/checkpoint.py`` (orbax there): a
checkpoint is a directory ``ckpt-<tag>/`` holding ``state.pt``, a dict of
the parameters, the optimizer state (count, mu, nu), the step, the states of
the trainer's generators, the parameter EMA when it is tracked, and the
epoch -- everything an exact resume needs.  A save writes into a
``<path>.tmp-<pid>`` sibling and renames it on completion, so a directory
under the final name is always a committed checkpoint; a save killed midway
leaves only a tmp directory, which the listings skip.  The files need no
template to be read, so ``pretrain_params`` hands a pretrain checkpoint's
parameters to the SSL -> supervised handoff (train/contrastive.py) whatever
its decoder or projection head.  ``prune_checkpoints`` keeps the newest
step-tagged checkpoints of a streaming run.  Importing orbax checkpoints of
the JAX package is not ported.

``save_checkpoint(..., async_save=True)`` (``TrainConfig.async_checkpoint``)
copies the state to host memory on the caller's thread and returns; a
writer thread then writes and renames it.  One save is in flight at a time:
every save first waits for the one before.  ``wait_for_checkpoints`` blocks
until it has committed, and ``restore_checkpoint`` and
``latest_committed_checkpoint`` wait for it first.  A write that fails on the
thread raises at the next save or wait.

On a mesh the file is the same: every rank takes part in gathering the full
state (``TrainerBase.save_checkpoint``, ``parallel.mesh.ShardedModel.full_state``,
on the main thread of each rank), rank 0 writes it (on its writer thread
with ``async_save``), and the ranks meet at a barrier; a restore reads the
file on every rank and cuts it to the rank's shards, onto any mesh or one
device.
"""
from __future__ import annotations

import glob
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional

import torch

STATE_FILE = 'state.pt'


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _write(path: str, host_state: Dict[str, Any]) -> None:
    tmp = f'{path}.tmp-{os.getpid()}'
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(host_state, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


class _Writer:
    """The process's one checkpoint writer thread and its last error."""

    def __init__(self):
        self.lock = threading.Lock()
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def _run(self, path: str, host_state: Dict[str, Any]) -> None:
        try:
            _write(path, host_state)
        except Exception as e:   # handed to the caller at the next save or wait
            self.error = e

    def start(self, path: str, host_state: Dict[str, Any]) -> None:
        with self.lock:
            self.thread = threading.Thread(target=self._run, args=(path, host_state),
                                           name=f'checkpoint {os.path.basename(path)}')
            self.thread.start()

    def wait(self) -> None:
        with self.lock:
            thread, self.thread = self.thread, None
        if thread is not None:
            thread.join()
        error, self.error = self.error, None
        if error is not None:
            raise RuntimeError(f'a checkpoint write failed on the writer thread: '
                               f'{error!r}') from error


_WRITER = _Writer()


def wait_for_checkpoints() -> None:
    """Block until the save in flight (if any) has committed; raise if its
    write failed."""
    _WRITER.wait()


def save_checkpoint(path: str, state: Dict[str, Any], async_save: bool = False) -> str:
    """Write ``state`` (its tensors copied to the host) as the checkpoint
    directory ``path``, replacing one already there.  ``async_save``: copy
    to the host here, write on the writer thread, return at once.  Returns
    the absolute path."""
    path = os.path.abspath(path)
    wait_for_checkpoints()
    host_state = _to_cpu(state)
    if async_save:
        _WRITER.start(path, host_state)
    else:
        _write(path, host_state)
    return path


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The state dict saved at ``path``, with its tensors on the host (after
    the save in flight, if any, has committed)."""
    wait_for_checkpoints()
    file = os.path.join(os.path.abspath(path), STATE_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f'no committed checkpoint at {path} (missing {STATE_FILE})')
    return torch.load(file, map_location='cpu', weights_only=True)


def pretrain_params(path: str) -> Dict[str, torch.Tensor]:
    """A pretrain checkpoint's parameters, read without a template: its EMA
    when one was saved (the smoothing exists to be transferred), else the
    raw parameters."""
    raw = restore_checkpoint(path)
    return raw.get('ema_params') or raw['params']


def check_params(params: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor],
                 what: str) -> None:
    """Raise ``ValueError`` unless ``params`` has exactly ``want``'s names
    and shapes."""
    bad = sorted(set(params) ^ set(want))
    bad += sorted(k for k in set(params) & set(want)
                  if tuple(params[k].shape) != tuple(want[k].shape))
    if bad:
        raise ValueError(f'{what} does not match this model (wrong model size?): '
                         f'{len(bad)} names or shapes differ, e.g. {bad[:4]}')


def committed_checkpoints(output_dir: str) -> List[str]:
    """Committed ``ckpt-*`` directories under ``output_dir``, oldest first:
    ``ckpt-step{N}`` names by step, everything else by mtime.  tmp
    directories of an unfinished save are skipped."""
    out = []
    for p in glob.glob(os.path.join(output_dir, 'ckpt-*')):
        base = os.path.basename(p)
        if '.tmp-' in base or not os.path.isfile(os.path.join(p, STATE_FILE)):
            continue
        m = re.match(r'ckpt-step(\d+)$', base)
        out.append((int(m.group(1)) if m else -1, os.path.getmtime(p), p))
    return [p for _, _, p in sorted(out)]


def latest_committed_checkpoint(output_dir: str) -> Optional[str]:
    """Newest committed ``ckpt-*`` directory (the crash-recovery target),
    after the save in flight, if any, has committed."""
    wait_for_checkpoints()
    cands = committed_checkpoints(output_dir)
    return cands[-1] if cands else None


def prune_checkpoints(output_dir: str, keep: int = 2) -> None:
    """Drop all but the newest ``keep`` committed step-tagged checkpoints.
    Only ``ckpt-step{N}`` names are pruned (best/final/epoch tags are
    user-facing artifacts); a save in flight is tmp-named, hence never a
    deletion target."""
    steps = [p for p in committed_checkpoints(output_dir)
             if re.match(r'ckpt-step\d+$', os.path.basename(p))]
    for p in steps[:-keep] if keep else steps:
        shutil.rmtree(p, ignore_errors=True)
