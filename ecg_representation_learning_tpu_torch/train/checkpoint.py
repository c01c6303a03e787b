"""Checkpoints of the full train state as torch files.

Counterpart of the JAX package's ``train/checkpoint.py`` (orbax there): a
checkpoint is a directory ``ckpt-<tag>/`` holding ``state.pt``, a dict of
the parameters, the optimizer state (count, mu, nu), the step, the states of
the trainer's generators, the parameter EMA when it is tracked, and the
epoch -- everything an exact resume needs.  A save writes into a
``<path>.tmp-<pid>`` sibling and renames it on completion, so a directory
under the final name is always a committed checkpoint; a save killed midway
leaves only a tmp directory, which the listings skip.  Importing orbax
checkpoints of the JAX package is not ported.
"""
from __future__ import annotations

import glob
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = 'state.pt'


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, state: Dict[str, Any]) -> str:
    """Write ``state`` (its tensors copied to the host) as the checkpoint
    directory ``path``, replacing one already there.  Returns the absolute
    path."""
    path = os.path.abspath(path)
    tmp = f'{path}.tmp-{os.getpid()}'
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_to_cpu(state), os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The state dict saved at ``path``, with its tensors on the host."""
    file = os.path.join(os.path.abspath(path), STATE_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f'no committed checkpoint at {path} (missing {STATE_FILE})')
    return torch.load(file, map_location='cpu', weights_only=True)


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
    """Newest committed ``ckpt-*`` directory (the crash-recovery target)."""
    cands = committed_checkpoints(output_dir)
    return cands[-1] if cands else None
