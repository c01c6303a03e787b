"""Convert a checkpoint of the JAX package (orbax) into one of the PyTorch port.

    python tools/orbax_to_port.py runs/x/ckpt-final converted/
    python -m ecg_representation_learning_tpu_torch.cli evaluate \\
        --checkpoint converted/ckpt-final ...

Reads the JAX checkpoint directory without a template (orbax's raw restore)
and its ``.meta.json`` sidecar (the epoch), and writes
``<out>/ckpt-<tag>/state.pt``, the port's checkpoint format
(``ecg_representation_learning_tpu_torch/train/checkpoint.py``), through
``models.port.train_state_from_flax``.  Every trainer's checkpoint converts:
the supervised ViT, the MAE and contrastive pretrainers (``cli train
--init-encoder`` takes the result), ``RingPretrainer`` and the GPipe pipeline
(written as the one-device ``scan_blocks`` file).

Carried: the parameters, the EMA when one was saved, Adam's count, mu and
nu (fused or optax-chain layout), the step and the epoch.  Not carried: the
random-generator state.  The two packages draw dropout, masks and
augmentations differently (JAX from a PRNG key, the port from torch
generators), so a trainer restoring a converted checkpoint keeps its own
generators, seeded from its config; training continues step for step only
where no randomness is drawn.

The script runs where JAX and orbax-checkpoint are installed (orbax pulls in
JAX); it imports nothing of the JAX package, and the port never imports
orbax.  Run as a script, it restores on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_jax_checkpoint(path: str):
    """(the raw restored tree as nested dicts of numpy arrays, the epoch from
    the ``.meta.json`` sidecar or 0)."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp
    path = os.path.abspath(path)
    tree = jax.tree.map(np.asarray, ocp.StandardCheckpointer().restore(path))
    meta = path + '.meta.json'
    epoch = 0
    if os.path.exists(meta):
        with open(meta) as f:
            epoch = int(json.load(f).get('epoch', 0))
    return tree, epoch


def convert(src: str, out_dir: str, tag: str | None = None) -> str:
    """Convert the JAX checkpoint ``src`` into ``out_dir/ckpt-<tag>``
    (default tag: ``src``'s own, ``ckpt-final`` -> ``final``); returns the
    written path."""
    from ecg_representation_learning_tpu_torch.models.port import train_state_from_flax
    from ecg_representation_learning_tpu_torch.train.checkpoint import save_checkpoint
    tree, epoch = read_jax_checkpoint(src)
    if tag is None:
        name = os.path.basename(os.path.abspath(src))
        tag = name[len('ckpt-'):] if name.startswith('ckpt-') else name
    return save_checkpoint(os.path.join(out_dir, f'ckpt-{tag}'),
                           train_state_from_flax(tree, epoch))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description='Convert a JAX-package orbax checkpoint into a port checkpoint '
                    '(<out>/ckpt-<tag>/state.pt). Carries the parameters, the EMA, '
                    "Adam's count/mu/nu, the step and the epoch. Does NOT carry the "
                    'random-generator state: the packages draw dropout and masks '
                    'differently, so the restoring trainer keeps its own generators.')
    p.add_argument('src', help='a JAX checkpoint directory (ckpt-*)')
    p.add_argument('out', help='directory to write ckpt-<tag> into')
    p.add_argument('--tag', default=None,
                   help="checkpoint tag (default: the source's, e.g. final)")
    args = p.parse_args(argv)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    print(json.dumps({'checkpoint': convert(args.src, args.out, args.tag)}))


if __name__ == '__main__':
    main()
