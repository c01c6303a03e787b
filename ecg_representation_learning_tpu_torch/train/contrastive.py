"""Contrastive (NT-Xent) pretraining and the SSL -> supervised handoff (the
JAX ``train/contrastive.py``).

``ContrastiveTrainer``: two stochastic views of each record
(``ops/augment.contrastive_view``, drawn from the trainer's device
generator), each normalized, padded and cropped, laid out [views_a;
views_b] and run through the shared ``EcgVitEncoder`` trunk in one forward;
NT-Xent contrasts each anchor against the whole batch.  The loop mechanics
are ``MaeTrainer``'s, its streaming pair too (``build_stream_step`` runs
the views on the decoded batch at its native rate, each through the fused
preprocess); the model, the step and the eval protocol differ.

On a mesh NT-Xent keeps the global batch's negatives: the projections are
all-gathered over 'data' with their gradient
(``torch.distributed.nn.functional.all_gather``) and laid out as one device
lays them out, so every rank computes the one-device loss of the global
batch; the views are drawn for the global batch (``ops.augment.view_draws``)
and each rank keeps its rows.

The handoff: ``load_any_encoder`` reads a pretrain checkpoint of either
kind (its EMA when one was saved), tells the kind from the top-level names
of its parameters (``_detect_kind``), and copies the trunk into an
``EcgVit`` state_dict (``transfer_contrastive_encoder`` or
``pretrain.transfer_encoder``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..configs import ContrastiveConfig, MaeConfig, TrainConfig, VitConfig
from ..models.contrastive import EcgContrastive, nt_xent
from ..ops.augment import contrastive_view, view_draws
from ..parallel import spmd
from .checkpoint import check_params, pretrain_params
from .pretrain import MaeTrainer, transfer_encoder
from .trainer import SplitData, eval_mode


class ContrastiveTrainer(MaeTrainer):
    """SimCLR-style pretrainer over the shared ViT trunk."""

    default_dir = 'contrastive'
    log_name = 'EcgContrastive'

    def __init__(self, model_cfg: VitConfig, con_cfg: ContrastiveConfig,
                 train_cfg: TrainConfig, train_data: Optional[SplitData] = None,
                 eval_data: Optional[SplitData] = None, norm_stats=None,
                 output_dir: Optional[str] = None, device=None, mesh=None):
        self.con_cfg = con_cfg
        super().__init__(model_cfg, MaeConfig(), train_cfg, train_data=train_data,
                         eval_data=eval_data, norm_stats=norm_stats,
                         output_dir=output_dir, device=device, mesh=mesh)
        accum = max(1, train_cfg.grad_accum)
        if accum > 1:
            # NT-Xent is a whole-batch objective: under accumulation each
            # microbatch contrasts only against itself
            self.logger.warning(
                'grad_accum=%d on ContrastiveTrainer: NT-Xent negatives are '
                'MICROBATCH-local (%d samples, not %d) -- the objective '
                'weakens with accum. Prefer a data-parallel batch over '
                'accumulation.', accum, train_cfg.train_batch_size // accum,
                train_cfg.train_batch_size)

    def _build_model(self, model_cfg: VitConfig, mae_cfg: MaeConfig) -> torch.nn.Module:
        return EcgContrastive(model_cfg, self.con_cfg)

    def _views(self, sig: torch.Tensor, generator: torch.Generator,
               draws=(None, None), prep=None) -> torch.Tensor:
        """Two views of a raw (B, C, L) batch -> model inputs (``prep``,
        default ``_model_input``: normalized, padded, cropped) laid out
        [views_a; views_b] (row i pairs with row i + B).  ``draws`` may give
        each view's draws (see ``contrastive_view``)."""
        cc = self.con_cfg
        prep = prep or self._model_input
        if draws == (None, None) and spmd.data_index()[1] > 1:
            knobs = dict(scale_lo=cc.scale_lo, scale_hi=cc.scale_hi,
                         jitter_sigma=cc.jitter_sigma, lead_dropout=cc.lead_dropout,
                         shift_frac=cc.shift_frac, timeout_hi=cc.timeout_hi)
            draws = tuple(spmd.global_draw(sig.shape[0], lambda n: view_draws(
                (n, *sig.shape[1:]), **knobs, generator=generator, device=sig.device))
                for _ in range(2))
        views = [prep(contrastive_view(
            sig.float(), scale_lo=cc.scale_lo, scale_hi=cc.scale_hi,
            jitter_sigma=cc.jitter_sigma, lead_dropout=cc.lead_dropout,
            shift_frac=cc.shift_frac, timeout_hi=cc.timeout_hi,
            generator=generator, draws=d)) for d in draws]
        return torch.cat(views, dim=0)

    def _micro_loss(self, sig: torch.Tensor, prep=None):
        """The NT-Xent of two views of ``sig``, each through ``prep`` (plus
        the weighted MoE aux loss for a MoE trunk; the metrics keep the
        NT-Xent).  As
        the stream step (``build_stream_step``, inherited): two views of the
        decoded batch at its native rate, each through the fused preprocess
        (JAX ``train/contrastive.py:213-268``)."""
        z, aux = self._net(self._views(sig, self.rng.device, prep=prep), rng=self.rng,
                           return_aux=True)
        loss, acc = nt_xent(_global_pairs(z, spmd.all_gather_data(z)),
                            self.con_cfg.temperature, with_accuracy=True)
        return {'loss': loss.detach(), 'contrast_acc': acc}, self._objective(loss, aux)

    @eval_mode
    def eval_batch(self, sig: torch.Tensor, generator: torch.Generator):
        """(NT-Xent loss, top-1 accuracy) of one raw batch on the served
        weights, with views from ``generator``."""
        with self._spmd():
            views = self._views(sig, generator)
        z = self._eval_forward(views)
        with self._spmd():
            z = _global_pairs(z, [spmd.gather_rows(z[None])[i]
                                  for i in range(spmd.data_index()[1])])
        return nt_xent(z, self.con_cfg.temperature, with_accuracy=True)

    def evaluate(self, data: Optional[SplitData] = None, seed: int = 0) -> float:
        """Held-out NT-Xent loss with a fixed view generator (seeded with
        ``seed``) and full batches only: the loss is a property of the whole
        batch, so a ragged tail is dropped rather than padded with duplicate
        rows (false negatives).  A split smaller than the eval batch size is
        one smaller batch."""
        data = data if data is not None else self.eval_data
        if data is None or len(data) == 0:
            raise ValueError('no eval data')
        if not self.initialized:
            self.init_state()
        bsz = min(self.cfg.eval_batch_size, len(data))
        if bsz < 4:
            raise ValueError(f'contrastive eval needs a batch of >= 4 for a meaningful '
                             f'negative pool (got {bsz} = min(eval_batch_size='
                             f'{self.cfg.eval_batch_size}, split rows {len(data)}))')
        gen = torch.Generator(device=self.device).manual_seed(seed)
        losses = []
        if bsz % (1 if self.mesh is None else self.mesh.shape['data']):
            raise ValueError(f'contrastive eval batch {bsz} does not split over the '
                             f'{self.mesh.shape["data"]} data ranks')
        for i in range(0, len(data) - bsz + 1, bsz):
            sigs, idx = self._sig_inputs(data, self._local_take(np.arange(i, i + bsz)))
            loss, _ = self.eval_batch(sigs.index_select(0, idx), gen)
            losses.append(float(loss))
        return float(np.mean(losses))


def _global_pairs(z: torch.Tensor, parts) -> torch.Tensor:
    """The data ranks' projections ``parts`` (each [views_a; views_b] of its
    rows, ``z`` this rank's) laid out as one device lays out the global
    batch: [all views_a; all views_b]."""
    if len(parts) == 1:
        return z
    b = z.shape[0] // 2
    return torch.cat([p[:b] for p in parts] + [p[b:] for p in parts])


# ---------------------------------------------------------------------------
# Encoder transfer
# ---------------------------------------------------------------------------
def transfer_contrastive_encoder(con_params: Mapping[str, torch.Tensor],
                                 vit_params: Mapping[str, torch.Tensor]
                                 ) -> Dict[str, torch.Tensor]:
    """The ``EcgVit`` state_dict ``vit_params`` with the contrastive trunk
    copied in as it is (both models name it ``encoder``); the head keeps its
    init and the projection MLP is dropped.  The trunk's names and shapes are
    checked first, so a wrong-size checkpoint fails here."""
    trunk = {k: v for k, v in con_params.items() if k.startswith('encoder.')}
    check_params(trunk, {k: v for k, v in vit_params.items() if k.startswith('encoder.')},
                 'contrastive encoder')
    out = {k: v.detach().clone() for k, v in vit_params.items()}
    for k, v in trunk.items():
        out[k] = v.detach().clone().to(out[k].device)
    return out


def _detect_kind(names, path: str) -> str:
    if 'encoder' in names and 'proj_fc1' in names:
        return 'contrastive'
    if any(n.startswith('encoder_') for n in names):
        return 'mae'
    raise ValueError(f'checkpoint {path} is neither an MAE nor a contrastive pretrain '
                     f'checkpoint (param groups: {sorted(names)[:6]}...)')


def _top_names(params: Mapping[str, torch.Tensor]):
    return {k.split('.')[0] for k in params}


def detect_encoder_kind(path: str) -> str:
    """'mae' | 'contrastive' from a checkpoint's parameter names: the MAE
    trunk is flat (``encoder_patch_embed``, ``encoder_blocks``, ...), the
    contrastive one sits under ``encoder`` beside the projection head."""
    return _detect_kind(_top_names(pretrain_params(path)), path)


def load_contrastive_encoder(path: str) -> Dict[str, torch.Tensor]:
    """A contrastive checkpoint's parameters (``cli pretrain --objective
    contrastive`` output), for :func:`transfer_contrastive_encoder`."""
    return pretrain_params(path)


def load_any_encoder(path: str, vit_params: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The SSL -> supervised handoff: ``vit_params`` (an ``EcgVit``
    state_dict) with the trunk of the pretrain checkpoint at ``path`` (MAE or
    contrastive, detected) copied in."""
    saved = pretrain_params(path)
    if _detect_kind(_top_names(saved), path) == 'contrastive':
        return transfer_contrastive_encoder(saved, vit_params)
    return transfer_encoder(saved, vit_params)
