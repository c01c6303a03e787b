"""Attention-rollout visualization for the 1-D ViT (the JAX package's
``utils/rollout.py``).

Reference ``EcgVitVisualizer`` (models/ecg_vit.py:164-265): capture per-layer
attention, average heads, add identity (residual), row-normalize, multiply up
the layers, take cls->patch scores, and render patch-aligned shading over the
12-lead plot with ground-truth/prediction bar charts.

The attention maps come from the model's ``return_attention`` forward
(``models/vit.py`` returns the stacked (L, B, H, T, T) probabilities), the
rollout math is the JAX package's numpy pass, and the rendering is host-side
matplotlib.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..registry import PTBXL_CODE2ID, PTBXL_ID2CODE
from .viz import barplot, plot_ecg, save_fig, set_color_bar


def attention_rollout(attn: np.ndarray) -> np.ndarray:
    """(L, H, T, T) or (L, B, H, T, T) -> (L, T-1) cls->patch rollout scores.

    Exact reference math (ecg_vit.py:184-194): mean over heads, += I,
    row-normalize, cumulative layer matmul ``A_l @ A_{l-1}``, then the cls row
    minus the cls column, normalized to [0, 1].
    """
    attn = np.asarray(attn)
    if attn.ndim == 5:
        assert attn.shape[1] == 1, 'pass a single sample'
        attn = attn[:, 0]
    L, H, T, _ = attn.shape
    a = attn.mean(axis=1)                      # (L, T, T)
    a = a + np.eye(T)[None]
    a = a / a.sum(axis=-1, keepdims=True)
    roll = np.empty_like(a)
    roll[0] = a[0]
    for i in range(1, L):
        roll[i] = a[i] @ a[i - 1]
    scores = roll[:, 0, 1:]                    # cls -> patch tokens per layer
    scores = scores / max(float(scores.max()), 1e-12)
    assert ((0 <= scores) & (scores <= 1)).all()
    return scores


def top_predictions(probs: np.ndarray, labels: np.ndarray,
                    threshold: float = 0.6, max_n: int = 5
                    ) -> Tuple[List[str], List[float], List[bool]]:
    """Reference prediction-selection logic (ecg_vit.py:197-211): up to 5
    predictions above 0.6, plus every ground-truth code not already shown."""
    probs = np.asarray(probs)
    top_n = min(int((probs > threshold).sum()), max_n)
    idxs_top = np.argsort(-probs)[:top_n]
    str_lbs = [PTBXL_ID2CODE[i] for i in np.nonzero(labels)[0]]
    str_preds = [PTBXL_ID2CODE[i] for i in idxs_top]
    confs = [float(probs[i]) for i in idxs_top]
    correct = [p in str_lbs for p in str_preds]
    for lb in str_lbs:
        if lb not in str_preds:
            str_preds.append(lb)
            confs.append(float(probs[PTBXL_CODE2ID[lb]]))
            correct.append(False)
    return str_preds, confs, correct


class EcgVitVisualizer:
    """Render rollout shading + prediction/label bars for one sample.
    ``model`` is an ``EcgVit`` holding the weights to show (the served ones:
    ``cli visualize`` loads the EMA when tracked); the forward runs on the
    model's device."""

    def __init__(self, model, palette_correct: str = 'YlGn',
                 palette_incorrect: str = 'OrRd'):
        self.model = model
        self.palette_correct, self.palette_incorrect = palette_correct, palette_incorrect

    def __call__(self, sample_values, labels, save: bool = False,
                 layer: Optional[int] = None):
        import matplotlib.pyplot as plt
        import matplotlib.patches as patches
        import seaborn as sns
        import torch
        from matplotlib.gridspec import GridSpec

        sig = np.asarray(sample_values)
        labels = np.asarray(labels)
        assert sig.ndim == 2 and sig.shape[0] == 12, sig.shape
        patch_size = self.model.cfg.patch_size
        L = sig.shape[-1]
        assert L % patch_size == 0, (L, patch_size)

        dev = next(self.model.parameters()).device
        self.model.eval()
        with torch.no_grad():
            out = self.model(torch.as_tensor(sig[None], dtype=torch.float32, device=dev),
                             labels=torch.as_tensor(labels[None], device=dev),
                             return_attention=True)
        loss = float(out.loss)
        probs = 1 / (1 + np.exp(-out.logits[0].double().cpu().numpy()))
        scores = attention_rollout(out.attention.float().cpu().numpy())
        i_layer = (self.model.cfg.num_hidden_layers - 1) if layer is None else layer

        str_preds, confs, correct = top_predictions(probs, labels)
        str_lbs = [PTBXL_ID2CODE[i] for i in np.nonzero(labels)[0]]

        fig = plt.figure(figsize=(16, 8))
        n_lb, n_pd = max(len(str_lbs), 1), max(len(str_preds), 1)
        gs = GridSpec(2 * (n_lb + n_pd) + 5, 40, figure=fig)
        ax_lb = fig.add_subplot(gs[:n_lb, :6])
        ax_pd = fig.add_subplot(gs[n_lb + 1:n_lb + 1 + n_pd, :6])
        idx_bar = n_lb + 1 + n_pd + 1
        ax_cb_c = fig.add_subplot(gs[idx_bar:idx_bar + 1, :6])
        ax_cb_i = fig.add_subplot(gs[idx_bar + 2:idx_bar + 3, :6])
        ax_sig = fig.add_subplot(gs[:, 7:])

        plt.figtext(0.1, 0.96, f'loss = {loss:.3f}')
        cmap_c = sns.color_palette(self.palette_correct, as_cmap=True)
        cmap_i = sns.color_palette(self.palette_incorrect, as_cmap=True)
        if str_lbs:
            barplot(x=str_lbs, y=[100] * len(str_lbs), ax=ax_lb,
                    palette=[cmap_c(1.0)] * len(str_lbs), orient='h',
                    xlabel='Ground truths', with_value=False)
        if str_preds:
            cs = [(cmap_c(cf) if ok else cmap_i(cf))
                  for cf, ok in zip(confs, correct)]
            barplot(x=str_preds, y=[round(c * 100, 1) for c in confs], ax=ax_pd,
                    palette=cs, orient='h', xlabel='Predictions', ylabel='Confidence')
        vals = [round(c * 100, 1) for c in confs] + [100]
        set_color_bar(vals, ax=ax_cb_c, color_palette=self.palette_correct,
                      orientation='horizontal')
        set_color_bar(vals, ax=ax_cb_i, color_palette=self.palette_incorrect,
                      orientation='horizontal')

        plot_ecg(sig, xlabel='timestep', ylabel='V', title='Input signal',
                 legend=False, ax=ax_sig, gap_factor=1.5, show=False)
        mi, ma = ax_sig.get_ylim()
        cmap = sns.color_palette('Blues_r', as_cmap=True)
        for i_pch in range(L // patch_size):
            score = float(scores[i_layer, i_pch])
            start = i_pch * patch_size
            rect = patches.Rectangle(xy=(start, mi), width=patch_size,
                                     height=ma - mi, facecolor=cmap(score),
                                     alpha=score)
            ax_sig.add_patch(rect)
            if start:
                ax_sig.axvline(x=start, lw=0.2, c=cmap(1))
        title = f'[CLS] <= Patch token Attention Map at layer {i_layer + 1}'
        plt.suptitle(title)
        if save:
            return save_fig(title)
        plt.show()
