"""Host-side signal plotting (reference util/ecg.py:20-89 + util.py:490-551;
the JAX package's ``utils/viz.py``).

``plot_1d`` overlays 1-D traces; ``plot_ecg`` renders the standard stacked
12-lead layout in the clinical order I, II, III, avR, avL, avF, V1-V6
(reference ecg.py:69); ``barplot`` and ``set_color_bar`` are the small
matplotlib helpers the visualizers use.  Everything is matplotlib-on-host;
tensors (on any device) are converted on entry.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..registry import LEAD_NAMES


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_1d(arr, label: Union[str, List[str], None] = None, title: Optional[str] = None,
            save: Union[bool, str] = False, new_fig: bool = True, show: bool = True,
            e: Optional[int] = None, ax=None, plot_kwargs: Optional[dict] = None):
    """Overlay one or many 1-D signals (reference plot_1d, ecg.py:20-51).

    ``e``: plot only the first ``e`` samples.
    """
    import matplotlib.pyplot as plt
    arr = _np(arr)
    if arr.ndim == 1:
        arr = arr[None]
    labels = [label] * len(arr) if isinstance(label, str) or label is None else label
    kwargs = dict(lw=0.4, marker='o', ms=0.5)
    kwargs.update(plot_kwargs or {})
    if new_fig and ax is None:
        plt.figure(figsize=(16, 5))
    target = ax if ax is not None else plt
    for sig, lb in zip(arr, labels):
        sig = sig[:e] if e else sig
        target.plot(sig, label=lb, **kwargs)
    if any(lb for lb in labels):
        (ax or plt.gca()).legend()
    if title:
        (ax.set_title if ax else plt.title)(title)
    if save:
        save_fig(save if isinstance(save, str) else (title or 'plot-1d'))
    elif show and ax is None:
        plt.show()


def plot_ecg(arr, title: Optional[str] = None, xlabel: str = 'timestep',
             ylabel: str = 'V', legend: bool = True, save: Union[bool, str] = False,
             show: bool = True, ax=None, gap_factor: float = 1.0,
             lead_names: Sequence[str] = LEAD_NAMES):
    """Stacked 12-lead plot (reference plot_ecg, ecg.py:54-89): each lead
    offset vertically by ``gap_factor *`` the global amplitude range."""
    import matplotlib.pyplot as plt
    arr = _np(arr)
    assert arr.ndim == 2, arr.shape
    n_lead = arr.shape[0]
    height = np.nanmax(arr) - np.nanmin(arr)
    gap = height * gap_factor if height > 0 else 1.0
    own_fig = ax is None
    if own_fig:
        _, ax = plt.subplots(figsize=(16, 10))
    cmap = plt.get_cmap('tab20')
    for i in range(n_lead):
        offset = (n_lead - 1 - i) * gap
        name = lead_names[i] if i < len(lead_names) else f'lead {i}'
        ax.plot(arr[i] + offset, lw=0.5, color=cmap(i % 20), label=name)
        ax.axhline(offset, lw=0.2, color='gray', alpha=0.5)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_yticks([(n_lead - 1 - i) * gap for i in range(n_lead)])
    ax.set_yticklabels(list(lead_names[:n_lead]))
    if title:
        ax.set_title(title)
    if legend:
        ax.legend(loc='upper right', fontsize=7)
    if save:
        save_fig(save if isinstance(save, str) else (title or 'ecg-12-lead'))
    elif show and own_fig:
        plt.show()
    return ax


def plot_rpeak(sig, idx_rpeak, title: Optional[str] = None, save: Union[bool, str] = False,
               show: bool = True):
    """Signal with R-peak markers (reference plot_rpeak, ecg.py:127-144)."""
    import matplotlib.pyplot as plt
    sig = _np(sig)
    plt.figure(figsize=(16, 5))
    plt.plot(np.arange(sig.size), sig, marker='o', ms=0.3, lw=0.25,
             label='Signal', alpha=0.6)
    for i in idx_rpeak:
        plt.axvline(x=i, c='r', lw=0.5, label='R peak')
    handles, labels = plt.gca().get_legend_handles_labels()
    by_label = dict(zip(labels, handles))
    plt.legend(by_label.values(), by_label.keys())
    t = 'ECG R-peaks' + (f', {title}' if title else '')
    plt.title(t)
    if save:
        return save_fig(save if isinstance(save, str) else t)
    if show:
        plt.show()


def plot_resampling(x, y, x_new, y_new, title: Optional[str] = None, show: bool = True):
    """Original vs resampled signal overlay (reference plot_resampling, ecg.py:114-125)."""
    import matplotlib.pyplot as plt
    plt.figure(figsize=(16, 6))
    plt.plot(x, y, marker='o', ms=4, lw=2, label='Original', alpha=0.5)
    plt.plot(x_new, y_new, marker='x', ms=4, lw=1, label='Resampled')
    if title:
        plt.title(title)
    plt.legend()
    if show:
        plt.show()


def barplot(x, y, ax=None, palette=None, orient: str = 'v', width: float = 0.8,
            xlabel: Optional[str] = None, ylabel: Optional[str] = None,
            with_value: bool = True, title: Optional[str] = None):
    """Labelled bar plot (reference util.py:530-551)."""
    import matplotlib.pyplot as plt
    own_fig = ax is None
    if own_fig:
        _, ax = plt.subplots()
    y = _np(y)
    if orient == 'h':
        bars = ax.barh(list(x)[::-1], y[::-1], height=width,
                       color=(palette[::-1] if palette else None))
        if with_value:
            for b, v in zip(bars, y[::-1]):
                ax.text(b.get_width(), b.get_y() + b.get_height() / 2,
                        f' {v:.3g}', va='center', fontsize=7)
    else:
        bars = ax.bar(list(x), y, width=width, color=palette)
        if with_value:
            for b, v in zip(bars, y):
                ax.text(b.get_x() + b.get_width() / 2, b.get_height(),
                        f'{v:.3g}', ha='center', fontsize=7)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    return ax


def vals2colors(vals, palette: str = 'mako'):
    """Map values to colors through a seaborn palette (util.py helpers)."""
    import seaborn as sns
    vals = _np(vals).astype(float)
    lo, hi = np.nanmin(vals), np.nanmax(vals)
    norm = (vals - lo) / (hi - lo + 1e-12)
    cmap = sns.color_palette(palette, as_cmap=True)
    return [cmap(v) for v in norm]


def set_color_bar(vals, ax, color_palette: str = 'Blues', orientation: str = 'vertical'):
    """Attach a colorbar scaled to ``vals`` (reference util.py:506-527)."""
    import matplotlib as mpl
    import matplotlib.pyplot as plt
    import seaborn as sns
    vals = _np(vals).astype(float)
    norm = mpl.colors.Normalize(vmin=float(np.nanmin(vals)), vmax=float(np.nanmax(vals)))
    cmap = sns.color_palette(color_palette, as_cmap=True)
    mappable = mpl.cm.ScalarMappable(norm=norm, cmap=cmap)
    plt.colorbar(mappable, cax=ax, orientation=orientation)


def save_fig(title: str, out_dir: str = 'plots'):
    import matplotlib.pyplot as plt
    os.makedirs(out_dir, exist_ok=True)
    safe = ''.join(c if c.isalnum() or c in ' -_,.=' else '_' for c in title)
    path = os.path.join(out_dir, f'{safe}.png')
    plt.savefig(path, dpi=200, bbox_inches='tight')
    return path
