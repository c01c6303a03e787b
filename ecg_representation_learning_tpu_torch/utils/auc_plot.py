"""Per-code AUROC report plots (reference chore/plot.py:13-113; the JAX
package's ``utils/auc_plot.py``).

``PtbxlAucVisualizer.grouped_plot``: per-class AUROC bars grouped by the
PTB-XL taxonomy (diagnostic superclass rows NORM/HYP/MI/CD/STTC, then form
and rhythm rows); ``sorted_plot``: all codes sorted by AUROC with aspect +
description labels.  Taxonomy comes from the frozen registry instead of the
generated config.json.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..registry import (
    PTBXL_CODE2DESCRIPTION, PTBXL_DIAGNOSTIC_TAXONOMY, PTBXL_FORM_CODES,
    PTBXL_RHYTHM_CODES, ptbxl_code_aspects,
)
from .viz import barplot, save_fig, set_color_bar, vals2colors

_SUPERCLASS_DESC = {
    'NORM': 'normal ECG', 'HYP': 'hypertrophy', 'MI': 'myocardial infarction',
    'CD': 'conduction disturbance', 'STTC': 'ST/T changes',
}


class PtbxlAucVisualizer:
    def __init__(self, code2auc: Dict[str, float]):
        # percentages, one decimal, like the reference (plot.py:15)
        self.code2auc = {c: round(v * 100, 1) for c, v in code2auc.items()}

    def _auc(self, code: str) -> float:
        return self.code2auc.get(code, float('nan'))

    def grouped_plot(self, save: bool = True, title: Optional[str] = None,
                     color_by: str = 'class', color_palette: Optional[str] = None):
        """Taxonomy-proportional layout matching the reference's hand-tuned
        GridSpec (chore/plot.py:31-46): a 4x26 grid where NORM (1 code),
        HYP (5) and MI share row 0 with the score-mode colorbar in the first
        column, CD/STTC split row 1, and the form/rhythm rows are centered
        to their code counts.  ``color_by='score'`` colors bars by AUROC
        value and renders the colorbar axis; ``'class'`` colors consecutively
        by group (gap 4) and hides it."""
        import math

        import matplotlib.pyplot as plt
        import seaborn as sns
        from matplotlib.gridspec import GridSpec
        assert color_by in ('class', 'score')
        sup_order = ['NORM', 'HYP', 'MI', 'CD', 'STTC']
        diag_codes = {
            sup: [c for sub in PTBXL_DIAGNOSTIC_TAXONOMY[sup].values() for c in sub]
            for sup in sup_order}
        form_codes = list(PTBXL_FORM_CODES)
        rhythm_codes = list(PTBXL_RHYTHM_CODES)

        fig = plt.figure(figsize=(16, 12), constrained_layout=False)
        n_row, n_col = 4, 24 + 2
        gs = GridSpec(n_row, n_col, figure=fig)
        sep1, sep2 = 2, 2  # inter-axis gaps so tick labels don't collide
        ax_cbar = fig.add_subplot(gs[0, :1])
        axes_diag = {}
        # row 0: colorbar | NORM (1 code, widened) | HYP (5) | MI (rest)
        axes_diag['NORM'] = fig.add_subplot(gs[0, 1 + sep1:1 + sep1 + 2])
        hyp_start = (1 + sep1 + 2) + sep1
        axes_diag['HYP'] = fig.add_subplot(gs[0, hyp_start:hyp_start + 5])
        axes_diag['MI'] = fig.add_subplot(gs[0, hyp_start + 5 + sep1:])
        # row 1: CD | STTC
        axes_diag['CD'] = fig.add_subplot(gs[1, 0:11])
        axes_diag['STTC'] = fig.add_subplot(gs[1, 11 + sep2:])
        # rows 2/3: form and rhythm, centered to their code counts
        n_form, n_rhythm = len(form_codes), len(rhythm_codes)
        i_form = n_col // 2 - math.ceil((n_form + 1) / 2)
        i_rhythm = n_col // 2 - math.ceil((n_rhythm + 1) / 2)
        ax_form = fig.add_subplot(gs[2, i_form:i_form + n_form])
        ax_rhythm = fig.add_subplot(gs[3, i_rhythm:i_rhythm + n_rhythm])

        codes_all = [c for sup in sup_order for c in diag_codes[sup]]
        codes_all += form_codes + rhythm_codes
        aucs_all = [self._auc(c) for c in codes_all]
        if color_by == 'class':
            color_gap = 4  # consecutive group coloring with a gap
            cs = sns.color_palette(color_palette or 'husl',
                                   n_colors=len(codes_all) + color_gap * len(sup_order))
            ax_cbar.set_visible(False)
        else:
            pnm = color_palette or 'Spectral_r'
            color_gap, cs = 0, vals2colors(aucs_all, pnm)
            set_color_bar(aucs_all, ax_cbar, color_palette=pnm)

        groups = [(axes_diag[sup],
                   f'Diagnostic: {_SUPERCLASS_DESC[sup]} ({sup})',
                   diag_codes[sup]) for sup in sup_order]
        groups += [(ax_form, 'Form', form_codes),
                   (ax_rhythm, 'Rhythm', rhythm_codes)]
        count = 0
        for ax, desc, codes in groups:
            vals = [self._auc(c) for c in codes]
            cs_ = cs[count:count + len(codes)]
            count += len(codes) + color_gap
            barplot(x=[c.replace('/', '/\n') for c in codes], y=vals, ax=ax,
                    palette=list(cs_), width=0.375)
            ax.set_xlabel(desc, style='italic')
        # shared ylim over the DIAGNOSTIC axes (rounded to 10s, headroom for
        # the value labels above each bar -- chore/plot.py:81-85)
        finite = np.asarray([v for v in aucs_all if np.isfinite(v)])
        if finite.size:
            ma = min(round(float(finite.max()), -1) + 10 + 5, 105)
            mi = max(round(float(finite.min()), -1) - 10, 0)
            for ax in axes_diag.values():
                ax.set_ylim([mi, ma])
        fig.supylabel('Binary Classification AUROC (%)')
        fig.supxlabel('SCP code')
        title = title or 'PTB-XL per-code AUROC bar plot by group'
        fig.suptitle(title)
        fig.tight_layout()
        if save:
            return save_fig(title)
        plt.show()

    def sorted_plot(self, save: bool = True, title: Optional[str] = None):
        import matplotlib.pyplot as plt
        codes = sorted(self.code2auc, key=self.code2auc.get, reverse=True)

        def label(code: str) -> str:
            # aspects + capitalized description, matching the reference's
            # sorted-plot labels (chore/plot.py:101-113)
            aspects = ', '.join(a.capitalize() for a in ptbxl_code_aspects(code))
            desc = PTBXL_CODE2DESCRIPTION.get(code, code)
            return f'{aspects}: {code} - {desc.capitalize()}'

        plt.figure(figsize=(14, max(6, 0.2 * len(codes))))
        import seaborn as sns
        palette = sns.color_palette('mako_r', n_colors=len(codes))
        barplot(x=[label(c) for c in codes], y=[self.code2auc[c] for c in codes],
                palette=list(palette), orient='h', xlabel='SCP code',
                ylabel='AUROC (%)', ax=plt.gca())
        title = title or 'PTB-XL per-code AUROC sorted bar plot'
        plt.title(title)
        if save:
            return save_fig(title)
        plt.show()
