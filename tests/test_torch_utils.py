"""The port's utilities (utils/misc.py, utils/ecg_domain.py, utils/viz.py,
utils/auc_plot.py), ``registry_gen`` and the taxonomy half of ``registry``,
on the CPU, against the JAX package.

The cases of ``tests/test_utils.py`` on the port, each held to the JAX
function's output on the same seeded input (exactly: both are the same host
numpy code); ``registry_gen`` without pandas on JAX's synthetic
``scp_statements.csv`` plus a diagnostic row with a blank class (pandas reads
it as NaN and files the code under 'nan'; the stdlib reader gives the same
dict); the taxonomy tables, ``ptbxl_code_aspects``,
``ptbxl_diagnostic_class`` and every ``config()`` path equal to JAX's (the
cases of ``tests/test_config_accessor.py`` and ``tests/test_registry.py``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import matplotlib
matplotlib.use('Agg')

import numpy as np
import pandas as pd
import pytest
import torch

from ecg_representation_learning_tpu import registry as JR
from ecg_representation_learning_tpu import registry_gen as jgen
from ecg_representation_learning_tpu.utils import ecg_domain as jdomain
from ecg_representation_learning_tpu.utils import misc as jmisc
from ecg_representation_learning_tpu_torch import registry as R
from ecg_representation_learning_tpu_torch import registry_gen
from ecg_representation_learning_tpu_torch.utils import (PtbxlAucVisualizer, correct_peaks,
                                                         detect_rpeaks, device_trace,
                                                         fit_power_law, fmt_time, plot_ecg,
                                                         profile_runtime, r2, readable_int,
                                                         refine_rpeak)
from ecg_representation_learning_tpu_torch.utils.check_args import ca

ROOT = Path(__file__).resolve().parents[1]


# --- tests/test_utils.py ---------------------------------------------------------
@pytest.mark.parametrize('num', [999, 1234, 85_700_000, -4_200, 3e15, 0])
def test_readable_int(num):
    assert readable_int(num) == jmisc.readable_int(num)
    assert readable_int(num, 'B') == jmisc.readable_int(num, 'B')
    assert readable_int(85_700_000) == '85.7M'


@pytest.mark.parametrize('secs', [59, 61, 3661, 0.4, 7322.6])
def test_fmt_time(secs):
    import datetime
    assert fmt_time(secs) == jmisc.fmt_time(secs)
    td = datetime.timedelta(seconds=secs)
    assert fmt_time(td) == jmisc.fmt_time(td)
    assert fmt_time(3661) == '1h 1m 1s'


def test_r2(rng):
    y = np.asarray([1.0, 2.0, 3.0])
    assert r2(y, y) == 1.0
    assert r2(y, np.full(3, y.mean())) == 0.0
    a, b = rng.standard_normal(50), rng.standard_normal(50)
    assert r2(a, b) == jdomain.r2(a, b)


def test_refine_rpeak(rng):
    fs = 250
    sig = np.zeros(1000)
    true_peaks = np.arange(100, 1000, 200)
    sig[true_peaks] = 10.0
    sig += 0.05 * rng.standard_normal(1000)
    tentative = true_peaks + rng.integers(-15, 15, true_peaks.size)
    refined = refine_rpeak(sig, tentative, fs)
    np.testing.assert_array_equal(refined, true_peaks)
    np.testing.assert_array_equal(refined, jdomain.refine_rpeak(sig, tentative, fs))
    for direction in ('up', 'down', 'both'):
        np.testing.assert_array_equal(
            correct_peaks(sig, tentative, 20, 3, direction),
            jdomain.correct_peaks(sig, tentative, 20, 3, direction))


def test_detect_rpeaks(rng):
    fs = 250
    t = np.arange(2500) / fs
    phase = (t * 1.2) % 1.0
    sig = 100 * np.exp(-((phase - 0.5) ** 2) / (2 * 0.0004))
    sig += 0.5 * rng.standard_normal(sig.size)
    peaks = detect_rpeaks(sig, fs)
    assert 10 <= peaks.size <= 14
    assert (np.diff(peaks) > fs * 0.3).all()
    np.testing.assert_array_equal(peaks, jdomain.detect_rpeaks(sig, fs))


def test_fit_power_law_matches_jax():
    x = np.arange(1, 40, dtype=float)
    y = 3.0 * x ** -1.3 * (1 + 0.01 * np.sin(x))
    (a, b), (xs, ys) = fit_power_law(x, y, return_fit=2)
    (ja, jb), (jxs, jys) = jdomain.fit_power_law(x, y, return_fit=2)
    assert (a, b) == (ja, jb) and abs(b + 1.3) < 0.05
    np.testing.assert_array_equal(ys, jys)


def test_profile_runtime_and_step_timer(capsys):
    assert profile_runtime(sum, [1, 2, 3], top=3) == 6
    assert 'function calls' in capsys.readouterr().out
    from ecg_representation_learning_tpu_torch.utils.misc import StepTimer
    st = StepTimer()
    st.input_done()
    st.step_done()
    s = st.summary()
    assert s['steps'] == 1 and 0 <= s['input_fraction'] <= 1
    assert set(s) == set(jmisc.StepTimer().summary())


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / 'trace')) as path:
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    with open(path) as f:
        trace = json.load(f)
    names = {e.get('name') for e in trace['traceEvents']}
    assert any('matmul' in str(n) or 'mm' == n for n in names), sorted(map(str, names))[:20]


def test_auc_plot_renders(tmp_path, rng, monkeypatch):
    code2auc = {c: float(rng.uniform(0.5, 1.0)) for c in R.PTBXL_ID2CODE}
    monkeypatch.chdir(tmp_path)
    viz = PtbxlAucVisualizer(code2auc)
    p1 = viz.grouped_plot(save=True)
    p2 = viz.sorted_plot(save=True)
    p3 = viz.grouped_plot(save=True, color_by='score', title='score-mode grouped AUROC')
    assert all(os.path.exists(p) for p in (p1, p2, p3))
    from ecg_representation_learning_tpu.utils import PtbxlAucVisualizer as JaxViz
    assert viz.code2auc == JaxViz(code2auc).code2auc


def test_auc_grouped_plot_taxonomy_layout(tmp_path, rng, monkeypatch):
    """The port's grouped plot lays its axes out where the JAX package's
    does (the reference's hand-tuned GridSpec, chore/plot.py:31-46)."""
    import matplotlib.pyplot as plt
    from ecg_representation_learning_tpu.utils import PtbxlAucVisualizer as JaxViz
    code2auc = {c: float(rng.uniform(0.5, 1.0)) for c in R.PTBXL_ID2CODE}
    monkeypatch.chdir(tmp_path)

    def layout(viz, mode):
        plt.close('all')
        viz.grouped_plot(save=True, color_by=mode, title=f'layout-{mode}')
        axes = plt.gcf().get_axes()
        return ([(a.get_xlabel(), tuple(np.round(a.get_position().bounds, 6)),
                  a.get_visible(), a.get_ylim(),
                  [t.get_text() for t in a.get_xticklabels()]) for a in axes])

    for mode, cbar_visible in (('class', False), ('score', True)):
        got = layout(PtbxlAucVisualizer(code2auc), mode)
        assert got == layout(JaxViz(code2auc), mode), mode
        bar_axes = [g for g in got if g[0]]
        assert len(bar_axes) == 7
        w = {g[0].split('(')[-1].rstrip(')'): g[1][2] for g in bar_axes}
        assert w['NORM'] < w['HYP'] < w['MI'], w
        assert any(g[2] for g in got if not g[0]) == cbar_visible, mode


def test_plot_ecg_renders(tmp_path, rng, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ax = plot_ecg(rng.standard_normal((12, 500)), title='t', save='ecg-test', show=False)
    assert os.path.exists(os.path.join('plots', 'ecg-test.png'))
    assert [t.get_text() for t in ax.get_yticklabels()] == list(JR.LEAD_NAMES)


# --- registry_gen ------------------------------------------------------------------
def _scp_csv(path, blank_class=False):
    """JAX's synthetic scp_statements.csv (tests/test_registry_gen.py), plus
    optionally a diagnostic row whose class and subclass are blank."""
    rows = {
        'code': ['NORM', 'IMI', 'SR', 'NDT', 'XX'],
        'diagnostic': [1, 1, 0, 1, 0],
        'form': [0, 0, 0, 1, 0],
        'rhythm': [0, 0, 1, 0, 0],
        'diagnostic_class': ['NORM', 'MI', '', 'STTC', ''],
        'diagnostic_subclass': ['NORM', 'IMI', '', 'STTC', ''],
        'description': ['normal', 'inferior MI', 'sinus rhythm', 'non-diag T', 'junk'],
    }
    if blank_class:
        extra = {'code': 'QQQ', 'diagnostic': 1.0, 'form': None, 'rhythm': None,
                 'diagnostic_class': '', 'diagnostic_subclass': '', 'description': ''}
        for k, v in extra.items():
            rows[k].append(v)
    pd.DataFrame(rows).set_index('code').to_csv(path)
    return str(path)


@pytest.mark.parametrize('blank_class', [False, True])
def test_extract_ptb_codes_matches_jax(tmp_path, blank_class):
    path = _scp_csv(tmp_path / 'scp.csv', blank_class)
    ext = registry_gen.extract_ptb_codes(path)
    assert ext == jgen.extract_ptb_codes(path)
    assert ext['id2code'][:4] == ['NORM', 'IMI', 'SR', 'NDT']   # XX has no aspect
    assert ext['form_codes'] == ['NDT'] and ext['rhythm_codes'] == ['SR']
    assert ext['diagnostic_taxonomy']['MI']['IMI'] == ['IMI']
    assert ext['code2description']['SR'] == 'sinus rhythm'
    if blank_class:
        # pandas' NaN quirk, kept: a blank class files the code under 'nan'
        assert ext['diagnostic_taxonomy']['nan'] == {'nan': ['QQQ']}
        assert ext['code2description']['QQQ'] == 'nan'


def test_registry_gen_verifies_the_frozen_registry(tmp_path):
    """A CSV written from the frozen taxonomy verifies clean, on both
    packages; the module's command line prints the same report."""
    diag = {c: (sup, sub) for sup, subs in R.PTBXL_DIAGNOSTIC_TAXONOMY.items()
            for sub, codes in subs.items() for c in codes}
    df = pd.DataFrame({
        'code': list(R.PTBXL_ID2CODE),
        'diagnostic': [1.0 if c in diag else None for c in R.PTBXL_ID2CODE],
        'form': [1.0 if c in R.PTBXL_FORM_CODES else None for c in R.PTBXL_ID2CODE],
        'rhythm': [1.0 if c in R.PTBXL_RHYTHM_CODES else None for c in R.PTBXL_ID2CODE],
        'diagnostic_class': [diag.get(c, ('', ''))[0] for c in R.PTBXL_ID2CODE],
        'diagnostic_subclass': [diag.get(c, ('', ''))[1] for c in R.PTBXL_ID2CODE],
        'description': [R.PTBXL_CODE2DESCRIPTION[c] for c in R.PTBXL_ID2CODE],
    }).set_index('code')
    path = str(tmp_path / 'scp.csv')
    df.to_csv(path)
    ext = registry_gen.extract_ptb_codes(path)
    assert ext == jgen.extract_ptb_codes(path)
    assert registry_gen.verify_against_registry(ext) == []
    assert jgen.verify_against_registry(ext) == []
    ext['form_codes'] = ext['form_codes'][1:]
    assert registry_gen.verify_against_registry(ext) == jgen.verify_against_registry(ext)
    res = subprocess.run([sys.executable, '-m', 'ecg_representation_learning_tpu_torch.registry_gen',
                          '--scp-statements', path, '--verify'], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == {'ok': True, 'problems': []}


# --- the taxonomy half of the registry -----------------------------------------------
@pytest.mark.parametrize('name', ['PTBXL_CODE2ID', 'PTBXL_FORM_CODES', 'PTBXL_RHYTHM_CODES',
                                  'PTBXL_DIAGNOSTIC_TAXONOMY', 'PTBXL_SUBCLASS_DESCRIPTION',
                                  'LEAD_NAMES', 'RANDOM_SEED'])
def test_taxonomy_tables_equal_jax(name):
    assert getattr(R, name) == getattr(JR, name)


def test_code_aspects_and_classes_equal_jax():
    for c in list(R.PTBXL_ID2CODE) + ['XX']:
        assert R.ptbxl_code_aspects(c) == JR.ptbxl_code_aspects(c), c
        assert R.ptbxl_diagnostic_class(c) == JR.ptbxl_diagnostic_class(c), c
    assert all(R.ptbxl_code_aspects(c) for c in R.PTBXL_ID2CODE)
    diag = {c for sup in R.PTBXL_DIAGNOSTIC_TAXONOMY.values()
            for codes in sup.values() for c in codes}
    assert diag | set(R.PTBXL_FORM_CODES) | set(R.PTBXL_RHYTHM_CODES) == set(R.PTBXL_ID2CODE)


def _paths(node, prefix=''):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _paths(v, f'{prefix}.{k}' if prefix else k)
    else:
        yield prefix


@pytest.mark.parametrize('root', ['datasets', 'datasets-export', 'pre_processing',
                                  'random-seed'])
def test_config_paths_equal_jax(root):
    tree = R.config(root)
    assert tree == JR.config(root)
    for path in list(_paths(tree, root))[::7]:
        assert R.config(path) == JR.config(path), path


def test_config_dot_paths():
    assert R.config('datasets.PTB-XL.fqs') == 500
    assert R.config('datasets.PTB-XL.n_rec') == 21837
    assert R.config('datasets.INCART.fqs') == 257
    assert R.config('pre_processing.zheng.low_pass.passband') == 50.0
    assert R.config('pre_processing.zheng.nlm.window_size') == 10
    assert R.config('random-seed') == 77
    assert len(R.config('datasets.PTB-XL.code.id2code')) == 71
    assert R.config('datasets.PTB-XL.code.code2id')['NORM'] == 4
    assert R.config('datasets-export.total')[0] == 'INCART'
    assert abs(R.config('datasets.PTB-XL.train-stats.original.mean')[0] + 0.0019577) < 1e-6
    with pytest.raises(KeyError):
        R.config('nonexistent.key')
    ca(pad_mode='shift')
    with pytest.raises(ValueError):
        ca(pad_mode='edge')
