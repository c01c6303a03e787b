"""The port's data and metrics modules against the JAX package's.

``data/datasets.py`` is a numpy copy: the synthetic corpus and the splits
must be byte-equal for the same seed.  ``train/metrics.py``: the numpy
metrics must be equal, and ``binary_stats`` (torch here, jnp there) equal
on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu import registry as jregistry
from ecg_representation_learning_tpu.data import datasets as jdata
from ecg_representation_learning_tpu.train import metrics as jmetrics
from ecg_representation_learning_tpu_torch import registry
from ecg_representation_learning_tpu_torch.data import datasets as tdata
from ecg_representation_learning_tpu_torch.train import metrics as tmetrics


@pytest.mark.parametrize('kw', [dict(n=96, length=640),
                                dict(n=64, length=2500, seed=3),
                                dict(n=80, length=640, n_marker_classes=4),
                                dict(n=192, length=704, n_marker_classes=16, hard=True)])
def test_synth_ptbxl_byte_equal(kw):
    want = jdata.synth_ptbxl(**kw)
    got = tdata.synth_ptbxl(**kw)
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1] == want[1]
    assert got[2].tobytes() == want[2].tobytes()


@pytest.mark.parametrize('n_sample', [None, 7])
def test_splits_byte_equal(n_sample):
    signals, labels, folds = jdata.synth_ptbxl(n=128, length=640, n_marker_classes=4)
    want = jdata.get_ptbxl_splits(signals, labels, folds, n_sample)
    got = tdata.get_ptbxl_splits(signals, labels, folds, n_sample)
    for name in ('train', 'eval', 'test'):
        a, b = getattr(got, name), getattr(want, name)
        assert a.signals.tobytes() == b.signals.tobytes()
        assert a.labels.tobytes() == b.labels.tobytes()
        assert len(a) == len(b)
    for a, b in zip(tdata.split_by_strat_fold(folds, n_sample),
                    jdata.split_by_strat_fold(folds, n_sample)):
        np.testing.assert_array_equal(a, b)
    assert tdata.compute_train_stats(signals, folds) == \
        jdata.compute_train_stats(signals, folds)


def test_label_parsing_equal():
    for scp in ("{'NORM': 100.0, 'SR': 0.0}", {'IMI': 50.0, 'XYZ': 1.0, 'AFIB': 0}, {}):
        assert tdata.parse_scp_codes(scp) == jdata.parse_scp_codes(scp)
    ids = [[0, 5], [], [70], [4, 4]]
    np.testing.assert_array_equal(tdata.labels_to_multi_hot(ids),
                                  jdata.labels_to_multi_hot(ids))
    assert (registry.N_LEADS, registry.TARGET_FQS) == (jregistry.N_LEADS,
                                                       jregistry.TARGET_FQS)


def _probs_labels(seed, n=60, c=71, p_pos=0.2):
    rng = np.random.default_rng(seed)
    labels = (rng.uniform(size=(n, c)) < p_pos).astype(np.float32)
    labels[:, 3] = 0.0                       # a constant column, masked out
    probs = np.clip(0.6 * labels + 0.5 * rng.uniform(size=(n, c)), 0, 1).astype(np.float32)
    probs[:10, 7] = probs[10:20, 7] = 0.25   # ties
    return probs, labels


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_roc_auc_and_multilabel_auroc_equal(seed):
    probs, labels = _probs_labels(seed)
    for j in (0, 7, 20):
        assert tmetrics.roc_auc(probs[:, j], labels[:, j]) == \
            jmetrics.roc_auc(probs[:, j], labels[:, j])
    got = tmetrics.multilabel_auroc(probs, labels)
    want = jmetrics.multilabel_auroc(probs, labels)
    assert got == want and 'IMI' in got['per_class_auc'] and 'LNGQT' not in got['per_class_auc']
    assert tmetrics.multilabel_auroc(probs, np.zeros_like(labels)) == \
        {'macro_auc': None, 'per_class_auc': None}
    assert np.isnan(tmetrics.roc_auc(probs[:, 0], np.zeros(len(probs))))


@pytest.mark.parametrize('seed', [0, 1])
def test_binary_stats_and_reports_equal(seed):
    probs, labels = _probs_labels(seed)
    want = jmetrics.binary_stats(jnp.asarray(probs), jnp.asarray(labels))
    got = tmetrics.binary_stats(torch.from_numpy(probs), torch.from_numpy(labels))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-7)
    assert tmetrics.classification_report(probs, labels) == \
        jmetrics.classification_report(probs, labels)
    assert tmetrics.per_class_recall(probs, labels) == jmetrics.per_class_recall(probs, labels)
    got_acc = tmetrics.get_accuracy(probs, labels)
    want_acc = jmetrics.get_accuracy(probs, labels)
    assert set(got_acc) == set(want_acc)
    assert got_acc['per_class_auc'] == want_acc['per_class_auc']
    np.testing.assert_allclose(got_acc['binary_accuracy'], want_acc['binary_accuracy'],
                               rtol=1e-7)
