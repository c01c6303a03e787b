"""The port's tokenizer (models/tokenizer.py) and ``pad_to_multiple``, on the
CPU, against the JAX package.

The ten cases of ``tests/test_tokenizer.py`` run on the port.  ``jax.random``
cannot be replayed by a torch generator, so parity is held from JAX's k-means++
centers: Lloyd from them against the JAX ``kmeans_fit`` (centers 1e-5, counts
equal, inertia 1e-5 relative; the two sum in different orders, float32),
nearest-centroid ids equal, and the tokenizer's fit from JAX's seeding equal
to JAX's; k-means++ itself is held by its statistics (a chi-square test of the
first draw against uniform and of the next against D^2).  The pickles load
across the packages, and ``cli tokenize`` runs on a synthetic HDF5.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ecg_representation_learning_tpu.models import tokenizer as J
from ecg_representation_learning_tpu.ops.pad import pad_to_multiple as jax_pad_to_multiple
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.models import tokenizer as T
from ecg_representation_learning_tpu_torch.models.tokenizer import (EcgTokenizer,
                                                                    fit_power_law,
                                                                    kmeans_fit,
                                                                    nearest_centroid)
from ecg_representation_learning_tpu_torch.ops.pad import pad_to_multiple

torch.set_num_threads(2)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """numpy input goes to the GPU; here, to the CPU."""
    monkeypatch.setattr(T, 'default_device', lambda device=None: torch.device('cpu'))


# --- the JAX package's ten cases ------------------------------------------------
def test_kmeans_recovers_clusters(rng):
    centers_true = rng.standard_normal((4, 8)) * 10
    x = np.concatenate([centers_true[i] + 0.1 * rng.standard_normal((100, 8))
                        for i in range(4)])
    centers, counts, inertia = kmeans_fit(_t(x), k=4, n_iter=32, generator=_gen())
    d = np.linalg.norm(centers_true[:, None] - centers.numpy()[None], axis=-1).min(axis=1)
    assert d.max() < 0.5
    np.testing.assert_allclose(np.sort(counts.numpy()), [100] * 4)
    assert float(inertia) < 500


def test_kmeans_vs_sklearn_inertia(rng):
    from sklearn.cluster import KMeans
    x = rng.standard_normal((500, 8)).astype(np.float32)
    sk = KMeans(n_clusters=16, n_init=4, random_state=0).fit(x)
    _, _, inertia = kmeans_fit(_t(x), k=16, n_iter=64, generator=_gen())
    assert float(inertia) < sk.inertia_ * 1.1


def test_nearest_centroid(rng):
    centers = rng.standard_normal((16, 8)).astype(np.float32)
    x = centers[[3, 7, 7, 0]] + 1e-3
    ids, dist = nearest_centroid(_t(x), _t(centers))
    np.testing.assert_array_equal(ids.numpy(), [3, 7, 7, 0])
    assert dist.numpy().max() < 0.01


def test_tokenizer_roundtrip(rng):
    sigs = rng.standard_normal((16, 12, 250)).astype(np.float32)
    tok = EcgTokenizer(k=8, pad='shift').fit(sigs, n_clusters=32, n_iter=32)
    ids, means = tok(sigs)
    assert ids.shape == (16, 12, 32) and means.shape == (16, 12, 32)
    assert ids.min() >= 0 and ids.max() < 32
    dec = tok.decode(ids, means=means)
    assert dec.shape == (16, 12, 256)
    padded = pad_to_multiple(_t(sigs), 8, 'shift').numpy()
    assert np.abs(dec - padded).mean() < np.abs(padded).mean()


def test_tokenizer_threshold_filtering(rng):
    sigs = rng.standard_normal((8, 2, 200)).astype(np.float32)
    tok = EcgTokenizer(k=8).fit(sigs, n_clusters=16, n_iter=16)
    big, _ = tok._filtered_codebook(None)
    small, _ = tok._filtered_codebook(int(tok.lens.max()))
    assert small.shape[0] < big.shape[0]
    ids, _ = tok(sigs, th=int(tok.lens.max()))
    assert ids.max() < small.shape[0]
    frac_book, _ = tok._filtered_codebook(0.01)
    assert 1 <= frac_book.shape[0] <= 16


def test_tokenizer_persistence(tmp_path, rng):
    sigs = rng.standard_normal((4, 2, 96)).astype(np.float32)
    tok = EcgTokenizer(k=8).fit(sigs, n_clusters=8, n_iter=8)
    tok2 = EcgTokenizer.load(tok.save(str(tmp_path / 'tok.pickle')))
    np.testing.assert_array_equal(tok.centers, tok2.centers)
    np.testing.assert_array_equal(tok.lens, tok2.lens)
    np.testing.assert_array_equal(tok(sigs)[0], tok2(sigs)[0])


def test_rank_frequency_power_law():
    tok = EcgTokenizer(k=8)
    ranks = np.arange(1, 65)
    tok.lens = (1000 * ranks ** -1.5).astype(np.int64) + 1
    tok.centers = np.zeros((64, 8), np.float32)
    rf = tok.rank_frequency()
    assert rf['exponent'] < -1.0
    a, b = fit_power_law(ranks.astype(float), 5.0 * ranks ** -2.0)
    np.testing.assert_allclose(b, -2.0, atol=1e-6)
    np.testing.assert_allclose(a, 5.0, rtol=1e-6)
    j = J.EcgTokenizer(k=8, centers=tok.centers, lens=tok.lens).rank_frequency()
    assert rf['exponent'] == j['exponent'] and rf['coeff'] == j['coeff']


def test_kmeans_chunked_equivalence(rng):
    x = _t(rng.standard_normal((500, 8)))
    c_whole, n_whole, i_whole = kmeans_fit(x, k=16, n_iter=8, chunk=500, generator=_gen(3))
    c_chunk, n_chunk, i_chunk = kmeans_fit(x, k=16, n_iter=8, chunk=64, generator=_gen(3))
    np.testing.assert_allclose(c_whole.numpy(), c_chunk.numpy(), atol=1e-5)
    np.testing.assert_array_equal(n_whole.numpy(), n_chunk.numpy())
    np.testing.assert_allclose(float(i_whole), float(i_chunk), rtol=1e-5)


def test_kmeans_large_n_bounded_memory(rng):
    n = 1 << 20
    x = _t(rng.standard_normal((n, 8)))
    centers, counts, inertia = kmeans_fit(x, k=256, n_iter=2, generator=_gen())
    assert torch.isfinite(centers).all()
    assert int(counts.sum()) == n and counts.dtype == torch.float64
    ids, _ = nearest_centroid(x, centers)
    assert ids.shape == (n,) and int(ids.max()) < 256
    assert np.isfinite(float(inertia))


def test_centroid_grid_renders(tmp_path, rng, monkeypatch):
    import matplotlib
    matplotlib.use('Agg')
    monkeypatch.chdir(tmp_path)
    sigs = rng.standard_normal((12, 2, 160)).astype(np.float32)
    tok = EcgTokenizer(k=8).fit(sigs, n_clusters=48, n_iter=8)
    paths = tok.centroid_grid(sigs=sigs, n_row=2, n_col=4, n_sample=4)
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)
    paths2 = tok.centroid_grid(n_row=4, n_col=12)
    assert len(paths2) == 1 and os.path.exists(paths2[0])


# --- parity with the JAX package -----------------------------------------------
@pytest.mark.parametrize('chunk', [3000, 512])
def test_lloyd_from_jax_seeding_matches_jax(chunk):
    x = np.random.default_rng(0).standard_normal((3000, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    init = np.asarray(J.kmeans_plus_plus_init(key, jnp.asarray(x), 16))
    jc, jn, ji = J.kmeans_fit(key, jnp.asarray(x), k=16, n_iter=20, chunk=chunk)
    tc, tn, ti = kmeans_fit(_t(x), 16, n_iter=20, chunk=chunk, init=_t(init))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


def test_nearest_centroid_ids_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5000, 8)).astype(np.float32)
    c = rng.standard_normal((64, 8)).astype(np.float32)
    jids, jd = J.nearest_centroid(jnp.asarray(x), jnp.asarray(c), chunk=1024)
    ids, d = nearest_centroid(_t(x), _t(c), chunk=1024)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5, rtol=0)


@pytest.mark.parametrize('mode', ['zero', 'shift'])
@pytest.mark.parametrize('length', [250, 256, 3])
def test_pad_to_multiple_matches_jax(mode, length):
    x = np.random.default_rng(2).standard_normal((2, 3, length)).astype(np.float32)
    want = np.asarray(jax_pad_to_multiple(jnp.asarray(x), 8, mode))
    got = pad_to_multiple(_t(x), 8, mode).numpy()
    np.testing.assert_array_equal(got, want)
    if mode == 'zero' or length >= 8:      # 'shift' repeats at most the whole record
        assert got.shape[-1] == length + 8 - length % 8      # always pads
    with pytest.raises(ValueError, match='pad mode'):
        pad_to_multiple(_t(x), 8, 'edge')


def test_tokenizer_fit_from_jax_seeding_matches_jax(monkeypatch):
    """``EcgTokenizer.fit`` with the port's k-means++ swapped for JAX's draw
    (on the same segments, key PRNGKey(seed)) gives JAX's codebook."""
    sigs = (0.2 * np.random.default_rng(3).standard_normal((6, 12, 250))).astype(np.float32)
    jtok = J.EcgTokenizer(k=8, pad='shift').fit(sigs, n_clusters=24, n_iter=12, seed=5)

    def jax_seeding(x, k, generator):
        return _t(np.asarray(J.kmeans_plus_plus_init(jax.random.PRNGKey(5),
                                                     jnp.asarray(x.numpy()), k)))
    monkeypatch.setattr(T, 'kmeans_plus_plus_init', jax_seeding)
    tok = EcgTokenizer(k=8, pad='shift').fit(sigs, n_clusters=24, n_iter=12, seed=5)
    np.testing.assert_array_equal(tok.lens, jtok.lens)
    np.testing.assert_allclose(tok.centers, jtok.centers, atol=1e-5, rtol=0)
    assert (tok.k, tok.pad, tok.fit_method, tok.n_sig, tok.cls_th) == \
        (jtok.k, jtok.pad, jtok.fit_method, jtok.n_sig, jtok.cls_th)
    ids, means = tok(sigs)
    jids, jmeans = jtok(sigs)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(means, jmeans, atol=1e-6, rtol=0)


def _draw_index(x, centers):
    return [int(np.nonzero((x == c).all(axis=1))[0][0]) for c in centers]


def test_kmeans_plus_plus_statistics():
    """The first center is uniform over the points; the second is drawn with
    probability D^2 to the first (never the first again).  Chi-square over
    6000 seeded draws of k = 2 from 6 points."""
    x = np.asarray([[0, 0], [1, 0], [0, 2], [3, 1], [-1, -1], [4, 4]], np.float32)
    n, runs = len(x), 6000
    gen = _gen(11)
    pairs = np.asarray([_draw_index(x, T.kmeans_plus_plus_init(_t(x), 2, gen).numpy())
                        for _ in range(runs)])
    first = np.bincount(pairs[:, 0], minlength=n)
    assert stats.chisquare(first).pvalue > 1e-3
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)             # (first, second)
    obs = np.zeros((n, n))
    np.add.at(obs, (pairs[:, 0], pairs[:, 1]), 1)
    assert (obs[np.arange(n), np.arange(n)] == 0).all()    # D = 0 is never drawn
    expected = first[:, None] * d2 / d2.sum(1, keepdims=True)
    cells = expected > 0
    chi2 = (((obs - expected) ** 2)[cells] / expected[cells]).sum()
    assert stats.chi2.sf(chi2, df=n * (n - 2)) > 1e-3


def test_sklearn_backends_match_jax_and_need_sklearn(rng, monkeypatch):
    data = rng.standard_normal((60, 8)).astype(np.float32)
    want = J.cluster(data, method='birch', threshold=0.8)
    got = T.cluster(data, method='birch', threshold=0.8)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    monkeypatch.setitem(sys.modules, 'sklearn', None)
    monkeypatch.setitem(sys.modules, 'sklearn.cluster', None)
    with pytest.raises(ImportError, match='scikit-learn'):
        T.cluster(data, method='dbscan', eps=0.5)


def test_pickles_load_across_the_packages(tmp_path, rng):
    sigs = rng.standard_normal((4, 3, 120)).astype(np.float32)
    port = EcgTokenizer(k=8).fit(sigs, n_clusters=8, n_iter=8)
    jtok = J.EcgTokenizer(k=8).fit(sigs, n_clusters=8, n_iter=8)
    from_port = J.EcgTokenizer.load(port.save(str(tmp_path / 'port.pickle')))
    from_jax = EcgTokenizer.load(jtok.save(str(tmp_path / 'jax.pickle')))
    for a, b in ((port, from_port), (jtok, from_jax)):
        np.testing.assert_array_equal(a(sigs)[0], b(sigs)[0])
        np.testing.assert_array_equal(a.lens, b.lens)
        assert isinstance(b.centers, np.ndarray) and a.cls_th == b.cls_th


def test_cli_synth_and_tokenize(tmp_path, capsys):
    cli.main(['synth', '--n', '32', '--out', str(tmp_path)])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli.main(['tokenize', '--hdf5', info['hdf5'], '--k', '8', '--clusters', '16',
              '--iters', '8', '--out', str(tmp_path / 'tok.pickle')])
    tok_info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.exists(tok_info['tokenizer']) and tok_info['n_clusters'] == 16
    assert np.isfinite(tok_info['power_law_exponent'])
    tok = J.EcgTokenizer.load(tok_info['tokenizer'])        # the JAX package reads it
    assert tok.centers.shape == (16, 8) and int(tok.lens.sum()) == 32 * 12 * (2500 // 8 + 1)
