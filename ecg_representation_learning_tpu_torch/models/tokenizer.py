"""Signal tokenizer: cluster fixed-length segments into a discrete vocabulary
(the JAX package's ``models/tokenizer.py``).

Reference ``EcgTokenizer`` (models/ecg_tokenizer.py:140-626): pad signals to a
multiple of ``k`` ('zero'/'shift' modes), reshape N x C x L into length-k
segments, mean-center each segment, cluster (the practical backend is KMeans,
ecg_tokenizer.py:29), store (centers, cluster sizes); encode = nearest-centroid
query, with optional minimum-cluster-size filtering (``CustNN``,
ecg_tokenizer.py:193-220); decode = centroid lookup; pickle persistence;
rank-frequency power-law analysis (ecg_tokenizer.py:443-487).

k-means is Lloyd's algorithm on the segments' device with k-means++ seeding,
chunked so the (segments x centers) distances never exceed (chunk x K).  What
differs from the JAX package, and why:

  * the k-means++ draw is an inverse-CDF draw (a float64 cumulative sum and
    ``searchsorted`` on a uniform value from the explicit generator):
    ``torch.multinomial`` takes at most 2^24 categories and PTB-XL has 82 M
    segments;
  * the Lloyd update sums each chunk's segments per cluster with a (K x chunk)
    one-hot product, not ``index_add_``, whose float atomics would make two
    fits differ; the chunks' sums accumulate in float64 and the counts are
    int64, so they are exact beyond 2^24 per cluster (JAX counts in float32);
    nothing in an iteration waits for the host;
  * the distance products run with TF32 off; ``argmin`` ties go to the first
    index, as in JAX.

``jax.random`` cannot be replayed by a torch generator: parity with JAX is held
through ``kmeans_fit(init=...)`` from JAX's k-means++ centers.  The sklearn
backends run on the host.  ``EcgTokenizer.save`` writes the JAX package's
pickle dict (numpy arrays, the same keys), so either package loads the
other's tokenizers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pickle
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.pad import pad_to_multiple
from ..runtime import default_device

DEFAULT_CHUNK = 1 << 16   # 64k segments a chunk: (chunk, K=256) distances are 67 MB


@contextlib.contextmanager
def _no_tf32():
    """float32 products in full precision (the JAX package's HIGHEST)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, D), (K, D) -> (N, K) squared euclidean distances through one
    product, summed in JAX's order: (|x|^2 - 2 x.c) + |c|^2 (the first sum is
    the product's epilogue: -2 x.c is exact, so it rounds once, as JAX's)."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)
    with _no_tf32():
        d = torch.addmm(x2, x, c.T, alpha=-2.0)
    return d.add_(c2[None, :])


def kmeans_plus_plus_init(x: torch.Tensor, k: int,
                          generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding (the reference KMeans default, ecg_tokenizer.py:29):
    the first center uniform, each next one drawn with probability
    proportional to the squared distance to the nearest center so far."""
    n = x.shape[0]
    # indices stay on the device: no draw waits for the host
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    chosen = [x.index_select(0, first)]
    d = (x - chosen[0]).square_().sum(1)
    for _ in range(1, k):
        cdf = d.double().cumsum_(0)
        u = torch.rand((1,), generator=generator, device=x.device,
                       dtype=torch.float64) * cdf[-1:]
        idx = torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)
        chosen.append(x.index_select(0, idx))
        d = torch.minimum(d, (x - chosen[-1]).square_().sum(1))
    return torch.cat(chosen)


def _assign(xb: torch.Tensor, centers: torch.Tensor):
    """(ids, squared distance to the nearest center) of one chunk."""
    dists = _pairwise_sq_dists(xb, centers)
    mind, ids = torch.min(dists, dim=1)
    return ids, mind


_GROUP = 512   # rows per batch of the one-hot product


def _one_hot_sums(xb: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """Per-cluster sums (K, D) float64 of one chunk, as a (K x chunk) one-hot
    product: the same bits every run.  The product runs as a batch of
    (K x 512) one-hot blocks (a single (K x chunk) product reduces its long
    axis on a handful of thread blocks) whose partial sums are added in a
    fixed order."""
    n, d = xb.shape
    n_pad = -(-n // _GROUP) * _GROUP
    onehot = xb.new_zeros((k, n_pad)).scatter_(0, ids[None, :], 1.0)
    if n_pad != n:
        xb = torch.cat([xb, xb.new_zeros((n_pad - n, d))])
    g = n_pad // _GROUP
    with _no_tf32():
        parts = torch.bmm(onehot.view(k, g, _GROUP).transpose(0, 1), xb.view(g, _GROUP, d))
    return parts.sum(0, dtype=torch.float64)


def _count(counts: torch.Tensor, ids: torch.Tensor) -> None:
    """Add each id's occurrences to the int64 ``counts`` (integer adds: exact,
    the same in any order, and no wait for the host, as ``bincount`` has)."""
    counts.scatter_add_(0, ids, torch.ones_like(ids))


def kmeans_fit(x: torch.Tensor, k: int, n_iter: int = 64, chunk: int = DEFAULT_CHUNK,
               generator: Optional[torch.Generator] = None,
               init: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd iterations on ``x`` (N, D) float32, seeded by ``init`` (K, D) or
    else by k-means++ from ``generator`` (default: seed 0 on x's device).
    Returns (centers (K, D) float32, counts (K,) float64, inertia float64).

    Runs per ``chunk`` of segments, so peak memory is O(chunk x K) beside
    ``x``; an empty cluster keeps its center."""
    n, d = x.shape
    chunk = min(chunk, n)
    if init is not None:
        centers = init.to(device=x.device, dtype=x.dtype).clone()
    else:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        centers = kmeans_plus_plus_init(x, k, generator)
    parts = torch.split(x, chunk)
    for _ in range(n_iter):
        sums = torch.zeros((k, d), dtype=torch.float64, device=x.device)
        counts = torch.zeros((k,), dtype=torch.int64, device=x.device)
        for xb in parts:
            ids = _assign(xb, centers)[0]
            sums += _one_hot_sums(xb, ids, k)
            _count(counts, ids)
        new = (sums / torch.clamp(counts[:, None], min=1)).to(x.dtype)
        centers = torch.where(counts[:, None] > 0, new, centers)
    counts = torch.zeros((k,), dtype=torch.int64, device=x.device)
    inertia = torch.zeros((), dtype=torch.float64, device=x.device)
    for xb in parts:
        ids, mind = _assign(xb, centers)
        _count(counts, ids)
        inertia += mind.sum(dtype=torch.float64)
    return centers, counts.to(torch.float64), inertia


def nearest_centroid(x: torch.Tensor, centers: torch.Tensor, chunk: int = DEFAULT_CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode: (N, D) segments -> (ids (N,) int64, distances (N,)); chunked so
    the (N, K) distance matrix never materializes."""
    centers = centers.to(device=x.device, dtype=x.dtype)
    ids, dist = [], []
    for xb in torch.split(x, min(chunk, max(x.shape[0], 1))):
        i, mind = _assign(xb, centers)
        ids.append(i)
        dist.append(torch.sqrt(torch.clamp(mind, min=0.0)))
    return torch.cat(ids), torch.cat(dist)


# ---------------------------------------------------------------------------
# Pluggable clustering backends (reference cluster()/cluster_args,
# ecg_tokenizer.py:20-85: hierarchical / dbscan / optics / birch / kmeans with
# a per-method threshold keyword).  kmeans runs on the device (above); the
# others are host-side sklearn, kept for parity with the exploratory track.
# ---------------------------------------------------------------------------
CLUSTER_THRESHOLD_KEY = {          # reference D_CLS_TH (ecg_tokenizer.py:72-78)
    'hierarchical': 'distance_threshold',
    'dbscan': 'eps',
    'optics': 'max_eps',
    'birch': 'threshold',
    'kmeans': 'n_clusters',
}


def _kmeans(data: torch.Tensor, k: int, seed: int, n_iter: int):
    """(centers, ids) tensors of the seeded k-means of ``data``."""
    gen = torch.Generator(device=data.device).manual_seed(seed)
    centers, _, _ = kmeans_fit(data, k=k, n_iter=n_iter, generator=gen)
    return centers, nearest_centroid(data, centers)[0]


def _on_device(x) -> torch.Tensor:
    """A tensor stays where it is; numpy input goes to the GPU."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32), device=default_device())


def cluster(data, method: str = 'kmeans', seed: int = 77, n_iter: int = 64,
            **kwargs) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster (N, D) points -> (centers (K, D), labels (N,)) as numpy.

    kmeans runs on ``data``'s device when it is a tensor, else on the GPU;
    the other methods dispatch to sklearn on the host (label -1 noise points
    from DBSCAN/OPTICS are dropped from the codebook)."""
    if method == 'kmeans':
        x = _on_device(data)
        centers, ids = _kmeans(x.float(), kwargs.pop('n_clusters'), seed, n_iter)
        return centers.cpu().numpy(), ids.cpu().numpy()

    try:
        import sklearn.cluster as skc
    except ImportError as e:
        raise ImportError(f'clustering method {method!r} needs scikit-learn; '
                          f"method='kmeans' runs without it") from e
    data = data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
    factories = {
        'hierarchical': lambda: skc.AgglomerativeClustering(
            n_clusters=None, linkage='average', **kwargs),
        'dbscan': lambda: skc.DBSCAN(min_samples=kwargs.pop('min_samples', 5), **kwargs),
        'optics': lambda: skc.OPTICS(min_samples=kwargs.pop('min_samples', 5), **kwargs),
        'birch': lambda: skc.Birch(n_clusters=None, **kwargs),
    }
    if method not in factories:
        raise ValueError(f'Unknown clustering method {method!r}')
    model = factories[method]().fit(data)
    labels = np.asarray(model.labels_)
    uniq = np.unique(labels[labels >= 0])
    centers = np.stack([data[labels == u].mean(axis=0) for u in uniq]) \
        if uniq.size else np.zeros((0, data.shape[1]), data.dtype)
    remap = {int(u): i for i, u in enumerate(uniq)}
    ids = np.asarray([remap.get(int(l), -1) for l in labels])
    return centers.astype(np.float32), ids


# ---------------------------------------------------------------------------
# Tokenizer object
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EcgTokenizer:
    """Parity object for the reference tokenizer (fit / encode / decode /
    size-threshold filtering / persistence / power-law report).  Signals may
    be numpy arrays or tensors; segmenting, k-means and encoding run on the
    tensor's device, and on the GPU for numpy input."""
    k: int = 8
    pad: str = 'shift'
    centers: Optional[np.ndarray] = None     # (K, k)
    lens: Optional[np.ndarray] = None        # (K,) cluster sizes
    fit_method: str = 'kmeans'
    n_sig: Optional[int] = None
    cls_th: Optional[int] = None             # n_clusters used at fit time

    def _segment(self, sig) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
        """pad -> (S, k) mean-centered segments + per-segment means + out shape."""
        x = pad_to_multiple(_on_device(sig).float(), self.k, self.pad)
        segs = x.reshape(-1, self.k)
        means = segs.mean(dim=-1, keepdim=True)
        return segs - means, means, tuple(x.shape[:-1]) + (x.shape[-1] // self.k,)

    def fit(self, sigs, method: str = 'kmeans', n_clusters: int = 256,
            n_iter: int = 64, seed: int = 77, **cluster_kwargs) -> 'EcgTokenizer':
        """Fit the codebook on (N, C, L) signals (reference fit,
        ecg_tokenizer.py:352-508).  ``method``: 'kmeans' (on the device) or
        the sklearn backends 'hierarchical'/'dbscan'/'optics'/'birch' (on the
        host); per-method threshold kwargs as in :data:`CLUSTER_THRESHOLD_KEY`."""
        segs, _, _ = self._segment(sigs)
        if method == 'kmeans':
            cluster_kwargs['n_clusters'] = n_clusters
            centers_t, ids_t = _kmeans(segs, n_clusters, seed, n_iter)
            counts_np = torch.bincount(ids_t, minlength=n_clusters).cpu().numpy()
            centers = centers_t.cpu().numpy()
        else:
            centers, ids = cluster(segs, method=method, seed=seed, n_iter=n_iter,
                                   **cluster_kwargs)
            counts_np = np.bincount(ids[ids >= 0], minlength=centers.shape[0])
        counts_np = counts_np.astype(np.int64)
        order = np.argsort(-counts_np)  # sort by cluster size, descending
        self.centers = np.asarray(centers)[order]
        self.lens = counts_np[order]
        self.fit_method = method
        self.n_sig = int(sigs.shape[0])
        self.cls_th = cluster_kwargs.get(CLUSTER_THRESHOLD_KEY.get(method), n_clusters)
        return self

    def _filtered_codebook(self, th: Optional[Union[int, float]]
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """CustNN semantics (ecg_tokenizer.py:197-214): drop centroids whose
        cluster size is below ``th`` (int absolute / float fraction of total)."""
        if th is None:
            return self.centers, np.arange(self.centers.shape[0])
        if isinstance(th, float):
            assert 0 < th < 1
            th = round(float(self.lens.sum()) * th)
        keep = self.lens >= th
        return self.centers[keep], np.nonzero(keep)[0]

    def __call__(self, sig, th: Optional[Union[int, float]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode: (..., L) -> (token ids (..., S), segment means (..., S))."""
        assert self.centers is not None, 'fit() first'
        segs, means, out_shape = self._segment(sig)
        codebook, _ = self._filtered_codebook(th)
        ids, _ = nearest_centroid(segs, torch.as_tensor(codebook))
        return (ids.cpu().numpy().reshape(out_shape),
                means.cpu().numpy().reshape(out_shape))

    def decode(self, ids: np.ndarray, th: Optional[Union[int, float]] = None,
               means: Optional[np.ndarray] = None) -> np.ndarray:
        """ids (..., S) -> (..., S*k) signal; add back segment means if given."""
        codebook, _ = self._filtered_codebook(th)
        segs = codebook[np.asarray(ids)]                  # (..., S, k)
        if means is not None:
            segs = segs + np.asarray(means)[..., None]
        return segs.reshape(segs.shape[:-2] + (-1,))

    # ------------------------------------------------------------- persistence
    def save(self, path: str) -> str:
        with open(path, 'wb') as f:
            pickle.dump({
                'k': self.k, 'pad': self.pad, 'centers': self.centers,
                'lens': self.lens, 'fit_method': self.fit_method,
                'n_sig': self.n_sig, 'cls_th': self.cls_th,
            }, f)
        return path

    @classmethod
    def load(cls, path: str) -> 'EcgTokenizer':
        with open(path, 'rb') as f:
            d = pickle.load(f)
        return cls(**d)

    # ---------------------------------------------------------------- analysis
    def centroid_grid(self, sigs=None, n_row: int = 4, n_col: int = 8, n_sample: int = 8,
                      seed: int = 77, save: bool = True) -> list:
        """Cluster-centroid browser (reference ecg_tokenizer.py:509-624) as a
        static host-side report: a grid of centroid subplots ordered by
        cluster frequency, each overlaid with up to ``n_sample`` member
        segments when ``sigs`` is given, symmetric shared y-limits per page,
        per-cell ``Seg #i, sz count`` titles.  The reference drives the same
        grid with an interactive slider and saves its first and last frames
        (ecg_tokenizer.py:609-621); this renders exactly those two pages.
        Returns the saved figure paths (or shows interactively)."""
        import matplotlib.pyplot as plt
        import seaborn as sns

        from ..utils.viz import save_fig as save_fig_
        assert self.centers is not None, 'fit() first'
        k_vocab = self.centers.shape[0]
        per_page = n_row * n_col
        n_pages = max(1, int(np.ceil(k_vocab / per_page)))
        pages = sorted({0, n_pages - 1})
        rng = np.random.default_rng(seed)
        segs = ids = None
        if sigs is not None and n_sample:
            segs_t, _, _ = self._segment(sigs)
            segs = segs_t.cpu().numpy()
            ids = nearest_centroid(segs_t, torch.as_tensor(self.centers))[0].cpu().numpy()
        cs = sns.color_palette('husl', n_colors=per_page)
        paths = []
        for page in pages:
            offset = page * per_page
            n_plot = min(per_page, k_vocab - offset)
            page_centers = self.centers[offset:offset + n_plot]
            ylim = float(np.abs(page_centers).max()) * 1.25 or 1.0
            fig, axes = plt.subplots(n_row, n_col,
                                     figsize=(n_col * 3, n_row * 2))
            axes = np.atleast_1d(axes).ravel()
            for cell in range(per_page):
                ax = axes[cell]
                if cell >= n_plot:
                    ax.set_visible(False)
                    continue
                ci = offset + cell
                if segs is not None:
                    members = np.nonzero(ids == ci)[0]
                    take = (rng.choice(members, size=n_sample, replace=False)
                            if members.size > n_sample else members)
                    for si in take:
                        ax.plot(segs[si], lw=0.25, marker='o', ms=0.3,
                                c=cs[cell], alpha=0.5)
                ax.plot(self.centers[ci], lw=0.75, marker='o', ms=0.9,
                        c=cs[cell])
                ax.set_title(f'Seg #{ci + 1}, sz {int(self.lens[ci])}',
                             fontsize=8)
                ax.set_ylim([-ylim, ylim])
                ax.set_xticklabels([])
                ax.set_yticklabels([])
            title = (f'{self.fit_method} cluster centroid plot by frequency '
                     f'with k={self.k}, n={self.n_sig}, '
                     f'eps={self.cls_th}, page {page + 1} of {n_pages}')
            fig.suptitle(title)
            fig.tight_layout()
            if save:
                paths.append(save_fig_(title))
                plt.close(fig)
            else:
                plt.show()
        return paths

    def rank_frequency(self) -> Dict[str, np.ndarray]:
        """Cluster-size rank-frequency curve + power-law fit
        (reference ecg_tokenizer.py:443-487 / util/ecg.py fit_power_law)."""
        assert self.lens is not None
        freqs = np.sort(self.lens)[::-1].astype(np.float64)
        ranks = np.arange(1, freqs.size + 1, dtype=np.float64)
        a, b = fit_power_law(ranks, freqs)
        return {'ranks': ranks, 'freqs': freqs, 'coeff': a, 'exponent': b}


def fit_power_law(x: np.ndarray, y: np.ndarray) -> Tuple[float, float]:
    """Fit y = a * x^b by least squares in log-log space
    (reference util/ecg.py:96-113 uses scipy.optimize; log-log LS is the
    standard closed form)."""
    mask = (x > 0) & (y > 0)
    lx, ly = np.log(x[mask]), np.log(y[mask])
    b, log_a = np.polyfit(lx, ly, 1)
    return float(np.exp(log_a)), float(b)
