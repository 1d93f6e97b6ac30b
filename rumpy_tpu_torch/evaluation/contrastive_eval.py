"""ContrastiveEval: embedding quality of a degradation predictor.

Port of ``rumpy_tpu/evaluation/contrastive_eval.py``. The embeddings of an
eval set and their degradation classes stay on the device, and the
clustering scores are computed there in float64 with the definitions of
scikit-learn's ``davies_bouldin_score``, ``calinski_harabasz_score`` and
``silhouette_score`` (Euclidean), without scikit-learn; one copy brings
the three numbers back. :meth:`ContrastiveEval.dump_embeddings` writes the
npz and a CSV (pandas' layout, by the csv module), and
:meth:`ContrastiveEval.scatter_plot` a t-SNE (or UMAP) map of them
(scikit-learn and matplotlib, imported when called).
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rumpy_tpu_torch.models import contrastive_labelling as cl


def clustering_scores(embeddings, labels) -> Dict[str, float]:
    """Davies-Bouldin, Calinski-Harabasz and silhouette scores of
    ``embeddings`` (N, D) clustered by ``labels`` (N,), in float64 on the
    embeddings' device. Empty when there are fewer than two classes or no
    more samples than classes."""
    x = torch.as_tensor(embeddings).to(torch.float64)
    lab = torch.as_tensor(labels, device=x.device)
    uniq, inv = torch.unique(lab, return_inverse=True)
    k, n = int(uniq.numel()), x.shape[0]
    if k < 2 or n <= k:
        return {}
    counts = torch.bincount(inv, minlength=k).to(torch.float64)
    cent = torch.zeros(k, x.shape[1], dtype=torch.float64, device=x.device)
    cent.index_add_(0, inv, x)
    cent = cent / counts[:, None]

    # Calinski-Harabasz: between- over within-cluster dispersion
    resid = x - cent[inv]
    extra = (counts * ((cent - x.mean(dim=0)) ** 2).sum(dim=1)).sum()
    intra = (resid ** 2).sum()
    ch = torch.where(intra == 0, torch.ones_like(intra),
                     extra * (n - k) / (intra * (k - 1)))

    # Davies-Bouldin: mean over clusters of the worst (s_i + s_j) / d_ij
    s = torch.zeros(k, dtype=torch.float64, device=x.device)
    s.index_add_(0, inv, resid.norm(dim=1))
    s = s / counts
    cd = torch.cdist(cent, cent, compute_mode="donot_use_mm_for_euclid_dist")
    degenerate = (s.abs() <= 1e-8).all() | (cd.abs() <= 1e-8).all()
    ratio = (s[:, None] + s[None, :]) / torch.where(cd == 0, torch.inf, cd)
    db = torch.where(degenerate, torch.zeros_like(intra), ratio.max(dim=1).values.mean())

    # silhouette: (b - a) / max(a, b) per sample, 0 in a cluster of one
    dist = torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist")
    dist.fill_diagonal_(0.0)
    onehot = torch.nn.functional.one_hot(inv, k).to(torch.float64)
    to_cluster = dist @ onehot  # (N, k) sums of distances
    own = counts[inv]
    a = to_cluster.gather(1, inv[:, None])[:, 0] / (own - 1)
    mean_to = to_cluster / counts[None, :]
    b = torch.where(onehot.bool(), torch.inf, mean_to).min(dim=1).values
    sil = torch.nan_to_num((b - a) / torch.maximum(a, b))
    sil = torch.where(own == 1, torch.zeros_like(sil), sil).mean()

    db, ch, sil = torch.stack([db, ch, sil]).cpu().tolist()
    return {"davies_bouldin": db, "calinski_harabasz": ch, "silhouette": sil}


class ContrastiveEval:
    def __init__(self, handler, state, m_map=None, valid=None, mags=None,
                 num_classes=0, labelling_strategy="default"):
        self.handler = handler
        self.state = state
        self.m_map = m_map or {}
        self.valid = valid or []
        self.mags = mags or []
        self.num_classes = num_classes
        self.labelling_strategy = labelling_strategy

    def generate_data_encoding(self, loader) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embeddings (N, 256), classes (N,)) of every batch of ``loader``
        (the first crop of a multi-crop batch), on the handler's device;
        class 0 where the set has no metadata."""
        device = self.handler.device
        embeddings: List[torch.Tensor] = []
        labels: List[torch.Tensor] = []
        for batch in loader:
            imgs = batch["lr"]
            if isinstance(imgs, list):
                imgs = np.stack(imgs)
            if imgs.ndim == 5:  # multi-crop: the first crop
                imgs = imgs[:, 0]
            emb = self.handler.run_embedding(self.state, imgs)
            embeddings.append(emb)
            metas = batch.get("metadata")
            if metas is not None and np.size(metas) and self.m_map and self.num_classes:
                metas = torch.as_tensor(np.asarray(metas, np.float32), device=device)
                labels.append(cl.assign_classes(metas, self.m_map, self.valid, self.mags,
                                                self.num_classes, self.labelling_strategy))
            else:
                labels.append(torch.zeros(emb.shape[0], dtype=torch.int64, device=device))
        return torch.cat(embeddings), torch.cat(labels)

    clustering_scores = staticmethod(clustering_scores)

    @staticmethod
    def dump_embeddings(embeddings, labels, path_prefix: str) -> None:
        """``<prefix>.npz`` (embeddings, labels) and ``<prefix>.csv``: a
        column per embedding dimension, named 0 .. D-1, and ``label``."""
        emb = torch.as_tensor(embeddings).cpu().numpy()
        lab = torch.as_tensor(labels).cpu().numpy()
        np.savez(path_prefix + ".npz", embeddings=emb, labels=lab)
        with open(path_prefix + ".csv", "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow([str(i) for i in range(emb.shape[1])] + ["label"])
            for row, label in zip(emb, lab):
                w.writerow([str(v) for v in row] + [str(label)])

    @staticmethod
    def scatter_plot(embeddings, labels, out_path: str, method: str = "tsne") -> Optional[str]:
        """A 2-D map of the embeddings coloured by class, written to
        ``out_path``: UMAP where ``method`` is "umap" and ``umap`` is
        installed, else scikit-learn's t-SNE (perplexity ``min(30, max(2,
        N // 3))``). None under 5 embeddings."""
        emb = torch.as_tensor(embeddings).cpu().numpy()
        lab = torch.as_tensor(labels).cpu().numpy()
        if len(emb) < 5:
            return None
        from rumpy_tpu_torch.utils.visualization import pyplot
        plt = pyplot()
        if method not in ("tsne", "umap"):
            raise ValueError(f"Unknown scatter method {method!r} (expected 'tsne' or 'umap')")
        if method == "umap":
            try:
                import umap
                pts = umap.UMAP(n_components=2).fit_transform(emb)
            except ImportError:
                method = "tsne"
        if method == "tsne":
            try:
                from sklearn.manifold import TSNE
            except ImportError as e:
                raise ImportError("the t-SNE scatter plot needs scikit-learn (sklearn), "
                                  "which is not installed") from e
            perp = min(30, max(2, len(emb) // 3))
            pts = TSNE(n_components=2, perplexity=perp).fit_transform(emb)
        fig, ax = plt.subplots(figsize=(6, 5))
        sc = ax.scatter(pts[:, 0], pts[:, 1], c=lab, cmap="tab20", s=12)
        fig.colorbar(sc, ax=ax, label="degradation class")
        ax.set_title(f"{method} embedding map")
        fig.tight_layout()
        fig.savefig(out_path)
        plt.close(fig)
        return out_path
