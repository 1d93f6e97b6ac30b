"""Face-recognition evaluation: identification ranks, CMC and ROC.

Port of ``rumpy_tpu/utils/face_recognition.py``: probe embeddings are
matched against a gallery; rank retrieval with tie resolution gives the
cumulative-match curve, and thresholded genuine/impostor decisions give
the ROC (AUC and equal-error rate). The rank and curve math is numpy, the
JAX package's own. The embedding network is pluggable:
:class:`FaceRecognizer` runs its ``extractor`` (the port's
``LightCNNFeatures`` or ``VGG16Features`` through
``models/feature_extractors.py::perceptual_loss_mechanism``, or any
callable on an NHWC float batch) on the extractor's device, default the
card, and reads the features back once a batch.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rumpy_tpu_torch.device import resolve_device, to_device


def distance_feats(v: np.ndarray, u: np.ndarray,
                   method: str = "l2") -> np.ndarray:
    """(N,F) x (M,F) -> (N,M) pairwise distances
    (metrics.py:442-455; sklearn distance_metrics equivalents)."""
    v = np.asarray(v, np.float64)
    u = np.asarray(u, np.float64)
    method = method.lower()
    if method in ("l2", "euclidean"):
        d2 = (np.sum(v ** 2, 1)[:, None] + np.sum(u ** 2, 1)[None]
              - 2.0 * v @ u.T)
        return np.sqrt(np.maximum(d2, 0.0))
    if method in ("l1", "cityblock", "manhattan"):
        return np.abs(v[:, None, :] - u[None, :, :]).sum(-1)
    if method == "cosine":
        vn = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
        un = u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-12)
        return 1.0 - vn @ un.T
    raise ValueError(
        "Distance method must be one of: l2, euclidean, l1, cityblock, "
        f"manhattan, cosine (got {method!r})")


def cumulative_match(probe_gallery_measure, probe_ids, gallery_ids,
                     mode: str = "dist", resolve_ties: bool = True,
                     tie_mode: str = "average", quick_probe: bool = False):
    """Rank-retrieval / CMC (metrics.py:600-727).

    :returns: id_rank2 (per-probe retrieval rank) when quick_probe, else
        (CMC_x ranks, CMC_y retrieval % at each rank, id_rank2).
    """
    if mode not in ("sim", "dist"):
        raise ValueError("mode must be 'dist' or 'sim'")
    if tie_mode not in ("optimistic", "pessimistic", "average"):
        raise ValueError("tie_mode must be optimistic/pessimistic/average")
    m = np.asarray(probe_gallery_measure, np.float64)
    gallery_ids = list(gallery_ids)
    n_id = m.shape[0]
    id_rank2 = np.zeros(n_id)
    for ctr, person_id in enumerate(probe_ids):
        order = (np.flip(np.argsort(m[ctr])) if mode == "sim"
                 else np.argsort(m[ctr]))
        sorted_ids = [gallery_ids[x] for x in order]
        rank = int(np.where(np.asarray(sorted_ids) == person_id)[0][0]) + 1
        if resolve_ties:
            sorted_scores = m[ctr][order]
            score_idx = np.where(
                sorted_scores == sorted_scores[rank - 1])[0]
            same_score_ids = [sorted_ids[x] for x in score_idx]
            n_same = int(np.sum(np.asarray(same_score_ids) == person_id))
            n_unique = len(np.unique(np.asarray(same_score_ids)))
            if len(score_idx) > 1 and n_unique > 1:
                if tie_mode == "optimistic":
                    rank = score_idx[0] + 1
                elif tie_mode == "pessimistic":
                    rank = (score_idx[-1] + 1 if n_same == 1
                            else score_idx[0] + n_unique)
                else:  # average of best and worst possible ranks
                    worst = (score_idx[-1] + 1 if n_same == 1
                             else score_idx[0] + n_unique)
                    rank = ((score_idx[0] + 1) + worst) / 2.0
        id_rank2[ctr] = rank
    if quick_probe:
        return id_rank2
    cmc_x = list(range(1, len(gallery_ids) + 1))
    cmc_y = [float(np.sum(id_rank2 <= r) / n_id * 100.0)
             for r in cmc_x]
    return cmc_x, cmc_y, id_rank2


def calculate_accuracy(threshold, dist, actual_issame,
                       mode: str = "dist"):
    """TPR/FPR/accuracy at one threshold (metrics.py:730-755)."""
    dist = np.asarray(dist)
    actual = np.asarray(actual_issame, bool)
    if mode == "dist":
        predict = np.less(dist, threshold)
    elif mode == "sim":
        predict = np.greater(dist, threshold)
    else:
        raise ValueError("mode must be 'dist' or 'sim'")
    tp = np.sum(np.logical_and(predict, actual))
    fp = np.sum(np.logical_and(predict, ~actual))
    tn = np.sum(np.logical_and(~predict, ~actual))
    fn = np.sum(np.logical_and(~predict, actual))
    tpr = 0.0 if tp + fn == 0 else float(tp) / float(tp + fn)
    fpr = 0.0 if fp + tn == 0 else float(fp) / float(fp + tn)
    acc = float(tp + tn) / dist.size
    return tpr, fpr, acc


def roc_calc(dist, actual_issame=None, mode: str = "dist",
             thresh_min: float = 0.0, thresh_max: float = 1.01,
             thresh_step: float = 0.01):
    """Per-threshold mean TPR/FPR across probes (metrics.py:757-823)."""
    dist = np.asarray(dist)
    n_faces, n_id = dist.shape
    if actual_issame is None:
        actual_issame = np.eye(n_faces, n_id, dtype=bool)
    thresholds = np.arange(thresh_min, thresh_max, thresh_step)
    tprs = np.zeros((n_faces, len(thresholds)))
    fprs = np.zeros((n_faces, len(thresholds)))
    for pid in range(n_faces):
        for ti, t in enumerate(thresholds):
            tprs[pid, ti], fprs[pid, ti], _ = calculate_accuracy(
                t, dist[pid], actual_issame[pid], mode)
    return fprs.mean(0), tprs.mean(0), thresholds


def roc_main(dist, actual_issame=None, score_mode: str = "dist",
             thresh_min: float = 0.0, thresh_max: float = 1.01,
             thresh_step: float = 0.01):
    """ROC + AUC + equal-error rate (metrics.py:823-864). EER solved on
    the piecewise-linear interpolant of (fpr, tpr) — numpy bisection in
    place of scipy brentq."""
    if score_mode not in ("dist", "sim"):
        raise ValueError("mode must be 'dist' or 'sim'")
    fpr, tpr, thresholds = roc_calc(
        dist, actual_issame=actual_issame, mode=score_mode,
        thresh_min=thresh_min, thresh_max=thresh_max,
        thresh_step=thresh_step)
    order = np.argsort(fpr)
    fx, ty = fpr[order], tpr[order]
    auc = float(np.trapezoid(ty, fx))

    def f(x):
        return 1.0 - x - np.interp(x, fx, ty)
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2.0
        if f(lo) * f(mid) <= 0:
            hi = mid
        else:
            lo = mid
    eer = float((lo + hi) / 2.0)
    return auc, eer, fpr, tpr, thresholds


class FaceRecognizer:
    """Gallery-based face identification and verification scoring.
    ``extractor`` maps an NHWC float batch to (N, F) embeddings; it runs on
    its module's device, or on ``device`` (default "cuda") for a plain
    callable. Weight-gated extractors raise at construction, not here."""

    def __init__(self, extractor: Optional[Callable] = None, device=None):
        self.extractor = extractor
        self.device = device
        self.gallery: Optional[np.ndarray] = None
        self.gallery_ids: Optional[List] = None

    def _device(self) -> torch.device:
        module = getattr(self.extractor, "module", None)
        if isinstance(module, torch.nn.Module):
            for p in module.parameters():
                return p.device
        return resolve_device(self.device)

    def _extract(self, images) -> np.ndarray:
        """(N, F) float32 features of an NHWC batch (array or tensor)."""
        if self.extractor is None:
            raise RuntimeError(
                "FaceRecognizer needs an embedding extractor (e.g. a "
                "weight-loaded PerceptualExtractor) to process images")
        with torch.no_grad():
            feats = self.extractor(to_device(images, self._device(), torch.float32))
        feats = np.asarray(feats.float().cpu().numpy() if torch.is_tensor(feats) else feats)
        return feats.reshape(feats.shape[0], -1)

    def register_gallery(self, images=None, features=None,
                         gallery_ids=None) -> None:
        if features is None:
            features = self._extract(images)
        self.gallery = np.asarray(features)
        self.gallery = self.gallery.reshape(self.gallery.shape[0], -1)
        self.gallery_ids = (list(gallery_ids) if gallery_ids is not None
                            else list(range(self.gallery.shape[0])))

    def fr_rank(self, probes=None, probe_ids=None, features=None,
                method: str = "l2") -> np.ndarray:
        """Mean retrieval rank of each probe against the registered
        gallery (run_VGG_fr_rank, metrics.py:204-222)."""
        if self.gallery is None:
            raise RuntimeError("No gallery registered")
        if probe_ids is None:
            raise ValueError(
                "Need a probe ID to evaluate face recognition performance.")
        feats = features if features is not None else self._extract(probes)
        feats = np.asarray(feats).reshape(len(probe_ids), -1)
        dist = distance_feats(feats, self.gallery, method)
        return cumulative_match(dist, probe_ids, self.gallery_ids,
                                mode="dist", quick_probe=True)

    def full_package(self, probes=None, probe_ids=None, features=None,
                     method: str = "l2",
                     thresh_max: Optional[float] = None) -> Dict:
        """CMC + ROC summary for a probe set (full_package,
        metrics.py:867-913)."""
        if self.gallery is None:
            raise RuntimeError("No gallery registered")
        feats = features if features is not None else self._extract(probes)
        feats = np.asarray(feats).reshape(len(probe_ids), -1)
        dist = distance_feats(feats, self.gallery, method)
        scale = float(dist.max()) or 1.0
        norm_dist = dist / scale
        cmc_x, cmc_y, ranks = cumulative_match(
            dist, probe_ids, self.gallery_ids, mode="dist")
        issame = np.asarray(
            [[g == p for g in self.gallery_ids] for p in probe_ids], bool)
        auc, eer, fpr, tpr, thresholds = roc_main(
            norm_dist, actual_issame=issame,
            thresh_max=thresh_max or 1.01)
        return {"CMC_x": cmc_x, "CMC_y": cmc_y, "ranks": ranks,
                "mean_rank": float(ranks.mean()), "AUC": auc, "EER": eer,
                "FPR": fpr, "TPR": tpr, "thresholds": thresholds}


def plot_cmc(cmc_data: Dict[str, Tuple[Sequence, Sequence]],
             save_loc: str = ".", xlim=None, ylim=None) -> str:
    """CMC comparison plot to PDF (metrics.py:922+). cmc_data maps
    label -> (CMC_x, CMC_y)."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 5))
    for label, (x, y) in cmc_data.items():
        ax.plot(x, y, "-o", label=label, markersize=3)
    ax.set_xlabel("Rank")
    ax.set_ylabel("Rank retrieval rate (%)")
    ax.grid(True)
    ax.set_title("Cumulative Match Curve (CMC)")
    if xlim:
        ax.set_xlim(xlim)
    if ylim:
        ax.set_ylim(ylim)
    ax.legend()
    out = os.path.join(save_loc, "cmc_curves.pdf")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out
