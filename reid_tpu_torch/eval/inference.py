"""Retrieval inference and evaluation (ref `reid/image_reid_inference.py`).

Counterpart of `reid_tpu/eval/inference.py:run_inference` (ref :161-320):
gallery + query TTA embeddings -> merge -> camera de-bias -> k-reciprocal
Jaccard (+ the Market attribute prior, where given) -> DBSCAN -> tracklet
smoothing -> Jaccard again -> CMC/mAP, or plain dot-product scores when
re-ranking is off. `evaluate_features` is the part after the embedding, so
that the same features can go through it on the card and on the CPU. With
a `parallel.Mesh` of several ranks (`mesh=`), every rank embeds both sets
and both Jaccard calls run row-sharded over the ranks
(`ops.rerank.compute_jaccard_distance_sharded`), the faiss IndexShards
role; every rank returns the same CMC / mAP.

With a `timing` dict, each stage's seconds are added to it under its name
(embed, debias, jaccard1, dbscan, smoothing, jaccard2, eval), with the
device synchronized at each boundary, and the steps of each Jaccard call
under "jaccard1_steps" and "jaccard2_steps" (see `ops/rerank.py`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.camera import diminish_camera_bias, smooth_tracklets
from ..ops.dbscan import dbscan_precomputed
from ..ops.rerank import jaccard_distance
from ..train.image_train import extract_embeddings
from ..utils.timing import StageTimer
from .cmc_map import evaluate_all, evaluate_rerank


def _steps(timing: Optional[dict], name: str) -> Optional[dict]:
    return None if timing is None else timing.setdefault(name, {})


def evaluate_features(qf: torch.Tensor, gf: torch.Tensor, query, gallery,
                      cfg, rerank: bool = True, verbose: bool = True,
                      timing: Optional[Dict[str, float]] = None,
                      keep: Optional[dict] = None,
                      attribute_dist: Optional[np.ndarray] = None,
                      mesh=None):
    """(CMC, mAP) from query and gallery embeddings on one device, or with
    the Jaccard row-sharded over `mesh`.
    `query` and `gallery` give `labels`, `cams` and `seqs` (numpy).
    `attribute_dist` ((N, N) over [gallery ; query], `eval/attributes.py`)
    is added to the first Jaccard distances, as the reference does. With
    `keep`, the final merged distance matrix is stored under "dists"."""
    dev = gf.device
    stages = StageTimer(timing, dev)
    gl, gc, gs = gallery.labels, gallery.cams, gallery.seqs
    ql, qc, qs = query.labels, query.cams, query.seqs
    if not rerank:
        out = evaluate_all(qf, ql, qc, gf, gl, gc, verbose=verbose)
        stages.mark("eval")
        return out

    # merged = [gallery ; query] (ref :270-272)
    merged = torch.cat([gf, qf])
    cams = np.concatenate([gc, qc])
    n_g = len(gf)
    r = cfg.retrieval
    merged = diminish_camera_bias(
        merged, torch.as_tensor(cams, device=dev),
        lambda_reg=r.cam_bias_lambda, num_cams=int(cams.max()) + 1)
    stages.mark("debias")

    sparse_s = r.rerank_sparse_s or None
    dists = jaccard_distance(merged, k1=r.k1, k2=r.k2, sparse_s=sparse_s,
                             search_option=r.search_option,
                             timing=_steps(timing, "jaccard1_steps"),
                             mesh=mesh)
    if attribute_dist is not None:
        dists = dists + torch.as_tensor(attribute_dist, device=dev)
    stages.mark("jaccard1")

    # DBSCAN over the merged distances -> pseudo groups; tracklet id =
    # seq * num_labels + pseudo label (ref :290-310)
    labels = dbscan_precomputed(
        dists.cpu().numpy(), eps=r.dbscan_eps,
        min_samples=min(r.dbscan_min_samples, int(cams.max()) + 2))
    num_labels = int(labels.max()) + 1 if labels.max() >= 0 else 0
    stages.mark("dbscan")
    if num_labels > 0:
        seqs = np.concatenate([gs, qs])
        tracklet_ids = np.where(labels >= 0, seqs * num_labels + labels, -1)
        merged = smooth_tracklets(
            merged, torch.as_tensor(tracklet_ids, device=dev),
            alpha=r.smooth_tracklet_alpha)
        stages.mark("smoothing")
        del dists
        dists = jaccard_distance(merged, k1=r.k1, k2=r.k2, sparse_s=sparse_s,
                                 timing=_steps(timing, "jaccard2_steps"),
                                 mesh=mesh)
        stages.mark("jaccard2")

    # query-to-gallery block of the merged distance matrix
    out = evaluate_rerank(dists[n_g:, :n_g], ql, qc, gl, gc, verbose=verbose)
    stages.mark("eval")
    if keep is not None:
        keep["dists"] = dists
    return out


def run_inference(model, query, gallery, cfg, rerank: bool = True,
                  verbose: bool = True,
                  embed_fn: Optional[Callable] = None, device="cuda",
                  timing: Optional[Dict[str, float]] = None,
                  keep: Optional[dict] = None,
                  attribute_dist: Optional[np.ndarray] = None, mesh=None):
    """Returns (CMC, mAP). Follows ref image_reid_inference.py main
    :242-320. `embed_fn` (images [0, 255] -> embeddings: the int8 serving
    embed, or a loaded serving artifact) replaces the model's TTA
    extractor, and `model` may then be None. With `keep`, the embeddings
    are stored under "qf" and "gf" (and the final distances, see
    `evaluate_features`); `attribute_dist` and `mesh` go to
    `evaluate_features`."""
    stages = StageTimer(timing, device)
    bs = cfg.train.batch_size
    if embed_fn is not None:
        from .serving import extract_embeddings_with
        gf = extract_embeddings_with(embed_fn, gallery, bs, device)
        qf = extract_embeddings_with(embed_fn, query, bs, device)
    else:
        tta = cfg.retrieval.tta_flip
        gf = extract_embeddings(model, gallery, bs, tta, device)
        qf = extract_embeddings(model, query, bs, tta, device)
    stages.mark("embed")
    if keep is not None:
        keep.update(qf=qf, gf=gf)
    return evaluate_features(qf, gf, query, gallery, cfg, rerank=rerank,
                             verbose=verbose, timing=timing, keep=keep,
                             attribute_dist=attribute_dist, mesh=mesh)
