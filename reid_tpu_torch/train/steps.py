"""The train step and the eval forwards of the port.

Counterpart of `reid_tpu/train/steps.py`: `make_train_step` (the hot loop
of ref image_reid_train.py:75-97 and the XBM variant of
image_reid_train_xbm.py:88-92) and `embed_with_flip` (ref
image_reid_inference.py:78-135, inference_efficient). The eval forward is
the model's own call, so that a serving artifact can trace it; callers
serve under `torch.inference_mode`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..data.transforms import augment_apply, augment_draws
from ..losses import (hybrid_loss, update_dcc_luts, xbm_enqueue,
                      xbm_triplet_loss)
from ..models.factory import TRANSFORMERS
from .state import ReIDTrainState


def _rows(tree, rows: slice):
    """These rows of every tensor of a (nested) dict of draws."""
    if isinstance(tree, dict):
        return {k: _rows(v, rows) for k, v in tree.items()}
    return tree[rows]


def make_train_step(cfg: Config, use_xbm_gate: bool = False,
                    generator: Optional[torch.Generator] = None, mesh=None):
    """train_step(state, batch) -> (state, metrics), updating `state` in
    place. In order: the augmentation of uint8 images (draws from
    `generator`, or the batch's own "aug_draws"); the train-mode forward,
    which updates the BatchNorm statistics (a transformer's dropout masks
    drawn from `generator` too, on the device; a dropout rate of 0 needs
    none); the f32 hybrid loss, plus the XBM triplet while "xbm_active"
    under `use_xbm_gate`; gradients for the parameters and the centers;
    the clipped model update and the rescaled center update; the DCC
    tables from the logits; the XBM enqueue.

    batch: images (B, H, W, 3) uint8 or normalized float, labels (B,),
    cams (B,) and weights (B,) optional (the cams feed the camera bias
    under `cam_factor` > 0 and the transformers' SIE table), xbm_active a
    bool (default True). Nothing is read back to the host: metrics are
    device scalars.
    Under PK sampling with K dividing B, each class has exactly K
    instances in a batch, which bounds the DCC table's rounds without a
    host read; without PK sampling the bound is B (the rounds past a
    batch's largest class write only the table's spare row), as in
    `plr_train`.

    Data parallel over a `parallel.Mesh` of more than one rank: `batch`
    holds this rank's rows (`parallel.place_batch`) and the step is the
    step of the global batch. The augmentation draws are made for the
    global batch (the generators of all ranks agree) and sliced; the
    forward runs under `global_batch_stats`; the f32 feature and logits
    are all-gathered with autograd, with the labels and weights, so the
    hybrid loss, the batch-hard mining, the center, DCC and XBM terms
    and the table updates see the global batch on every rank; the
    parameter gradients are summed over the ranks and scaled
    (`parallel.all_reduce_mean_grads`), the center gradient is already
    the global one. Every rank then holds the same state."""
    from ..models.layers import global_batch_stats
    from ..parallel.mesh import all_gather_rows, all_reduce_mean_grads

    dp = mesh is not None and mesh.collective
    group = mesh.stats_group if dp else None
    k = cfg.train.num_instances
    rounds = k if k > 0 and cfg.train.batch_size % k == 0 else None
    transformer = cfg.model.backbone in TRANSFORMERS
    use_cam = cfg.model.cam_factor > 0 or transformer
    drop = {"rng": generator} if transformer else {}

    def train_step(state: ReIDTrainState, batch: dict):
        images, labels = batch["images"], batch["labels"]
        weights = batch.get("weights")
        if images.dtype == torch.uint8:
            draws = batch.get("aug_draws")
            if draws is None:
                b, h, w, _ = images.shape
                draws = augment_draws(
                    generator, b * (mesh.size if dp else 1), h, w,
                    pad=cfg.data.pad, device=images.device)
            if dp:
                draws = _rows(draws, mesh.rows(
                    draws["flip_u"].shape[0]))
            images = augment_apply(images, draws, pad=cfg.data.pad,
                                   flip_prob=cfg.data.flip_prob,
                                   erase_prob=cfg.data.random_erasing_prob)
        with global_batch_stats(group):
            feature, logits = state.model(
                images, batch.get("cams") if use_cam else None, train=True,
                **drop)
        feature = feature.to(torch.float32)
        logits = logits.to(torch.float32)
        if dp:
            feature = all_gather_rows(feature, mesh, grad=True)
            logits = all_gather_rows(logits, mesh, grad=True)
            labels = all_gather_rows(labels, mesh)
            if weights is not None:
                weights = all_gather_rows(weights, mesh)
        centers = state.loss_state.centers.detach().requires_grad_()
        total, aux = hybrid_loss(
            state.loss_state._replace(centers=centers), feature, logits,
            labels, cfg.loss, weights=weights)
        if use_xbm_gate and state.xbm is not None:
            xbm_l = xbm_triplet_loss(feature, labels, state.xbm)
            if batch.get("xbm_active", True):
                total = total + xbm_l
            aux["xbm"] = xbm_l
        params = state.params()
        grads = torch.autograd.grad(total, params + [centers],
                                    allow_unused=True,
                                    materialize_grads=True)
        state.tx.apply(params, all_reduce_mean_grads(grads[:-1], mesh),
                       state.opt_state)
        new_centers = state.center_tx.apply(centers.detach(), grads[-1])
        dcc = state.loss_state.dcc
        if cfg.loss.use_dcc:
            dcc = update_dcc_luts(dcc, logits, labels,
                                  momentum=cfg.loss.dcc_momentum,
                                  rounds=rounds or labels.shape[0])
        state.loss_state = state.loss_state._replace(centers=new_centers,
                                                     dcc=dcc)
        if use_xbm_gate and state.xbm is not None:
            state.xbm = xbm_enqueue(state.xbm, feature, labels)
        state.step += 1
        metrics = {"loss": total.detach(),
                   **{k: v.detach() for k, v in aux.items()}}
        return state, metrics

    return train_step


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                           min=1e-12)


def embed_with_flip(model, images: torch.Tensor) -> torch.Tensor:
    """Dual-pass TTA embedding: the normal and the horizontally flipped
    batch through one forward; [l2n(feat) || l2n(logits)] averaged over the
    two views and L2-normalized. A dual-head model (PLR-OSNet, whose
    logits are a pair) embeds its feature alone, l2n(feat), as the
    reference's eval path does (ref plr_osnet.py:107-110)."""
    both = torch.cat([images, torch.flip(images, dims=(2,))], dim=0)
    feats, logits = model(both)
    b = images.shape[0]
    if isinstance(logits, tuple):
        emb = l2n(feats.to(torch.float32))
    else:
        emb = torch.cat([l2n(feats.to(torch.float32)),
                         l2n(logits.to(torch.float32))], dim=1)
    return l2n(0.5 * (emb[:b] + emb[b:]))


def embed_single(model, images: torch.Tensor) -> torch.Tensor:
    """One view: l2n([l2n(feat) || l2n(logits)]). A dual-head model is
    refused: the JAX package's one-view embed (`extract_embeddings` and
    the serving step without the flip) fails on its logits pair, so
    there is no such path to follow."""
    f, lg = model(images)
    if isinstance(lg, tuple):
        raise ValueError("a dual-head model (plr_osnet) embeds only with "
                         "tta_flip, as in the JAX package")
    return l2n(torch.cat([l2n(f.to(torch.float32)),
                          l2n(lg.to(torch.float32))], dim=1))
