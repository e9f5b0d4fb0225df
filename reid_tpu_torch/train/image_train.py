"""Image-ReID training and whole-dataset embedding of the port.

Counterpart of `reid_tpu/train/image_train.py` (ref
`reid/image_reid_train.py`), on one device or data-parallel over a
`parallel.Mesh` (`mesh=`, the JAX package's GSPMD data parallelism):
  * `train_cnn` (ref :39-112): PK loader, device augmentation, the hybrid
    loss, the epoch-0 DCC seeding from class-mean logits
    (`seed_dcc_luts`, ref generate_centers :70-74), and the `.npz`
    checkpoint (flax naming, `utils/flax_bridge.py`) where the JAX package
    writes orbax;
  * the continual phase (ref :342-556): `produce_pseudo_data` (TTA embed
    -> camera de-bias -> Jaccard, whose ranking is kernel K6 and dense
    min-sum kernel K7 -> DBSCAN -> centroids), `expand_classifier` and
    `train_continual` (per-sample weights: pseudo 1 / real 0, over B);
  * `extract_embeddings` (ref inference_efficient,
    image_reid_inference.py:78-135).

One deliberate difference: the JAX package's `train_continual` keeps the
optimizer that `expand_classifier` built (the source run's lr and
schedule over one step an epoch), so the continual lr of 7e-5 that it
sets is never used; the port builds the continual optimizer from the
continual configuration.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..data.dataset import ReIDDataset
from ..data.loader import make_eval_loader, make_train_loader
from ..data.transforms import inference_batch
from ..losses import DCCState, normalize
from ..models import build_model
from .state import ReIDTrainState, create_train_state, make_optimizers
from .steps import embed_single, embed_with_flip, make_train_step


@torch.no_grad()
def seed_dcc_luts(state: ReIDTrainState, dataset: ReIDDataset,
                  batch_size: int, num_classes: int) -> ReIDTrainState:
    """Both DCC tables <- the L2-normalized per-class means of the eval
    forward's logits over the whole train set (ref generate_centers,
    image_reid_train.py:70-74). The eval loader wraps its last batch and,
    as in the JAX package, the wrapped rows count too. The sums are 0/1
    matmuls, which add in one order on every run."""
    model = state.model
    dev = next(model.parameters()).device
    sums = torch.zeros((num_classes, num_classes), device=dev)
    counts = torch.zeros((num_classes,), device=dev)
    for batch in make_eval_loader(dataset, batch_size, device=dev):
        _, logits = model(inference_batch(batch["images"]))
        onehot = F.one_hot(batch["labels"].long(), num_classes).to(
            torch.float32)
        sums += onehot.T @ logits.to(torch.float32)
        counts += onehot.sum(0)
    feats = normalize(sums / torch.clamp(counts, min=1.0)[:, None])
    state.loss_state = state.loss_state._replace(
        dcc=DCCState(lut_ccc=feats, lut_icc=feats.clone()))
    return state


def checkpoint_path(ckpt_dir: str, dataset: str) -> str:
    return os.path.join(ckpt_dir, f"cnn_net_checkpoint_{dataset}.npz")


def train_cnn(cfg: Config, dataset: ReIDDataset,
              state: Optional[ReIDTrainState] = None, use_xbm: bool = False,
              log_every: int = 50, ckpt_dir: str = "checkpoint",
              ckpt: str = "", device="cuda", mesh=None
              ) -> Tuple[ReIDTrainState, list]:
    """The train loop (ref train_cnn :39-112 and its XBM variant). Without
    `state`, a fresh one: the model and the centers drawn from a
    generator seeded `cfg.train.seed`, the model warm-started from the
    `.npz` `ckpt` when given (ref --ckpt, :42-45). Each step's
    augmentation draws come from a device generator seeded seed + 1. The
    loss is read back every `log_every` steps (the only host read of the
    loop) and returned; the checkpoint goes to `ckpt_dir`.

    With a `parallel.Mesh` of p > 1 ranks (B divisible by p), the loop is
    data parallel and each step equals the step at world 1: every rank
    starts from rank 0's model and tables (`replicate`), draws the same
    PK epoch and loads its rows of each batch (`make_train_loader(shard=)`),
    and runs `make_train_step(mesh=)`; only rank 0 writes the
    checkpoint."""
    from ..parallel.mesh import replicate
    from ..utils.flax_bridge import (flax_variables, load_flax_variables,
                                     save_npz)

    dp = mesh is not None and mesh.collective
    if dp and not mesh.member:
        raise ValueError("this rank is outside the mesh (fit_mesh keeps the "
                         "first ranks whose count divides the batch)")
    if dp and cfg.train.batch_size % mesh.size:
        raise ValueError(f"batch_size {cfg.train.batch_size} not divisible "
                         f"by mesh size {mesh.size}")
    bs = cfg.train.batch_size
    steps_per_epoch = max(len(dataset) // bs, 1)
    if state is None:
        gen = torch.Generator().manual_seed(cfg.train.seed)
        model = build_model(cfg.model.backbone,
                            num_classes=cfg.model.num_classes,
                            num_cams=cfg.model.num_cams,
                            dtype=getattr(torch, cfg.model.dtype),
                            device=device, generator=gen,
                            renorm=cfg.model.renorm)
        if ckpt:
            load_flax_variables(model, ckpt)
        state = create_train_state(model, cfg, steps_per_epoch, gen)
    dev = next(state.model.parameters()).device
    if dp:
        replicate(mesh, state.model)
        replicate(mesh, [state.loss_state.centers, *state.loss_state.dcc])
    train_step = make_train_step(
        cfg, use_xbm_gate=use_xbm,
        generator=torch.Generator(dev).manual_seed(cfg.train.seed + 1),
        mesh=mesh)
    shard = (mesh.rank, mesh.size) if dp else (0, 1)

    loss_stats = []
    for epoch in range(cfg.train.epochs):
        if epoch == 0 and cfg.loss.use_dcc:
            state = seed_dcc_luts(state, dataset, bs, cfg.model.num_classes)
        loader = make_train_loader(dataset, bs, cfg.train.num_instances,
                                   seed=cfg.train.seed, epoch=epoch,
                                   device=dev, shard=shard)
        t0 = time.time()
        for i, batch in enumerate(loader):
            step_batch = {"images": batch["images"],
                          "labels": batch["labels"], "cams": batch["cams"]}
            if use_xbm:
                step_batch["xbm_active"] = epoch > cfg.loss.xbm_start_epoch
            # the continual phase weighs every batch (ref :452): real
            # samples 0, pseudo 1, over the batch size
            if dataset.cross_domain:
                step_batch["weights"] = _continual_weights(batch["weights"],
                                                           bs)
            state, metrics = train_step(state, step_batch)
            if i % log_every == 0:
                loss = float(metrics["loss"])
                loss_stats.append(loss)
                print(f"epoch {epoch} step {i}: loss={loss:.4f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
    if not dp or mesh.rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        save_npz(checkpoint_path(ckpt_dir, cfg.data.dataset),
                 flax_variables(state.model))
    return state, loss_stats


@torch.inference_mode()
def extract_embeddings(model, dataset: ReIDDataset, batch_size: int,
                       tta_flip: bool = True, device="cuda") -> torch.Tensor:
    """(len(dataset), D) f32 embeddings on `device`: TTA dual pass with
    `tta_flip`, one view otherwise. The loader wraps the last batch; its
    extra rows are cut off here."""
    feats = []
    for batch in make_eval_loader(dataset, batch_size, device=device):
        images = inference_batch(batch["images"])
        feats.append(embed_with_flip(model, images) if tta_flip
                     else embed_single(model, images))
    return torch.cat(feats)[:len(dataset)]


def _continual_weights(flags: torch.Tensor, batch_size: int
                       ) -> torch.Tensor:
    """Per-sample weights of the continual phase: flag 0 for real
    (source) samples, 1 for pseudo (data_prepare.py:88-89), over the
    (global) batch size (image_reid_train.py:452)."""
    return flags.to(torch.float32) / batch_size


def produce_pseudo_data(state: ReIDTrainState, target_dataset: ReIDDataset,
                        cfg: Config, min_yield: float = 0.2, mesh=None
                        ) -> Tuple[list, np.ndarray, int]:
    """Pseudo-label a target-domain train set (ref :342-402): TTA embed ->
    camera de-bias -> Jaccard (`ops.rerank.jaccard_distance` with the
    configuration's search plan) -> DBSCAN on the host. Returns the pseudo
    records (pids offset by the source class count), the cluster
    centroids and the number of clusters; refuses a clustering with fewer
    clusters than `min_yield` of the target's train ids (ref
    image_reid_inference.py:304). With a `mesh` of several ranks, every
    rank embeds the whole set and the Jaccard runs row-sharded
    (`compute_jaccard_distance_sharded`); every rank gets the same
    records."""
    from ..cli import full_f32
    from ..ops.camera import diminish_camera_bias
    from ..ops.dbscan import dbscan_precomputed
    from ..ops.rerank import jaccard_distance

    dev = next(state.model.parameters()).device
    r = cfg.retrieval
    with full_f32(), torch.inference_mode():
        emb = extract_embeddings(state.model, target_dataset,
                                 cfg.train.batch_size, r.tta_flip, dev)
        cams = torch.as_tensor(target_dataset.cams, device=dev)
        emb = diminish_camera_bias(emb, cams, lambda_reg=r.cam_bias_lambda,
                                   num_cams=int(target_dataset.cams.max())
                                   + 1)
        jac = jaccard_distance(emb, k1=r.k1, k2=r.k2,
                               sparse_s=r.rerank_sparse_s or None,
                               search_option=r.search_option,
                               mesh=mesh)
        jac = jac.cpu().numpy()
    emb = emb.cpu().numpy()
    labels = dbscan_precomputed(jac, eps=r.dbscan_eps,
                                min_samples=r.dbscan_min_samples)
    del jac
    num_clusters = int(labels.max()) + 1 if labels.max() >= 0 else 0
    if num_clusters < min_yield * target_dataset.num_train_pids:
        raise RuntimeError(
            f"pseudo-label yield too low: {num_clusters} clusters < "
            f"{min_yield:.0%} of {target_dataset.num_train_pids} train pids")
    base = cfg.model.num_classes
    kept = np.flatnonzero(labels >= 0)
    records = [(target_dataset.records[i][0], base + int(labels[i]),
                target_dataset.records[i][2], target_dataset.records[i][3])
               for i in kept]
    centroids = np.zeros((num_clusters, emb.shape[1]), np.float32)
    for lbl in range(num_clusters):
        centroids[lbl] = emb[kept[labels[kept] == lbl]].mean(0)
    print(f"pseudo labels: {num_clusters} clusters over "
          f"{len(records)}/{len(target_dataset)} images", flush=True)
    return records, centroids, num_clusters


def expand_classifier(state: ReIDTrainState, cfg: Config, num_new: int,
                      centroids: Optional[np.ndarray] = None
                      ) -> Tuple[ReIDTrainState, Config]:
    """Classifier surgery of the continual phase (ref :405-412): the head
    widened to num_classes + num_new, the prior rows kept, the new rows
    seeded from the centroids' first feat_dim dims (scaled to the old
    rows' mean norm) or 0.001 N(0, 1) noise from `np.random.default_rng(0)`;
    the centers widened with N(0, 1) rows from `default_rng(1)`, the DCC
    tables zero-padded; fresh optimizer state, as in the JAX package."""
    model = state.model
    # (feat, C) in flax's layout and memory order, so that numpy sums as
    # it sums the flax kernel
    kernel = np.ascontiguousarray(
        model.classifier.weight.detach().cpu().numpy().T)
    feat_dim, n_old = kernel.shape
    new_cols = 0.001 * np.random.default_rng(0).normal(
        size=(feat_dim, num_new)).astype(kernel.dtype)
    if centroids is not None and centroids.shape[0] == num_new:
        seed = centroids[:, :feat_dim].T.astype(kernel.dtype)
        norm = np.linalg.norm(seed, axis=0, keepdims=True)
        new_cols = np.where(norm > 0, seed / np.maximum(norm, 1e-9) *
                            np.linalg.norm(kernel, axis=0).mean(), new_cols)
    kernel = np.concatenate([kernel, new_cols], axis=1)
    n_total = n_old + num_new
    dev = next(model.parameters()).device

    centers = state.loss_state.centers.cpu().numpy()
    centers = np.concatenate([centers, np.random.default_rng(1).normal(
        size=(num_new, centers.shape[1])).astype(centers.dtype)])
    luts = []
    for old in state.loss_state.dcc:
        lut = torch.zeros((n_total, n_total), device=dev)
        lut[:n_old, :n_old] = old
        luts.append(lut)

    new_cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    num_classes=n_total))
    sd = model.state_dict()
    sd["classifier.weight"] = torch.from_numpy(np.ascontiguousarray(
        kernel.T))
    wide = build_model(new_cfg.model.backbone, num_classes=n_total,
                       num_cams=new_cfg.model.num_cams, dtype=model.dtype,
                       device=dev, renorm=new_cfg.model.renorm)
    wide.load_state_dict(sd)
    fresh = create_train_state(wide, new_cfg, 1, torch.Generator()
                               .manual_seed(cfg.train.seed + 2))
    fresh.loss_state = fresh.loss_state._replace(
        centers=torch.from_numpy(centers).to(dev), dcc=DCCState(*luts))
    return fresh, new_cfg


def train_continual(cfg: Config, state: ReIDTrainState,
                    source_dataset: ReIDDataset, target_records: list,
                    centroids: np.ndarray, num_new: int, epochs: int = 40,
                    log_every: int = 50, ckpt_dir: str = "checkpoint",
                    mesh=None) -> Tuple[ReIDTrainState, list]:
    """The continual phase (ref train_cnn_continual :405-479): merge the
    pseudo records into the source dataset, widen the classifier, and
    train with the weighted hybrid loss plus the smoothed CE (tao 2) at
    Adam lr 7e-5 (ref :415-424)."""
    source_dataset.add_pseudo(target_records, num_new)
    source_dataset.set_cross_domain()
    state, cfg = expand_classifier(state, cfg, num_new, centroids)
    cfg = cfg.replace(
        loss=dataclasses.replace(cfg.loss, use_ce=True, tao=2.0),
        train=dataclasses.replace(cfg.train, epochs=epochs, lr=7e-5,
                                  warmup_epochs=1, hold_epochs=20))
    state.tx, state.center_tx = make_optimizers(
        cfg, max(len(source_dataset) // cfg.train.batch_size, 1))
    return train_cnn(cfg, source_dataset, state=state, log_every=log_every,
                     ckpt_dir=ckpt_dir, mesh=mesh)
