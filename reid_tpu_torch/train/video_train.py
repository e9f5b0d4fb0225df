"""Video ReID training (ref `reid/video_reid_train.py`).

Counterpart of `reid_tpu/train/video_train.py`. `VideoTrackletDataset`
parses MOT16 gt.txt files into per-identity tracklets of `seq_len` crops
(pedestrian class only, the lamda box dilation, the tiny-box filter; a
short tracklet padded with its last crop, a longer one sampled without
replacement); it stays in numpy and PIL, reading the same frames and
drawing from the same `numpy.random.Generator` as the JAX package, so a
seed gives both packages the same batches. The step trains the 3-D
`video_resnet50` with the hybrid loss on its f32 2,048-wide feature and
logits, the DCC tables left at their zero init (the video loop never
seeds or updates them), MADGRAD(1e-4, weight decay 5e-4, momentum 0)
without a gradient clip under the staircase StepLR(300, 0.5), and the
centers by c - 0.5 gc / lamda.

`train_video` runs on one device, or data-parallel over a
`parallel.Mesh` (`mesh=`, the JAX package's `fit_mesh` / `replicate` /
`place_batch` form): every rank draws the same batches and keeps its
rows, the 3-D BatchNorms take global statistics, and the loss runs on
the all-gathered global batch, so a step at world p is the step at
world 1 (as `train.steps.make_train_step(mesh=)`).
"""

from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..losses import HybridLossState, hybrid_loss, init_hybrid_state
from ..models import build_model
from .optim import Madgrad
from .schedules import staircase_exponential_schedule

FEAT_DIM = 2048                        # the 3-D ResNet-50's feature width


class VideoTrackletDataset:
    """MOT16 gt.txt -> {identity: [(bbox, frame, seq_dir), ...]}."""

    def __init__(self, gt_paths: Sequence[str], seq_len: int = 10,
                 lamda: float = 1.0, prefix_image_path: str = "",
                 height: int = 256, width: int = 128):
        assert lamda >= 1.0
        self.seq_len = seq_len
        self.lamda = lamda
        self.prefix = prefix_image_path
        self.height = height
        self.width = width
        self.gt_info, self.labels = self._read_gt(gt_paths)

    def _read_gt(self, gt_paths):
        """Ref read_gt (:35-63): consecutive labels across sequences from
        the running (id - label) offset, so the rows of one file must come
        grouped by track id; class column 1 (pedestrian) only; the lamda
        dilation; boxes with w or h <= 10 skipped."""
        gt_info = defaultdict(list)
        label = -1
        diff = 0
        labels = []
        for path in gt_paths:
            with open(path) as f:
                for raw in f:
                    line = [float(v) for v in raw.strip().split(",")]
                    if len(line) < 8 or line[-2] != 1:
                        continue
                    if line[1] - label != diff:
                        label += 1
                        labels.append(label)
                        diff = line[1] - label
                    x, y, w, h = line[2:6]
                    if self.lamda > 1.0:
                        x = max(0.0, x - x * (self.lamda - 1) / 2)
                        y = max(0.0, y - y * (self.lamda - 1) / 2)
                        w *= self.lamda
                        h *= self.lamda
                    if w <= 10 or h <= 10 or x + w <= 10 or y + h <= 10:
                        continue
                    seq_dir = path.split(os.sep)[-3] if os.sep in path else ""
                    gt_info[label].append(((x, y, w, h), int(line[0]),
                                           seq_dir))
        return gt_info, labels

    def __len__(self):
        return len(self.labels)

    def load_sequence(self, item: int, rng: np.random.Generator):
        """(seq_len, H, W, 3) uint8 crops and the int label: each crop cut
        from its whole frame and resized bilinearly by PIL."""
        from PIL import Image

        infos = self.gt_info[item]
        if len(infos) < self.seq_len:
            infos = list(infos) + [infos[-1]] * (self.seq_len - len(infos))
        else:
            idx = rng.choice(len(infos), size=self.seq_len, replace=False)
            infos = [infos[i] for i in idx]
        crops = []
        for (x, y, w, h), frame, seq_dir in infos:
            p = os.path.join(self.prefix, seq_dir, "img1",
                             f"{frame:06d}.jpg")
            with Image.open(p) as im:
                im = im.convert("RGB")
                box = (round(max(0, x)), round(max(0, y)),
                       round(min(im.size[0], x + w)),
                       round(min(im.size[1], y + h)))
                crop = im.crop(box).resize((self.width, self.height),
                                           Image.BILINEAR)
            crops.append(np.asarray(crop, np.uint8))
        return np.stack(crops), self.labels[item]

    def batches(self, batch_size: int, rng: np.random.Generator):
        """Batches over a permutation of the identities, the last padded
        with the start of the permutation: {"images": (B, T, H, W, 3) f32
        in [0, 1], "labels": (B,) int32}, numpy."""
        order = rng.permutation(len(self))
        for s in range(0, len(order), batch_size):
            chunk = order[s:s + batch_size]
            if len(chunk) < batch_size:
                chunk = np.concatenate(
                    [chunk, order[:batch_size - len(chunk)]])
            seqs, labels = zip(*(self.load_sequence(int(i), rng)
                                 for i in chunk))
            yield {"images": np.stack(seqs).astype(np.float32) / 255.0,
                   "labels": np.asarray(labels, np.int32)}


@dataclasses.dataclass
class VideoTrainState:
    """What the video step reads and updates: the model (parameters and
    BatchNorm statistics), the centers and DCC tables, MADGRAD and its
    state."""
    model: torch.nn.Module
    loss_state: HybridLossState
    opt_state: dict
    tx: Madgrad

    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def create_video_train_state(model: torch.nn.Module, num_classes: int,
                             generator: torch.Generator) -> VideoTrainState:
    """A fresh state around `model`: centers (num_classes, 2048) drawn from
    `generator`, zero DCC tables, and MADGRAD(1e-4, weight decay 5e-4,
    momentum 0) under the staircase decay (1e-4, 300, 0.5) without a
    gradient clip (ref video_reid_train.py:115-116 builds bare MADGRAD),
    on the model's device."""
    dev = next(model.parameters()).device
    tx = Madgrad(staircase_exponential_schedule(1e-4, 300, 0.5),
                 weight_decay=5e-4, grad_clip=None, momentum=0.0)
    return VideoTrainState(
        model=model,
        loss_state=init_hybrid_state(num_classes, FEAT_DIM, generator, dev),
        opt_state=tx.init(list(model.parameters())), tx=tx)


def make_video_train_step(cfg: Config, mesh=None):
    """step(state, batch) -> (state, loss), updating `state` in place: the
    train-mode forward (which updates the BatchNorm statistics), the
    hybrid loss on the f32 feature and logits with the DCC tables as they
    are, gradients for the parameters and the centers, MADGRAD, and the
    centers' step c - 0.5 gc / lamda, the division by the constant lamda
    a multiplication by its f32 reciprocal as XLA compiles it. batch:
    images (B, T, H, W, 3) f32 and labels (B,) int32 on the model's
    device. The loss stays on the device: the step reads nothing back.
    Over a `mesh` of several ranks, `batch` holds this rank's rows: the
    forward runs under `global_batch_stats`, the feature, logits and
    labels are all-gathered (the first two with autograd) and the
    parameter gradients summed over the ranks and scaled."""
    from ..models.layers import global_batch_stats
    from ..parallel.mesh import all_gather_rows, all_reduce_mean_grads

    inv_lamda = float(np.float32(1.0) / np.float32(cfg.loss.center_lamda))
    dp = mesh is not None and mesh.collective

    def step(state: VideoTrainState, batch: dict):
        with global_batch_stats(mesh.stats_group if dp else None):
            feature, logits = state.model(batch["images"], train=True)
        feature = feature.to(torch.float32)
        logits = logits.to(torch.float32)
        labels = batch["labels"]
        if dp:
            feature = all_gather_rows(feature, mesh, grad=True)
            logits = all_gather_rows(logits, mesh, grad=True)
            labels = all_gather_rows(labels, mesh)
        centers = state.loss_state.centers.detach().requires_grad_()
        total, _ = hybrid_loss(state.loss_state._replace(centers=centers),
                               feature, logits, labels, cfg.loss)
        params = state.params()
        grads = torch.autograd.grad(total, params + [centers],
                                    allow_unused=True,
                                    materialize_grads=True)
        state.tx.apply(params, all_reduce_mean_grads(grads[:-1], mesh),
                       state.opt_state)
        with torch.no_grad():
            new_centers = centers.detach() - (0.5 * grads[-1]) * inv_lamda
        state.loss_state = state.loss_state._replace(centers=new_centers)
        return state, total.detach()

    return step


def to_device(batch: dict, device) -> dict:
    """A numpy batch of `VideoTrackletDataset.batches` on `device`."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def train_video(cfg: Config, dataset: VideoTrackletDataset,
                epochs: int = 25, batch_size: int = 8, seq_len: int = 10,
                device="cuda", mesh=None) -> Tuple[dict, list]:
    """Ref train (:110-138) on one device, or data-parallel over `mesh`
    (batch_size divisible by its size; every rank starts from rank 0's
    model and centers). Returns (variables, losses):
    the flax variable tree of the trained `video_resnet50` (built with one
    class per identity in `cfg.model.dtype`, its init drawn from a
    generator seeded `cfg.train.seed`, the centers from one seeded 1) and
    the loss of every step, read back once after the last. Batches are
    drawn from `numpy.random.default_rng(cfg.train.seed)`, as in the JAX
    package. `seq_len` is the dataset's; the JAX package sizes its init
    batch by it."""
    from ..parallel.mesh import place_batch, replicate
    from ..utils.flax_bridge import flax_variables

    del seq_len
    dp = mesh is not None and mesh.collective
    if dp and not mesh.member:
        raise ValueError("this rank is outside the mesh (fit_mesh keeps the "
                         "first ranks whose count divides the batch)")
    if dp and batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh "
                         f"size {mesh.size}")
    num_classes = len(dataset.labels)
    model = build_model("video_resnet50", num_classes=num_classes,
                        dtype=getattr(torch, cfg.model.dtype), device=device,
                        generator=torch.Generator().manual_seed(
                            cfg.train.seed))
    state = create_video_train_state(model, num_classes,
                                     torch.Generator().manual_seed(1))
    if dp:
        replicate(mesh, model)
        replicate(mesh, [state.loss_state.centers])
    step = make_video_train_step(cfg, mesh=mesh)
    losses = []
    rng = np.random.default_rng(cfg.train.seed)
    for _ in range(epochs):
        for batch in dataset.batches(batch_size, rng):
            batch = to_device(batch, device)
            if dp:
                batch = place_batch(mesh, batch)
            state, loss = step(state, batch)
            losses.append(loss)
    losses = torch.stack(losses).tolist() if losses else []
    return flax_variables(model), losses

