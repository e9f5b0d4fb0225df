"""CenterNetLite training and its serve-path detector function.

Counterpart of `reid_tpu/train/detector_train.py`: `train_detector` trains
the detector on (frame, padded boxes) supervision with the CenterNet
focal / L1 loss and Adam, and `make_detector_fn` builds the detect
function that `track_main` calls without `--detections`.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..models.detector import (CenterNetLite, decode_detections,
                               detection_loss, make_centernet_targets)
from ..tracking.pipeline import resize_bilinear_matmul
from ..utils.quantize import inv_f32
from .optim import Adam


def train_detector(frames: np.ndarray, tlwh: np.ndarray, valid: np.ndarray,
                   det_hw: Tuple[int, int] = (288, 512), epochs: int = 10,
                   batch_size: int = 8, lr: float = 1e-3, base: int = 32,
                   seed: int = 0, log_fn: Callable[[str], None] = print,
                   device="cuda"):
    """Train CenterNetLite (f32, its init drawn from a generator seeded
    `seed`) on full frames with padded gt boxes; frames (N, H, W, 3)
    uint8, tlwh (N, D, 4) in frame pixels, valid (N, D). Each batch is
    resized to `det_hw` on the device as `jax.image.resize` does it
    (antialiased bilinear, of x / 255 in f32), its boxes scaled to match;
    the model runs in train mode (batch statistics) under optax's Adam at
    `lr`. Batches are drawn from `numpy.random.default_rng(seed)` as in
    the JAX package (whole batches only); each epoch's losses are read
    back once, at its end. Returns (model, its flax variable tree, the
    mean loss of each epoch)."""
    from ..utils.flax_bridge import flax_variables

    n, fh, fw = frames.shape[:3]
    dh, dw = det_hw
    sx, sy = dw / fw, dh / fh
    scaled = np.asarray(tlwh, np.float32) * np.asarray([sx, sy, sx, sy])
    model = CenterNetLite(base=base).init_weights(
        torch.Generator().manual_seed(seed)).to(device)
    params = list(model.parameters())
    tx = Adam(lr)
    opt_state = tx.init(params)
    scale = inv_f32(255.0)

    def step(imgs, boxes, vmask):
        x = resize_bilinear_matmul(imgs.to(torch.float32) * scale, (dh, dw))
        targets = make_centernet_targets(boxes, vmask, (dh, dw))
        loss = detection_loss(model(x, train=True), *targets)
        tx.apply(params, torch.autograd.grad(loss, params), opt_state)
        return loss.detach()

    rng = np.random.default_rng(seed)
    losses: List[float] = []
    for epoch in range(epochs):
        order = rng.permutation(n)
        ep = []
        for s in range(0, n - batch_size + 1, batch_size):
            b = order[s:s + batch_size]
            ep.append(step(
                torch.from_numpy(np.ascontiguousarray(frames[b])).to(device),
                torch.from_numpy(scaled[b].astype(np.float32)).to(device),
                torch.from_numpy(np.asarray(valid[b], bool)).to(device)))
        # an epoch without a whole batch has no loss (NaN, as np.mean of
        # no values gives the JAX package's)
        losses.append(float(np.mean(torch.stack(ep).cpu().numpy()
                                    .astype(np.float64))) if ep
                      else float("nan"))
        log_fn(f"detector epoch {epoch}: loss={losses[-1]:.4f}")
    return model.eval(), flax_variables(model), losses


def make_detector_fn(model: CenterNetLite,
                     det_hw: Tuple[int, int] = (288, 512),
                     max_dets: int = 64, min_conf: float = 0.05):
    """fn(frame (H,W,3) uint8) -> (tlwh, conf, valid) NumPy arrays in frame
    pixels: the antialiased bilinear resize of `jax.image.resize` to
    `det_hw`, the model, `decode_detections`, the boxes scaled back to the
    frame, and valid = conf > `min_conf`."""
    dh, dw = det_hw
    dev = next(model.parameters()).device

    @torch.no_grad()
    def detect(frame):
        fr = torch.as_tensor(np.asarray(frame)).to(dev)
        img = resize_bilinear_matmul(fr.to(torch.float32) * inv_f32(255.0),
                                     (dh, dw))
        tlwh, scores = decode_detections(model(img[None]), max_dets=max_dets)
        sx, sy = fr.shape[1] / dw, fr.shape[0] / dh
        tlwh = tlwh[0] * torch.tensor([sx, sy, sx, sy], device=dev)
        conf = scores[0].cpu().numpy()
        return tlwh.cpu().numpy(), conf, conf > min_conf

    return detect
