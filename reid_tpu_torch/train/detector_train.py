"""The CenterNetLite serve-path detector function.

Counterpart of `reid_tpu/train/detector_train.py:make_detector_fn`;
`train_detector` belongs to the training slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.detector import CenterNetLite, decode_detections
from ..tracking.pipeline import resize_bilinear_matmul
from ..utils.quantize import inv_f32


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
