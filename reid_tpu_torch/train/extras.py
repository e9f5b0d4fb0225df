"""Small training utilities. Ref `reid/train_utils.py`.

Counterpart of `reid_tpu/train/extras.py`:

- `mixup_batch`   mixup (ref :173-194), its draws from a
                  `numpy.random.Generator`, the mixing in `mixup_apply`
- `plot_loss`     the loss-curve PNG (ref :80-91), nothing without
                  matplotlib
- `model_size_mb` the parameters' size (ref :161-170)
- `redetection`   re-crop each image to its best person detection (ref
                  :105-147), the detector pluggable
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def mixup_apply(images: torch.Tensor, labels: torch.Tensor,
                num_classes: int, lam: float, perm):
    """lam * images + (1 - lam) * images[perm] and the same mix of the
    one-hot labels (B, C), in f32 with lam and 1 - lam taken in f32."""
    lam32 = np.float32(lam)
    keep, other = float(lam32), float(np.float32(1.0) - lam32)
    perm = torch.as_tensor(np.array(perm), device=images.device)
    mixed = keep * images + other * images[perm]
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    return mixed, keep * onehot + other * onehot[perm]


def mixup_batch(rng: np.random.Generator, images: torch.Tensor,
                labels: torch.Tensor, num_classes: int, alpha: float = 0.2):
    """Mixup: lam ~ Beta(alpha, alpha) and a permutation of the batch,
    both drawn from `rng`; returns (mixed images, soft labels (B, C))."""
    lam = rng.beta(alpha, alpha)
    perm = rng.permutation(images.shape[0])
    return mixup_apply(images, labels, num_classes, lam, perm)


def plot_loss(loss_stats: Sequence[float],
              out: str = "images/loss_curve.png") -> Optional[str]:
    """Save a loss-curve PNG and return its path; None without
    matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    plt.figure(figsize=(8, 4))
    plt.plot(loss_stats)
    plt.xlabel("step")
    plt.ylabel("loss")
    plt.tight_layout()
    plt.savefig(out)
    plt.close()
    return out


def model_size_mb(model: torch.nn.Module) -> float:
    """The parameters' footprint in MB (2^20 bytes); buffers such as the
    BatchNorm statistics are not parameters, as in a flax params tree."""
    return float(sum(p.numel() * p.element_size()
                     for p in model.parameters())) / (1 << 20)


def redetection(detector: Callable, images: np.ndarray,
                conf_thres: float = 0.4) -> np.ndarray:
    """Each image (B, H, W, 3) uint8 cut to its highest-scoring detection
    and resized back to (H, W) bilinearly by PIL; an image keeps its
    whole frame where nothing scores `conf_thres` or the box is empty.
    `detector(images)` gives a (boxes_tlwh (M, 4), scores (M,)) pair an
    image."""
    from PIL import Image

    out = []
    for img, (boxes, scores) in zip(images, detector(images)):
        if len(scores) == 0 or scores.max() < conf_thres:
            out.append(img)
            continue
        x, y, w, h = boxes[int(np.argmax(scores))]
        h_img, w_img = img.shape[:2]
        x0, y0 = int(max(0, x)), int(max(0, y))
        x1, y1 = int(min(w_img, x + w)), int(min(h_img, y + h))
        if x1 <= x0 or y1 <= y0:
            out.append(img)
            continue
        out.append(np.asarray(Image.fromarray(img[y0:y1, x0:x1]).resize(
            (w_img, h_img), Image.BILINEAR)))
    return np.stack(out)
