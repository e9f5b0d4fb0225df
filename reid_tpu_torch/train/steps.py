"""Eval forwards of the port.

Counterpart of `reid_tpu/train/steps.py:embed_with_flip` (ref
image_reid_inference.py:78-135, inference_efficient): the eval forward is
the model's own call, so that a serving artifact can trace it; callers
serve under `torch.inference_mode`. The train step belongs to the
training slice.
"""

from __future__ import annotations

import torch


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                           min=1e-12)


def embed_with_flip(model, images: torch.Tensor) -> torch.Tensor:
    """Dual-pass TTA embedding: the normal and the horizontally flipped
    batch through one forward; [l2n(feat) || l2n(logits)] averaged over the
    two views and L2-normalized."""
    both = torch.cat([images, torch.flip(images, dims=(2,))], dim=0)
    feats, logits = model(both)
    b = images.shape[0]
    emb = torch.cat([l2n(feats.to(torch.float32)),
                     l2n(logits.to(torch.float32))], dim=1)
    return l2n(0.5 * (emb[:b] + emb[b:]))


def embed_single(model, images: torch.Tensor) -> torch.Tensor:
    """One view: l2n([l2n(feat) || l2n(logits)])."""
    f, lg = model(images)
    return l2n(torch.cat([l2n(f.to(torch.float32)),
                          l2n(lg.to(torch.float32))], dim=1))
