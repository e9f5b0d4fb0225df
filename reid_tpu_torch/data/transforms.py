"""The inference transform of the port.

Counterpart of `reid_tpu/data/transforms.py:inference_batch` (ref
get_inference_transforms[_flipped], data_transforms.py:56-209). The
training augmentations belong to the training slice.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def inference_batch(images: torch.Tensor) -> torch.Tensor:
    """uint8 or float [0, 255] NHWC -> normalized f32: (x / 255 - mean) /
    std, rounded as the compiled JAX program rounds it: XLA turns both
    divisions by constants into multiplications by their f32 reciprocals
    and fuses the first with the subtraction, fma(x, 1/255, -mean) *
    (1/std). The TTA flip is the caller's (`train/steps.py`)."""
    x = images.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=x.device)
    neg_mean = -torch.tensor(IMAGENET_MEAN, **f32)
    inv_std = 1.0 / torch.tensor(IMAGENET_STD, **f32)
    return torch.addcmul(neg_mean, x, torch.tensor(1.0 / 255.0, **f32)) \
        * inv_std
