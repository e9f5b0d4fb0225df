"""Foreground / background segmentation augmentation.

Counterpart of `reid_tpu/data/segmentation.py` (role of ref
`reid/segmentation.py`: person FG/BG extraction with an optional
Gaussian-blurred background). The segmenter is the compact trainable
U-Net `SegUNet` (flax's module names, so a JAX tree crosses through
`utils/flax_bridge.py`); `models.deeplab.DeepLabV3` with its
`extract_foreground` is the reference-exact segmenter where torchvision's
weights are supplied (`utils.torch_convert.convert_deeplabv3`).

  * `gaussian_blur`: separable depthwise Gaussian (sigma 3, radius 7) in
    f32 with zero padding, as `lax.conv_general_dilated(..., "SAME")`;
  * `extract_foreground_background` (ref :35-49): the pixels where
    sigmoid(mask) > threshold kept, the rest blurred or zeroed;
  * `batched_extraction` (ref :52-63): segment and composite a batch;
  * `train_segmenter`: SegUNet on (image, person mask) pairs with BCE +
    soft-Dice under Adam, the batches drawn from
    `np.random.default_rng(seed)` as the JAX package draws them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import (BatchNorm, Conv2d, ConvTranspose2d, kaiming_,
                             lecun_, max_pool_same)


class SegUNet(nn.Module):
    """Small encoder / decoder FG/BG segmenter: (B, H, W, 3) -> (B, H, W,
    1) logits; H and W divisible by 4. `train` (the default, as flax's)
    takes batch statistics."""

    def __init__(self, base: int = 32, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        b = base
        for name, cin, ch in (("e1", 3, b), ("e2", b, 2 * b),
                              ("e3", 2 * b, 4 * b), ("d2", 4 * b, 2 * b),
                              ("d1", 2 * b, b)):
            # a block: 3x3 conv (no bias) -> BatchNorm -> ReLU
            setattr(self, f"{name}_conv", Conv2d(cin, ch, 3, padding=1,
                                                 dtype=dtype))
            setattr(self, f"{name}_bn", BatchNorm(ch, dtype=dtype))
        self.up2 = ConvTranspose2d(4 * b, 2 * b, 4, 2, dtype=dtype)
        self.up1 = ConvTranspose2d(2 * b, b, 4, 2, dtype=dtype)
        self.head = Conv2d(b, 1, 1, dtype=dtype, bias=True)

    def init_weights(self, generator: torch.Generator):
        """flax's initializers: kaiming normal (fan out) for the block
        convs, lecun normal for the transposed convs and the head, zero
        biases, unit BatchNorms; drawn from `generator`."""
        for name in ("e1", "e2", "e3", "d2", "d1"):
            conv = getattr(self, f"{name}_conv")
            kaiming_(conv.weight.data, 9 * conv.out_channels, generator)
        for up in (self.up1, self.up2):
            lecun_(up.weight.data, 16 * up.weight.shape[0], generator)
            nn.init.zeros_(up.bias.data)
        self.head.reset_parameters(generator, init="lecun")
        return self

    def _block(self, name, x, train):
        conv, bn = getattr(self, f"{name}_conv"), getattr(self, f"{name}_bn")
        return F.relu(bn(conv(x), train))

    def forward(self, x, train: bool = True):
        x = x.to(self.dtype)
        e1 = self._block("e1", x, train)
        # flax's nn.max_pool(y, (2, 2), (2, 2))
        e2 = self._block("e2", max_pool_same(e1, 2, 2, 0), train)
        e3 = self._block("e3", max_pool_same(e2, 2, 2, 0), train)
        d2 = self._block("d2", torch.cat([self.up2(e3), e2], dim=-1), train)
        d1 = self._block("d1", torch.cat([self.up1(d2), e1], dim=-1), train)
        return self.head(d1)


def gaussian_blur(images: torch.Tensor, sigma: float = 3.0,
                  radius: int = 7) -> torch.Tensor:
    """Separable Gaussian blur over (B, H, W, C) in f32: the normalized
    taps exp(-x^2 / (2 sigma^2)) over [-radius, radius] (x / sigma as x
    times the f32 reciprocal of sigma, as XLA compiles it), down the
    rows then along the columns, each a depthwise conv with zero
    padding."""
    dev = images.device
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    r = xs * float(np.float32(1.0) / np.float32(sigma))
    k = torch.exp(-0.5 * (r * r))
    k = k / k.sum()
    c = images.shape[-1]
    x = images.to(torch.float32).permute(0, 3, 1, 2)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1),
                 padding=(radius, 0), groups=c)
    x = F.conv2d(x, k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1),
                 padding=(0, radius), groups=c)
    return x.permute(0, 2, 3, 1)


def extract_foreground_background(images: torch.Tensor, masks: torch.Tensor,
                                  blur_background: bool = True,
                                  threshold: float = 0.5) -> torch.Tensor:
    """FG kept where sigmoid(masks) > threshold; BG blurred or zeroed (ref
    segmentation.py:35-49). masks (B, H, W, 1) logits; f32 out."""
    fg = (torch.sigmoid(masks) > threshold).to(torch.float32)
    img = images.to(torch.float32)
    bg = gaussian_blur(img) if blur_background else torch.zeros_like(img)
    return fg * img + (1.0 - fg) * bg


@torch.no_grad()
def batched_extraction(model: nn.Module, images: torch.Tensor,
                       blur_background: bool = True) -> torch.Tensor:
    """Segment (`model(images, train=False)`) and composite a batch (ref
    batched_extraction :52-63)."""
    masks = model(images, train=False)
    return extract_foreground_background(images, masks, blur_background)


def segmenter_loss(logits: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """BCE (optax's `sigmoid_binary_cross_entropy`, averaged) plus the
    soft-Dice loss 1 - mean((2 |p m| + 1) / (|p| + |m| + 1)) per image."""
    bce = torch.mean(-m * F.logsigmoid(logits)
                     - (1.0 - m) * F.logsigmoid(-logits))
    prob = torch.sigmoid(logits)
    inter = torch.sum(prob * m, dim=(1, 2))
    dice = 1.0 - torch.mean((2.0 * inter + 1.0) / (
        torch.sum(prob, dim=(1, 2)) + torch.sum(m, dim=(1, 2)) + 1.0))
    return bce + dice


def train_segmenter(images, masks, epochs: int = 10, batch_size: int = 16,
                    lr: float = 1e-3, base: int = 32, seed: int = 0,
                    log_fn=print, device="cuda",
                    variables: Optional[dict] = None):
    """Train SegUNet on (image, person-mask) pairs with BCE + soft-Dice
    (the JAX package's `train_segmenter`). images (N, H, W, 3) uint8 or
    float in [0, 255], masks (N, H, W) in {0, 1}. The model starts from
    flax `variables` when given, else from a generator seeded `seed`;
    Adam(lr); each epoch takes `np.random.default_rng(seed)`'s
    permutation in whole batches (the rest dropped). Returns (model,
    losses): the mean loss of each epoch."""
    from ..train.optim import Adam
    from ..utils.flax_bridge import load_flax_variables

    images = torch.as_tensor(np.asarray(images))
    masks = torch.as_tensor(np.asarray(masks, np.float32))
    model = SegUNet(base=base)
    if variables is not None:
        load_flax_variables(model, variables)
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    model = model.to(device)
    params = list(model.parameters())
    tx = Adam(lr)
    opt = tx.init(params)
    inv255 = float(np.float32(1.0) / np.float32(255.0))
    rng = np.random.default_rng(seed)
    losses = []
    for epoch in range(epochs):
        order = rng.permutation(len(images))
        ep = []
        for s in range(0, len(order) - batch_size + 1, batch_size):
            b = torch.as_tensor(order[s:s + batch_size])
            x = images[b].to(device).to(torch.float32) * inv255
            m = masks[b].to(device)
            loss = segmenter_loss(model(x, train=True)[..., 0]
                                  .to(torch.float32), m)
            grads = torch.autograd.grad(loss, params)
            tx.apply(params, grads, opt)
            ep.append(float(loss.detach()))
        losses.append(float(np.mean(ep)))
        log_fn(f"segmenter epoch {epoch}: loss={losses[-1]:.4f}")
    return model, losses
