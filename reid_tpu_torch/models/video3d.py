"""The 3-D video ResNet of tracklet ReID in PyTorch, on (N, T, H, W, C)
clips.

Counterpart of `reid_tpu/models/video3d.py`: a stem conv (1, 7, 7) / (1,
2, 2) -> BN -> ReLU -> max pool (1, 3, 3) / (1, 2, 2); four stages of
3-D bottlenecks (1x1x1 -> 3x3x3 with the stride on H and W -> 1x1x1 x4,
a downsample on block 0 of every stage), whose first norm is
`MixedNorm3D` (instance norm on the first c // 2 channels, batch norm on
the rest) on stages 1 and 2; GeM over (T, H, W) (or the mean with
`pooling="avg"`); a bias-free BNNeck and a bias-free classifier.
Returns (bnneck_feature, logits) by default and with train=True
(pooled_feature, logits); `cam` is accepted and ignored, as `num_cams`
is. Module names equal the flax ones ("layer2_0/conv2" is
"layer2_0.conv2" here, MixedNorm3D's halves "in" and "bn").

In bf16 every conv whose product a BatchNorm reads keeps it in f32
(`keep_f32`), as the compiled JAX program does; MixedNorm3D's channel
split reads conv1's product rounded to bf16, which XLA's CPU conv rounds
once from the f32 conv of the rounded operands (`f32_sum`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .layers import (BatchNorm, Conv3d, GeM3D, InstanceNorm, Linear,
                     max_pool3d)

PLANES = (64, 128, 256, 512)


class MixedNorm3D(nn.Module):
    """Half instance, half batch norm over (T, H, W) (flax
    `MixedNorm3D`): `InstanceNorm` on the first c // 2 channels ("in"),
    BatchNorm on the rest ("bn")."""

    def __init__(self, c: int, dtype=torch.float32):
        super().__init__()
        self.half = c // 2
        # "in" is a Python keyword: the flax name reaches the module tree
        # through add_module
        self.add_module("in", InstanceNorm(self.half, dtype=dtype))
        self.bn = BatchNorm(c - self.half, dtype=dtype)

    def forward(self, x, train: bool = False):
        return torch.cat([getattr(self, "in")(x[..., :self.half]),
                          self.bn(x[..., self.half:], train)], dim=-1)


class Bottleneck3D(nn.Module):
    """3-D bottleneck (flax `Bottleneck3D`): 1x1x1 -> 3x3x3, stride (1, s,
    s) -> 1x1x1 to 4x planes, with a 1x1x1 / (1, s, s) downsample."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 ibn: bool = False, downsample: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.downsample = downsample
        s = (1, stride, stride)
        self.conv1 = Conv3d(cin, planes, 1, 1, dtype, keep_f32=not ibn,
                            f32_sum=ibn)
        self.bn1 = MixedNorm3D(planes, dtype) if ibn else \
            BatchNorm(planes, dtype=dtype)
        self.conv2 = Conv3d(planes, planes, 3, s, dtype, keep_f32=True)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.conv3 = Conv3d(planes, planes * 4, 1, 1, dtype, keep_f32=True)
        self.bn3 = BatchNorm(planes * 4, dtype=dtype)
        if downsample:
            self.down_conv = Conv3d(cin, planes * 4, 1, s, dtype,
                                    keep_f32=True)
            self.down_bn = BatchNorm(planes * 4, dtype=dtype)

    def forward(self, x, train: bool = False):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = torch.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        branch = self.down_bn(self.down_conv(x), train) \
            if self.downsample else x
        return torch.relu(y + branch)


class VideoResNet(nn.Module):
    """3-D ResNet trunk + GeM3D + BNNeck (flax `VideoResNet`)."""

    def __init__(self, num_classes: int = 751, num_cams: int = 6,
                 blocks: Sequence[int] = (3, 4, 6, 3),
                 pooling: str = "gem", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv3d(3, 64, (1, 7, 7), (1, 2, 2), dtype,
                            keep_f32=True)
        self.bn1 = BatchNorm(64, dtype=dtype)
        self.stages = []
        cin = 64
        for s, (p, nb) in enumerate(zip(PLANES, blocks)):
            for b in range(nb):
                name = f"layer{s + 1}_{b}"
                self.add_module(name, Bottleneck3D(
                    cin, p, 2 if (s > 0 and b == 0) else 1, ibn=s < 2,
                    downsample=b == 0, dtype=dtype))
                self.stages.append(name)
                cin = p * 4
        self.gem = GeM3D(dtype=dtype) if pooling == "gem" else None
        self.bnneck = BatchNorm(cin, use_bias=False, dtype=dtype)
        self.classifier = Linear(cin, num_classes, dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random init with flax's initializers, drawn from `generator`:
        kaiming (fan out) for every conv, normal(0.001) for the
        classifier."""
        for m in self.modules():
            if isinstance(m, Conv3d):
                m.reset_parameters(generator)
        self.classifier.reset_parameters(generator, std=0.001)
        return self

    def forward(self, x, cam: Optional[torch.Tensor] = None,
                train: bool = False):
        x = x.to(self.dtype)
        x = max_pool3d(torch.relu(self.bn1(self.conv1(x), train)))
        for name in self.stages:
            x = getattr(self, name)(x, train)
        if self.gem is not None:
            feat = self.gem(x)
        else:
            feat = x.to(torch.float32).mean(dim=(1, 2, 3)).to(self.dtype)
        bn = self.bnneck(feat, train)
        logits = self.classifier(bn)
        return (feat if train else bn), logits
