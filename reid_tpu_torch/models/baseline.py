"""The torchvision-style ResNet backbones in PyTorch, NHWC: "baseline"
(ResNet18), "resnet50" (ft_net) and "agw" (ResNet50 + non-local + GeM).

Counterpart of `reid_tpu/models/baseline.py`: a ResNet trunk with the last
stride 1 (stride 2 on the first block of stages 2 and 3 only), a downsample
on block 0 of every stage past the first and, for the bottleneck, of the
first too; the bottleneck's stride sits on its 3x3 (torchvision v1.5). The
head pools (average, or GeM for agw), maps to `bottleneck_dim` where that
differs from the pooled width, and ends in a bias-free BNNeck and a
bias-free classifier. Module names equal the flax ones ("layer2_0/conv2"
is "layer2_0.conv2" here). Returns (bnneck_feature, logits) by default and
with train=True (pooled_feature, logits); `cam` is accepted and ignored.

Every conv and dense layer whose product a BatchNorm reads keeps it in f32
(`keep_f32`), as the compiled JAX program does in bf16.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .layers import (BatchNorm, Conv2d, GeM, Linear, conv1x1, conv3x3,
                     make_norm2d, max_pool_same)

PLANES = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    """ResNet basic block (flax `BasicBlock`)."""
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.downsample = downsample
        self.conv1 = conv3x3(cin, planes, stride, dtype, keep_f32=True)
        self.bn1 = make_norm2d(planes, dtype)
        self.conv2 = conv3x3(planes, planes, 1, dtype, keep_f32=True)
        self.bn2 = make_norm2d(planes, dtype)
        if downsample:
            self.down_conv = conv1x1(cin, planes, stride, dtype,
                                     keep_f32=True)
            self.down_bn = make_norm2d(planes, dtype)

    def forward(self, x, train: bool = False):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        branch = self.down_bn(self.down_conv(x), train) \
            if self.downsample else x
        return torch.relu(y + branch)


class Bottleneck(nn.Module):
    """ResNet bottleneck, 1x1 -> 3x3 (the stride) -> 1x1 x4 (flax
    `Bottleneck`)."""
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.downsample = downsample
        self.conv1 = conv1x1(cin, planes, 1, dtype, keep_f32=True)
        self.bn1 = make_norm2d(planes, dtype)
        self.conv2 = conv3x3(planes, planes, stride, dtype, keep_f32=True)
        self.bn2 = make_norm2d(planes, dtype)
        self.conv3 = conv1x1(planes, planes * 4, 1, dtype, keep_f32=True)
        self.bn3 = make_norm2d(planes * 4, dtype)
        if downsample:
            self.down_conv = conv1x1(cin, planes * 4, stride, dtype,
                                     keep_f32=True)
            self.down_bn = make_norm2d(planes * 4, dtype)

    def forward(self, x, train: bool = False):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = torch.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        branch = self.down_bn(self.down_conv(x), train) \
            if self.downsample else x
        return torch.relu(y + branch)


class NonLocalBlock(nn.Module):
    """Embedded-Gaussian non-local block (flax `NonLocalBlock`): `g`,
    `theta`, `phi` and `w` are flax `nn.Conv` defaults (a bias, lecun
    normal init), `w_bn` a BatchNorm whose scale starts at 0, so a fresh
    block is the identity. The attention logits are read in f32 by the
    softmax, which the compiled JAX program computes from the bf16
    operands without rounding the product; the softmax is cast back to
    `dtype` before it weighs `g`."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.inter = inter = max(channels // 2, 1)
        self.g = Conv2d(channels, inter, 1, dtype=dtype, bias=True)
        self.theta = Conv2d(channels, inter, 1, dtype=dtype, bias=True)
        self.phi = Conv2d(channels, inter, 1, dtype=dtype, bias=True)
        self.w = Conv2d(inter, channels, 1, dtype=dtype, bias=True,
                        keep_f32=True)
        self.w_bn = BatchNorm(channels, dtype=dtype)

    def forward(self, x, train: bool = False):
        n, h, w, _ = x.shape
        g = self.g(x).reshape(n, h * w, self.inter)
        theta = self.theta(x).reshape(n, h * w, self.inter)
        phi = self.phi(x).reshape(n, h * w, self.inter)
        logits = torch.bmm(theta.to(torch.float32),
                           phi.to(torch.float32).transpose(1, 2))
        att = torch.softmax(logits, dim=-1).to(self.dtype)
        y = torch.bmm(att, g).reshape(n, h, w, self.inter)
        return x + self.w_bn(self.w(y), train)


class ResNetReID(nn.Module):
    """Torchvision-style ResNet trunk + BNNeck head (flax `ResNetReID`);
    `num_cams` is taken, as flax's is, and unused."""

    def __init__(self, num_classes: int = 751, num_cams: int = 6,
                 block: str = "basic", blocks: Sequence[int] = (2, 2, 2, 2),
                 non_local: bool = False, pooling: str = "avg",
                 bottleneck_dim: int = 512, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        blk = BasicBlock if block == "basic" else Bottleneck
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, dtype=dtype,
                            keep_f32=True)
        self.bn1 = make_norm2d(64, dtype)
        self.stages = []
        cin = 64
        for s, (p, nb) in enumerate(zip(PLANES, blocks)):
            for b in range(nb):
                # the last stage keeps stride 1 (the ReID convention)
                stride = 2 if (b == 0 and s in (1, 2)) else 1
                down = b == 0 and (s > 0 or blk.expansion > 1)
                name = f"layer{s + 1}_{b}"
                self.add_module(name, blk(cin, p, stride, down, dtype))
                self.stages.append(name)
                cin = p * blk.expansion
            if non_local and s in (1, 2):
                self.add_module(f"nl{s + 1}", NonLocalBlock(cin, dtype))
                self.stages.append(f"nl{s + 1}")
        self.gem = GeM(dtype=dtype) if pooling == "gem" else None
        self.bottleneck_fc = None
        if bottleneck_dim and bottleneck_dim != cin:
            self.bottleneck_fc = Linear(cin, bottleneck_dim, dtype,
                                        keep_f32=True)
            cin = bottleneck_dim
        self.bnneck = BatchNorm(cin, use_bias=False, dtype=dtype)
        self.classifier = Linear(cin, num_classes, dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random init with flax's initializers, drawn from `generator`:
        kaiming for the trunk's convs and `bottleneck_fc`, lecun normal
        for the non-local convs, normal(0.001) for the classifier, zeros
        for `w_bn`'s scale."""
        for m in self.modules():
            if isinstance(m, NonLocalBlock):
                for c in (m.g, m.theta, m.phi, m.w):
                    c.reset_parameters(generator, init="lecun")
                nn.init.zeros_(m.w_bn.weight)
            elif isinstance(m, (BasicBlock, Bottleneck)) or m is self:
                for c in m.children():
                    if isinstance(c, Conv2d):
                        c.reset_parameters(generator)
        if self.bottleneck_fc is not None:
            self.bottleneck_fc.reset_parameters(generator)
        self.classifier.reset_parameters(generator, std=0.001)
        return self

    def forward(self, x, cam: Optional[torch.Tensor] = None,
                train: bool = False):
        x = x.to(self.dtype)
        x = max_pool_same(torch.relu(self.bn1(self.conv1(x), train)))
        for name in self.stages:
            x = getattr(self, name)(x, train)
        if self.gem is not None:
            feat = self.gem(x)
        else:
            feat = x.to(torch.float32).mean(dim=(1, 2)).to(self.dtype)
        if self.bottleneck_fc is not None:
            feat = self.bottleneck_fc(feat)
        bn = self.bnneck(feat, train)
        logits = self.classifier(bn)
        return (feat.to(self.dtype) if train else bn), logits
