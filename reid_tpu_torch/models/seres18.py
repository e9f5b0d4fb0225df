"""SE-ResNet18-IBN and its family (CARes18, EMARes18) in PyTorch, NHWC.

Counterpart of `reid_tpu/models/seres18.py`: the ResNet18-IBN-a trunk (IBN
on bn1 of stages 1-3), a block attention on every basic block applied to
the residual branch before the skip-add (`attention`: the SE gate,
"triplet" for CARes18 or "ema" for EMARes18), stage-4 stride 1, a stem
of conv7x7/2 -> BN -> maxpool3x3/2 with no ReLU, GeM pooling ->
BNNeck -> bias-free classifier, and the per-camera bias. With `renorm`
every norm of the trunk but the BNNeck is a BatchRenorm (IBN's batch
half too). Module names equal the flax ones, so a flax variable path
("block21/down_conv", "block21/triplet_att/cw/conv") names the same layer
here ("block21.down_conv"). Returns what flax returns: (bnneck_feature,
logits) by default, and with train=True (the norms on batch statistics,
which update the running ones) (pooled_feature, logits).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .ema_attention import EMAttention
from .layers import (IBN, BatchNorm, Conv2d, GeM, Linear, SEBlock,
                     conv1x1, conv3x3, make_norm2d, max_pool_same)
from .triplet_attention import TripletAttention

# (planes, stride, ibn, downsample) per block; names block11 .. block42
STAGES = [
    (64, 1, True, False), (64, 1, True, False),
    (128, 2, True, True), (128, 1, True, False),
    (256, 2, True, True), (256, 1, True, False),
    (512, 1, False, True), (512, 1, False, False),
]


def block_names():
    return [f"block{i // 2 + 1}{i % 2 + 1}" for i in range(len(STAGES))]


ATTENTIONS = ("se", "triplet", "ema")


class SEBasicBlock(nn.Module):
    """ResNet basic block + its attention (flax `SEBasicBlock`)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 ibn: bool = False, downsample: bool = False,
                 dtype=torch.float32, attention: str = "se",
                 renorm: bool = False):
        super().__init__()
        if attention not in ATTENTIONS:
            raise ValueError(f"attention '{attention}' is not one of "
                             f"{ATTENTIONS}")
        self.cin, self.planes, self.stride = cin, planes, stride
        self.ibn, self.downsample = ibn, downsample
        self.attention, self.renorm = attention, renorm
        # every conv whose product a BatchNorm reads keeps it in f32, as
        # the compiled JAX program does; IBN's channel split reads conv1's
        # product rounded to `dtype` (bit-equal to flax in bf16 either way)
        self.conv1 = conv3x3(cin, planes, stride, dtype, keep_f32=not ibn)
        self.bn1 = IBN(planes, dtype=dtype, renorm=renorm) if ibn else \
            make_norm2d(planes, dtype, renorm)
        self.conv2 = conv3x3(planes, planes, 1, dtype, keep_f32=True)
        self.bn2 = make_norm2d(planes, dtype, renorm)
        if attention == "se":
            self.seblock = SEBlock(planes, dtype)
        elif attention == "triplet":
            self.triplet_att = TripletAttention(dtype)
        elif attention == "ema":
            self.ema_att = EMAttention(planes, dtype=dtype)
        if downsample:
            self.down_conv = conv1x1(cin, planes, stride, dtype,
                                     keep_f32=True)
            self.down_bn = make_norm2d(planes, dtype, renorm)

    def forward(self, x, train: bool = False):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if self.attention == "se":
            y = self.seblock(y) * y
        elif self.attention == "triplet":
            y = self.triplet_att(y, train)
        elif self.attention == "ema":
            y = self.ema_att(y, train)
        branch = self.down_bn(self.down_conv(x), train) if self.downsample \
            else x
        return torch.relu(y + branch)


class SERes18IBN(nn.Module):
    """SERes18-IBN (flax `SERes18IBN`, GeM pooling) with the blocks'
    `attention` and the trunk's `renorm`."""

    def __init__(self, num_classes: int = 751, num_cams: int = 6,
                 cam_factor: float = -1.0, dtype=torch.float32,
                 attention: str = "se", renorm: bool = False):
        super().__init__()
        self.dtype = dtype
        self.cam_factor = cam_factor
        self.attention, self.renorm = attention, renorm
        self.conv0 = Conv2d(3, 64, 7, stride=2, padding=3, dtype=dtype,
                            keep_f32=True)
        self.bn0 = make_norm2d(64, dtype, renorm)
        cin = 64
        for name, (planes, stride, ibn, down) in zip(block_names(), STAGES):
            self.add_module(name, SEBasicBlock(
                cin, planes, stride, ibn, down, dtype, attention, renorm))
            cin = planes
        self.gem = GeM(dtype=dtype)
        self.bnneck = BatchNorm(512, use_bias=False, dtype=dtype)
        self.cam_bias = nn.Parameter(torch.zeros(num_cams, 512))
        self.classifier = Linear(512, num_classes, dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random init with flax's initializers, drawn from `generator`."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.reset_parameters(generator)
            elif isinstance(m, Linear) and m is not self.classifier:
                m.reset_parameters(generator)
        self.classifier.reset_parameters(generator, std=0.001)
        nn.init.trunc_normal_(self.cam_bias, 0.0, 0.02 / 0.87962566103423978,
                              -0.04 / 0.87962566103423978,
                              0.04 / 0.87962566103423978,
                              generator=generator)
        return self

    def forward(self, x, cam: Optional[torch.Tensor] = None,
                train: bool = False):
        x = x.to(self.dtype)
        x = max_pool_same(self.bn0(self.conv0(x), train))
        for name in block_names():
            x = getattr(self, name)(x, train)
        feature = self.gem(x)
        bn_feat = self.bnneck(feature, train)
        if cam is not None:
            bn_feat = bn_feat + self.cam_factor * self.cam_bias.to(
                self.dtype)[cam]
        logits = self.classifier(bn_feat)
        return (feature if train else bn_feat), logits
