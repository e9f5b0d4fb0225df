"""OSNet (omni-scale network) and PLR-OSNet in PyTorch, NHWC.

Counterpart of `reid_tpu/models/osnet.py`, with flax's module names
("conv2_0/conv2_3_1/conv2", "conv40_1/gate/fc1"):

  * `ConvBNReLU`: conv (no bias) -> BatchNorm -> ReLU (or none);
  * `LightConv3x3`: a 1x1 conv, a depthwise 3x3 conv, BatchNorm, ReLU;
  * `ChannelGate`: the spatial mean (f32) -> fc1 -> ReLU -> fc2 ->
    sigmoid, one module (its parameters under "gate") gating all four
    streams of a block;
  * `OSBlock`: a 1x1 conv to features / 4, four streams of 1-4 stacked
    `LightConv3x3` (receptive fields 3, 5, 7, 9), each gated and summed, a
    1x1 conv back, plus the input (through a 1x1 conv "down" where the
    width changes), ReLU;
  * `OSNet`: a 7x7/2 stem and 3x3/2 max pool, stages of two blocks with a
    1x1 conv and a 2x2 average pool (odd sizes floor) between, a 1x1
    `conv5`, then the head: the spatial mean, `fc` (512), `fc_bn`, ReLU
    and the classifier; it returns (feature, logits) in both modes, with
    no BNNeck. Widths (64, 256, 384, 512) for x1.0; the factory scales
    them (`osnet_x0_5`, `osnet_x0_25`);
  * `PLROSNet`: the same trunk to conv3, with an `AttentionModule` (PAM ->
    SE) after each of the two transitions, then two copies of conv4 /
    conv5: the global branch pools four horizontal strips
    (rows h*i//4 : h*(i+1)//4, uneven where h % 4 != 0) into 4 x 512, the
    local branch takes the global max and `fc2` (512); `bn1` / `bn2` and
    `classifier1` / `classifier2`. Eval returns the concatenated
    L2-normalized `bn1` and `bn2` (2,560) and (y1, y2); train returns
    (v1, v2) and (y1, y2).

`cam` is taken, as flax's is, and unused. The bf16 roundings are those of
the compiled JAX program: a conv or dense layer whose product a
BatchNorm reads keeps it in f32 (`keep_f32`), the spatial means sum in
f32 and round to `dtype`, the gate's sigmoid rounds each step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .attention_modules import AttentionModule
from .layers import BatchNorm, Conv2d, Linear, max_pool_same, \
    sigmoid_stepwise

CHANNELS = (64, 256, 384, 512)


class ConvBNReLU(nn.Module):
    """conv (no bias, SAME) -> BatchNorm -> ReLU unless `relu` is off."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, relu: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.relu = relu
        self.conv = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                           dtype=dtype, keep_f32=True, groups=groups)
        self.bn = BatchNorm(cout, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = self.bn(self.conv(x), train)
        return torch.relu(x) if self.relu else x


class LightConv3x3(nn.Module):
    """1x1 pointwise -> 3x3 depthwise -> BatchNorm -> ReLU."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 1, dtype=dtype)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, dtype=dtype,
                            keep_f32=True, groups=cout)
        self.bn = BatchNorm(cout, dtype=dtype)

    def forward(self, x, train: bool = False):
        return torch.relu(self.bn(self.conv2(self.conv1(x)), train))


def _mean_hw(x: torch.Tensor, dtype) -> torch.Tensor:
    """`jnp.mean(x, axis=(1, 2))` of a `dtype` tensor: summed in f32, the
    mean rounded to `dtype`."""
    return x.to(torch.float32).mean((1, 2)).to(dtype)


class ChannelGate(nn.Module):
    """The unified aggregation gate: (N, H, W, C) -> (N, 1, 1, C)."""

    def __init__(self, features: int, reduction: int = 16,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        mid = max(features // reduction, 4)
        self.fc1 = Linear(features, mid, dtype, bias=True)
        self.fc2 = Linear(mid, features, dtype, bias=True)

    def forward(self, x):
        s = self.fc2(torch.relu(self.fc1(_mean_hw(x, self.dtype))))
        return sigmoid_stepwise(s)[:, None, None, :]


class OSBlock(nn.Module):
    """The omni-scale residual bottleneck."""

    def __init__(self, cin: int, features: int, bottleneck_reduction: int = 4,
                 dtype=torch.float32):
        super().__init__()
        mid = features // bottleneck_reduction
        self.conv1 = ConvBNReLU(cin, mid, 1, dtype=dtype)
        self.gate = ChannelGate(mid, dtype=dtype)
        self.streams = [[f"conv2_{t}_{i}" for i in range(t)]
                        for t in range(1, 5)]
        for names in self.streams:
            for name in names:
                self.add_module(name, LightConv3x3(mid, mid, dtype))
        self.conv3 = ConvBNReLU(mid, features, 1, relu=False, dtype=dtype)
        self.down = ConvBNReLU(cin, features, 1, relu=False, dtype=dtype) \
            if cin != features else None

    def forward(self, x, train: bool = False):
        x1 = self.conv1(x, train)
        y = None
        for t, names in enumerate(self.streams):
            s = x1
            for name in names:
                s = getattr(self, name)(s, train)
            s = self.gate(s) * s
            if y is None:
                y = s
            elif t < len(self.streams) - 1:
                y = y + s
            else:
                # conv3 reads the last sum unrounded (f32): an int8 conv3
                # quantizes it so; a float one rounds it to `dtype` itself
                y = y.to(torch.float32) + s.to(torch.float32)
        y = self.conv3(y, train)
        identity = x if self.down is None else self.down(x, train)
        return torch.relu(y + identity)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.avg_pool(x, (2, 2), strides=(2, 2))` on NHWC: VALID, so an
    odd height or width drops its last row or column. As the compiled JAX
    program computes it: the window's four values added in row order at
    x's dtype (each sum rounded), the sum times 0.25."""
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    s = x[:, 0:h:2, 0:w:2] + x[:, 0:h:2, 1:w:2]
    s = s + x[:, 1:h:2, 0:w:2]
    s = s + x[:, 1:h:2, 1:w:2]
    return (s.to(torch.float32) * 0.25).to(x.dtype)


class _Trunk(nn.Module):
    """What OSNet and PLR-OSNet share: stem, conv2 and conv3 with their
    transitions (PLR-OSNet's attention after each), named as flax's."""

    def __init__(self, channels: Sequence[int], attention: bool, dtype):
        super().__init__()
        self.dtype = dtype
        c = channels
        self.conv1 = ConvBNReLU(3, c[0], 7, 2, dtype=dtype)
        self.conv2_0 = OSBlock(c[0], c[1], dtype=dtype)
        self.conv2_1 = OSBlock(c[1], c[1], dtype=dtype)
        self.trans2 = ConvBNReLU(c[1], c[1], 1, dtype=dtype)
        self.conv3_0 = OSBlock(c[1], c[2], dtype=dtype)
        self.conv3_1 = OSBlock(c[2], c[2], dtype=dtype)
        self.trans3 = ConvBNReLU(c[2], c[2], 1, dtype=dtype)
        if attention:
            self.att1 = AttentionModule(c[1], dtype)
            self.att2 = AttentionModule(c[2], dtype)
        self.attention = attention

    def trunk(self, x, train: bool):
        x = max_pool_same(self.conv1(x.to(self.dtype), train))
        x = self.conv2_1(self.conv2_0(x, train), train)
        x = avg_pool2(self.trans2(x, train))
        if self.attention:
            x = self.att1(x, train)
        x = self.conv3_1(self.conv3_0(x, train), train)
        x = avg_pool2(self.trans3(x, train))
        if self.attention:
            x = self.att2(x, train)
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's initializers, drawn from `generator`: kaiming for every
        conv and dense layer but the heads that `normal_heads` names,
        normal(`head_std`) for those; biases and PAM's `gamma` stay 0."""
        heads = self.normal_heads()
        for m in self.modules():
            if isinstance(m, Conv2d) or (isinstance(m, Linear)
                                         and m not in heads):
                m.reset_parameters(generator)
        for m in heads:
            m.reset_parameters(generator, std=self.head_std)
        return self


class OSNet(_Trunk):
    """The OSNet trunk and its ReID head (flax `OSNet`)."""

    head_std = 0.001

    def __init__(self, num_classes: int = 751, num_cams: int = 6,
                 channels: Sequence[int] = CHANNELS, feat_dim: int = 512,
                 dtype=torch.float32):
        super().__init__(channels, False, dtype)
        c = channels
        self.conv4_0 = OSBlock(c[2], c[3], dtype=dtype)
        self.conv4_1 = OSBlock(c[3], c[3], dtype=dtype)
        self.conv5 = ConvBNReLU(c[3], c[3], 1, dtype=dtype)
        self.fc = Linear(c[3], feat_dim, dtype, keep_f32=True, bias=True)
        self.fc_bn = BatchNorm(feat_dim, dtype=dtype)
        self.classifier = Linear(feat_dim, num_classes, dtype, bias=True)

    def normal_heads(self):
        return [self.classifier]

    def forward(self, x, cam: Optional[torch.Tensor] = None,
                train: bool = False):
        x = self.trunk(x, train)
        x = self.conv4_1(self.conv4_0(x, train), train)
        x = self.conv5(x, train)
        feature = torch.relu(self.fc_bn(self.fc(_mean_hw(x, self.dtype)),
                                        train))
        return feature, self.classifier(feature)


class PLROSNet(_Trunk):
    """Part-level and global two-branch OSNet (flax `PLROSNet`)."""

    head_std = 0.01

    def __init__(self, num_classes: int = 751, num_cams: int = 6,
                 channels: Sequence[int] = CHANNELS, dtype=torch.float32):
        super().__init__(channels, True, dtype)
        c = channels
        for tag in ("0", "1"):
            self.add_module(f"conv4{tag}_0", OSBlock(c[2], c[3], dtype=dtype))
            self.add_module(f"conv4{tag}_1", OSBlock(c[3], c[3], dtype=dtype))
            self.add_module(f"conv5{tag}", ConvBNReLU(c[3], c[3], 1,
                                                      dtype=dtype))
        self.fc2 = Linear(c[3], 512, dtype, keep_f32=True, bias=True)
        self.bn1 = BatchNorm(4 * c[3], dtype=dtype)
        self.bn2 = BatchNorm(512, dtype=dtype)
        self.classifier1 = Linear(4 * c[3], num_classes, dtype, bias=True)
        self.classifier2 = Linear(512, num_classes, dtype, bias=True)

    def normal_heads(self):
        return [self.fc2, self.classifier1, self.classifier2]

    def _branch(self, x, tag: str, train: bool):
        x = getattr(self, f"conv4{tag}_0")(x, train)
        x = getattr(self, f"conv4{tag}_1")(x, train)
        return getattr(self, f"conv5{tag}")(x, train)

    def forward(self, x, cam: Optional[torch.Tensor] = None,
                train: bool = False):
        x = self.trunk(x, train)
        f1 = self._branch(x, "0", train)
        f2 = self._branch(x, "1", train)
        h = f1.shape[1]
        v1 = torch.cat([_mean_hw(f1[:, (h * i) // 4:(h * (i + 1)) // 4],
                                 self.dtype) for i in range(4)], dim=1)
        v2 = self.fc2(torch.amax(f2, dim=(1, 2)))
        bn1 = self.bn1(v1, train)
        bn2 = self.bn2(v2, train)
        y1, y2 = self.classifier1(bn1), self.classifier2(bn2)
        if not train:
            return torch.cat([_l2n(bn1), _l2n(bn2)], dim=1), (y1, y2)
        return (v1, v2), (y1, y2)


def _l2n(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v| in f32, 1e-12), the norm cast to v's dtype."""
    norm = torch.linalg.vector_norm(v.to(torch.float32), dim=1, keepdim=True)
    return v / torch.clamp(norm, min=1e-12).to(v.dtype)
