"""DeepLabV3-ResNet50 segmenter (torchvision's layout) on NHWC activations.

Counterpart of `reid_tpu/models/deeplab.py`, the architecture of the
reference's torch.hub `deeplabv3_resnet50` person segmenter (ref
reid/segmentation.py:12-14), with flax's module names, so that
`utils/flax_bridge.py` carries a JAX tree unchanged and
`utils/torch_convert.convert_deeplabv3` loads torchvision's state dict:

  * a ResNet50 trunk at output stride 8: layer3 and layer4 trade their
    stride for dilation 2 and 4, each layer's first block keeping the
    previous dilation for its 3x3 (multi-grid 1);
  * ASPP: a 1x1 branch, three 3x3 branches at rates 12 / 24 / 36 and an
    image-pooling branch (global mean -> 1x1 conv -> BatchNorm on the
    1x1 maps -> ReLU -> broadcast), concatenated and projected to
    `head_ch`;
  * 3x3 conv + BatchNorm + ReLU, a 1x1 classifier with bias, and the f32
    logits resized to the input by bilinear interpolation with
    half-pixel centres (`jax.image.resize(..., "bilinear")`, which for
    an upsampling is `F.interpolate(mode="bilinear",
    align_corners=False)`).

`width` scales every channel count (64 = torchvision); convs
(`layers.Conv2d`, with flax's kernel dilation) run in `dtype`,
BatchNorms in f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d, max_pool_same


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (stride on the 3x3), output 4 * planes."""

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, dtype=dtype)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride, dilation,
                            dtype=dtype, dilation=dilation)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.conv3 = Conv2d(planes, 4 * planes, 1, dtype=dtype)
        self.bn3 = BatchNorm(4 * planes, dtype=dtype)
        self.downsample = downsample
        if downsample:
            self.down_conv = Conv2d(cin, 4 * planes, 1, stride,
                                    dtype=dtype)
            self.down_bn = BatchNorm(4 * planes, dtype=dtype)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        if self.downsample:
            x = self.down_bn(self.down_conv(x), train)
        return F.relu(x + y)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling with the image-pooling branch."""

    def __init__(self, cin, ch=256, rates=(12, 24, 36), dtype=torch.float32):
        super().__init__()
        self.rates = tuple(rates)
        self.b0_conv = Conv2d(cin, ch, 1, dtype=dtype)
        self.b0_bn = BatchNorm(ch, dtype=dtype)
        for i, r in enumerate(self.rates, start=1):
            setattr(self, f"b{i}_conv", Conv2d(cin, ch, 3, 1, r, dtype=dtype,
                                               dilation=r))
            setattr(self, f"b{i}_bn", BatchNorm(ch, dtype=dtype))
        self.pool_conv = Conv2d(cin, ch, 1, dtype=dtype)
        self.pool_bn = BatchNorm(ch, dtype=dtype)
        self.project_conv = Conv2d((len(self.rates) + 2) * ch, ch, 1,
                                   dtype=dtype)
        self.project_bn = BatchNorm(ch, dtype=dtype)

    def forward(self, x, train: bool = False):
        outs = [F.relu(self.b0_bn(self.b0_conv(x), train))]
        for i in range(1, len(self.rates) + 1):
            conv, bn = getattr(self, f"b{i}_conv"), getattr(self, f"b{i}_bn")
            outs.append(F.relu(bn(conv(x), train)))
        g = x.mean((1, 2), keepdim=True)
        g = F.relu(self.pool_bn(self.pool_conv(g), train))
        outs.append(g.expand(-1, x.shape[1], x.shape[2], -1))
        y = self.project_conv(torch.cat(outs, dim=-1))
        return F.relu(self.project_bn(y, train))


class DeepLabV3(nn.Module):
    """(B, H, W, 3) -> per-pixel class logits (B, H, W, num_classes), f32."""

    def __init__(self, num_classes: int = 21, width: int = 64,
                 head_ch: int = 256, dtype=torch.float32):
        super().__init__()
        w = width
        self.dtype = dtype
        self.conv1 = Conv2d(3, w, 7, 2, 3, dtype=dtype)
        self.bn1 = BatchNorm(w, dtype=dtype)
        # (blocks, planes, stride, dilation): output stride 8
        specs = [(3, w, 1, 1), (4, 2 * w, 2, 1), (6, 4 * w, 1, 2),
                 (3, 8 * w, 1, 4)]
        cin = w
        self.blocks = []
        for li, (blocks, planes, stride, dil) in enumerate(specs, start=1):
            for bi in range(blocks):
                first = bi == 0
                name = f"layer{li}_{bi}"
                setattr(self, name, Bottleneck(
                    cin, planes, stride if first else 1,
                    (dil // 2 if dil > 1 else 1) if first else dil,
                    downsample=first, dtype=dtype))
                self.blocks.append(name)
                cin = 4 * planes
        self.aspp = ASPP(cin, head_ch, dtype=dtype)
        self.head_conv = Conv2d(head_ch, head_ch, 3, 1, 1, dtype=dtype)
        self.head_bn = BatchNorm(head_ch, dtype=dtype)
        self.classifier = Conv2d(head_ch, num_classes, 1, dtype=dtype,
                                 bias=True)

    def init_weights(self, generator: torch.Generator):
        """flax's default initializers (lecun_normal kernels, zero biases,
        unit BatchNorms), drawn from `generator`."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.reset_parameters(generator, init="lecun")
        return self

    def forward(self, x, train: bool = False):
        in_h, in_w = x.shape[1], x.shape[2]
        y = F.relu(self.bn1(self.conv1(x.to(self.dtype)), train))
        y = max_pool_same(y, 3, 2, 1)
        for name in self.blocks:
            y = getattr(self, name)(y, train)
        y = self.aspp(y, train)
        y = F.relu(self.head_bn(self.head_conv(y), train))
        y = self.classifier(y).to(torch.float32)
        y = F.interpolate(y.permute(0, 3, 1, 2), size=(in_h, in_w),
                          mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1)


def extract_foreground(logits: torch.Tensor,
                       person_class: int = 15) -> torch.Tensor:
    """(B, H, W) boolean person mask (ref segmentation.py
    extract_foreground_background :35-49): the argmax over the classes is
    the person class (VOC id 15)."""
    return torch.argmax(logits, dim=-1) == person_class
