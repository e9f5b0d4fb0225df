"""A cuDNN convolution that carries its own TF32 setting, as a custom op.

`models.layers.Conv2d` (`keep_f32`) and `utils.quantize.grouped_acc` set
cuDNN's process-wide TF32 flag around their f32 convolutions. A flag set
in Python is not part of a graph that `torch.export` records, so an
exported program would run those convolutions under whatever flag its
caller set: slower without TF32 where the layer allows it, inexact with
it where the layer forbids it. `conv2d_tf32` is a node that sets the
flag around the convolution each time it runs. `grouped_acc` (inference
only) always calls it; `Conv2d` calls it under export and keeps its
`with` block in eager code, where training differentiates through it and
the op has no autograd formula.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def _conv(x, w, stride, padding, dilation, groups):
    return F.conv2d(x, w, stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


@torch.library.custom_op("reid_tpu_torch::conv2d_tf32", mutates_args=())
def conv2d_tf32(x: torch.Tensor, w: torch.Tensor, stride: List[int],
                padding: List[int], dilation: List[int], groups: int,
                allow_tf32: bool) -> torch.Tensor:
    """`F.conv2d` of NCHW `x` with `w` under cuDNN's TF32 flag set to
    `allow_tf32`, its other flags as they are."""
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark,
                 deterministic=c.deterministic, allow_tf32=allow_tf32):
        return _conv(x, w, stride, padding, dilation, groups)


@conv2d_tf32.register_fake
def _(x, w, stride, padding, dilation, groups, allow_tf32):
    return _conv(x, w, stride, padding, dilation, groups)
