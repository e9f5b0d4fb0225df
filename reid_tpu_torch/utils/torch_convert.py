"""Torchvision ResNet weights -> the port's `ResNetReID` trunk.

Counterpart of `reid_tpu/utils/torch_convert.py:convert_torchvision_resnet`:
the ImageNet trunks that the reference heads start from (ft_baseline on
resnet18, ft_net and AGW on resnet50). Both layouts are PyTorch's, so a
tensor crosses as it is; only the names change:

  conv1 / bn1                       -> conv1 / bn1
  layerL.B.{conv,bn}{1..3}          -> layerL_B.{conv,bn}{1..3}
  layerL.B.downsample.{0,1}         -> layerL_B.down_conv / down_bn

A BatchNorm brings weight, bias, running_mean and running_var. The head
(non-local blocks, GeM, bottleneck fc, BNNeck, classifier) keeps its init,
as in the reference; `fc.*`, `num_batches_tracked` and tensors whose shape
differs from the model's are skipped.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch


def convert_torchvision_resnet(state_dict: Mapping[str, torch.Tensor],
                               model: torch.nn.Module,
                               blocks: Sequence[int] = (2, 2, 2, 2),
                               bottleneck: bool = False) -> int:
    """Copy a torchvision resnet18/34/50 state dict into `model`'s trunk
    in place; `blocks` / `bottleneck` name the trunk ((2, 2, 2, 2) basic
    for resnet18, (3, 4, 6, 3) bottleneck for resnet50). Returns the number
    of tensors copied; raises if none matched."""
    own = model.state_dict()
    pairs = [("conv1.weight", "conv1.weight")]
    bns = [("bn1", "bn1")]
    for li, nb in enumerate(blocks, start=1):
        for bi in range(nb):
            t, f = f"layer{li}.{bi}", f"layer{li}_{bi}"
            for ci in range(1, (3 if bottleneck else 2) + 1):
                pairs.append((f"{t}.conv{ci}.weight", f"{f}.conv{ci}.weight"))
                bns.append((f"{t}.bn{ci}", f"{f}.bn{ci}"))
            pairs.append((f"{t}.downsample.0.weight", f"{f}.down_conv.weight"))
            bns.append((f"{t}.downsample.1", f"{f}.down_bn"))
    for t, f in bns:
        pairs += [(f"{t}.{leaf}", f"{f}.{leaf}") for leaf in
                  ("weight", "bias", "running_mean", "running_var")]
    loaded = 0
    with torch.no_grad():
        for src, dst in pairs:
            if src in state_dict and dst in own and tuple(
                    state_dict[src].shape) == tuple(own[dst].shape):
                own[dst].copy_(torch.as_tensor(state_dict[src]))
                loaded += 1
    if loaded == 0:
        raise ValueError(
            "convert_torchvision_resnet: no tensor matched (wrong "
            "blocks/bottleneck for this checkpoint?)")
    return loaded
