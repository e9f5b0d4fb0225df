"""Published PyTorch weights -> the port's backbones: torchvision ResNets
into `ResNetReID` (`convert_torchvision_resnet`) and torchreid's OSNet
into `OSNet` (`convert_osnet`).

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


def convert_osnet(state_dict: Mapping[str, torch.Tensor],
                  model: torch.nn.Module) -> int:
    """Copy a torchreid-layout OSNet state dict (the reference's pretrained
    osnet_x1_0 trunk and feature head) into the port's `OSNet` in place;
    counterpart of `reid_tpu.utils.torch_convert.convert_osnet`. Names:

      conv1.{conv,bn}                   -> conv1.{conv,bn} (stem)
      convS.B (S = 2, 3, 4; B = 0, 1)   -> convS_B (OSBlock):
        conv1.{conv,bn}                 -> conv1.{conv,bn}
        conv2a / conv2b.K / conv2c.K / conv2d.K {conv1,conv2,bn}
                                        -> conv2_{t}_{K}.{conv1,conv2,bn}
        gate.fc1 / gate.fc2 (1x1 convs) -> gate.fc1 / gate.fc2 (dense)
        conv3 / downsample {conv,bn}    -> conv3 / down
      conv2.2 / conv3.2 (transitions)   -> trans2 / trans3
      conv5                             -> conv5
      fc.0 / fc.1 (Linear, BatchNorm1d) -> fc / fc_bn

    The classifier keeps its init (the class count differs); tensors the
    model lacks or whose size differs are skipped. Returns the number of
    tensors copied; raises if none matched."""
    pairs = []

    def conv_bn(src, dst):
        pairs.append((f"{src}.conv.weight", f"{dst}.conv.weight"))
        bn(f"{src}.bn", f"{dst}.bn")

    def bn(src, dst):
        pairs.extend((f"{src}.{leaf}", f"{dst}.{leaf}") for leaf in
                     ("weight", "bias", "running_mean", "running_var"))

    def osblock(src, dst):
        conv_bn(f"{src}.conv1", f"{dst}.conv1")
        for t, letter in enumerate("abcd", start=1):
            for k in range(t):
                s = f"{src}.conv2{letter}" + (f".{k}" if t > 1 else "")
                d = f"{dst}.conv2_{t}_{k}"
                pairs.extend((f"{s}.conv{i}.weight", f"{d}.conv{i}.weight")
                             for i in (1, 2))
                bn(f"{s}.bn", f"{d}.bn")
        for fc in ("fc1", "fc2"):
            pairs.extend((f"{src}.gate.{fc}.{leaf}", f"{dst}.gate.{fc}.{leaf}")
                         for leaf in ("weight", "bias"))
        conv_bn(f"{src}.conv3", f"{dst}.conv3")
        conv_bn(f"{src}.downsample", f"{dst}.down")

    conv_bn("conv1", "conv1")
    for s in (2, 3, 4):
        for b in range(2):
            osblock(f"conv{s}.{b}", f"conv{s}_{b}")
    conv_bn("conv2.2", "trans2")
    conv_bn("conv3.2", "trans3")
    conv_bn("conv5", "conv5")
    pairs += [("fc.0.weight", "fc.weight"), ("fc.0.bias", "fc.bias")]
    bn("fc.1", "fc_bn")
    own = model.state_dict()
    loaded = 0
    with torch.no_grad():
        for src, dst in pairs:
            if src not in state_dict or dst not in own:
                continue
            t = torch.as_tensor(state_dict[src])
            if t.ndim == 4 and own[dst].ndim == 2:
                t = t[:, :, 0, 0]          # the gate's 1x1 convs
            if tuple(t.shape) == tuple(own[dst].shape):
                own[dst].copy_(t)
                loaded += 1
    if loaded == 0:
        raise ValueError("convert_osnet: no tensor matched (not a "
                         "torchreid OSNet state dict?)")
    return loaded
