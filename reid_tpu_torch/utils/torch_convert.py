"""Published PyTorch weights -> the port's models: torchvision ResNets
into `ResNetReID` (`convert_torchvision_resnet`), torchreid's OSNet into
`OSNet` (`convert_osnet`), IBN-Net's `resnet18_ibn_a` trunk and the
reference's whole `SERse18_IBN` checkpoint into `SERes18IBN`
(`convert_resnet18_ibn`, `convert_seres18_full`), and torchvision's
`deeplabv3_resnet50` into `DeepLabV3` (`convert_deeplabv3`); the
counterparts of `reid_tpu/utils/torch_convert.py`'s converters.

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


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _copy_pairs(state_dict: Mapping[str, torch.Tensor],
                model: torch.nn.Module, pairs) -> int:
    """Copy each (source key, model key) pair whose source exists and
    whose shape is the model's (a 1x1 conv kernel into a dense weight
    drops its two unit axes, a one-element p becomes a scalar), in
    place; the number copied."""
    own = model.state_dict()
    loaded = 0
    with torch.no_grad():
        for src, dst in pairs:
            if src not in state_dict or dst not in own:
                continue
            t = torch.as_tensor(state_dict[src])
            if t.ndim == 4 and own[dst].ndim == 2:
                t = t[:, :, 0, 0]
            if own[dst].ndim == 0 and t.numel() == 1:
                t = t.reshape(())              # GeM's p
            if tuple(t.shape) == tuple(own[dst].shape):
                own[dst].copy_(t)
                loaded += 1
    return loaded


def _bn(src: str, dst: str, leaves=_BN_LEAVES):
    return [(f"{src}.{leaf}", f"{dst}.{leaf}") for leaf in leaves]


def convert_resnet18_ibn(state_dict: Mapping[str, torch.Tensor],
                         model: torch.nn.Module) -> int:
    """Copy an IBN-Net `resnet18_ibn_a` state dict (the reference's
    pretrained trunk, ref SERes18_IBN.py:201) into the trunk of the port's
    `SERes18IBN` in place (`reid_tpu/utils/torch_convert.py:47`):

      conv1 / bn1                     -> conv0 / bn0
      layerS.B.{conv1,conv2}          -> blockS{B+1}.{conv1,conv2}
      layerS.B.bn1.IN / .bn1.BN       -> blockS{B+1}.bn1.IN / .bn1.BN
        (plain bn1 in the last stage)
      layerS.B.bn2                    -> blockS{B+1}.bn2
      layerS.B.downsample.{0,1}       -> blockS{B+1}.down_conv / down_bn

    SE gates, GeM, BNNeck, classifier and cam bias keep their init, as
    in the reference. Returns the number of tensors copied; raises if
    none matched."""
    pairs = [("conv1.weight", "conv0.weight")] + _bn("bn1", "bn0")
    for stage in range(1, 5):
        for blk in range(2):
            t, f = f"layer{stage}.{blk}", f"block{stage}{blk + 1}"
            pairs += [(f"{t}.conv{i}.weight", f"{f}.conv{i}.weight")
                      for i in (1, 2)]
            pairs += _bn(f"{t}.bn1.IN", f"{f}.bn1.IN", ("weight", "bias"))
            pairs += _bn(f"{t}.bn1.BN", f"{f}.bn1.BN") + _bn(
                f"{t}.bn1", f"{f}.bn1") + _bn(f"{t}.bn2", f"{f}.bn2")
            pairs += [(f"{t}.downsample.0.weight", f"{f}.down_conv.weight")]
            pairs += _bn(f"{t}.downsample.1", f"{f}.down_bn")
    loaded = _copy_pairs(state_dict, model, pairs)
    if loaded == 0:
        raise ValueError("convert_resnet18_ibn: no tensor matched (not a "
                         "resnet18_ibn_a state dict?)")
    return loaded


def convert_seres18_full(state_dict: Mapping[str, torch.Tensor],
                         model: torch.nn.Module) -> int:
    """Copy a whole reference `SERse18_IBN` checkpoint (the reference's
    `cnn_net_checkpoint_*.pt`, ref SERes18_IBN.py:186-277) into the port's
    `SERes18IBN` in place (`reid_tpu/utils/torch_convert.py:97`): the
    trunk, the SE gates, GeM's p, the BNNeck, the classifier and the
    camera bias.

      conv0 / bn0                               -> conv0 / bn0
      basicBlockSB.block_pre.{conv1,conv2}      -> blockSB.{conv1,conv2}
      basicBlockSB.block_pre.bn1[.IN/.BN], bn2  -> blockSB.bn1[...], bn2
      basicBlockSB.block_post.{conv,bn}         -> blockSB.down_conv/down_bn
      basicBlockSB.seblock.fc1 (1x1 conv), fc2  -> blockSB.seblock.fc1/fc2
      avgpooling.p / bnneck / classifier.0      -> gem.p / bnneck / classifier
      cam_bias                                  -> cam_bias

    The BNNeck's bias is frozen at 0 in the reference and absent here.
    Returns the number of tensors copied; raises if none matched."""
    pairs = [("conv0.weight", "conv0.weight")] + _bn("bn0", "bn0")
    for stage in range(1, 5):
        for blk in range(1, 3):
            t, f = f"basicBlock{stage}{blk}", f"block{stage}{blk}"
            pre = f"{t}.block_pre"
            pairs += [(f"{pre}.conv{i}.weight", f"{f}.conv{i}.weight")
                      for i in (1, 2)]
            pairs += _bn(f"{pre}.bn1.IN", f"{f}.bn1.IN", ("weight", "bias"))
            pairs += _bn(f"{pre}.bn1.BN", f"{f}.bn1.BN") + _bn(
                f"{pre}.bn1", f"{f}.bn1") + _bn(f"{pre}.bn2", f"{f}.bn2")
            pairs += [(f"{t}.block_post.conv.weight", f"{f}.down_conv.weight")]
            pairs += _bn(f"{t}.block_post.bn", f"{f}.down_bn")
            pairs += [(f"{t}.seblock.fc{i}.weight",
                       f"{f}.seblock.fc{i}.weight") for i in (1, 2)]
    pairs += [("avgpooling.p", "gem.p"), ("classifier.0.weight",
                                          "classifier.weight"),
              ("cam_bias", "cam_bias")]
    pairs += _bn("bnneck", "bnneck", ("weight", "running_mean",
                                      "running_var"))
    loaded = _copy_pairs(state_dict, model, pairs)
    if loaded == 0:
        raise ValueError("convert_seres18_full: no tensor matched (not a "
                         "reference SERse18_IBN checkpoint?)")
    return loaded


def convert_deeplabv3(state_dict: Mapping[str, torch.Tensor],
                      model: torch.nn.Module) -> int:
    """Copy a torchvision `deeplabv3_resnet50` state dict (the reference's
    hub segmenter, ref reid/segmentation.py:12-14) into the port's
    `models.deeplab.DeepLabV3` in place
    (`reid_tpu/utils/torch_convert.py:387`):

      backbone.conv1 / bn1                 -> conv1 / bn1
      backbone.layerL.B.{conv,bn}{1..3},
        .downsample.{0,1}                  -> layerL_B.{...}, down_conv/bn
      classifier.0.convs.{0..3}.{0,1}      -> aspp.b{i}_conv / b{i}_bn
      classifier.0.convs.4.{1,2}           -> aspp.pool_conv / pool_bn
      classifier.0.project.{0,1}           -> aspp.project_conv / bn
      classifier.{1,2,4}                   -> head_conv / head_bn /
                                              classifier (with its bias)

    aux_classifier.* is ignored. Returns the number of tensors copied;
    raises if none matched (a wrong width, or not this checkpoint)."""
    pairs = [("backbone.conv1.weight", "conv1.weight")] + _bn(
        "backbone.bn1", "bn1")
    for li, blocks in ((1, 3), (2, 4), (3, 6), (4, 3)):
        for bi in range(blocks):
            t, f = f"backbone.layer{li}.{bi}", f"layer{li}_{bi}"
            for ci in (1, 2, 3):
                pairs += [(f"{t}.conv{ci}.weight", f"{f}.conv{ci}.weight")]
                pairs += _bn(f"{t}.bn{ci}", f"{f}.bn{ci}")
            pairs += [(f"{t}.downsample.0.weight", f"{f}.down_conv.weight")]
            pairs += _bn(f"{t}.downsample.1", f"{f}.down_bn")
    for i in range(4):
        pairs += [(f"classifier.0.convs.{i}.0.weight",
                   f"aspp.b{i}_conv.weight")]
        pairs += _bn(f"classifier.0.convs.{i}.1", f"aspp.b{i}_bn")
    pairs += [("classifier.0.convs.4.1.weight", "aspp.pool_conv.weight")]
    pairs += _bn("classifier.0.convs.4.2", "aspp.pool_bn")
    pairs += [("classifier.0.project.0.weight", "aspp.project_conv.weight")]
    pairs += _bn("classifier.0.project.1", "aspp.project_bn")
    pairs += [("classifier.1.weight", "head_conv.weight")]
    pairs += _bn("classifier.2", "head_bn")
    pairs += [("classifier.4.weight", "classifier.weight"),
              ("classifier.4.bias", "classifier.bias")]
    loaded = _copy_pairs(state_dict, model, pairs)
    if loaded == 0:
        raise ValueError(
            "convert_deeplabv3: no tensor matched (wrong width, or not a "
            "torchvision deeplabv3_resnet50 checkpoint)")
    return loaded
