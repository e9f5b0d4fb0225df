"""Model factory - name -> module. Counterpart of
`reid_tpu/models/factory.py:build_model` for the backbones the port has:
the SERes18 family (seres18, cares18, emares18), the torchvision-style
ResNets (baseline, resnet50, agw), OSNet (osnet = osnet_x1_0, osnet_x0_5,
osnet_x0_25), PLR-OSNet (plr_osnet), ViT-t with SIE (vit), Swin-T v1 /
v2 with the U-Net head (swin_v1, swin_v2) and the 3-D video ResNets
(video_resnet50, video_resnet18), which take (N, T, H, W, 3) clips: every
name of the JAX package's registry."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .baseline import ResNetReID
from .osnet import CHANNELS, OSNet, PLROSNet
from .seres18 import SERes18IBN
from .swin import SwinTransformer
from .video3d import VideoResNet
from .vit import ViT


def osnet_channels(mult: float):
    """OSNet's stage widths scaled by `mult`, at least 16 each."""
    return tuple(max(16, int(c * mult)) for c in CHANNELS)


BOTTLENECK50 = dict(block="bottleneck", blocks=(3, 4, 6, 3))
# name -> (module, its arguments besides num_classes, num_cams and dtype)
MODELS = {
    "seres18": (SERes18IBN, {}),
    # CARes18: the same skeleton with triplet attention blocks
    "cares18": (SERes18IBN, dict(attention="triplet")),
    # EMARes18: efficient multi-scale attention blocks
    "emares18": (SERes18IBN, dict(attention="ema")),
    # ft_baseline: ResNet18 + ClassBlock
    "baseline": (ResNetReID, dict(block="basic", blocks=(2, 2, 2, 2))),
    # ft_net: ResNet50 + ClassBlock
    "resnet50": (ResNetReID, BOTTLENECK50),
    # AGW: ResNet50 + non-local + GeM pooling, no bottleneck fc
    "agw": (ResNetReID, dict(BOTTLENECK50, non_local=True, pooling="gem",
                             bottleneck_dim=0)),
    # OSNet at three widths; "osnet" is x1.0
    "osnet": (OSNet, {}),
    "osnet_x1_0": (OSNet, {}),
    "osnet_x0_5": (OSNet, dict(channels=osnet_channels(0.5))),
    "osnet_x0_25": (OSNet, dict(channels=osnet_channels(0.25))),
    # PLR-OSNet: PAM + SE attention, global part and local branches
    "plr_osnet": (PLROSNet, {}),
    # ViT-t: dim 384, depth 6, 16 heads, mlp 2,048, SIE, BNNeck
    "vit": (ViT, {}),
    # Swin-T: hidden 96, layers (2, 2, 6, 2), heads (3, 6, 12, 24), window 7
    "swin_v1": (SwinTransformer, dict(version="v1")),
    "swin_v2": (SwinTransformer, dict(version="v2")),
    # the 3-D video ResNets of tracklet ReID, on (N, T, H, W, 3) clips
    "video_resnet50": (VideoResNet, dict(blocks=(3, 4, 6, 3))),
    "video_resnet18": (VideoResNet, dict(blocks=(2, 2, 2, 2))),
}

TRANSFORMERS = ("vit", "swin_v1", "swin_v2")
VIDEO = ("video_resnet50", "video_resnet18")


def supports_renorm(name: str) -> bool:
    """Whether backbone `name` has the BatchRenorm option: the SERes18
    family does, the ResNets and OSNets (here and in the JAX package) do
    not."""
    return name in MODELS and MODELS[name][0] is SERes18IBN


def build_model(name: str, num_classes: int, num_cams: int = 6,
                dtype=torch.float32, device="cuda",
                generator: Optional[torch.Generator] = None,
                renorm: bool = False,
                input_hw: Optional[Tuple[int, int]] = None, **kw):
    """Build an eval-mode model by backbone name on `device`, initialized
    from `generator` (a fresh one seeded 0 when None). `renorm` puts
    BatchRenorm into the SERes18 family's trunk; the other backbones have
    no such option (nor in the JAX package) and refuse it. `input_hw`
    sizes ViT's position table (its default (448, 224) otherwise); the
    other models take any size and ignore it. Further keyword arguments
    go to the model's constructor, as the JAX factories pass them
    (`vit`: num_seqs, dim, depth, heads, mlp_dim, dropout; `swin_*`:
    hidden_dim, layers, heads, head_dim, window_size, and `sie=True` for
    the SIE table that flax creates when `init` sees a cam; the video
    models: blocks, pooling). Names that neither package has raise
    KeyError."""
    if name not in MODELS:
        raise KeyError(f"no backbone '{name}'; have {sorted(MODELS)}")
    cls = MODELS[name][0]
    if renorm:
        if not supports_renorm(name):
            raise ValueError(f"renorm: backbone '{name}' has no BatchRenorm "
                             "option (the SERes18 family has: seres18, "
                             "cares18, emares18)")
        kw = dict(kw, renorm=True)
    if input_hw is not None and cls is ViT:
        kw = dict(kw, input_hw=tuple(input_hw))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = cls(num_classes=num_classes, num_cams=num_cams, dtype=dtype,
                **dict(MODELS[name][1], **kw))
    return model.init_weights(generator).to(device).eval()
