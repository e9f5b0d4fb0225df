"""Model factory - name -> module. Counterpart of
`reid_tpu/models/factory.py:build_model` for the backbones the port has:
seres18, baseline, resnet50 and agw."""

from __future__ import annotations

from typing import Optional

import torch

from .baseline import ResNetReID
from .seres18 import SERes18IBN

BOTTLENECK50 = dict(block="bottleneck", blocks=(3, 4, 6, 3))
# name -> (module, its arguments besides num_classes, num_cams and dtype)
MODELS = {
    "seres18": (SERes18IBN, {}),
    # ft_baseline: ResNet18 + ClassBlock
    "baseline": (ResNetReID, dict(block="basic", blocks=(2, 2, 2, 2))),
    # ft_net: ResNet50 + ClassBlock
    "resnet50": (ResNetReID, BOTTLENECK50),
    # AGW: ResNet50 + non-local + GeM pooling, no bottleneck fc
    "agw": (ResNetReID, dict(BOTTLENECK50, non_local=True, pooling="gem",
                             bottleneck_dim=0)),
}


def build_model(name: str, num_classes: int, num_cams: int = 6,
                dtype=torch.float32, device="cuda",
                generator: Optional[torch.Generator] = None):
    """Build an eval-mode model by backbone name on `device`, initialized
    from `generator` (a fresh one seeded 0 when None)."""
    if name not in MODELS:
        raise KeyError(f"backbone '{name}' is not ported yet; have "
                       f"{sorted(MODELS)}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    cls, kw = MODELS[name]
    model = cls(num_classes=num_classes, num_cams=num_cams, dtype=dtype, **kw)
    return model.init_weights(generator).to(device).eval()
