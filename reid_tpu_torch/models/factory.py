"""Model factory - name -> module. Counterpart of
`reid_tpu/models/factory.py:build_model`; this slice ports "seres18"."""

from __future__ import annotations

from typing import Optional

import torch


def build_model(name: str, num_classes: int, num_cams: int = 6,
                dtype=torch.float32, device="cuda",
                generator: Optional[torch.Generator] = None):
    """Build an eval-mode model by backbone name on `device`, initialized
    from `generator` (a fresh one seeded 0 when None)."""
    if name != "seres18":
        raise KeyError(f"backbone '{name}' is not ported yet; have "
                       "['seres18']")
    from .seres18 import SERes18IBN
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = SERes18IBN(num_classes=num_classes, num_cams=num_cams,
                       dtype=dtype).init_weights(generator)
    return model.to(device).eval()
