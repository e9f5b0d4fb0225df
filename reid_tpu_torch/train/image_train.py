"""Whole-dataset embedding of the port.

Counterpart of `reid_tpu/train/image_train.py:extract_embeddings` (ref
inference_efficient, image_reid_inference.py:78-135). Training and pseudo
labelling belong to the training slice; so does the crop-jitter
("strong") test-time transform.
"""

from __future__ import annotations

import torch

from ..data.dataset import ReIDDataset
from ..data.loader import make_eval_loader
from ..data.transforms import inference_batch
from .steps import embed_single, embed_with_flip


@torch.inference_mode()
def extract_embeddings(model, dataset: ReIDDataset, batch_size: int,
                       tta_flip: bool = True, device="cuda") -> torch.Tensor:
    """(len(dataset), D) f32 embeddings on `device`: TTA dual pass with
    `tta_flip`, one view otherwise. The loader wraps the last batch; its
    extra rows are cut off here."""
    feats = []
    for batch in make_eval_loader(dataset, batch_size, device=device):
        images = inference_batch(batch["images"])
        feats.append(embed_with_flip(model, images) if tta_flip
                     else embed_single(model, images))
    return torch.cat(feats)[:len(dataset)]
