"""The serving embed: images in, retrieval embeddings out.

Counterpart of `reid_tpu/eval/serving.py`'s `make_embed_fn`,
`calibrate_serving_qstate`, `make_int8_embed_fn` and
`extract_embeddings_artifact`: normalization, the dual-view TTA flip and
the L2-normalized [feat || logits] merge around a model, in f32 or
post-training quantized to int8 (`utils/quantize.py`, which reaches the
kernels `conv3x3_s8` and `se_basic_block_s8` on the card). Export to a
serving artifact (StableHLO in the JAX package; `torch.export` here) is a
later slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..data.dataset import ReIDDataset
from ..data.loader import make_eval_loader
from ..data.transforms import inference_batch
from ..train.steps import embed_single, embed_with_flip


def make_embed_fn(model, tta_flip: bool = True) -> Callable:
    """fn(images [0, 255] (B, H, W, 3)) -> (B, 512 + C) L2-normalized
    embeddings: the function the reference freezes into its ONNX graph
    (inference_efficient, image_reid_inference.py:78-135). `model` is the
    f32 model or its `quantized_model` copy."""

    def embed(images: torch.Tensor) -> torch.Tensor:
        x = inference_batch(images)
        return embed_with_flip(model, x) if tta_flip \
            else embed_single(model, x)

    return embed


@torch.inference_mode()
def calibrate_serving_qstate(model, calib_images: torch.Tensor,
                             tta_flip: bool = True):
    """Calibrate and quantize through the tensors the serving step feeds the
    model: `inference_batch`, and with TTA the concatenated [normal ;
    flipped] batch."""
    from ..utils.quantize import quantize

    x = inference_batch(calib_images)
    if tta_flip:
        x = torch.cat([x, torch.flip(x, dims=(2,))], dim=0)
    return quantize(model, [x])


def make_int8_embed_fn(model, calib_images: torch.Tensor = None,
                       tta_flip: bool = True, qstate=None) -> Callable:
    """The int8 serving embed: calibrate on `calib_images` ([0, 255],
    (N, H, W, 3)) unless a `qstate` is given, then serve through the
    quantized copy of `model`."""
    from ..utils.quantize import quantized_model

    if qstate is None:
        if calib_images is None:
            raise ValueError("need calib_images or a precomputed qstate")
        qstate = calibrate_serving_qstate(model, calib_images,
                                          tta_flip=tta_flip)
    return make_embed_fn(quantized_model(model, qstate), tta_flip=tta_flip)


@torch.inference_mode()
def extract_embeddings_with(embed: Callable, dataset: ReIDDataset,
                            batch_size: int, device="cuda") -> torch.Tensor:
    """Whole-dataset embeddings through a serving embed (the
    `extract_embeddings_artifact` role), cut back to `len(dataset)`."""
    feats = [embed(b["images"].to(torch.float32))
             for b in make_eval_loader(dataset, batch_size, device=device)]
    return torch.cat(feats)[:len(dataset)]
