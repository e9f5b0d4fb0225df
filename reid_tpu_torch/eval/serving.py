"""The serving embed: images in, retrieval embeddings out.

Counterpart of `reid_tpu/eval/serving.py`'s `make_embed_fn`,
`calibrate_serving_qstate`, `make_int8_embed_fn`, `export_reid_artifact`,
`load_serving_fn` and `extract_embeddings_artifact`: normalization, the
dual-view TTA flip and the L2-normalized [feat || logits] merge around a
model, in f32 or post-training quantized to int8 (`utils/quantize.py`,
which reaches the kernels `conv3x3_s8` and `se_basic_block_s8` on the
card), served in process or exported whole to a serving artifact: a
`torch.export` `.pt2` here, where the JAX package writes StableHLO.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..data.dataset import ReIDDataset
from ..data.loader import make_eval_loader
from ..data.transforms import inference_batch
from ..train.steps import embed_single, embed_with_flip
from ..utils.export import export_serving_fn, load_serving_fn

__all__ = ["make_embed_fn", "calibrate_serving_qstate", "make_int8_embed_fn",
           "export_reid_artifact", "load_serving_fn",
           "extract_embeddings_with"]


def make_embed_fn(model, tta_flip: bool = True) -> Callable:
    """fn(images [0, 255] (B, H, W, 3)) -> (B, 512 + C) L2-normalized
    embeddings: the function the reference freezes into its ONNX graph
    (inference_efficient, image_reid_inference.py:78-135). `model` is the
    f32 model or its `quantized_model` copy. Runs without autograd, so a
    caller outside `torch.inference_mode` keeps no graph."""

    def embed(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
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


def export_reid_artifact(model, path: str, height: int, width: int,
                         tta_flip: bool = True, dynamic_batch: bool = True,
                         int8_calib: torch.Tensor = None, qstate=None):
    """Export the whole serving step - normalization, TTA, the L2 merge -
    around `model` to a `.pt2` at `path` (ref to_onnx,
    train_prepare.py:14-47); returns the ExportedProgram. Inputs are
    images [0, 255] (b, height, width, 3) f32 on the model's device, where
    the artifact then runs.

    With `int8_calib` ([0, 255] images) the backbone is calibrated and
    quantized to int8 first; a `qstate` skips the calibration, so the same
    scales serve in process (`make_int8_embed_fn`) and in the artifact.
    The int8 graph holds K1 and K2 as custom ops."""
    if qstate is None and int8_calib is not None:
        qstate = calibrate_serving_qstate(model, int8_calib,
                                          tta_flip=tta_flip)
    if qstate is not None:
        from ..utils.quantize import quantized_model
        model = quantized_model(model, qstate)
    dev = next(model.parameters()).device
    example = (torch.zeros((2, height, width, 3), dtype=torch.float32,
                           device=dev),)
    return export_serving_fn(make_embed_fn(model, tta_flip=tta_flip),
                             example, path, dynamic_batch=dynamic_batch)


@torch.inference_mode()
def extract_embeddings_with(embed: Callable, dataset: ReIDDataset,
                            batch_size: int, device="cuda") -> torch.Tensor:
    """Whole-dataset embeddings through a serving embed or a loaded
    artifact (the `extract_embeddings_artifact` role), cut back to
    `len(dataset)`."""
    feats = [embed(b["images"].to(torch.float32))
             for b in make_eval_loader(dataset, batch_size, device=device)]
    return torch.cat(feats)[:len(dataset)]
