"""Serving artifacts through `torch.export`.

Counterpart of `reid_tpu/utils/export.py` (the deployment-format role of
the reference's ONNX export with a dynamic batch axis, ref
`reid/train_prepare.py:14-47`; consumed at `image_reid_inference.py:239`).
Where the JAX package writes a StableHLO module, the port writes a `.pt2`
ExportedProgram with a symbolic batch axis `b`. The two formats are not
interchangeable: each package reads only its own.

The int8 kernels K1 and K2 are custom ops (`reid_tpu_torch::conv3x3_s8`,
`reid_tpu_torch::se_basic_block_s8`, `ops/qconv.py`, `ops/qblock.py`), so
an exported graph holds them as nodes and a loaded artifact launches them
on the card, counted as any other launch.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


class _Fn(torch.nn.Module):
    """A callable as the root module that `torch.export` takes; the
    tensors it closes over become the program's constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_serving_fn(fn: Callable, example_args: Tuple, path: str,
                      dynamic_batch: bool = True
                      ) -> torch.export.ExportedProgram:
    """Export `fn(*example_args)` and save it at `path` (a `.pt2`).

    `fn` closes over its weights, like the reference's exported ONNX graph.
    With `dynamic_batch`, dim 0 of every argument is the one symbolic size
    `b`; give examples of batch 2 or more, so that tracing does not
    specialise `b` to 0 or 1. Tracing runs outside inference mode, whose
    tensors `torch.export` cannot trace. The file holds the program and
    the tensors it closes over, not the example arguments."""
    shapes = None
    if dynamic_batch:
        b = torch.export.Dim("b")
        # one entry: `_Fn.forward` takes its arguments as *args
        shapes = (tuple({0: b} for _ in example_args),)
    with torch.inference_mode(False), torch.no_grad():
        ep = torch.export.export(_Fn(fn), tuple(example_args),
                                 dynamic_shapes=shapes)
    # the archive would otherwise carry the example arguments, a whole
    # chunk of frames for a tracking chunk
    ep.example_inputs = None
    torch.export.save(ep, path)
    return ep


def load_serving_fn(path: str) -> Callable:
    """The callable of a saved artifact (the ORT-session role). It runs on
    the device it was exported on."""
    from .. import ops  # noqa: F401  registers the custom ops it may hold

    return torch.export.load(path).module()
