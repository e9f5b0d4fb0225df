"""Flax variables -> the port's modules, without JAX.

The inverse of the layout map in `reid_tpu/utils/torch_convert.py:12-17`:
flax conv kernels are HWIO and become OIHW, dense kernels (in, out) become
(out, in); BatchNorm `scale`/`bias` with `batch_stats` `mean`/`var` become
`weight`/`bias`/`running_mean`/`running_var`, InstanceNorm `scale`/`bias`
become `weight`/`bias`; `gem/p` and `cam_bias` keep their names. A flax path
"block11/bn1/IN/scale" names the parameter "block11.bn1.IN.weight". The
same map carries the detectors (`models/yolo.py`, `models/detector.py`),
whose module names equal the flax ones; a transposed conv's kernel
(kh, kw, in, out) becomes (in, out, kh, kw) flipped in both spatial axes
(`models.layers.ConvTranspose2d` says why).

Variables arrive as a nested dict of numpy arrays ({"params": ...,
"batch_stats": ...}) or as an `.npz` whose keys are the `/`-joined paths
("params/block11/conv1/kernel"), which takes the place of an orbax
checkpoint here. A JAX `QuantState` crosses the same way.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from .quantize import QuantState

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_npz(path: str, variables: Mapping) -> None:
    """Write a variable tree as an `.npz` with `/`-joined keys."""
    np.savez(path, **{"/".join(k): np.asarray(v)
                      for k, v in flatten(variables).items()})


def load_npz(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def kernel_to_torch(k: np.ndarray) -> np.ndarray:
    """Flax kernel layout -> PyTorch weight layout."""
    k = np.asarray(k)
    return k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T


def transposed_kernel_to_torch(k: np.ndarray) -> np.ndarray:
    """flax ConvTranspose kernel (kh, kw, in, out), transpose_kernel=False
    -> the (in, out, kh, kw) weight of `conv_transpose2d`, flipped."""
    return np.ascontiguousarray(
        np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1))


def torch_state_dict(variables: Mapping, transposed: Iterable[str] = ()
                     ) -> Dict[str, torch.Tensor]:
    """The state_dict of a flax variable tree; `transposed` names the
    modules ("up3") that are transposed convs."""
    transposed = set(transposed)
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, v in flatten(variables.get(coll, {})).items():
            *mods, leaf = path
            arr = np.asarray(v, np.float32)
            if leaf == "kernel":
                arr = (transposed_kernel_to_torch(arr)
                       if ".".join(mods) in transposed
                       else kernel_to_torch(arr))
            name = ".".join(mods + [_LEAF.get(leaf, leaf)])
            sd[name] = torch.tensor(arr)
    return sd


def load_flax_variables(model: torch.nn.Module, variables) -> None:
    """Copy flax variables (a tree, or an `.npz` path) into `model`; every
    parameter and buffer must be covered."""
    from ..models.layers import ConvTranspose2d

    if isinstance(variables, str):
        variables = load_npz(variables)
    transposed = [n for n, m in model.named_modules()
                  if isinstance(m, ConvTranspose2d)]
    model.load_state_dict(torch_state_dict(variables, transposed),
                          strict=True)


def quant_state_from_flax(qstate, device="cuda") -> QuantState:
    """A JAX `QuantState` (or its `.tree()`) as the port's `QuantState`."""
    tree = qstate.tree() if hasattr(qstate, "tree") else qstate
    kernels = {p: torch.tensor(kernel_to_torch(np.asarray(k, np.int8)),
                               device=device)
               for p, k in tree["kernels"].items()}
    w_scales = {p: torch.tensor(np.asarray(s, np.float32), device=device)
                for p, s in tree["w_scales"].items()}
    act_scales = {p: float(np.float32(s))
                  for p, s in tree["act_scales"].items()}
    return QuantState(kernels, w_scales, act_scales)
