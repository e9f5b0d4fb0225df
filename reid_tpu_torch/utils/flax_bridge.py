"""Flax variables -> the port's modules, without JAX.

The inverse of the layout map in `reid_tpu/utils/torch_convert.py:12-17`:
flax conv kernels are HWIO and become OIHW, dense kernels (in, out) become
(out, in); BatchNorm `scale`/`bias` with `batch_stats` `mean`/`var` become
`weight`/`bias`/`running_mean`/`running_var` (BatchRenorm adds its int32
`steps`), the other norms' `scale`/`bias` become `weight`/`bias`; `gem/p`,
`cam_bias`, `steps` and MetaAconC1D's `p1`/`p2` keep their names. A flax path
"block11/bn1/IN/scale" names the parameter "block11.bn1.IN.weight". The
same map carries the detectors (`models/yolo.py`, `models/detector.py`),
whose module names equal the flax ones; a transposed conv's kernel
(kh, kw, in, out) becomes (in, out, kh, kw) flipped in both spatial axes
(`models.layers.ConvTranspose2d` says why).

Variables arrive as a nested dict of numpy arrays ({"params": ...,
"batch_stats": ...}) or as an `.npz` whose keys are the `/`-joined paths
("params/block11/conv1/kernel"), which takes the place of an orbax
checkpoint here. A JAX `QuantState` crosses the same way. The way back,
`flax_variables`, gives a module's variables in flax naming and layout:
training writes its checkpoint with it. `train_state_from_flax` carries a
whole JAX train state across (variables, centers, DCC tables, optimizer
moments and count, XBM ring; PLR-OSNet's two branches' tables), so that
both packages can resume from one point. OSNet's depthwise kernels
(kh, kw, 1, C) become (C, 1, kh, kw) by the same transpose, a 1-D conv's
kernel (k, in, out) becomes (out, in, k), and PAM's `gamma` keeps its
name. The transformers' attention (`models/vit.py:HeadDense`, flax's
`DenseGeneral`s "query", "key", "value" and "out" of
`MultiHeadDotProductAttention`) has 3-D kernels that a transpose would
scramble: (in, heads, head_dim) becomes (heads * head_dim, in) and
(heads, head_dim, out) becomes (out, heads * head_dim), a (heads,
head_dim) bias becomes flat, and the way back restores those shapes.
The video model's 3-D conv kernels (kT, kH, kW, I, O) become (O, I, kT,
kH, kW), named explicitly as well. The
cls token, the position tables (ViT's (1, L + 1, D), Swin v1's
(2ws - 1, 2ws - 1)), v2's `logit_scale` and the SIE tables keep their
names and shapes. Swin's SIE table exists in a flax tree only where
`init` saw a cam: loading a tree with or without it gives the model
that table or takes it away. The GAN (`gan/models.py`) adds three
kinds: flax's `nn.SpectralNorm` keeps a layer's power-iteration `u` and
`sigma` in `batch_stats` under "<block>/SpectralNorm_<i>/<layer>/kernel/
{u,sigma}" (one key with slashes in flax's own tree, nested keys after
an `.npz`), which become the buffers "<block>.<layer>.u" / ".sigma"
(`SpectralConv2d.sn_index` gives <i> back); an `nn.Embed` table keeps
its name "embedding"; and its transposed convs cross as above, (4, 2)
and 6x6 kernels too.
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
    """Flax kernel layout -> PyTorch weight layout: a 3-D conv's (kT, kH,
    kW, I, O) becomes (O, I, kT, kH, kW), a 2-D conv's (kH, kW, I, O)
    (O, I, kH, kW), a dense or 1-D conv's kernel its transpose."""
    k = np.asarray(k)
    if k.ndim == 5:
        return k.transpose(4, 3, 0, 1, 2)
    return k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T


# the DenseGenerals of flax's MultiHeadDotProductAttention, by name
_HEADS_IN = ("query", "key", "value")
_HEADS_OUT = "out"


def head_kernel_to_torch(name: str, k: np.ndarray) -> np.ndarray:
    """An attention projection's 3-D kernel -> its (out, in) weight:
    (in, heads, head_dim) for "query" / "key" / "value", (heads,
    head_dim, out) for "out"."""
    k = np.asarray(k)
    if name == _HEADS_OUT:
        return np.ascontiguousarray(k.reshape(-1, k.shape[-1]).T)
    return np.ascontiguousarray(k.reshape(k.shape[0], -1).T)


def _is_head_leaf(mods, arr, leaf) -> bool:
    """A kernel (3-D) or bias (2-D) of an attention projection."""
    if not mods or leaf not in ("kernel", "bias"):
        return False
    if mods[-1] in _HEADS_IN:
        return arr.ndim == (3 if leaf == "kernel" else 2)
    return mods[-1] == _HEADS_OUT and leaf == "kernel" and arr.ndim == 3


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
            *mods, leaf = _spectral_path(path)
            # BatchRenorm's step counter stays an integer
            arr = np.asarray(v, np.int32 if leaf == "steps" else np.float32)
            if _is_head_leaf(mods, arr, leaf):
                arr = head_kernel_to_torch(mods[-1], arr) \
                    if leaf == "kernel" else arr.reshape(-1)
            elif leaf == "kernel":
                arr = (transposed_kernel_to_torch(arr)
                       if ".".join(mods) in transposed
                       else kernel_to_torch(arr))
            name = ".".join(mods + [_LEAF.get(leaf, leaf)])
            sd[name] = torch.tensor(arr)
    return sd


def _spectral_path(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """A SpectralNorm statistic's path ("block1", "SpectralNorm_0",
    "conv1/kernel/u") as the buffer's ("block1", "conv1", "u"); any
    other path as it is."""
    parts = "/".join(path).split("/")
    for i, p in enumerate(parts):
        if p.startswith("SpectralNorm_") and len(parts) == i + 4:
            return tuple(parts[:i] + [parts[i + 1], parts[i + 3]])
    return path


def load_flax_variables(model: torch.nn.Module, variables) -> None:
    """Copy flax variables (a tree, or an `.npz` path) into `model`; every
    parameter and buffer must be covered. BatchRenorm's `steps` counters
    are dropped where `model` has plain BatchNorm in their place: eval-mode
    BatchRenorm is BatchNorm's function of the same scale, bias, mean and
    var, so a `--renorm` checkpoint serves as the JAX package serves it
    (whose restore skips the leaves its model lacks)."""
    from ..models.layers import ConvTranspose2d

    if isinstance(variables, str):
        variables = load_npz(variables)
    _adopt_sie_table(model, variables)
    transposed = [n for n, m in model.named_modules()
                  if isinstance(m, ConvTranspose2d)]
    sd = torch_state_dict(variables, transposed)
    own = model.state_dict()
    sd = {k: v for k, v in sd.items()
          if k in own or not k.endswith(".steps")}
    model.load_state_dict(sd, strict=True)


def _adopt_sie_table(model: torch.nn.Module, variables) -> None:
    """Give a Swin the SIE table that the tree has, or take away the one
    the tree lacks (flax's tree has it only where `init` saw a cam)."""
    from ..models.swin import SwinTransformer

    if not isinstance(model, SwinTransformer):
        return
    table = variables.get("params", {}).get("side_info_embedding")
    if table is None:
        model.side_info_embedding = None
    elif model.side_info_embedding is None:
        dev = next(model.parameters()).device
        model.side_info_embedding = torch.nn.Parameter(
            torch.zeros(np.shape(table), device=dev))


def classifier_width(params) -> int:
    """The number of classes of a flax params tree: the width of its
    classifier ("classifier"; PLR-OSNet's "classifier1"; the
    transformers' "mlp_head")."""
    for name in ("classifier", "classifier1", "mlp_head"):
        if name in params:
            return int(params[name]["kernel"].shape[1])
    raise KeyError("no classifier in the checkpoint's params")


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


def kernel_from_torch(w: np.ndarray) -> np.ndarray:
    """PyTorch weight layout -> flax kernel layout (`kernel_to_torch`'s
    inverse)."""
    w = np.asarray(w)
    if w.ndim == 5:
        return w.transpose(2, 3, 4, 1, 0)
    return w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T


def flax_variables(model: torch.nn.Module) -> Dict[str, Any]:
    """{"params": ..., "batch_stats": ...} of `model` as nested dicts of
    f32 numpy arrays in flax naming and layout: the inverse of
    `torch_state_dict`, so `load_flax_variables` reads it back."""
    from ..gan.models import SpectralConv2d
    from ..models.layers import ConvTranspose2d
    from ..models.vit import HeadDense

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, leaf, value):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value

    for mname, m in model.named_modules():
        path = mname.split(".") if mname else []
        is_conv = isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d,
                                 torch.nn.Conv3d, torch.nn.Linear))
        for name, t in m.named_parameters(recurse=False):
            arr = t.detach().to("cpu", torch.float32).numpy()
            leaf = name
            if isinstance(m, HeadDense):
                arr, leaf = _head_from_torch(m, name, arr)
            elif name == "weight":
                if isinstance(m, ConvTranspose2d):
                    arr, leaf = arr.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
                elif is_conv:
                    arr, leaf = kernel_from_torch(arr), "kernel"
                else:
                    leaf = "scale"
            put(params, path, leaf, np.array(arr))
        for name, t in m.named_buffers(recurse=False):
            if name in m._non_persistent_buffers_set:
                continue        # constants (Swin's masks and offsets)
            if isinstance(m, SpectralConv2d):
                put(stats, path[:-1] + [f"SpectralNorm_{m.sn_index}"],
                    f"{path[-1]}/kernel/{name}", t.detach().cpu().numpy())
                continue
            leaf = {"running_mean": "mean", "running_var": "var",
                    "steps": "steps"}[name]
            dtype = torch.int32 if name == "steps" else torch.float32
            put(stats, path, leaf, t.detach().to("cpu", dtype).numpy())
    return {"params": params, "batch_stats": stats}


def _head_from_torch(m, name: str, arr: np.ndarray):
    """A `HeadDense` parameter back in flax's DenseGeneral shape."""
    h, hd = m.heads, m.head_dim
    if name == "bias":
        return (arr.reshape(h, hd) if m.to_heads else arr), "bias"
    if m.to_heads:
        return arr.T.reshape(-1, h, hd), "kernel"
    return arr.T.reshape(h, hd, -1), "kernel"


def _named_tree(tree, names, device) -> list:
    """A flax parameter-shaped tree as tensors in the order of `names`
    (torch parameter names), kernels in torch layout."""
    sd = torch_state_dict({"params": tree})
    return [sd[n].to(device) for n in names]


def _find_states(opt_state, fields):
    """The optax states in a (nested) chain state that have `fields`."""
    if all(hasattr(opt_state, f) for f in fields):
        return [opt_state]
    if isinstance(opt_state, (tuple, list)):
        return [s for x in opt_state for s in _find_states(x, fields)]
    return []


def _opt_state_from_flax(tx, opt_state, names, device) -> dict:
    """The port's optimizer state for `tx` from an optax chain state: Adam's
    mu / nu and count, MADGRAD's grad_sum / grad_sum_sq / x0 and count, or
    SGD's trace and the schedule's count."""
    from ..train.optim import Madgrad

    if isinstance(tx, Madgrad):
        (m,) = _find_states(opt_state, ("grad_sum", "grad_sum_sq", "x0"))
        return {"count": int(np.asarray(m.count)),
                **{k: _named_tree(getattr(m, k), names, device)
                   for k in ("grad_sum", "grad_sum_sq", "x0")}}
    if tx.adam:
        (a,) = _find_states(opt_state, ("mu", "nu", "count"))
        return {"count": int(np.asarray(a.count)),
                "mu": _named_tree(a.mu, names, device),
                "nu": _named_tree(a.nu, names, device)}
    (sched,) = _find_states(opt_state, ("count",))
    if not tx.momentum:
        return {"count": int(np.asarray(sched.count))}
    (tr,) = _find_states(opt_state, ("trace",))
    return {"count": int(np.asarray(sched.count)),
            "trace": _named_tree(tr.trace, names, device)}


def train_state_from_flax(state, cfg, steps_per_epoch: int, device="cuda"):
    """The port's train state from a JAX one (its arrays read as numpy):
    from a `ReIDTrainState` the port's `ReIDTrainState` (the model with
    params and batch_stats, centers, DCC tables, the optimizer's moments
    and count, the XBM ring and the step); from PLR-OSNet's
    `PLRTrainState` the port's (the model, both branches' centers and DCC
    tables, the optimizer state, the step). The optimizers come from `cfg`
    and `steps_per_epoch`, as the JAX state's were built; the center
    optimizers have no state."""
    from ..losses import DCCState, HybridLossState, XBMState
    from ..models import build_model
    from ..train.state import ReIDTrainState, make_optimizers

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    def loss_state(ls):
        return HybridLossState(
            centers=t(ls.centers),
            dcc=DCCState(lut_ccc=t(ls.dcc.lut_ccc),
                         lut_icc=t(ls.dcc.lut_icc)))

    params = state.params
    variables = {"params": params, "batch_stats": state.batch_stats}
    model = build_model(cfg.model.backbone,
                        num_classes=classifier_width(params),
                        num_cams=np.shape(params["cam_bias"])[0]
                        if "cam_bias" in params else cfg.model.num_cams,
                        dtype=getattr(torch, cfg.model.dtype), device=device,
                        renorm=cfg.model.renorm,
                        input_hw=(cfg.data.height, cfg.data.width))
    load_flax_variables(model, variables)
    names = [n for n, _ in model.named_parameters()]
    tx, center_tx = make_optimizers(cfg, steps_per_epoch)
    opt = _opt_state_from_flax(tx, state.opt_state, names, device)
    if hasattr(state, "loss1"):
        from ..train.plr_train import PLRTrainState
        return PLRTrainState(model=model, loss1=loss_state(state.loss1),
                             loss2=loss_state(state.loss2), opt_state=opt,
                             tx=tx, center_tx=center_tx,
                             step=int(np.asarray(state.step)))
    xbm = None
    if state.xbm is not None:
        xbm = XBMState(feats=t(state.xbm.feats),
                       labels=t(state.xbm.labels, torch.int32),
                       ptr=int(np.asarray(state.xbm.ptr)))
    return ReIDTrainState(model=model, loss_state=loss_state(
        state.loss_state), opt_state=opt, tx=tx, center_tx=center_tx,
        step=int(np.asarray(state.step)), xbm=xbm)
