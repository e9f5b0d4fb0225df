"""Post-training int8 quantization of any module tree of the port (the
SERes18 embed, the YOLOv5 trunk).

Counterpart of `reid_tpu/utils/quantize.py`. The JAX package calibrates and
executes through flax method interceptors; here calibration hooks every
`Conv2d` and `Linear` that `select` accepts and execution swaps modules:

  * calibration records each layer's input absmax (forward pre-hooks);
  * weights get per-output-channel symmetric scales, absmax / 127;
  * every calibrated layer runs in int8: its input is quantized (round half
    to even, clip to +-127), accumulated s8 x s8 -> s32 exactly, rescaled
    by sx*sw in f32 and cast to the layer's dtype;
  * stride-1 SE blocks with Cin and Cout multiples of 128 run as one fused
    block (`ops/qblock.py`), and the other 3x3 stride-1 convs with both
    channel counts multiples of 128 run on `ops/qconv.py` - the routing
    order of `quantization_interceptor`;
  * the remaining int8 layers (stem, 64-channel blocks, stride-2 convs, SE
    fcs of non-fused blocks, classifier) multiply an im2col by
    `torch._int_mm` on the card (cuBLAS s8 x s8 -> s32, exact; K and N
    zero-padded to multiples of 8, M to more than 16), and in float64
    (exact) on the CPU.

Keys are flax module paths ("block21/conv2"), so a JAX `QuantState` maps
onto this one (`utils/flax_bridge.py`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import Conv2d, Linear
from ..models.seres18 import SEBasicBlock
from ..ops.qblock import QBlockParams, fold_bn, se_basic_block_s8
from ..ops.qconv import (conv3x3_s8, conv_acc_plain, pack_conv_weight,
                         qconv_applicable, quantize_s8)


@dataclasses.dataclass(frozen=True)
class QuantState:
    """Int8 kernels + scales keyed by flax module path ("a/b/c")."""
    kernels: Dict[str, torch.Tensor]    # int8, PyTorch layout (OIHW / OI)
    w_scales: Dict[str, torch.Tensor]   # (C_out,) f32
    act_scales: Dict[str, float]        # f32-valued input scale per layer


def _path(name: str) -> str:
    return name.replace(".", "/")


def quantizable(model: nn.Module) -> Iterable[Tuple[str, nn.Module]]:
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            yield _path(name), m


@torch.no_grad()
def calibrate(model: nn.Module, batches: Sequence[torch.Tensor],
              select: Optional[Callable[[str, nn.Module], bool]] = None
              ) -> Dict[str, float]:
    """Run calibration batches; return per-layer input absmax."""
    select = select or (lambda path, m: True)
    stats: Dict[str, torch.Tensor] = {}
    hooks = []

    def hook_for(path):
        def hook(_m, args):
            v = torch.amax(torch.abs(args[0].to(torch.float32)))
            stats[path] = v if path not in stats else torch.maximum(
                stats[path], v)
        return hook

    for path, m in quantizable(model):
        if select(path, m):
            hooks.append(m.register_forward_pre_hook(hook_for(path)))
    try:
        for b in batches:
            model(b)
    finally:
        for h in hooks:
            h.remove()
    return {k: float(v) for k, v in stats.items()}


@torch.no_grad()
def quantize_weights(model: nn.Module, act_absmax: Dict[str, float]
                     ) -> QuantState:
    """Per-output-channel symmetric int8 quantization of every layer that
    has a calibrated activation scale."""
    mods = dict(quantizable(model))
    kernels, w_scales, act_scales = {}, {}, {}
    for path, amax in act_absmax.items():
        kernel = mods[path].weight.to(torch.float32)
        dims = tuple(range(1, kernel.dim()))       # all but C_out
        absmax = torch.clamp(torch.amax(torch.abs(kernel), dim=dims),
                             min=1e-12)
        scale = absmax / 127.0
        q = torch.clamp(torch.round(kernel / scale.reshape(-1, *[1] * len(
            dims))), -127, 127).to(torch.int8)
        kernels[path] = q
        w_scales[path] = scale
        act_scales[path] = float(np.float32(max(amax, 1e-12) / 127.0))
    return QuantState(kernels, w_scales, act_scales)


def quantize(model: nn.Module, calib_batches: Sequence[torch.Tensor],
             select: Optional[Callable[[str, nn.Module], bool]] = None
             ) -> QuantState:
    """One-shot PTQ: calibrate + quantize."""
    return quantize_weights(model, calibrate(model, calib_batches, select))


def inv_f32(s: float) -> float:
    """The f32 reciprocal of f32(s): XLA compiles a division by a constant
    into a multiplication by it."""
    return float(np.float32(1.0) / np.float32(s))


def quantize_input(x: torch.Tensor, sx: float) -> torch.Tensor:
    """`_quantized_conv`'s input quantization, clip(round(x / sx)), as the
    compiled JAX program computes it: XLA rewrites the division by the
    constant scale into a multiplication by its f32 reciprocal."""
    return quantize_s8(x, inv_f32(sx))


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


class _Int8Matmul(nn.Module):
    """acc = A @ W^T for int8 A (M, K) and the layer's packed (N, K)
    weight, exact, returned as f32 (the rounding of `acc.astype(f32)`)."""

    def __init__(self, wt: torch.Tensor):
        super().__init__()
        n, k = wt.shape
        self.n, self.k = n, k
        self.register_buffer("wt", wt.contiguous())
        # the card's copy for torch._int_mm, zero-padded to multiples of 8
        wp = torch.zeros((_pad_to(n, 8), _pad_to(k, 8)), dtype=torch.int8)
        wp[:n, :k] = wt.cpu()
        self.register_buffer("wt_pad", wp)

    def acc(self, a: torch.Tensor) -> torch.Tensor:
        if a.device.type == "cpu":
            return (a.to(torch.float64) @ self.wt.to(torch.float64).T).to(
                torch.float32)
        # `a` has K columns, or already the zero-padded width (an im2col)
        m, ka = a.shape
        mp = max(m, 32)
        kp = self.wt_pad.shape[1]
        if mp != m or ka != kp:
            a_p = torch.zeros((mp, kp), dtype=torch.int8, device=a.device)
            a_p[:m, :ka] = a
            a = a_p
        out = torch._int_mm(a, self.wt_pad.T)
        return out[:m, :self.n].to(torch.float32)


def _im2col(xq: torch.Tensor, k: int, stride: int, padding: int,
            k_cols: int) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """NHWC int8 -> (B*Ho*Wo, k_cols) rows ordered (dy, dx, cin), zero
    columns past k*k*cin."""
    b, h, w, c = xq.shape
    if k == 1:
        xs = xq[:, ::stride, ::stride, :]
        rows = xs.reshape(-1, c)
        if k_cols != c:
            rows = F.pad(rows, (0, k_cols - c))
        return rows, xs.shape[:3]
    xp = F.pad(xq, (0, 0, padding, padding, padding, padding))
    cols = xp.unfold(1, k, stride).unfold(2, k, stride)   # b,ho,wo,c,k,k
    ho, wo = cols.shape[1], cols.shape[2]
    out = torch.zeros((b, ho, wo, k_cols), dtype=xq.dtype, device=xq.device)
    out[..., :k * k * c].unflatten(-1, (k, k, c)).copy_(
        cols.permute(0, 1, 2, 4, 5, 3))
    return out.reshape(b * ho * wo, k_cols), (b, ho, wo)


class QConv2d(nn.Module):
    """An int8 conv: `_quantized_conv`, with the 3x3 stride-1 route to the
    `conv3x3_s8` kernel."""

    def __init__(self, conv: Conv2d, kq: torch.Tensor, sw: torch.Tensor,
                 sx: float):
        super().__init__()
        # rounded to the layer's dtype whatever reads it (`keep_f32` is the
        # float conv's): the compiled JAX program keeps this rounding
        self.dtype = conv.dtype
        self.bias = conv.bias
        self.k = conv.kernel_size[0]
        self.stride = conv.stride[0]
        self.padding = conv.padding[0]
        self.sx = sx
        self.register_buffer("scale", sw.to(torch.float32) * sx)
        # activations are always 4-D NHWC, so only the kernel decides
        self.route = qconv_applicable((0, 0, 0, 0), tuple(kq.shape),
                                      conv.stride, conv.padding,
                                      conv.groups, conv.dilation)
        self.mm = _Int8Matmul(pack_conv_weight(kq))

    def forward(self, x):
        xq = quantize_input(x, self.sx)
        if self.route:
            out = conv3x3_s8(xq, self.mm.wt, self.scale, out_dtype=self.dtype)
            return out if self.bias is None else out + self.bias.to(
                self.dtype)
        if xq.device.type == "cpu":
            acc = conv_acc_plain(xq, self.mm.wt, self.k, self.stride,
                                 self.padding)
        else:
            rows, (b, ho, wo) = _im2col(xq, self.k, self.stride,
                                        self.padding, self.mm.wt_pad.shape[1])
            acc = self.mm.acc(rows).reshape(b, ho, wo, -1)
        out = acc * self.scale
        if self.bias is not None:
            out = out + self.bias.to(torch.float32)
        return out.to(self.dtype)


class QLinear(nn.Module):
    """An int8 dense layer: `_quantized_dense`."""

    def __init__(self, lin: Linear, kq: torch.Tensor, sw: torch.Tensor,
                 sx: float):
        super().__init__()
        self.dtype = lin.dtype
        self.sx = sx
        self.register_buffer("scale", sw.to(torch.float32) * sx)
        self.mm = _Int8Matmul(kq)

    def forward(self, x):
        xq = quantize_input(x, self.sx)
        lead = xq.shape[:-1]
        acc = self.mm.acc(xq.reshape(-1, xq.shape[-1]))
        return (acc.reshape(*lead, -1) * self.scale).to(self.dtype)


class QSEBasicBlock(nn.Module):
    """A stride-1 SE block run as one fused int8 block. Its parameters
    stay on the device `make_qblock_params` put them on."""

    def __init__(self, params: QBlockParams, ibn: bool, dtype):
        super().__init__()
        self.p = params
        self.ibn = ibn
        self.dtype = dtype

    def forward(self, x):
        return se_basic_block_s8(x.contiguous(), self.p, ibn=self.ibn,
                                 out_dtype=self.dtype)


@torch.no_grad()
def make_qblock_params(block: SEBasicBlock, qstate: QuantState,
                       prefix: str) -> QBlockParams:
    """Fold one SEBasicBlock's parameters and quantization state into
    `QBlockParams` (`reid_tpu.utils.quantize.make_qblock_params`):
    BN affines fold with the conv dequant scales; the IBN flavor keeps
    conv1's dequant vector apart and zero-pads the two half affines."""
    f32 = torch.float32
    dev = block.conv1.weight.device
    k1 = qstate.kernels[prefix + "conv1"]
    k2 = qstate.kernels[prefix + "conv2"]
    cout, cin = k1.shape[0], k1.shape[1]
    dq1 = qstate.w_scales[prefix + "conv1"] * qstate.act_scales[
        prefix + "conv1"]
    dq2 = qstate.w_scales[prefix + "conv2"] * qstate.act_scales[
        prefix + "conv2"]
    kw = {}
    if block.ibn:
        half = cout // 2
        bn, inn = block.bn1.BN, block.bn1.IN
        a_bn, c_bn = fold_bn(bn.weight, bn.bias, bn.running_mean,
                             bn.running_var)
        pad = torch.zeros(half, dtype=f32, device=dev)
        kw.update(a1=torch.cat([pad, a_bn]), c1=torch.cat([pad, c_bn]),
                  dq1_vec=dq1 * torch.ones(cout, dtype=f32, device=dev),
                  in_scale=torch.cat([inn.weight.to(f32), pad]),
                  in_bias=torch.cat([inn.bias.to(f32), pad]))
    else:
        bn = block.bn1
        a1, c1 = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var)
        kw.update(a1=a1 * dq1, c1=c1)
    a2, c2 = fold_bn(block.bn2.weight, block.bn2.bias,
                     block.bn2.running_mean, block.bn2.running_var)
    if block.downsample:
        path = prefix + "down_conv"
        dqd = qstate.w_scales[path] * qstate.act_scales[path]
        bn = block.down_bn
        ad, cd = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var)
        kw.update(wd=qstate.kernels[path].reshape(cout, cin).contiguous(),
                  ad=ad * dqd, cd=cd, inv_sxd=inv_f32(qstate.act_scales[path]))
    se = block.seblock
    p = QBlockParams(
        w1=pack_conv_weight(k1), w2=pack_conv_weight(k2),
        a2=a2 * dq2, c2=c2,
        inv_sx1=inv_f32(qstate.act_scales[prefix + "conv1"]),
        inv_sx2=inv_f32(qstate.act_scales[prefix + "conv2"]),
        wfc1=se.fc1.weight.T.to(torch.bfloat16).contiguous(),
        wfc2=se.fc2.weight.T.to(torch.bfloat16).contiguous(),
        **kw)
    return QBlockParams(*[v.to(dev).contiguous()
                          if isinstance(v, torch.Tensor) else v for v in p])


def _fused(block: SEBasicBlock, qstate: QuantState, prefix: str) -> bool:
    """`_qblock_route`'s test: stride 1, Cin and Cout multiples of 128, and
    every conv of the block quantized."""
    if block.stride != 1 or block.cin % 128 or block.planes % 128:
        return False
    rels = ("conv1", "conv2") + (("down_conv",) if block.downsample else ())
    return all(prefix + r in qstate.kernels for r in rels)


def _set_submodule(root: nn.Module, path: str, module: nn.Module) -> None:
    parent_path, _, leaf = path.rpartition("/")
    parent = root.get_submodule(parent_path.replace("/", ".")) \
        if parent_path else root
    setattr(parent, leaf, module)


def quantized_model(model: nn.Module, qstate: QuantState) -> nn.Module:
    """A copy of `model` whose calibrated layers execute in int8: fused SE
    blocks first (SERes18), then every remaining Conv2d / Linear in
    `qstate`, whatever the tree; layers not in `qstate` keep their
    precision."""
    qm = copy.deepcopy(model)
    for name, block in list(qm.named_modules()):
        path = _path(name)
        if isinstance(block, SEBasicBlock) and _fused(block, qstate,
                                                      path + "/"):
            _set_submodule(qm, path, QSEBasicBlock(
                make_qblock_params(block, qstate, path + "/"), block.ibn,
                block.conv1.dtype))
    dev = next(model.parameters()).device
    for path, m in list(quantizable(qm)):
        if path not in qstate.kernels:
            continue
        kq = qstate.kernels[path]
        sw = qstate.w_scales[path]
        sx = qstate.act_scales[path]
        q = QConv2d(m, kq, sw, sx) if isinstance(m, Conv2d) else QLinear(
            m, kq, sw, sx)
        _set_submodule(qm, path, q.to(dev))
    return qm
