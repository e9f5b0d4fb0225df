"""YOLOv5-class detector (CSP-Darknet + PANet + anchor Detect head), eval
mode, NHWC.

Counterpart of `reid_tpu/models/yolo.py`: the modules (`ConvBnSiLU`,
`Bottleneck`, `C3`, `SPPF`, `YOLOv5` with the published depth/width
multiples), `decode_yolo`, `nms_fixed` with its serial oracle,
`quantize_yolo`, `make_yolo_detector_fn` and `build_yolo`
(`decode_candidates` is `decode_yolo` before its top-k); plus
`load_yolov5_state_dict`, the counterpart of
`reid_tpu/utils/torch_convert.py:convert_yolov5` for a published
(ultralytics) `state_dict`. Module names equal the flax ones (l0 .. l23,
cv1/cv2/cv3, m{j}, det_m{k}), so a flax variable path
("l6/m0/cv2/conv/kernel") names the same parameter here
("l6.m0.cv2.conv.weight").

Rounding follows the compiled JAX program, which drops a rounding to
bf16 that the backend inserted where the next op converts back to f32
explicitly: a conv's product reaches its BatchNorm in f32
(`Conv2d.keep_f32`), and a SiLU product or a residual sum reaches an int8
layer's quantization unrounded, so block outputs here are f32 and each
float conv, concatenation and residual add rounds its inputs to bf16.

Under `quantize_yolo`'s int8 the trunk's 3x3 stride-1 convs whose Cin and
Cout are multiples of 128 run on the `conv3x3_s8` kernel (`ops/qconv.py`):
in YOLOv5s at 288x512 the bottlenecks l6.m0-m2, l13.m0 and l20.m0 at
18x32 with 128 channels and l8.m0 and l23.m0 at 9x16 with 256.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..tracking.pipeline import resize_bilinear_matmul
from ..utils.quantize import (calibrate, inv_f32, quantize_weights,
                              quantized_model)
from .detector import topk_stable
from .layers import (BatchNorm, Conv2d, max_pool_same, sigmoid_stepwise,
                     silu, upsample2_nearest)

# depth_multiple, width_multiple per published variant
YOLO_VARIANTS = {
    # pico: not a published variant - tiny widths for tests
    "yolov5p": (0.33, 0.125),
    "yolov5n": (0.33, 0.25),
    "yolov5s": (0.33, 0.50),
    "yolov5m": (0.67, 0.75),
    "yolov5l": (1.00, 1.00),
    "yolov5x": (1.33, 1.25),
}

# P5 anchor priors (w, h) in input pixels per level - the family's defaults
YOLO_ANCHORS = (
    ((10.0, 13.0), (16.0, 30.0), (33.0, 23.0)),      # P3/8
    ((30.0, 61.0), (62.0, 45.0), (59.0, 119.0)),     # P4/16
    ((116.0, 90.0), (156.0, 198.0), (373.0, 326.0)), # P5/32
)
YOLO_STRIDES = (8, 16, 32)
# the letterbox canvas value
PAD_VALUE = 0.447


def _divisible(x: float, d: int = 8) -> int:
    return max(int(round(x / d)) * d, d)


def cat(dtype, *xs) -> torch.Tensor:
    """Channel concatenation of the `dtype`-rounded inputs."""
    return torch.cat([x.to(dtype) for x in xs], dim=-1)


class ConvBnSiLU(nn.Module):
    """Conv + BN(eps 1e-3) + SiLU - the family's basic block; returns the
    SiLU product in f32, unrounded (`layers.silu`)."""

    def __init__(self, cin: int, ch: int, k: int = 1, s: int = 1,
                 dtype=torch.float32, p: int = -1):
        super().__init__()
        p = k // 2 if p < 0 else p   # -1 = autopad; the 6x6 stem uses p=2
        self.conv = Conv2d(cin, ch, k, s, p, dtype, keep_f32=True)
        self.bn = BatchNorm(ch, eps=1e-3, dtype=dtype)

    def forward(self, x):
        return silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, ch: int, shortcut: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.cv1 = ConvBnSiLU(cin, ch, 1, dtype=dtype)
        self.cv2 = ConvBnSiLU(ch, ch, 3, dtype=dtype)
        self.add = shortcut and cin == ch
        self.dtype = dtype

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        if not self.add:
            return y
        # the sum of the two dtype-rounded terms, unrounded
        return x.to(self.dtype).float() + y.to(self.dtype).float()


class C3(nn.Module):
    """CSP bottleneck: split 1x1 branches, n bottlenecks on one side."""

    def __init__(self, cin: int, ch: int, n: int = 1, shortcut: bool = True,
                 dtype=torch.float32):
        super().__init__()
        c_ = ch // 2
        self.n = n
        self.cv1 = ConvBnSiLU(cin, c_, 1, dtype=dtype)
        self.cv2 = ConvBnSiLU(cin, c_, 1, dtype=dtype)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c_, c_, shortcut, dtype))
        self.cv3 = ConvBnSiLU(2 * c_, ch, 1, dtype=dtype)
        self.dtype = dtype

    def forward(self, x):
        a = self.cv1(x)
        b = self.cv2(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(cat(self.dtype, a, b))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 max-pools, concat."""

    def __init__(self, cin: int, ch: int, dtype=torch.float32):
        super().__init__()
        c_ = cin // 2
        self.cv1 = ConvBnSiLU(cin, c_, 1, dtype=dtype)
        self.cv2 = ConvBnSiLU(4 * c_, ch, 1, dtype=dtype)
        self.dtype = dtype

    def forward(self, x):
        x = self.cv1(x).to(self.dtype)
        y1 = max_pool_same(x, 5, 1, 2)
        y2 = max_pool_same(y1, 5, 1, 2)
        y3 = max_pool_same(y2, 5, 1, 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=-1))


class YOLOv5(nn.Module):
    """Full detector; returns the 3 raw head maps (B, Hl, Wl, na*(5+nc))
    in f32 (each head conv computes in `dtype`, as flax's does)."""

    def __init__(self, num_classes: int = 1, variant: str = "yolov5s",
                 dtype=torch.float32):
        super().__init__()
        gd, gw = YOLO_VARIANTS[variant]
        self.num_classes, self.variant, self.dtype = num_classes, variant, \
            dtype

        def c(ch):
            return _divisible(ch * gw)

        def d(n):
            return max(round(n * gd), 1)

        def cbs(cin, ch, k, s, p=-1):
            return ConvBnSiLU(cin, ch, k, s, dtype, p)

        # backbone (torch indices 0-9)
        self.l0 = cbs(3, c(64), 6, 2, 2)                           # P1/2
        self.l1 = cbs(c(64), c(128), 3, 2)                         # P2/4
        self.l2 = C3(c(128), c(128), d(3), dtype=dtype)
        self.l3 = cbs(c(128), c(256), 3, 2)                        # P3/8
        self.l4 = C3(c(256), c(256), d(6), dtype=dtype)
        self.l5 = cbs(c(256), c(512), 3, 2)                        # P4/16
        self.l6 = C3(c(512), c(512), d(9), dtype=dtype)
        self.l7 = cbs(c(512), c(1024), 3, 2)                       # P5/32
        self.l8 = C3(c(1024), c(1024), d(3), dtype=dtype)
        self.l9 = SPPF(c(1024), c(1024), dtype)
        # PANet neck (torch indices 10-23)
        self.l10 = cbs(c(1024), c(512), 1, 1)
        self.l13 = C3(2 * c(512), c(512), d(3), False, dtype)
        self.l14 = cbs(c(512), c(256), 1, 1)
        self.l17 = C3(2 * c(256), c(256), d(3), False, dtype)
        self.l18 = cbs(c(256), c(256), 3, 2)
        self.l20 = C3(2 * c(256), c(512), d(3), False, dtype)
        self.l21 = cbs(c(512), c(512), 3, 2)
        self.l23 = C3(2 * c(512), c(1024), d(3), False, dtype)
        # Detect head (torch index 24): plain biased convs
        no = 3 * (5 + num_classes)
        for i, ch in enumerate((c(256), c(512), c(1024))):
            self.add_module(f"det_m{i}", Conv2d(ch, no, 1, dtype=dtype,
                                                bias=True, keep_f32=True))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random init with flax's default initializers (lecun_normal
        kernels, zero biases, unit BN), drawn from `generator`."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.reset_parameters(generator, init="lecun")
        return self

    def forward(self, x) -> List[torch.Tensor]:
        x = x.to(self.dtype)
        x = self.l2(self.l1(self.l0(x)))
        p3 = self.l4(self.l3(x))
        p4 = self.l6(self.l5(p3))
        x = self.l9(self.l8(self.l7(p4)))
        dt = self.dtype
        t10 = self.l10(x).to(dt)
        x = self.l13(cat(dt, upsample2_nearest(t10), p4))
        t14 = self.l14(x).to(dt)
        o3 = self.l17(cat(dt, upsample2_nearest(t14), p3))
        o4 = self.l20(cat(dt, self.l18(o3), t14))
        o5 = self.l23(cat(dt, self.l21(o4), t10))
        return [getattr(self, f"det_m{i}")(o)
                for i, o in enumerate((o3, o4, o5))]


def decode_candidates(preds: Sequence[torch.Tensor], num_classes: int = 1,
                      anchors=YOLO_ANCHORS, strides=YOLO_STRIDES
                      ) -> torch.Tensor:
    """Raw head maps -> every candidate (B, N, 6) as (cx, cy, w, h, score,
    cls) in input pixels, in candidate order (level P3, P4, P5, then y, x,
    anchor). score = obj * best class prob; xy = (2*sig - 0.5 + grid) *
    stride, wh = (2*sig)^2 * anchor."""
    na, no = 3, 5 + num_classes
    flat = []
    for p, anc, stride in zip(preds, anchors, strides):
        b, h, w, _ = p.shape
        s = sigmoid_stepwise(p.reshape(b, h, w, na, no).to(torch.float32))
        dev = s.device
        gx = torch.arange(w, dtype=torch.float32, device=dev)[
            None, None, :, None]
        gy = torch.arange(h, dtype=torch.float32, device=dev)[
            None, :, None, None]
        xy = torch.stack([(2.0 * s[..., 0] - 0.5 + gx) * stride,
                          (2.0 * s[..., 1] - 0.5 + gy) * stride], dim=-1)
        anc_t = torch.tensor(anc, dtype=torch.float32, device=dev)
        wh = (2.0 * s[..., 2:4]) ** 2 * anc_t
        conf = s[..., 4:5] * s[..., 5:]
        score, cls = torch.max(conf, dim=-1)
        flat.append(torch.cat([xy, wh, score[..., None],
                               cls.to(torch.float32)[..., None]],
                              dim=-1).reshape(b, h * w * na, 6))
    return torch.cat(flat, dim=1)


def decode_yolo(preds: Sequence[torch.Tensor], num_classes: int = 1,
                max_candidates: int = 512, anchors=YOLO_ANCHORS,
                strides=YOLO_STRIDES
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw head maps -> the top-K candidates (`decode_candidates`): (xywh
    (B, K, 4) center format in input pixels, score (B, K), cls (B, K)) in
    descending score order, ties to the lower candidate index (the levels
    concatenated, as `lax.top_k` orders them)."""
    allp = decode_candidates(preds, num_classes, anchors, strides)
    k = min(max_candidates, allp.shape[1])
    top_s, idx = topk_stable(allp[..., 4], k)
    top = torch.gather(allp, 1, idx[..., None].expand(-1, -1, 6))
    return top[..., :4], top_s, top[..., 5]


def _nms_alive_serial(suppress, alive0):
    """Sequential-greedy survivor mask (the textbook K-step loop), NumPy:
    the oracle of the rounds fixpoint in `nms_fixed`."""
    suppress = np.asarray(suppress)
    alive = np.asarray(alive0).copy()
    k = alive.shape[0]
    for i in range(k):
        if alive[i]:
            kill = suppress[i] & (np.arange(k) > i)
            alive &= ~kill
    return alive


def suppression(xywh: torch.Tensor, cls: torch.Tensor,
                iou_thres: float) -> torch.Tensor:
    """(K, K) bool: candidate i and j of one class overlap by IoU >
    `iou_thres`."""
    tl = xywh[:, :2] - 0.5 * xywh[:, 2:4]
    br = xywh[:, :2] + 0.5 * xywh[:, 2:4]
    itl = torch.maximum(tl[:, None], tl[None])
    ibr = torch.minimum(br[:, None], br[None])
    iwh = torch.clamp(ibr - itl, min=0.0)
    inter = iwh[..., 0] * iwh[..., 1]
    wh = torch.clamp(br - tl, min=0.0)
    area = wh[:, 0] * wh[:, 1]
    iou = inter / torch.clamp(area[:, None] + area[None] - inter, min=1e-9)
    return (iou > iou_thres) & (cls[:, None] == cls[None])


def nms_fixed(xywh: torch.Tensor, scores: torch.Tensor, cls: torch.Tensor,
              iou_thres: float = 0.45, conf_thres: float = 0.25,
              max_dets: int = 64, stats: Optional[Dict[str, int]] = None):
    """Greedy class-wise NMS over K candidates sorted by descending score,
    static shapes: (tlwh (max_dets, 4), conf (max_dets,), valid
    (max_dets,)).

    Greedy NMS is the unique fixpoint of
        alive_i = (score_i > conf) and not any(j < i, alive_j, iou_ji > thr)
    and a round of the Jacobi iteration (one (K,) x (K, K) matvec of the
    strictly upper-triangular kill edges) settles every box whose
    suppression chain is no deeper than the round, so the loop ends after
    depth + 1 rounds, bit-identical to `_nms_alive_serial`. Its exit test
    reads one bool a round back to the host (a device sync on the card);
    `stats["rounds"]` counts the rounds where `stats` is given."""
    k = xywh.shape[0]
    tl = xywh[:, :2] - 0.5 * xywh[:, 2:4]
    idx = torch.arange(k, device=xywh.device)
    mask = (suppression(xywh, cls, iou_thres)
            & (idx[:, None] < idx[None])).to(torch.float32)
    alive0 = scores > conf_thres
    alive, prev, rounds = alive0, torch.zeros_like(alive0), 0
    while rounds < k and bool(torch.any(alive != prev)):
        blocked = (alive.to(torch.float32) @ mask) > 0.0
        alive, prev, rounds = alive0 & ~blocked, alive, rounds + 1
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + rounds
    sel = torch.where(alive, scores, torch.tensor(float("-inf"),
                                                  device=scores.device))
    conf, order = topk_stable(sel, min(max_dets, k))
    boxes = torch.cat([tl, xywh[:, 2:4]], dim=1)[order]          # tlwh
    valid = torch.isfinite(conf)
    pad = max_dets - conf.shape[0]
    if pad > 0:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        conf = torch.nn.functional.pad(conf, (0, pad), value=float("-inf"))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return boxes, torch.where(valid, conf, 0.0), valid


def letterbox_geometry(frame_hw, det_hw):
    """(scale, (nh, nw), (py, px)) of the aspect-preserving resize into
    `det_hw`, with Python's `round`, as the JAX package computes it."""
    fh, fw = frame_hw
    dh, dw = det_hw
    scale = min(dh / fh, dw / fw)
    nh, nw = int(round(fh * scale)), int(round(fw * scale))
    return scale, (nh, nw), ((dh - nh) // 2, (dw - nw) // 2)


def letterbox(frames: torch.Tensor, det_hw) -> torch.Tensor:
    """uint8 frames (N, H, W, 3) -> (N, dh, dw, 3) f32 in [0, 1]: the
    antialiased bilinear resize of `jax.image.resize` into the centered
    box, on a canvas of PAD_VALUE."""
    _, (nh, nw), (py, px) = letterbox_geometry(frames.shape[1:3], det_hw)
    img = resize_bilinear_matmul(frames.to(torch.float32) * inv_f32(255.0),
                                 (nh, nw))
    canvas = torch.full((frames.shape[0], *det_hw, 3), PAD_VALUE,
                        dtype=torch.float32, device=frames.device)
    canvas[:, py:py + nh, px:px + nw] = img
    return canvas


@torch.no_grad()
def quantize_yolo(model: YOLOv5, frames, det_hw: Tuple[int, int] = (384, 640)):
    """Post-training int8 quantization of the YOLO trunk: calibrates on
    the letterboxed `frames` ([0, 255] uint8, (N, H, W, 3)) and returns a
    `QuantState` for `make_yolo_detector_fn(..., qstate=...)`. The
    detection-head convs (`det_m*`) stay in the model's precision."""
    dev = next(model.parameters()).device
    frames = torch.as_tensor(np.asarray(frames)).to(dev)
    absmax = calibrate(model, [letterbox(frames, det_hw)],
                       select=lambda path, m: not path.startswith("det_m"))
    return quantize_weights(model, absmax)


def make_yolo_detector_fn(model: YOLOv5, det_hw: Tuple[int, int] = (384, 640),
                          max_dets: int = 64, conf_thres: float = 0.25,
                          iou_thres: float = 0.45, qstate=None,
                          keep: Optional[dict] = None):
    """fn(frame (H,W,3) uint8) -> (tlwh, conf, valid) NumPy arrays in frame
    pixels, the serve-path detector contract: letterbox, forward, decode,
    NMS, then the letterbox undone. With `qstate` (from `quantize_yolo`)
    the trunk's convs run in int8 (`utils.quantize.quantized_model`).
    `keep`, where given, receives the last call's head maps ("preds") and
    candidates ("candidates", `decode_candidates`) on the device and sums
    `nms_fixed`'s rounds ("rounds")."""
    net = model if qstate is None else quantized_model(model, qstate)
    dev = next(model.parameters()).device

    @torch.no_grad()
    def detect(frame):
        fr = torch.as_tensor(np.asarray(frame)).to(dev)
        scale, _, (py, px) = letterbox_geometry(fr.shape[:2], det_hw)
        preds = net(letterbox(fr[None], det_hw))
        xywh, scores, cls = decode_yolo(preds, num_classes=model.num_classes)
        tlwh, conf, valid = nms_fixed(xywh[0], scores[0], cls[0],
                                      iou_thres=iou_thres,
                                      conf_thres=conf_thres,
                                      max_dets=max_dets, stats=keep)
        if keep is not None:
            keep["preds"] = preds
            keep["candidates"] = decode_candidates(preds, model.num_classes)
        # undo the letterbox -> original frame pixels
        shift = torch.tensor([px, py, 0.0, 0.0], device=dev)
        tlwh = (tlwh - shift) * inv_f32(scale)
        return tlwh.cpu().numpy(), conf.cpu().numpy(), valid.cpu().numpy()

    return detect


def build_yolo(variant: str = "yolov5s", num_classes: int = 1,
               dtype=torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None) -> YOLOv5:
    """An eval-mode YOLOv5 on `device`, initialized from `generator` (a
    fresh one seeded 1 when None, the key the JAX CLI initializes its
    detector with)."""
    if variant not in YOLO_VARIANTS:
        raise KeyError(f"unknown YOLO variant {variant!r}; "
                       f"have {sorted(YOLO_VARIANTS)}")
    if generator is None:
        generator = torch.Generator().manual_seed(1)
    model = YOLOv5(num_classes=num_classes, variant=variant, dtype=dtype)
    return model.init_weights(generator).to(device).eval()


def yolov5_state_dict_names(state_dict) -> Dict[str, str]:
    """{checkpoint key: parameter name here} for a published YOLOv5
    `state_dict` (`DetectionModel.state_dict()`: 'model.{i}.conv.weight',
    'model.{i}.cv1.bn.running_mean', 'model.{i}.m.{j}.cv2.conv.weight',
    'model.24.m.{k}.weight'; with or without the 'model.' prefix), as
    `convert_yolov5` reads them: a bottleneck list '.m.{j}.' is the module
    'm{j}', the Detect head's convs are 'det_m{k}', and every other key is
    skipped."""
    names = {}
    leaves = ("weight", "bias", "running_mean", "running_var")
    for key in state_dict:
        k = key
        if k.startswith("model.model."):
            k = k[len("model."):]
        if not k.startswith("model."):
            if not k.split(".", 1)[0].isdigit():
                continue
            k = "model." + k
        parts = k.split(".")
        idx, rest = parts[1], parts[2:]
        if not idx.isdigit() or not rest:
            continue
        if idx == "24":
            if rest[0] == "m" and len(rest) == 3 and rest[2] in leaves[:2]:
                names[key] = f"det_m{rest[1]}.{rest[2]}"
            continue
        path, i = [f"l{idx}"], 0
        while i < len(rest):
            if rest[i] == "m" and i + 1 < len(rest) and rest[i + 1].isdigit():
                path.append(f"m{rest[i + 1]}")
                i += 2
            else:
                path.append(rest[i])
                i += 1
        leaf, mod = path[-1], path[:-1]
        if (mod and mod[-1] == "conv" and leaf == "weight") or (
                mod and mod[-1] == "bn" and leaf in leaves):
            names[key] = ".".join(path)
    return names


@torch.no_grad()
def load_yolov5_state_dict(model: YOLOv5, state_dict) -> int:
    """Copy a published YOLOv5 `state_dict` (a mapping of tensors, or the
    path of a `.pt` file read with `torch.load(weights_only=True)`) into
    `model` by name; a tensor whose name or shape has no counterpart is
    skipped, as `convert_yolov5` skips it. Returns the tensors loaded and
    raises ValueError when none matched (a checkpoint of another variant
    or family)."""
    if isinstance(state_dict, str):
        state_dict = torch.load(state_dict, map_location="cpu",
                                weights_only=True)
        if hasattr(state_dict, "state_dict"):
            state_dict = state_dict.state_dict()
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    loaded = 0
    for key, name in yolov5_state_dict_names(state_dict).items():
        val = state_dict[key]
        if not hasattr(val, "detach") or name not in own:
            continue
        if tuple(val.shape) != tuple(own[name].shape):
            continue
        own[name].copy_(val.detach().to(own[name].dtype))
        loaded += 1
    if loaded == 0:
        raise ValueError(
            "load_yolov5_state_dict: no tensor in the state_dict matched "
            "the model (wrong variant width/depth, or not a yolov5-family "
            "checkpoint)")
    return loaded
