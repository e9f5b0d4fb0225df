"""The transforms of the port: inference, training augmentation and the
crop-jitter test-time transform.

Counterparts of `reid_tpu/data/transforms.py`'s `inference_batch`,
`augment_batch` and `strong_inference_batch` (ref data_transforms.py,
data_augment.py). The randomised ones come in two steps: a *draw* step that
takes a `torch.Generator` and returns each sample's random numbers (crop
offsets, flip, gray-fuse and erasing uniforms and rectangles) on the
device, and an *apply* step that takes those draws. The two packages'
generators give different numbers; the tests hand JAX's draws to the apply
step. Every draw is made on the device and nothing is read back, so the
train step stays free of host reads.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_GRAY_W = (0.299, 0.587, 0.114)  # PIL 'L' conversion weights
# -mean and 1 / std, each rounded once to f32 as XLA folds them
_NEG_MEAN = tuple(-float(v) for v in
                  torch.tensor(IMAGENET_MEAN, dtype=torch.float32))
_INV_STD = tuple(float(v) for v in
                 1.0 / torch.tensor(IMAGENET_STD, dtype=torch.float32))


_CONSTS: Dict[tuple, torch.Tensor] = {}


def _f32(values, like: torch.Tensor) -> torch.Tensor:
    """An f32 constant on `like`'s device, copied there once per device: a
    copy from the host waits for the device's queue, so one a call would
    stall every train step. A traced input (torch.export's fake tensors)
    gets a constant of its own, which the trace keeps."""
    if type(like) is not torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=like.device)
    key = (values, like.device)
    t = _CONSTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.tensor(values, dtype=torch.float32, device=like.device)
        _CONSTS[key] = t
    return t


def inference_batch(images: torch.Tensor) -> torch.Tensor:
    """uint8 or float [0, 255] NHWC -> normalized f32: (x / 255 - mean) /
    std, rounded as the compiled JAX program rounds it: XLA turns both
    divisions by constants into multiplications by their f32 reciprocals
    and fuses the first with the subtraction, fma(x, 1/255, -mean) *
    (1/std). The TTA flip is the caller's (`train/steps.py`)."""
    x = images.to(torch.float32)
    return torch.addcmul(_f32(_NEG_MEAN, x), x, _f32(1.0 / 255.0, x)) \
        * _f32(_INV_STD, x)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std as XLA compiles it: (x - mean) * (1 / std)."""
    return (x - _f32(IMAGENET_MEAN, x)) * _f32(_INV_STD, x)


def _unit(images: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [0, 1] as x * f32(1 / 255)."""
    x = images.to(torch.float32)
    return x * _f32(1.0 / 255.0, x)


def shift_crop(x: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
               pad: int) -> torch.Tensor:
    """Zero-pad each side by `pad` and crop back to (h, w) at per-sample
    integer offsets: out[b, i, j] = padded[b, oy[b] + i, ox[b] + j]. A
    gather, exact, as the JAX package's one-hot shift products are."""
    b, h, w, _ = x.shape
    if pad == 0:
        return x
    padded = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    dev = x.device
    rows = oy.long()[:, None] + torch.arange(h, device=dev)[None, :]
    cols = ox.long()[:, None] + torch.arange(w, device=dev)[None, :]
    bi = torch.arange(b, device=dev)[:, None, None]
    return padded[bi, rows[:, :, None], cols[:, None, :]]


def _rect_mask(h: int, w: int, rect: torch.Tensor) -> torch.Tensor:
    """(B, h, w, 1) masks of the rectangles rect[b] = (y0, x0, rh, rw)."""
    dev = rect.device
    y = torch.arange(h, device=dev)[None, :, None]
    x = torch.arange(w, device=dev)[None, None, :]
    y0, x0, rh, rw = (rect[:, i, None, None] for i in range(4))
    return ((y >= y0) & (y < y0 + rh) & (x >= x0) & (x < x0 + rw))[..., None]


def _draw_rects(generator: torch.Generator, b: int, h: int, w: int,
                sl: float, sh: float, r1: float, device) -> torch.Tensor:
    """Random-erasing style rectangles (y0, x0, rh, rw), (B, 4) int64:
    area U(sl, sh) * h * w, aspect exp(U(log r1, -log r1)), sides rounded
    half to even and clamped to [1, h - 1] / [1, w - 1], the corner drawn
    in [0, h) and [0, w) and wrapped into the free range (the JAX
    package's clamped sample in place of the reference's rejection loop,
    train_prepare.py:165-209)."""
    u = torch.rand((2, b), generator=generator, device=device)
    area = (u[0] * (sh - sl) + sl) * (h * w)
    log_r = math.log(r1)
    aspect = torch.exp(u[1] * (-2.0 * log_r) + log_r)
    rh = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, h - 1).long()
    rw = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, w - 1).long()
    y0 = torch.randint(0, h, (b,), generator=generator, device=device) \
        % torch.clamp(h - rh, min=1)
    x0 = torch.randint(0, w, (b,), generator=generator, device=device) \
        % torch.clamp(w - rw, min=1)
    return torch.stack([y0, x0, rh, rw], dim=1)


def augment_draws(generator: torch.Generator, b: int, h: int, w: int,
                  pad: int = 10, sl: float = 0.02, sh: float = 0.4,
                  r1: float = 0.3, device="cuda") -> Dict[str, torch.Tensor]:
    """Each sample's random numbers for `augment_apply`: the flip uniform,
    the crop offsets in [0, 2 pad], the gray-fuse uniform and rectangle,
    the erasing uniform and rectangle."""
    u = torch.rand((3, b), generator=generator, device=device)
    off = torch.randint(0, 2 * pad + 1, (2, b), generator=generator,
                        device=device)
    return {"flip_u": u[0], "oy": off[0], "ox": off[1], "gray_u": u[1],
            "gray_rect": _draw_rects(generator, b, h, w, sl, sh, r1, device),
            "erase_u": u[2],
            "erase_rect": _draw_rects(generator, b, h, w, sl, sh, r1,
                                      device)}


def augment_apply(images: torch.Tensor, draws: Dict[str, torch.Tensor],
                  pad: int = 10, flip_prob: float = 0.5,
                  lg_prob: float = 0.35, gg_prob: float = 0.05,
                  erase_prob: float = 0.5) -> torch.Tensor:
    """The training chain on a batch, normalized f32 (B, H, W, 3) out
    (`reid_tpu/data/transforms.py:augment_batch`): horizontal flip where
    flip_u < flip_prob; zero pad by `pad` and crop back at (oy, ox);
    Fuse_Gray (ref data_augment.py:257-276): the gray rectangle where
    gray_u < lg_prob, the whole image gray where gray_u < lg_prob +
    gg_prob; ImageNet normalization; random erasing of the erase rectangle
    to the mean (0 after normalization) where erase_u < erase_prob."""
    b, h, w, _ = images.shape
    x = _unit(images)
    flip = (draws["flip_u"] < flip_prob)[:, None, None, None]
    x = torch.where(flip, torch.flip(x, dims=(2,)), x)
    x = shift_crop(x, draws["oy"], draws["ox"], pad)
    # XLA's dot over the 3 channels: an fma chain in channel order
    gw = _f32(_GRAY_W, x)
    gray = torch.addcmul(torch.addcmul(x[..., 0] * gw[0], x[..., 1], gw[1]),
                         x[..., 2], gw[2])
    gray3 = gray[..., None].expand(-1, -1, -1, 3)
    p = draws["gray_u"][:, None, None, None]
    local = torch.where(_rect_mask(h, w, draws["gray_rect"]), gray3, x)
    x = torch.where(p < lg_prob, local,
                    torch.where(p < lg_prob + gg_prob, gray3, x))
    x = _normalize(x)
    erase = _rect_mask(h, w, draws["erase_rect"]) & (
        draws["erase_u"] < erase_prob)[:, None, None, None]
    return torch.where(erase, torch.zeros((), device=x.device), x)


def strong_inference_draws(generator: torch.Generator, b: int,
                           pad: int = 10, device="cuda"
                           ) -> Dict[str, torch.Tensor]:
    """The crop offsets of `strong_inference_apply`, in [0, 2 pad]."""
    off = torch.randint(0, 2 * pad + 1, (2, b), generator=generator,
                        device=device)
    return {"oy": off[0], "ox": off[1]}


def strong_inference_apply(images: torch.Tensor,
                           draws: Dict[str, torch.Tensor], pad: int = 10,
                           flipped: bool = False) -> torch.Tensor:
    """'strong_inference' test-time crop jitter (ref data_transforms.py:
    60-76, `reid_tpu/data/transforms.py:strong_inference_batch`): optional
    flip, Pad(pad) + crop back at the drawn offsets, normalize."""
    x = _unit(images)
    if flipped:
        x = torch.flip(x, dims=(2,))
    return _normalize(shift_crop(x, draws["oy"], draws["ox"], pad))
