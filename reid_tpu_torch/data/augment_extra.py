"""Extra host-side augmentations. Ref `reid/data_augment.py`.

Counterpart of `reid_tpu/data/augment_extra.py`, the same NumPy, PIL and
OpenCV code (both packages give the same pixels for the same seed):

- `to_sketch` (ref :207-213): invert -> Gaussian blur -> colour dodge;
- `fuse_rgb_gray_sketch` (ref :230-253): randomly keep the RGB, gray or
  sketch version of a crop;
- `grabcut_foreground` and `OcclusionAugment` (ref Augmentation :12-101):
  paste a resized upper-body strip from a same-camera, different-identity
  image onto the top or bottom of the target image, optionally masked by
  grabCut's foreground.

Where `cv2` does not import, the blur is a 27-tap box filter and the
foreground mask all ones, as in the JAX module. The per-batch randomized
chain (flip, crop, gray, erase) runs on the device (`data/transforms.py`).
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

_GRAY_W = np.asarray([0.299, 0.587, 0.114], np.float32)


def to_sketch(img: np.ndarray) -> np.ndarray:
    """Color-dodge sketch conversion (ref toSketch :207-213)."""
    g = (img.astype(np.float32) @ _GRAY_W)
    inv = 255.0 - g
    if _HAS_CV2:
        blur = cv2.GaussianBlur(inv, (27, 27), 0)
    else:  # separable box-ish approximation
        k = np.ones(27, np.float32) / 27
        blur = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1,
            np.apply_along_axis(
                lambda c: np.convolve(c, k, mode="same"), 0, inv))
    dodge = np.clip(g * 256.0 / np.maximum(255.0 - blur, 1.0), 0, 255)
    return np.repeat(dodge[..., None], 3, axis=-1).astype(np.uint8)


def fuse_rgb_gray_sketch(img: np.ndarray, rng: random.Random,
                         p_gray: float = 0.4, p_sketch: float = 0.1
                         ) -> np.ndarray:
    """Randomly swap the crop for a gray or sketch version (ref :230-253)."""
    p = rng.random()
    if p < p_sketch:
        return to_sketch(img)
    if p < p_sketch + p_gray:
        g = (img.astype(np.float32) @ _GRAY_W).astype(np.uint8)
        return np.repeat(g[..., None], 3, axis=-1)
    return img


def grabcut_foreground(img: np.ndarray, iters: int = 3) -> np.ndarray:
    """Person-foreground mask via grabCut (ref :78, train_utils.py:150-158);
    all-ones when cv2 is unavailable."""
    if not _HAS_CV2:
        return np.ones(img.shape[:2], np.uint8)
    h, w = img.shape[:2]
    mask = np.zeros((h, w), np.uint8)
    rect = (max(1, w // 8), max(1, h // 16),
            max(2, w - w // 4), max(2, h - h // 8))
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    try:
        cv2.grabCut(img, mask, rect, bgd, fgd, iters,
                    cv2.GC_INIT_WITH_RECT)
    except Exception:
        return np.ones((h, w), np.uint8)
    return np.where((mask == 2) | (mask == 0), 0, 1).astype(np.uint8)


class OcclusionAugment:
    """Paste-occlusion augmentation over a parsed record list
    (ref data_augment.py:12-101)."""

    def __init__(self, records: Sequence[Tuple[str, int, int, int]],
                 foreground: bool = False, seed: int = 0):
        self.records = list(records)
        self.rng = random.Random(seed)
        self.foreground = foreground
        self.cam_pid = defaultdict(set)
        self.campid_index = defaultdict(lambda: defaultdict(list))
        for idx, (path, pid, camid, seqid) in enumerate(self.records):
            self.cam_pid[camid].add(pid)
            self.campid_index[camid][pid].append(idx)

    def _load(self, idx) -> np.ndarray:
        from PIL import Image
        with Image.open(self.records[idx][0]) as im:
            return np.asarray(im.convert("RGB"))

    def __call__(self, index: int) -> np.ndarray:
        """Return the image at `index` with a pasted occluder strip."""
        path, pid, camid, _ = self.records[index]
        ref = self._load(index).copy()
        donors = [i for p in self.cam_pid[camid] if p != pid
                  for i in self.campid_index[camid][p]]
        if not donors:
            return ref
        donor = self._load(self.rng.choice(donors))
        h = donor.shape[0]
        upper = donor[: max(1, int(0.25 * h))]
        rh, rw = ref.shape[:2]
        target_h = max(1, self.rng.randint(max(1, int(0.25 * rh) >> 1),
                                           max(2, int(0.25 * rh))))
        scale = target_h / upper.shape[0]
        tw = max(1, min(rw, int(upper.shape[1] * scale)))
        from PIL import Image
        strip = np.asarray(Image.fromarray(upper).resize((tw, target_h),
                                                         Image.BILINEAR))
        if self.foreground:
            m = grabcut_foreground(strip)[..., None]
        else:
            m = np.ones(strip.shape[:2], np.uint8)[..., None]
        x0 = self.rng.randint(0, rw - tw) if rw > tw else 0
        if self.rng.random() > 0.5:   # top or bottom occlusion
            region = ref[:target_h, x0:x0 + tw]
            ref[:target_h, x0:x0 + tw] = m * strip + (1 - m) * region
        else:
            region = ref[rh - target_h:, x0:x0 + tw]
            ref[rh - target_h:, x0:x0 + tw] = m * strip + (1 - m) * region
        return ref
