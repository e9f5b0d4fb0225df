"""Frame sources for the tracking serve path.

The frame-directory part of `reid_tpu/tracking/sources.py:20-41`: image
files (decoded with PIL, imported only for them) and `.npy` frame dumps,
which need no decoder. Yields (frame_idx starting at 1, RGB uint8
(H, W, 3)). Video files and webcams belong to a later slice.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Tuple

import numpy as np

_VIDEO_EXTS = (".avi", ".mp4", ".mov", ".mkv", ".webm", ".m4v")
_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def iter_frames(source: str,
                max_frames: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
    """Iterate RGB frames from a directory `source`: its image files and
    `.npy` dumps in sorted order."""
    if source.isdigit() or source.lower().endswith(_VIDEO_EXTS):
        raise NotImplementedError(
            "video and webcam sources are ported in a later slice; pass a "
            "directory of image or .npy frames")
    if not os.path.isdir(source):
        raise ValueError(f"unrecognized --source {source!r}: expected a "
                         "frame directory")
    paths = sorted(p for p in glob.glob(os.path.join(source, "*"))
                   if p.lower().endswith(_IMAGE_EXTS + (".npy",)))
    for i, p in enumerate(paths, 1):
        if p.lower().endswith(".npy"):      # raw uint8 RGB frame dump
            yield i, np.load(p)
        else:
            from PIL import Image
            with Image.open(p) as im:
                yield i, np.asarray(im.convert("RGB"))
        if max_frames and i >= max_frames:
            return
