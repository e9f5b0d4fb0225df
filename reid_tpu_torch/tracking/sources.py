"""Frame sources for the tracking serve path.

A copy of `reid_tpu/tracking/sources.py`: one iterator over a directory of
frames (image files decoded with PIL, `.npy` frame dumps), a video file or
a webcam index (OpenCV, else imageio for files). Every decoder is imported
only where its branch runs. Yields (frame_idx starting at 1, RGB uint8
(H, W, 3)).
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
    """Iterate RGB frames from `source`:
      - directory          -> sorted image files and `.npy` dumps inside
      - video file         -> decoded via OpenCV (fallback imageio)
      - integer string     -> webcam/stream index via OpenCV
    """
    n = 0
    if os.path.isdir(source):
        paths = sorted(p for p in glob.glob(os.path.join(source, "*"))
                       if p.lower().endswith(_IMAGE_EXTS + (".npy",)))
        for i, p in enumerate(paths, 1):
            if p.lower().endswith(".npy"):      # raw uint8 RGB frame dump
                yield i, np.load(p)
            else:
                from PIL import Image
                with Image.open(p) as im:
                    yield i, np.asarray(im.convert("RGB"))
            n += 1
            if max_frames and n >= max_frames:
                return
        return

    if source.isdigit() or source.lower().endswith(_VIDEO_EXTS):
        try:
            import cv2

            cap = cv2.VideoCapture(int(source) if source.isdigit()
                                   else source)
            i = 0
            while cap.isOpened():
                ok, frame = cap.read()
                if not ok:
                    break
                i += 1
                yield i, frame[..., ::-1].copy()   # BGR -> RGB
                n += 1
                if max_frames and n >= max_frames:
                    break
            cap.release()
            return
        except ImportError:
            pass
        import imageio.v2 as imageio

        for i, frame in enumerate(imageio.get_reader(source), 1):
            yield i, np.asarray(frame)[..., :3]
            if max_frames and i >= max_frames:
                return
        return

    raise ValueError(f"unrecognized --source {source!r}: expected a frame "
                     "directory, a video file, or a webcam index")


def source_fps(source: str, default: int = 30) -> int:
    """Best-effort FPS probe for video sources (annotated-output framerate)."""
    if not os.path.isdir(source) and not source.isdigit():
        try:
            import cv2

            cap = cv2.VideoCapture(source)
            fps = cap.get(cv2.CAP_PROP_FPS)
            cap.release()
            if fps and fps > 0:
                return int(round(fps))
        except ImportError:
            pass
    return default
