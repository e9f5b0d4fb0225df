"""Annotation / video artifact writer.

A copy of `reid_tpu/tracking/annotate.py` (importing it would pull in JAX
through `reid_tpu.tracking`), unchanged below this paragraph.

Role of ref `track_yolov5.py:286-333` (box drawing + annotated video save):
draws track boxes + ids on frames (PIL) and writes either an image directory
or an MJPEG-style .avi via OpenCV when available.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

_PALETTE = [(230, 70, 70), (70, 200, 70), (70, 120, 240), (240, 200, 60),
            (200, 80, 220), (80, 220, 220), (245, 140, 50), (150, 150, 150)]


def draw_tracks(frame: np.ndarray, tlwh: np.ndarray, ids: np.ndarray,
                valid: np.ndarray, width: int = 2) -> np.ndarray:
    """Returns a copy of `frame` with colored boxes + id labels."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.asarray(frame))
    draw = ImageDraw.Draw(im)
    for i in np.flatnonzero(np.asarray(valid)):
        x, y, w, h = [float(v) for v in np.asarray(tlwh)[i]]
        tid = int(np.asarray(ids)[i])
        color = _PALETTE[tid % len(_PALETTE)]
        draw.rectangle([x, y, x + w, y + h], outline=color, width=width)
        draw.text((x + 2, max(0, y - 12)), str(tid), fill=color)
    return np.asarray(im)


class AnnotatedVideoWriter:
    """Writes annotated frames to a directory of JPEGs, or an .avi when
    OpenCV is importable (ref vid_writer, track_yolov5.py:315-333)."""

    def __init__(self, out_path: str, fps: int = 30):
        self.out_path = out_path
        self.fps = fps
        self._writer = None
        self._is_dir = not out_path.lower().endswith((".avi", ".mp4"))
        if self._is_dir:
            os.makedirs(out_path, exist_ok=True)
        self._idx = 0

    def write(self, frame: np.ndarray, tlwh, ids, valid):
        annotated = draw_tracks(frame, tlwh, ids, valid)
        self._idx += 1
        if self._is_dir:
            from PIL import Image
            Image.fromarray(annotated).save(
                os.path.join(self.out_path, f"{self._idx:06d}.jpg"))
            return
        import cv2
        if self._writer is None:
            h, w = annotated.shape[:2]
            self._writer = cv2.VideoWriter(
                self.out_path, cv2.VideoWriter_fourcc(*"MJPG"), self.fps,
                (w, h))
        self._writer.write(annotated[..., ::-1])  # RGB -> BGR

    def close(self):
        if self._writer is not None:
            self._writer.release()
            self._writer = None
