"""MOT16 I/O: detection ingestion + MOT-format txt writer.

A copy of `reid_tpu/tracking/mot.py` (importing it would pull in JAX
through `reid_tpu.tracking`).

Writer format mirrors ref `track_yolov5.py:275-284`:
`frame,id,x,y,w,h,conf,-1,-1,-1` (1-based frame/id, tlwh in pixels).
Detection loader reads MOT det.txt / gt.txt style CSV into per-frame padded
arrays (static shapes for the jit tracker).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np


def load_mot_detections(
    path: str, max_dets: int, min_conf: float = 0.0
) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parse a MOT detection file -> {frame: (tlwh (M,4), conf (M,), valid)}.

    Rows: frame, id, x, y, w, h, conf[, ...]. Detections beyond `max_dets`
    per frame are dropped by descending confidence (logged by the caller).
    """
    per_frame: Dict[int, List] = collections.defaultdict(list)
    with open(path) as f:
        for line in f:
            parts = line.strip().replace(" ", ",").split(",")
            if len(parts) < 7:
                continue
            frame = int(float(parts[0]))
            x, y, w, h = map(float, parts[2:6])
            conf = float(parts[6])
            if conf < min_conf:
                continue
            per_frame[frame].append((x, y, w, h, conf))

    out = {}
    for frame, rows in per_frame.items():
        rows.sort(key=lambda r: -r[4])
        rows = rows[:max_dets]
        tlwh = np.zeros((max_dets, 4), np.float32)
        conf = np.zeros((max_dets,), np.float32)
        valid = np.zeros((max_dets,), bool)
        for i, (x, y, w, h, c) in enumerate(rows):
            tlwh[i] = (x, y, w, h)
            conf[i] = c
            valid[i] = True
        out[frame] = (tlwh, conf, valid)
    return out


def write_mot_txt(path: str, results: List[dict]) -> int:
    """results: per frame dict(frame, tlwh (T,4), ids (T,), valid (T,),
    conf optional). Returns number of rows written."""
    rows = 0
    with open(path, "w") as f:
        for r in results:
            frame = int(r["frame"])
            tlwh = np.asarray(r["tlwh"])
            ids = np.asarray(r["ids"])
            valid = np.asarray(r["valid"])
            conf = np.asarray(r.get("conf", np.ones(len(ids))))
            for i in np.flatnonzero(valid):
                x, y, w, h = tlwh[i]
                f.write(f"{frame},{int(ids[i])},{x:.2f},{y:.2f},"
                        f"{w:.2f},{h:.2f},{conf[i]:.2f},-1,-1,-1\n")
                rows += 1
    return rows
