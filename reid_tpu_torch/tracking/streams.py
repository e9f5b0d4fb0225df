"""Multi-stream tracking on one card.

Counterpart of `reid_tpu/tracking/streams.py` without its mesh: S
independent video streams (cameras) go through one chunked tracker
(`pipeline.ChunkedTracker`). Per chunk, the crops of all S streams go to
the backbone in one `embed_fn` call (the embed batch grows S-fold), and the
association runs once for all streams with a leading stream axis on every
tensor, so each small per-frame launch and each host read of the
assignment loops is paid once for all S. Every stream's tracks are those of
its own single-stream run: selection (per-frame cap, crop budget) stays
within a stream, and a stream whose assignment has finished is frozen while
others still have work.

Sharding the stream axis over several cards needs a `torch.distributed`
process group; it goes with the port of `reid_tpu/parallel/`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import TrackerConfig
from .pipeline import make_chunked_tracker
from .tracker import TrackerState, init_tracker_state, stack_states


def init_stream_states(n_streams: int, max_tracks: int, feat_dim: int,
                       gallery_size: int = 1, device="cuda") -> TrackerState:
    """A TrackerState with a leading stream axis on every leaf."""
    one = init_tracker_state(max_tracks, feat_dim, gallery_size,
                             device=device)
    return stack_states([one] * n_streams)


def make_stream_tracker(cfg: TrackerConfig, embed_fn, crop_hw,
                        chunk: int = 16, crop_budget: Optional[int] = None,
                        device="cuda"):
    """Returns fn(states, frames, tlwh, conf, valid, affines=None,
    prev_frame=None, timing=None) -> (states, outputs) over S streams.

    Inputs carry a leading stream axis: frames (S, T, H, W, 3) uint8,
    tlwh (S, T, D, 4), conf/valid (S, T, D); `states` from
    `init_stream_states`. Outputs are (S, T, ...). Methods with camera
    motion compensation (botsort) estimate each stream's affines on the
    device unless `affines` (S, T, 2, 3) are given; `prev_frame`
    (S, H, W, 3) anchors the first affine of a chunk (None: identity, as
    the JAX package's vmapped program does). `crop_budget` caps each
    stream's embed batch. `timing` (a dict) gets the seconds of the
    chunk's stages. `device` is where the caller keeps the inputs;
    it is checked on each call; a list of more than one device is refused
    (sharding streams over cards is not ported yet)."""
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise NotImplementedError(
                f"make_stream_tracker runs on one card, got {len(device)} "
                "devices: sharding the stream axis over several cards needs "
                "a torch.distributed process group, which the port of "
                "reid_tpu/parallel/ brings")
        device = device[0]
    tracker = make_chunked_tracker(
        cfg, embed_fn, crop_hw, chunk, crop_budget=crop_budget)
    want = torch.device(device)

    @torch.no_grad()
    def run(states, frames, tlwh, conf, valid, affines=None,
            prev_frame=None, timing=None):
        if frames.device.type != want.type:
            raise ValueError(f"stream tracker made for {want}, got frames "
                             f"on {frames.device}")
        if frames.dim() != 5 or tlwh.dim() != 4:
            raise ValueError("frames (S, T, H, W, 3) and tlwh (S, T, D, 4) "
                             f"expected, got {tuple(frames.shape)}, "
                             f"{tuple(tlwh.shape)}")
        return tracker.run_streams(states, frames, tlwh, conf, valid,
                                   affines, prev_frame, timing)

    return run
