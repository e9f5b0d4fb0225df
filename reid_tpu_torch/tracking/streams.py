"""Multi-stream tracking on one card, or sharded over the ranks of a mesh.

Counterpart of `reid_tpu/tracking/streams.py`: S
independent video streams (cameras) go through one chunked tracker
(`pipeline.ChunkedTracker`). Per chunk, the crops of all S streams go to
the backbone in one `embed_fn` call (the embed batch grows S-fold), and the
association runs once for all streams with a leading stream axis on every
tensor, so each small per-frame launch and each host read of the
assignment loops is paid once for all S. Every stream's tracks are those of
its own single-stream run: selection (per-frame cap, crop budget) stays
within a stream, and a stream whose assignment has finished is frozen while
others still have work.

With a `parallel.Mesh` of p ranks (`mesh=`), the stream axis is split
over the ranks (S divisible by p, rank r taking streams r S/p : (r + 1)
S/p, JAX's P("data") order): each rank runs its streams through the same
chunked tracker, and the states and outputs are all-gathered in stream
order, so every rank returns what one device would.
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
                        device="cuda", mesh=None):
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
    it is checked on each call. With a `mesh` of several ranks, every
    rank passes the whole (S, ...) inputs and states and gets the whole
    (S, ...) result; it tracks only its S/p streams (`timing` then has
    its own streams' seconds)."""
    from ..parallel.mesh import all_gather_rows

    if isinstance(device, (list, tuple)):
        raise ValueError(
            f"make_stream_tracker: a list of {len(device)} devices; each "
            "rank drives one device, and mesh= (a parallel.Mesh) shards "
            "the streams over the ranks")
    tracker = make_chunked_tracker(
        cfg, embed_fn, crop_hw, chunk, crop_budget=crop_budget)
    want = torch.device(device)
    dp = mesh is not None and mesh.collective

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
        if not dp:
            return tracker.run_streams(states, frames, tlwh, conf, valid,
                                       affines, prev_frame, timing)
        mine = mesh.rows(frames.shape[0])
        local = [None if t is None else t[mine]
                 for t in (frames, tlwh, conf, valid, affines, prev_frame)]
        states, outs = tracker.run_streams(
            TrackerState(*[leaf[mine] for leaf in states]), *local[:4],
            local[4], local[5], timing)
        return (TrackerState(*[all_gather_rows(leaf.contiguous(), mesh)
                               for leaf in states]),
                {k: all_gather_rows(v.contiguous(), mesh)
                 for k, v in outs.items()})

    return run
