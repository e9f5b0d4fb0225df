"""End-to-end tracking pipeline - the serve path.

Counterpart of `reid_tpu/tracking/pipeline.py`: per frame, detections ->
crops -> ReID embed -> association -> MOT rows, with per-stage timing. The
chunked path crops every frame of a chunk, embeds all the chunk's crops in
one batch and then associates frame by frame (the JAX `lax.scan` becomes a
Python loop), for S streams at once (`ChunkedTracker`, `streams.py`).
Crops are built frame by frame into one buffer, which gives
the batched result while bounding the memory of the hat-matrix products at
1080p.

`embed_fn(crops)` maps (N, ch, cw, 3) ImageNet-normalized crops to (N, F)
L2-normalized features; the model's parameters live in its module.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TrackerConfig
from ..utils.timing import StageTimer
from .assignment import device_loop
from .gmc import chunk_affines_translation, estimate_affine
from .methods import uses_gmc
from .mot import write_mot_txt
from .tracker import (Tracker, TrackerState, _update_impl, apply_gmc,
                      stack_states, unstack_state)

# the tracker's per-frame outputs, in the order of the serving boundary
_OUT_KEYS = ("tlwh", "ids", "valid")
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def resize_bilinear_matmul(x: torch.Tensor, out_hw: Tuple[int, int],
                           antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of (H, W, C) or (B, H, W, C) as two hat-matrix
    products, with the semantics of `jax.image.resize(..., "bilinear")`
    (the triangle kernel widened by in/out on a downscale)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape

    def hat(out_dim, in_dim):
        scale = out_dim / in_dim
        src = (torch.arange(out_dim, dtype=torch.float32, device=x.device)
               + 0.5) / scale - 0.5
        cols = torch.arange(in_dim, dtype=torch.float32, device=x.device)
        ks = min(scale, 1.0) if antialias else 1.0
        wm = torch.clamp(1.0 - torch.abs((src[:, None] - cols) * ks), min=0)
        return wm / torch.clamp(wm.sum(dim=1, keepdim=True), min=1e-12)

    xf = x.to(torch.float32)
    out = torch.einsum("ih,bhwc->biwc", hat(oh, h), xf)
    out = torch.einsum("jw,biwc->bijc", hat(ow, w), out)
    if x.dtype.is_floating_point:
        out = out.to(x.dtype)
    return out[0] if squeeze else out


def crop_resize_bilinear(img: torch.Tensor, boxes: torch.Tensor, ch: int,
                         cw: int, downsample: int = 1) -> torch.Tensor:
    """Batched crop + resize as two f32 matrix products with per-crop hat
    matrices: (H, W, 3) x (D, 4 tlwh) -> (D, ch, cw, 3),
        out[d] = Wy[d] @ img @ Wx[d]^T   (per channel),
    contracting first along the axis that costs fewer operations (static
    in the shapes, as in the JAX package)."""
    if downsample > 1:
        s = int(downsample)
        h0, w0 = img.shape[0], img.shape[1]
        ph, pw = (-h0) % s, (-w0) % s
        img = img.to(torch.float32)
        if ph or pw:
            img = torch.nn.functional.pad(
                img.permute(2, 0, 1)[None], (0, pw, 0, ph),
                mode="replicate")[0].permute(1, 2, 0)
        img = img.reshape((h0 + ph) // s, s, (w0 + pw) // s, s, 3).mean(
            dim=(1, 3))
        boxes = boxes / s
    h, w = img.shape[0], img.shape[1]
    n = boxes.shape[0]
    dev = img.device

    def hat_weights(starts, sizes, out_dim, in_dim):
        o = (torch.arange(out_dim, dtype=torch.float32, device=dev)
             + 0.5) / out_dim
        src = starts[:, None] + o[None, :] * sizes[:, None] - 0.5
        src = torch.clamp(src, 0.0, in_dim - 1.0)
        cols = torch.arange(in_dim, dtype=torch.float32, device=dev)
        return torch.clamp(1.0 - torch.abs(src[:, :, None] - cols), min=0.0)

    wy = hat_weights(boxes[:, 1], boxes[:, 3], ch, h)     # (D, ch, H)
    wx = hat_weights(boxes[:, 0], boxes[:, 2], cw, w)     # (D, cw, W)
    imgf = img.to(torch.float32)
    cost_y_first = ch * h * w + ch * cw * w
    cost_x_first = cw * w * h + ch * h * cw
    if cost_x_first < cost_y_first:
        # cols[d, j, h, c] = sum_w Wx[d, j, w] img[h, w, c]
        img_w = imgf.permute(1, 0, 2).reshape(w, h * 3)
        cols = (wx.reshape(n * cw, w) @ img_w).reshape(n, cw, h, 3)
        # out[d, i, j, c] = sum_h Wy[d, i, h] cols[d, j, h, c]
        cols = cols.permute(0, 2, 1, 3).reshape(n, h, cw * 3)
        return torch.bmm(wy, cols).reshape(n, ch, cw, 3)
    # rows[d, i, w, c] = sum_h Wy[d, i, h] img[h, w, c]
    rows = (wy.reshape(n * ch, h) @ imgf.reshape(h, w * 3)).reshape(
        n, ch, w, 3)
    # out[d, i, j, c] = sum_w rows[d, i, w, c] Wx[d, j, w]
    rows = rows.permute(0, 1, 3, 2).reshape(n, ch * 3, w)
    out = torch.bmm(rows, wx.transpose(1, 2)).reshape(n, ch, 3, cw)
    return out.permute(0, 1, 3, 2)


def topk_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties to the
    lower index (the order `lax.top_k` keeps)."""
    return torch.sort(score, dim=-1, descending=True, stable=True)[1][
        ..., :k]


def _normalize(crops: torch.Tensor, dtype) -> torch.Tensor:
    mean = torch.tensor(_MEAN, device=crops.device)
    std = torch.tensor(_STD, device=crops.device)
    return ((crops - mean) / std).to(dtype)


def make_crop_embed(embed_fn: Callable, crop_hw: Tuple[int, int],
                    max_dets: int, crop_downsample: int = 1,
                    frame_crop_cap: Optional[int] = None,
                    embed_in_dtype: str = "float32"):
    """fn(frame (H,W,3) uint8, tlwh (D,4), conf (D,), valid (D,)) ->
    (feats (D, F), valid (D,)): crop, resize and normalize every box, then
    embed. `frame_crop_cap` crops only the top-cap valid boxes by
    confidence; the others come back invalid with zero features."""
    ch, cw = crop_hw
    handoff = getattr(torch, embed_in_dtype)
    if frame_crop_cap is not None and frame_crop_cap <= 0:
        frame_crop_cap = None
    cap = (max_dets if frame_crop_cap is None
           else min(frame_crop_cap, max_dets))

    def crop_embed(frame, tlwh, conf, valid):
        img = frame.to(torch.float32) / 255.0
        if cap < max_dets:
            score = torch.where(valid, conf, float("-inf"))
            sel = topk_indices(score, cap)
            boxes = tlwh[sel]
            kept = torch.zeros(max_dets, dtype=torch.bool,
                               device=valid.device)
            kept[sel] = True
            valid = valid & kept
        else:
            boxes = tlwh
        crops = _normalize(crop_resize_bilinear(
            img, boxes, ch, cw, downsample=crop_downsample), handoff)
        feats_c = embed_fn(crops)
        if cap < max_dets:
            feats = torch.zeros((max_dets, feats_c.shape[1]),
                                dtype=feats_c.dtype, device=feats_c.device)
            feats[sel] = feats_c
        else:
            feats = feats_c
        return feats, valid

    return crop_embed


class ChunkedTracker:
    """Tracks a chunk of frames of S streams: crop every frame's boxes and
    embed all streams' crops in one batch (`embed`), then associate frame
    by frame, all streams at once (`associate`). Every input and output has
    a leading stream axis (the JAX package's `jax.vmap` of its chunk
    program, `reid_tpu/tracking/streams.py`); calling the object tracks
    one stream, as S = 1 of the same code."""

    def __init__(self, cfg: TrackerConfig, embed_fn, crop_hw, chunk: int,
                 crop_budget: Optional[int], use_gmc: bool,
                 frame_crop_cap: Optional[int]):
        self.cfg = cfg
        self.embed_fn = embed_fn
        self.crop_hw = crop_hw
        self.crop_budget = crop_budget
        self.use_gmc = use_gmc
        self.cap = frame_crop_cap
        self.k_embed = max(1, int(cfg.embed_every))
        self.handoff = getattr(torch, cfg.embed_in_dtype)
        if self.k_embed > 1 and chunk % self.k_embed != 0:
            raise ValueError(
                f"embed_every={self.k_embed} requires chunk % embed_every "
                f"== 0 (chunk={chunk}) so the cadence phase is static per "
                "chunk")

    def embed(self, frames, tlwh, conf, valid):
        """frames (S,T,H,W,3) uint8; tlwh (S,T,D,4); conf/valid (S,T,D) ->
        (feats (S,T,D,F), valid (S,T,D)). The per-frame cap and the crop
        budget select within each stream; the crops of all streams go to
        `embed_fn` in one call."""
        n_s, t, d = tlwh.shape[:3]
        dev = tlwh.device
        ch, cw = self.crop_hw
        k = self.k_embed
        cap = d if self.cap is None else min(self.cap, d)
        emb = (torch.arange(t, device=dev) % k) == 0
        s_idx = torch.arange(n_s, device=dev)[:, None]
        if cap < d:
            # pre-crop per-frame selection of the top-cap valid boxes
            score_f = torch.where(valid, conf, float("-inf"))
            sel_f = topk_indices(score_f, cap)                 # (S, T, cap)
            boxes_c = torch.gather(tlwh, 2, sel_f[..., None].expand(
                -1, -1, -1, 4))
            conf_c = torch.gather(conf, 2, sel_f)
            valid_c = torch.gather(valid, 2, sel_f)
            kept_f = torch.zeros((n_s, t, d), dtype=torch.bool, device=dev)
            kept_f.scatter_(2, sel_f, True)
            if k > 1:
                valid = valid & (kept_f | ~emb[:, None])
            else:
                valid = valid & kept_f
        else:
            sel_f = torch.arange(d, device=dev).expand(n_s, t, d)
            boxes_c, conf_c, valid_c = tlwh, conf, valid
        # appearance cadence: crop + embed only every k-th frame
        eidx = torch.arange(0, t, k, device=dev)
        t_e = eidx.shape[0]
        crops = torch.empty((n_s, t_e, cap, ch, cw, 3), dtype=self.handoff,
                            device=dev)
        for si in range(n_s):
            for i in range(t_e):
                img = frames[si, i * k].to(torch.float32) / 255.0
                crops[si, i] = _normalize(crop_resize_bilinear(
                    img, boxes_c[si, i * k], ch, cw,
                    downsample=self.cfg.crop_downsample), self.handoff)
        crops = crops.reshape(n_s, t_e * cap, ch, cw, 3)
        sel_e = sel_f[:, ::k]
        conf_e, valid_e = conf_c[:, ::k], valid_c[:, ::k]
        flat_slots = (eidx[:, None] * d + sel_e).reshape(n_s, t_e * cap)

        if self.crop_budget is not None and self.crop_budget < t_e * cap:
            # each stream's B most confident valid crops go to the backbone
            score = torch.where(valid_e.reshape(n_s, -1),
                                conf_e.reshape(n_s, -1), float("-inf"))
            sel = topk_indices(score, self.crop_budget)          # (S, B)
            feats_b = self.embed_fn(crops[s_idx, sel].flatten(0, 1))
            target = flat_slots.gather(1, sel)
            feats = torch.zeros((n_s, t * d, feats_b.shape[-1]),
                                dtype=feats_b.dtype, device=dev)
            feats[s_idx, target] = feats_b.reshape(*sel.shape, -1)
            feats = feats.reshape(n_s, t, d, -1)
            kept = torch.zeros((n_s, t * d), dtype=torch.bool, device=dev)
            kept[s_idx, target] = True
            if k > 1:
                valid = valid & (kept.reshape(n_s, t, d) | ~emb[:, None])
            else:
                valid = valid & kept.reshape(n_s, t, d)
        elif cap < d or k > 1:
            feats_c = self.embed_fn(crops.flatten(0, 1))
            feats = torch.zeros((n_s, t * d, feats_c.shape[-1]),
                                dtype=feats_c.dtype, device=dev)
            feats[s_idx, flat_slots] = feats_c.reshape(*flat_slots.shape, -1)
            feats = feats.reshape(n_s, t, d, -1)
        else:
            feats = self.embed_fn(crops.flatten(0, 1)).reshape(n_s, t, d, -1)
        return feats, valid

    @staticmethod
    def gmc_affines(frames, prev_frame=None):
        """(S, T, 2, 3) camera-motion affines of the chunk, estimated on the
        frames' device in one batched FFT; `prev_frame` (S, H, W, 3)
        anchors the first (None: identity)."""
        anchor = frames[:, 0] if prev_frame is None else prev_frame
        return chunk_affines_translation(anchor, frames)

    def associate(self, states, tlwh, conf, feats, valid, affines=None):
        """The per-frame update over the chunk, all streams at once;
        `affines` (S, T, 2, 3) warp the tracks first when GMC is on.
        Returns (states, outputs (S, T, ...)).

        The frames run as one `device_loop` of k_embed frames a round (so
        each frame's cadence phase is static), each frame's outputs
        written into (S, T, ...) buffers: eager, a Python loop that reads
        nothing on the host; under `torch.export`, one `while_loop` whose
        graph holds one round's update whatever the chunk's length."""
        inputs = (tlwh, conf, feats, valid, affines)
        n = len(TrackerState._fields)
        t, k = tlwh.shape[1], self.k_embed
        s, slots = states.mean.shape[:2]
        dev = states.mean.device
        bufs = (torch.zeros((s, t, slots, 4), device=dev),
                torch.zeros((s, t, slots), dtype=torch.int32, device=dev),
                torch.zeros((s, t, slots), dtype=torch.bool, device=dev))

        def frames_of_round(i, *carry):
            st, outs = TrackerState(*carry[:n]), carry[n:]
            for j in range(k):
                f = (i + j).reshape(1)
                st, out = self._frame(
                    st, lambda x: x.index_select(1, f)[:, 0], j, *inputs)
                outs = [b.index_copy(1, f, out[key][:, None])
                        for b, key in zip(outs, _OUT_KEYS)]
            return (i + k, *st, *outs)

        i0 = torch.zeros((), dtype=torch.int64, device=dev)
        carry = device_loop(None, frames_of_round, (i0, *states, *bufs),
                            t // k)
        return (TrackerState(*carry[1:n + 1]),
                dict(zip(_OUT_KEYS, carry[n + 1:])))

    def _frame(self, states, at, phase, tlwh, conf, feats, valid, affines):
        """One frame's update: `at(x)` takes the frame's slice of each
        (S, T, ...) input, `phase` is its place in the embed cadence."""
        if self.use_gmc:
            states = apply_gmc(states, at(affines))
        hf = np.bool_(phase == 0) if self.k_embed > 1 else True
        return _update_impl(self.cfg, states, at(tlwh), at(conf), at(feats),
                            at(valid), has_feats=hf)

    def run_streams(self, states, frames, tlwh, conf, valid, affines=None,
                    prev_frame=None, timing: Optional[dict] = None):
        """One chunk of S streams: a batched state from
        `streams.init_stream_states`, inputs with a leading stream axis.
        With `timing`, the seconds of crop_embed, gmc and associate are
        added to it (the device synchronised at each boundary)."""
        stages = StageTimer(timing, frames.device)
        feats, valid = self.embed(frames, tlwh, conf, valid)
        stages.mark("crop_embed")
        if self.use_gmc and affines is None:
            affines = self.gmc_affines(frames, prev_frame)
        stages.mark("gmc")
        out = self.associate(states, tlwh, conf, feats, valid, affines)
        stages.mark("associate")
        return out

    def __call__(self, state, frames, tlwh, conf, valid, affines=None,
                 prev_frame=None):
        """One chunk of one stream: state from `init_tracker_state`,
        frames (T,H,W,3), tlwh (T,D,4), conf/valid (T,D)."""
        one = [None if v is None else v[None]
               for v in (affines, prev_frame)]
        states, outs = self.run_streams(
            stack_states([state]), frames[None], tlwh[None], conf[None],
            valid[None], *one)
        return unstack_state(states)[0], {k: v[0] for k, v in outs.items()}


def make_chunked_tracker(cfg: TrackerConfig, embed_fn, crop_hw,
                         chunk: int = 16, crop_budget: Optional[int] = None,
                         use_gmc: Optional[bool] = None,
                         frame_crop_cap: Optional[int] = None
                         ) -> ChunkedTracker:
    """The chunked throughput path: `run_chunk(state, frames, tlwh, conf,
    valid, affines=None, prev_frame=None) -> (state, outputs)`; with GMC
    and no `affines` they are estimated from the frames. `crop_budget`
    caps the chunk's embed batch, `frame_crop_cap` the per-frame crop
    count; both are output-identical when they exceed the valid boxes."""
    if use_gmc is None:
        use_gmc = uses_gmc(cfg)
    if frame_crop_cap is None:
        frame_crop_cap = cfg.frame_crop_cap
    if frame_crop_cap is not None and frame_crop_cap <= 0:
        frame_crop_cap = None
    return ChunkedTracker(cfg, embed_fn, crop_hw, chunk, crop_budget,
                          use_gmc, frame_crop_cap)


def chunk_serving_fn(tracker: ChunkedTracker) -> Callable:
    """One stream's chunk as a function of flat tensors: the serving
    boundary of an exported chunk (`utils.export.export_serving_fn(...,
    dynamic_batch=False)`), as the JAX package's export of its chunk
    program has it.

    In: the 13 `TrackerState` fields, then frames (T, H, W, 3) uint8, tlwh
    (T, D, 4), conf and valid (T, D) and, where the tracker compensates
    camera motion, prev_frame (H, W, 3), the frame before the chunk (the
    first frame for a sequence's first chunk), from which the graph
    estimates the chunk's affines. Out: the 13 new state fields, then
    tlwh (T, max_tracks, 4), ids and valid (T, max_tracks)."""
    n = len(TrackerState._fields)

    def serving(*flat):
        frames, tlwh, conf, valid = flat[n:n + 4]
        prev = flat[n + 4] if tracker.use_gmc else None
        state, out = tracker(TrackerState(*flat[:n]), frames, tlwh, conf,
                             valid, prev_frame=prev)
        return tuple(state) + tuple(out[k] for k in _OUT_KEYS)

    return serving


class TrackingPipeline:
    """Host frame loop: embed + track on the device, MOT rows on the host.
    Stage times are taken between device synchronisations.

    `gmc_mode` picks the chunked path's camera-motion estimator: "device",
    the batched phase correlation of each chunk, or "host", `estimate_affine`
    per frame (the step path's estimator). The affines applied are kept in
    `affines`, one (2, 3) array per frame."""

    def __init__(self, cfg: TrackerConfig, embed_fn, feat_dim: int,
                 device="cuda", gmc_mode: str = "device"):
        if gmc_mode not in ("device", "host"):
            raise ValueError(f"gmc_mode must be 'device' or 'host', got "
                             f"{gmc_mode!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.tracker = Tracker(cfg, feat_dim=feat_dim, device=self.device)
        self.state = self.tracker.init_state()
        self.embed_fn = embed_fn
        self.crop_embed = make_crop_embed(
            embed_fn, cfg.crop_hw, cfg.max_dets,
            crop_downsample=cfg.crop_downsample,
            frame_crop_cap=cfg.frame_crop_cap,
            embed_in_dtype=cfg.embed_in_dtype)
        self.results: List[dict] = []
        # the run's MOT scores, where the caller scored it (`--gt`)
        self.metrics: Optional[Dict[str, float]] = None
        self.timing = {"crop_embed": 0.0, "gmc": 0.0, "associate": 0.0,
                       "total": 0.0}
        self.frames = 0
        self._gmc = uses_gmc(cfg)
        self.gmc_mode = gmc_mode
        self.affines: List[np.ndarray] = []
        self._prev_frame = None
        self._k_embed = max(1, int(cfg.embed_every))
        self._step_idx = 0
        self._chunked = None
        self._chunk_key = None

    def _dev(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def step(self, frame_idx: int, frame: np.ndarray, tlwh: np.ndarray,
             conf: np.ndarray, valid: np.ndarray):
        t0 = time.perf_counter()
        if self._gmc:
            affine = estimate_affine(self._prev_frame, frame)
            if self._prev_frame is not None:
                self.state = apply_gmc(self.state,
                                       self._dev(affine, torch.float32))
            self._prev_frame = frame
            self.affines.append(affine)
            _sync(self.device)
        tg = time.perf_counter()
        is_embed = (self._step_idx % self._k_embed) == 0
        self._step_idx += 1
        tlwh_d = self._dev(tlwh, torch.float32)
        conf_d = self._dev(conf, torch.float32)
        valid_d = self._dev(valid, torch.bool)
        if is_embed:
            feats, valid_d = self.crop_embed(self._dev(frame), tlwh_d,
                                             conf_d, valid_d)
        else:
            # skip frame of the cadence: no crop/embed work
            feats = torch.zeros((tlwh_d.shape[0], self.tracker.feat_dim),
                                device=self.device)
        _sync(self.device)
        t1 = time.perf_counter()
        self.state, out = self.tracker.update(self.state, tlwh_d, conf_d,
                                              feats, valid_d,
                                              has_feats=is_embed)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        t2 = time.perf_counter()
        self.timing["gmc"] += tg - t0
        self.timing["crop_embed"] += t1 - tg
        self.timing["associate"] += t2 - t1
        self.timing["total"] += t2 - t0
        self.frames += 1
        self.results.append({"frame": frame_idx, "tlwh": out["tlwh"],
                             "ids": out["ids"], "valid": out["valid"]})
        return out

    def run_sequence(self, frames: np.ndarray, tlwh: np.ndarray,
                     conf: np.ndarray, valid: np.ndarray, chunk: int = 16,
                     first_frame: int = 1,
                     crop_budget: Optional[int] = None,
                     frame_crop_cap: Optional[int] = None) -> float:
        """Chunked path over T frames: frames (T,H,W,3) uint8; tlwh
        (T,D,4); conf/valid (T,D). Appends to self.results; returns fps.
        The last chunk is padded by repeating its last frame with no valid
        detection, as in the JAX package."""
        key = (chunk, crop_budget, frame_crop_cap)
        if self._chunked is None or self._chunk_key != key:
            self._chunked = make_chunked_tracker(
                self.cfg, self.embed_fn, self.cfg.crop_hw, chunk,
                crop_budget=crop_budget, frame_crop_cap=frame_crop_cap)
            self._chunk_key = key
        t_total = frames.shape[0]
        t0 = time.perf_counter()
        for s in range(0, t_total, chunk):
            e = min(s + chunk, t_total)
            pad = chunk - (e - s)

            def padded(x):
                if pad == 0:
                    return x[s:e]
                return np.concatenate([x[s:e], np.repeat(x[e - 1:e], pad,
                                                          axis=0)])
            vl = valid[s:e] if pad == 0 else np.concatenate(
                [valid[s:e], np.zeros((pad,) + valid.shape[1:], bool)])
            ta = time.perf_counter()
            fr = self._dev(padded(frames))
            tl = self._dev(padded(tlwh), torch.float32)
            cf = self._dev(padded(conf), torch.float32)
            feats, vd = self._chunked.embed(fr[None], tl[None], cf[None],
                                            self._dev(vl, torch.bool)[None])
            _sync(self.device)
            tb = time.perf_counter()
            affines = self._chunk_affines(frames, fr, s, e, pad) \
                if self._gmc else None
            tg = time.perf_counter()
            states, outs = self._chunked.associate(
                stack_states([self.state]), tl[None], cf[None], feats, vd,
                None if affines is None else affines[None])
            self.state = unstack_state(states)[0]
            outs = {k: v[0].cpu().numpy() for k, v in outs.items()}
            tc = time.perf_counter()
            self.timing["crop_embed"] += tb - ta
            self.timing["gmc"] += tg - tb
            self.timing["associate"] += tc - tg
            for i in range(e - s):
                self.results.append({
                    "frame": first_frame + s + i, "tlwh": outs["tlwh"][i],
                    "ids": outs["ids"][i], "valid": outs["valid"][i]})
        dt = time.perf_counter() - t0
        self.timing["total"] += dt
        self.frames += t_total
        return t_total / dt

    def _chunk_affines(self, frames, fr, s, e, pad):
        """The (T, 2, 3) affines of chunk [s, e) of `frames`, `fr` its
        padded frames on the device; the frame before the chunk anchors
        the first, as in the JAX package."""
        if self.gmc_mode == "host":
            prev, affs = frames[s - 1] if s > 0 else frames[0], []
            for i in range(s, e):
                affs.append(estimate_affine(prev, frames[i]))
                prev = frames[i]
            affs.extend([np.eye(2, 3, dtype=np.float32)] * pad)
            affines = self._dev(np.stack(affs))
        else:
            prev = self._dev(frames[s - 1])[None] if s > 0 else None
            affines = self._chunked.gmc_affines(fr[None], prev)[0]
        self.affines.extend(affines[:e - s].cpu().numpy())
        return affines

    def write(self, path: str) -> int:
        return write_mot_txt(path, self.results)

    def timing_summary(self) -> Dict[str, float]:
        """Per-frame ms per stage."""
        n = max(self.frames, 1)
        return {k: 1000.0 * v / n for k, v in self.timing.items()}
