"""Static-shape StrongSort-class tracker over a fixed-capacity slot SoA.

Counterpart of `reid_tpu/tracking/tracker.py`: the same slot
structure-of-arrays (`TrackerState`) and the same per-frame update -
Kalman predict -> two-stage gated matching -> update -> lifecycle - as
plain functions on tensors. Where the JAX package runs a device-side
`while_loop` (the ORU replay) this code reads the loop bound on the host
once per frame.

Scatters of the JAX code are rewritten so they never write out of range
(`mode="drop"` targets are routed to a spare slot that is cut off) and
never rely on the winner among duplicate indices (`.at[].max` becomes a
comparison against every index).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import TrackerConfig
from .assignment import INF_COST, gated_matches
from .costs import appearance_cost, diou_matrix, iou_matrix, l2_normalize
from .kalman import (CHI2_GATE_4DOF, kalman_gating_distance,
                     kalman_initiate, kalman_predict, kalman_update)

# status codes
FREE, TENTATIVE, CONFIRMED = 0, 1, 2


class TrackerState(NamedTuple):
    mean: torch.Tensor              # (T, 8) xyah + velocities
    cov: torch.Tensor               # (T, 8, 8)
    feat: torch.Tensor              # (T, F) EMA appearance
    status: torch.Tensor            # (T,) int32
    hits: torch.Tensor              # (T,) int32
    time_since_update: torch.Tensor  # (T,) int32
    track_id: torch.Tensor          # (T,) int32 (1-based; 0 = none)
    next_id: torch.Tensor           # () int32
    last_obs: torch.Tensor          # (T, 4) xyah of the last matched obs.
    frozen_mean: torch.Tensor       # (T, 8) state at the last match (ORU)
    frozen_cov: torch.Tensor        # (T, 8, 8)
    gallery: torch.Tensor           # (T, B, F) NN_BUDGET appearance ring
    gallery_count: torch.Tensor     # (T,) int32 - feats ever enqueued


def init_tracker_state(max_tracks: int, feat_dim: int, gallery_size: int = 1,
                       device="cuda") -> TrackerState:
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    eye = torch.eye(8, device=device).repeat(max_tracks, 1, 1)
    return TrackerState(
        mean=z(max_tracks, 8), cov=eye, feat=z(max_tracks, feat_dim),
        status=z(max_tracks, dtype=i32), hits=z(max_tracks, dtype=i32),
        time_since_update=z(max_tracks, dtype=i32),
        track_id=z(max_tracks, dtype=i32),
        next_id=torch.ones((), dtype=i32, device=device),
        last_obs=z(max_tracks, 4), frozen_mean=z(max_tracks, 8),
        frozen_cov=eye.clone(),
        gallery=z(max_tracks, gallery_size, feat_dim),
        gallery_count=z(max_tracks, dtype=i32))


def _tlwh_to_xyah(tlwh):
    xy = tlwh[..., :2] + 0.5 * tlwh[..., 2:4]
    a = tlwh[..., 2] / torch.clamp(tlwh[..., 3], min=1e-6)
    return torch.stack([xy[..., 0], xy[..., 1], a, tlwh[..., 3]], dim=-1)


def _xyah_to_tlwh(xyah):
    w = xyah[..., 2] * xyah[..., 3]
    h = xyah[..., 3]
    tl = torch.stack([xyah[..., 0] - 0.5 * w, xyah[..., 1] - 0.5 * h], -1)
    return torch.cat([tl, w[..., None], h[..., None]], dim=-1)


def _taken(match: torch.Tensor, flag: torch.Tensor, d: int) -> torch.Tensor:
    """(D,) bool: det j is the clipped match of some row whose flag is set
    (the JAX `zeros(D).at[clip(match)].max(flag)`)."""
    idx = torch.clamp(match, 0, d - 1).to(torch.int64)
    cols = torch.arange(d, device=match.device)
    return ((idx[:, None] == cols[None, :]) & flag[:, None]).any(dim=0)


class Tracker:
    """Per-frame tracker; `update` is (state, frame) -> (state, outputs)."""

    def __init__(self, cfg: TrackerConfig, feat_dim: int = 1263,
                 device="cuda"):
        self.cfg = cfg
        self.feat_dim = feat_dim
        self.device = device
        self._k_embed = max(1, int(cfg.embed_every))

    def init_state(self) -> TrackerState:
        budget = self.cfg.nn_budget if self.cfg.use_gallery else 1
        return init_tracker_state(self.cfg.max_tracks, self.feat_dim,
                                  gallery_size=budget, device=self.device)

    def update(self, state: TrackerState, tlwh, conf, feats, det_valid,
               has_feats: bool = True):
        """One frame. tlwh (D,4), conf (D,), feats (D,F), det_valid (D,).
        `has_feats=False` marks an appearance-skip frame of the embed
        cadence. Under a cadence (embed_every > 1) embed frames take the
        neutralizing path too (`np.True_` is not the literal `True`), so a
        track initiated on a skip frame stays appearance-neutral until its
        first real feature."""
        if has_feats:
            hf = np.True_ if self._k_embed > 1 else True
            return _update_impl(self.cfg, state, tlwh, conf, feats,
                                det_valid, has_feats=hf)
        return _update_impl(self.cfg, state, tlwh, conf, feats, det_valid,
                            has_feats=False)


def apply_gmc(state: TrackerState, affine: torch.Tensor) -> TrackerState:
    """Warp track positions by a 2x3 affine (camera-motion compensation),
    including the last observations and the ORU frozen states."""
    a, b = affine[:, :2], affine[:, 2]

    def warp8(m):
        return torch.cat([m[:, :2] @ a.T + b, m[:, 2:4], m[:, 4:6] @ a.T,
                          m[:, 6:]], dim=1)

    last = torch.cat([state.last_obs[:, :2] @ a.T + b, state.last_obs[:, 2:]],
                     dim=1)
    return state._replace(mean=warp8(state.mean), last_obs=last,
                          frozen_mean=warp8(state.frozen_mean))


def _update_impl(cfg: TrackerConfig, state: TrackerState, tlwh, conf, feats,
                 det_valid, has_feats=True):
    # `has_feats is True` (the literal) is the graph without cadence; any
    # other value (np.True_, False) takes the appearance-neutralizing path
    # of the embed cadence, as in the JAX package.
    static_hf = has_feats is True
    hf = bool(has_feats)
    dev = tlwh.device
    t_slots = state.mean.shape[0]
    d = det_valid.shape[0]
    raw_valid = det_valid
    if cfg.byte:
        low_valid = raw_valid & (conf >= cfg.byte_low) & \
            (conf < cfg.min_confidence)
    else:
        low_valid = torch.zeros_like(raw_valid)
    det_valid = raw_valid & (conf >= cfg.min_confidence)
    z_xyah = _tlwh_to_xyah(tlwh)

    active = state.status > FREE
    # ---- predict all active slots
    pmean, pcov = kalman_predict(state.mean, state.cov)
    mean = torch.where(active[:, None], pmean, state.mean)
    cov = torch.where(active[:, None, None], pcov, state.cov)

    # ---- stage 1: confirmed x dets, appearance + motion blend, chi2 gate
    confirmed = state.status == CONFIRMED
    if cfg.use_gallery:
        gn = l2_normalize(state.gallery)
        dn_ = l2_normalize(feats)
        gsim = torch.einsum("tbf,df->tbd", gn, dn_)
        budget = state.gallery.shape[1]
        filled = torch.arange(budget, device=dev)[None, :] < torch.clamp(
            state.gallery_count, max=budget)[:, None]            # (T, B)
        gdist = torch.where(filled[:, :, None], 1.0 - gsim, float("inf"))
        app = torch.amin(gdist, dim=1)                           # (T, D)
        app = torch.where(state.gallery_count[:, None] > 0, app, 1.0)
    else:
        app = appearance_cost(state.feat, feats)                 # (T, D)
    if not static_hf:
        # appearance-neutral value per cost form (skip frames, and tracks
        # that never received a feature)
        neutral = 1.0 if (cfg.fuse_min or cfg.aw_scale > 0) else 0.0
        app_known = (state.gallery_count > 0)[:, None] & hf
        app = torch.where(app_known, app, neutral)
    maha = kalman_gating_distance(mean, cov, z_xyah)             # (T, D)
    track_tlwh = _xyah_to_tlwh(mean[:, :4])
    lam = cfg.mc_lambda
    if cfg.fuse_min:
        # BoT-SORT fused cost
        d_iou1 = 1.0 - iou_matrix(track_tlwh, tlwh)
        emb_hat = torch.where(
            (app < cfg.fuse_theta_emb) & (d_iou1 < cfg.fuse_theta_prox),
            0.5 * app, 1.0)
        cost1 = torch.minimum(d_iou1, emb_hat)
    elif cfg.aw_scale > 0:
        # DeepOCSort additive IoU + adaptively weighted appearance
        sim = torch.where(det_valid[None, :], 1.0 - app, 0.0)
        row2 = torch.topk(sim, 2, dim=1).values                  # (T, 2)
        row_gap = row2[:, 0] - row2[:, 1]
        simt = torch.where(confirmed[:, None], sim, 0.0)
        col2 = torch.topk(simt.T, 2, dim=1).values               # (D, 2)
        col_gap = col2[:, 0] - col2[:, 1]
        boost = 0.5 * (row_gap[:, None] + col_gap[None, :])
        w_pair = 1.0 + cfg.aw_scale * torch.clamp(boost, 0.0, 1.0)
        d_iou1 = 1.0 - iou_matrix(track_tlwh, tlwh)
        cost1 = d_iou1 - cfg.aw_assoc * sim * w_pair
        cost1 = torch.where(d_iou1 > cfg.max_iou_distance, INF_COST, cost1)
    else:
        cost1 = lam * app + (1.0 - lam) * (maha / CHI2_GATE_4DOF) \
            * cfg.max_dist
        if not static_hf and lam > 0 and not hf:
            # skip frames of the cadence, blended form: IoU geometry scaled
            # so the stage-1 gate admits exactly d_iou < max_iou_distance
            d_iou_skip = 1.0 - iou_matrix(track_tlwh, tlwh)
            cost1 = d_iou_skip * (cfg.max_dist / cfg.max_iou_distance)
    if cfg.ocm_weight > 0:
        # OCSort observation-centric momentum
        vel = mean[:, 4:6]
        diff = z_xyah[None, :, :2] - mean[:, None, :2]           # (T, D, 2)
        vn = vel / torch.clamp(torch.linalg.norm(vel, dim=-1, keepdim=True),
                               min=1e-6)
        dn = diff / torch.clamp(torch.linalg.norm(diff, dim=-1,
                                                  keepdim=True), min=1e-6)
        cos = torch.sum(vn[:, None, :] * dn, dim=-1)             # (T, D)
        moving = torch.linalg.norm(vel, dim=-1) > 1.0
        cost1 = cost1 + cfg.ocm_weight * torch.where(
            moving[:, None], 1.0 - cos, 0.0)
    cost1 = torch.where(maha > CHI2_GATE_4DOF, INF_COST, cost1)
    match1 = gated_matches(cost1, confirmed, det_valid, cfg.max_dist,
                           method=cfg.assignment)                # (T,)
    det_taken1 = _taken(match1, match1 >= 0, d)

    # ---- stage 2: remaining tracks (tentative, or confirmed just-missed)
    # x remaining dets, DIoU cost
    unmatched1 = match1 < 0
    iou_track = active & unmatched1 & (
        (state.status == TENTATIVE) | (state.time_since_update == 1))
    cost2 = 1.0 - diou_matrix(track_tlwh, tlwh)
    match2 = gated_matches(cost2, iou_track, det_valid & ~det_taken1,
                           cfg.max_iou_distance, method=cfg.assignment)
    match = torch.where(match1 >= 0, match1, match2)

    if cfg.byte:
        # stage 3 (BYTE): unmatched confirmed tracks x low-score dets
        det_taken12 = _taken(match, match >= 0, d)
        byte_track = confirmed & (match < 0)
        match3 = gated_matches(cost2, byte_track, low_valid & ~det_taken12,
                               cfg.max_iou_distance, method=cfg.assignment)
        match = torch.where(match >= 0, match, match3)

    if cfg.ocr:
        # OCSort observation-centric recovery on the LAST observation
        det_taken_ocr = _taken(match, match >= 0, d)
        ocr_track = active & (match < 0) & (state.hits > 0)
        last_tlwh = _xyah_to_tlwh(state.last_obs)
        cost_ocr = 1.0 - iou_matrix(last_tlwh, tlwh)
        match_ocr = gated_matches(cost_ocr, ocr_track,
                                  det_valid & ~det_taken_ocr,
                                  cfg.max_iou_distance,
                                  method=cfg.assignment)
        match = torch.where(match >= 0, match, match_ocr)

    matched = match >= 0
    det_idx = torch.clamp(match, 0, d - 1).to(torch.int64)

    # ---- update matched tracks
    nsa_conf = conf[det_idx] if cfg.nsa else None
    umean, ucov = kalman_update(mean, cov, z_xyah[det_idx], nsa_conf)
    mean = torch.where(matched[:, None], umean, mean)
    cov = torch.where(matched[:, None, None], ucov, cov)

    if cfg.oru:
        # OCSort observation-centric re-update: a track re-associated after
        # a gap replays predict+update along a virtual trajectory from its
        # frozen state. Iterations past the longest reacquired gap are
        # no-ops, so the loop stops there (the bound is read on the host).
        gap_in = state.time_since_update
        reacq = matched & (gap_in >= 1) & (state.hits > 0)
        n_steps = (gap_in + 1).to(torch.float32)
        box1 = state.last_obs
        box2 = z_xyah[det_idx]
        n_max = torch.amax(torch.where(reacq, n_steps, 0.0))
        n_cap = float(torch.clamp(n_max, max=float(cfg.max_age + 1)))
        om, oc = state.frozen_mean, state.frozen_cov
        i = 1
        while i <= n_cap:
            pm, pc = kalman_predict(om, oc)
            frac = torch.clamp(i / n_steps, max=1.0)[:, None]
            virt = box1 + (box2 - box1) * frac
            um, uc = kalman_update(pm, pc, virt)
            live = reacq & (i <= n_steps)
            om = torch.where(live[:, None], um, om)
            oc = torch.where(live[:, None, None], uc, oc)
            i += 1
        mean = torch.where(reacq[:, None], om, mean)
        cov = torch.where(reacq[:, None, None], oc, cov)

    alpha = cfg.ema_alpha
    if cfg.dynamic_ema:
        # DeepOCSort dynamic appearance: low-confidence dets barely move it
        trust = torch.clamp(
            (conf[det_idx] - cfg.min_confidence)
            / max(1.0 - cfg.min_confidence, 1e-6), 0.0, 1.0)
        alpha = alpha + (1.0 - alpha) * (1.0 - trust)[:, None]
    dfeat = l2_normalize(feats[det_idx])
    new_feat = l2_normalize(alpha * state.feat + (1.0 - alpha) * dfeat)
    # appearance updates only consume real features
    matched_f = matched if static_hf else (matched & hf)
    if not static_hf:
        # a first real feature replaces the zero placeholder of a track
        # initiated on a skip frame
        new_feat = torch.where((state.gallery_count > 0)[:, None], new_feat,
                               dfeat)
    feat = torch.where(matched_f[:, None], new_feat, state.feat)

    # appearance gallery ring insert (NN_BUDGET role)
    t_idx = torch.arange(t_slots, device=dev)
    budget = state.gallery.shape[1]
    ptr = torch.remainder(state.gallery_count, budget).to(torch.int64)
    gallery = state.gallery.clone()
    gallery[t_idx, ptr] = torch.where(matched_f[:, None], dfeat,
                                      state.gallery[t_idx, ptr])
    gallery_count = torch.where(matched_f, state.gallery_count + 1,
                                state.gallery_count)

    # ORU/OCR bookkeeping: observation + frozen state refresh on a match
    last_obs = torch.where(matched[:, None], z_xyah[det_idx], state.last_obs)
    frozen_mean = torch.where(matched[:, None], mean, state.frozen_mean)
    frozen_cov = torch.where(matched[:, None, None], cov, state.frozen_cov)

    hits = torch.where(matched, state.hits + 1, state.hits)
    tsu = torch.where(matched, 0, state.time_since_update + 1)

    # ---- lifecycle
    status = state.status
    status = torch.where(
        matched & (status == TENTATIVE) & (hits >= cfg.n_init),
        CONFIRMED, status)
    deleted = active & ~matched & (
        (status == TENTATIVE) | (tsu > cfg.max_age))
    status = torch.where(deleted, FREE, status)
    track_id = torch.where(deleted, 0, state.track_id)

    # ---- initiate new tracks from unmatched dets into free slots
    det_matched = _taken(match, matched, d)
    new_det = det_valid & ~det_matched                            # (D,)
    free_slot = status == FREE                                    # (T,)
    # det of rank j goes to the free slot of rank j
    slot_rank = torch.cumsum(free_slot.to(torch.int32), 0,
                             dtype=torch.int32) - 1
    det_rank = torch.cumsum(new_det.to(torch.int32), 0,
                            dtype=torch.int32) - 1
    n_new = torch.sum(new_det, dtype=torch.int32)
    take = free_slot & (slot_rank < n_new)
    # rank -> det index (0 where no new det has that rank), the JAX
    # `zeros(D).at[where(new_det, det_rank, D)].set(arange(D), "drop")`
    ranks = torch.arange(d, device=dev)
    hit = new_det[None, :] & (det_rank[None, :] == ranks[:, None])
    rank_to_det = torch.where(hit.any(dim=1),
                              torch.argmax(hit.to(torch.uint8), dim=1), 0)
    src = rank_to_det[torch.clamp(slot_rank, 0, d - 1).to(torch.int64)]

    imean, icov = kalman_initiate(z_xyah[src])
    mean = torch.where(take[:, None], imean, mean)
    cov = torch.where(take[:, None, None], icov, cov)
    ifeat = l2_normalize(feats[src])
    feat = torch.where(take[:, None], ifeat, feat)
    hits = torch.where(take, 1, hits)
    tsu = torch.where(take, 0, tsu)
    status = torch.where(take, TENTATIVE, status)
    if cfg.n_init <= 1:      # n_init == 1 confirms immediately
        status = torch.where(take, CONFIRMED, status)
    new_ids = state.next_id + slot_rank
    track_id = torch.where(take, new_ids, track_id)
    next_id = state.next_id + n_new

    last_obs = torch.where(take[:, None], z_xyah[src], last_obs)
    frozen_mean = torch.where(take[:, None], imean, frozen_mean)
    frozen_cov = torch.where(take[:, None, None], icov, frozen_cov)
    init_gal = torch.zeros_like(gallery)
    init_gal[:, 0, :] = ifeat
    gallery = torch.where(take[:, None, None], init_gal, gallery)
    # a track initiated on a skip frame starts with no appearance
    init_count = 1 if (static_hf or hf) else 0
    gallery_count = torch.where(take, init_count, gallery_count)

    new_state = TrackerState(mean, cov, feat, status.to(torch.int32),
                             hits.to(torch.int32), tsu.to(torch.int32),
                             track_id.to(torch.int32), next_id, last_obs,
                             frozen_mean, frozen_cov, gallery,
                             gallery_count.to(torch.int32))
    # outputs: confirmed tracks updated this frame (MOT output rule)
    out_valid = (status == CONFIRMED) & (tsu == 0)
    outputs = {"tlwh": _xyah_to_tlwh(mean[:, :4]), "ids": new_state.track_id,
               "valid": out_valid}
    return new_state, outputs
