"""The five tracker methods: strongsort, deepocsort, ocsort, bytetrack,
botsort. Counterpart of `reid_tpu/tracking/methods.py`: each is a preset of
the one static-shape tracker core (tracker.py)."""

from __future__ import annotations

from ..config import TrackerConfig


def method_config(method: str, **overrides) -> TrackerConfig:
    if method == "strongsort":
        base = dict(method="strongsort", nsa=True)
    elif method == "botsort":
        base = dict(method="botsort", fuse_min=True, max_dist=0.8,
                    max_iou_distance=0.8, fuse_theta_emb=0.25,
                    fuse_theta_prox=0.5)
    elif method == "bytetrack":
        # appearance off; BYTE low-score second association on
        base = dict(method="bytetrack", mc_lambda=0.0, max_dist=2.0,
                    byte=True, byte_low=0.1)
    elif method == "ocsort":
        base = dict(method="ocsort", mc_lambda=0.0, max_dist=2.0,
                    ema_alpha=0.5, max_age=20, ocm_weight=0.2,
                    oru=True, ocr=True)
    elif method == "deepocsort":
        base = dict(method="deepocsort", ema_alpha=0.5, max_age=20,
                    ocm_weight=0.2, oru=True, ocr=True,
                    dynamic_ema=True, aw_scale=0.5, aw_assoc=0.75,
                    mc_lambda=0.0, max_dist=1.0)
    else:
        raise KeyError(f"unknown tracking method '{method}'")
    base.update(overrides)
    return TrackerConfig(**base)


def uses_gmc(cfg: TrackerConfig) -> bool:
    # cfg.gmc overrides the method default (botsort on, others off)
    if cfg.gmc is not None:
        return bool(cfg.gmc)
    return cfg.method == "botsort"
