"""Configuration of the port.

Own copies of `reid_tpu/config.py`'s `TrackerConfig`, `RetrievalConfig`
and `LossConfig` (fields, defaults and their notes unchanged; tests hold
them equal), and of the fields of `ModelConfig`, `TrainConfig` and
`DataConfig` that the retrieval CLI and the training slice read, so that
the port imports nothing of the JAX package.
The measured numbers in the notes were taken on a TPU v5e by the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Operating point of modification_deepsort/deep_sort.yaml:1-10."""
    method: str = "strongsort"         # strongsort|deepocsort|ocsort|bytetrack|botsort
    max_dist: float = 0.15             # cosine appearance gate
    min_confidence: float = 0.5
    max_iou_distance: float = 0.7
    max_age: int = 30
    n_init: int = 3
    nn_budget: int = 100
    ema_alpha: float = 0.9             # strongsort appearance EMA
    mc_lambda: float = 0.995           # motion/appearance cost blend
    max_tracks: int = 128              # static track-slot capacity (SoA)
    max_dets: int = 64                 # static per-frame detection capacity
    assignment: str = "greedy_rounds"  # "greedy_rounds" (default; mutual-min
                                       # rounds, provably same matching as
                                       # "greedy" in ~log serial trips —
                                       # measured +5.3% fps at MOT16 load)
                                       # | "greedy" | "auction" (eps-optimal)
    byte: bool = False                 # BYTE low-score second association:
                                       # dets in [byte_low, min_confidence)
                                       # can re-match lost tracks by IoU but
                                       # never initiate new tracks
    byte_low: float = 0.1
    ocm_weight: float = 0.0            # OCSort observation-centric momentum:
                                       # penalize dets whose direction from
                                       # the track disagrees with its velocity
    oru: bool = False                  # OCSort observation-centric re-update:
                                       # on re-association after a gap, re-run
                                       # the Kalman filter along a virtual
                                       # trajectory from the frozen state
    ocr: bool = False                  # OCSort observation-centric recovery:
                                       # final IoU association of unmatched
                                       # tracks' LAST OBSERVATIONS vs dets
    nsa: bool = False                  # StrongSort NSA Kalman: measurement
                                       # noise scaled by (1 - det confidence)
    dynamic_ema: bool = False          # DeepOCSort dynamic appearance: EMA
                                       # trust scaled by det confidence
    aw_scale: float = 0.0              # DeepOCSort adaptive appearance
                                       # weighting: boost the appearance term
                                       # by its row/col discriminativeness gap
    aw_assoc: float = 0.75             # DeepOCSort base appearance weight in
                                       # the additive IoU - w*sim cost
    gmc: Optional[bool] = None         # camera-motion compensation override:
                                       # None = method default (botsort on,
                                       # others off — the upstream submodule
                                       # similarly defaults BoT-SORT to its
                                       # sparse-flow GMC); True forces GMC on
                                       # for ANY method (upstream StrongSORT
                                       # ships ecc: true — pairs well with
                                       # embed_every: GMC keeps the motion
                                       # gate valid on appearance-free skip
                                       # frames, see EVAL.md); False forces
                                       # it off.
    fuse_min: bool = False             # BoT-SORT fused cost: min(IoU dist,
                                       # proximity-masked appearance dist)
    fuse_theta_emb: float = 0.25       # BoT-SORT appearance mask threshold
    fuse_theta_prox: float = 0.5       # BoT-SORT proximity (IoU dist) mask
    use_gallery: bool = False          # NN_BUDGET appearance gallery (min
                                       # cosine over the last nn_budget feats
                                       # per track) instead of the EMA feature
    crop_hw: Tuple[int, int] = (256, 128)  # ReID crop (h, w); ref TRACKING_EVAL.md:5
    crop_downsample: int = 1           # crop from an s x s avg-pooled frame:
                                       # bounds the pooled-plane footprint;
                                       # measured NOT faster on TPU (crop
                                       # einsum is shape-bound, not
                                       # FLOP-bound); boxes smaller than
                                       # s*crop_hw are upsampled anyway
                                       # (near-lossless, oversampled
                                       # regime — pool+bilinear is not
                                       # bit-identical to full-res crops)
    embed_in_dtype: str = "float32"    # dtype of the crop->embed handoff
                                       # (the (T*cap, ch, cw, 3) normalized
                                       # crops tensor). "bfloat16" halves
                                       # the HBM write+read between the crop
                                       # einsum and the backbone's first
                                       # conv; bit-identical downstream when
                                       # the embed model itself computes in
                                       # bf16 (its first op casts anyway).
                                       # Keep "float32" for f32 embed models.
    embed_every: int = 1               # appearance cadence: embed ReID crops
                                       # only on every k-th frame; in between
                                       # association is appearance-neutral
                                       # (pure motion/IoU) and the EMA
                                       # feature / NN gallery are untouched.
                                       # k=1 (default) is bit-identical to
                                       # embedding every frame. The chunked
                                       # path requires chunk % k == 0 so the
                                       # cadence stays static per program.
                                       # Measured (EVAL.md "Appearance
                                       # cadence"): MOT16-load fps 372->632
                                       # at k=2; hard-gauntlet quality
                                       # neutral-or-better for EVERY
                                       # method (strongsort +0.73 MOTA,
                                       # deepocsort +0.00, botsort -0.16;
                                       # bytetrack/ocsort bit-identical) —
                                       # skip frames associate on IoU
                                       # geometry (tracker.py cost_skip).
    frame_crop_cap: Optional[int] = None  # crop/embed only the top-cap
                                       # valid-by-confidence boxes per frame
                                       # (det SLOTS can exceed the affordable
                                       # crop count, e.g. a 300-det NMS feed);
                                       # slots beyond the cap are dropped from
                                       # `valid`. cap >= #valid per frame is
                                       # output-identical. None = crop every
                                       # slot.


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    backbone: str = "seres18"          # factory key (models/factory.py)
    num_classes: int = 751             # Market1501 train ids
    num_cams: int = 6
    feat_dim: int = 512
    cam_factor: float = -1.0           # scale of learnable per-camera bias
                                       # (ref SERes18_IBN.py:198,248)
    renorm: bool = False               # BatchRenorm instead of BatchNorm
    dtype: str = "bfloat16"            # compute dtype; params always float32


@dataclasses.dataclass(frozen=True)
class LossConfig:
    margin: float = 0.0                # 0 => WeightedRegularizedTriplet
                                       # (ref hybrid_losses.py:23-26)
    center_lamda: float = 5e-4         # ref image_reid_train.py lamda
    cluster_factor: float = 1.0
    smoothing: float = 0.1
    epsilon: float = 0.0               # poly-loss epsilon
    tao: float = 1.0                   # CE temperature
    dcc_scalar: float = 20.0           # ref center_contrastive_losses.py:72
    dcc_momentum: float = 0.1
    dcc_weight: float = 0.25
    use_dcc: bool = True
    use_ce: bool = False               # HybridLoss omits plain CE; Weighted adds it
    xbm: bool = False
    xbm_size_mult: int = 4             # memory K = mult * batch (ref XBM.py usage)
    # XBM warm-up gate: the plain CNN XBM trainer starts the memory at
    # epoch > 25 (ref image_reid_train_xbm.py:88); the SIE (side-info
    # transformer) XBM trainer starts at epoch > 10 (ref :167). The CLI sets
    # 10 for vit/swin backbones.
    xbm_start_epoch: int = 25


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64               # also the eval batch
    num_instances: int = 4             # K of PK sampling (ref --instance)
    epochs: int = 60
    lr: float = 3.5e-4                 # Adam when PK sampling (ref :51-56)
    center_lr: float = 0.5
    weight_decay: float = 5e-4
    warmup_epochs: int = 10            # ref WarmUpCosineScheduler (train_prepare.py:84)
    hold_epochs: int = 30
    eta_min: float = 7e-7
    grad_clip: float = 10.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "market1501"
    root: str = "data"
    height: int = 256                  # ref data_transforms.py Market sizes
    width: int = 128
    pad: int = 10
    random_erasing_prob: float = 0.5
    flip_prob: float = 0.5
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    k1: int = 20                       # k-reciprocal (ref faiss_utils.py:149)
    k2: int = 6
    lambda_value: float = 0.3
    dbscan_eps: float = 0.55           # ref image_reid_inference.py:290
    dbscan_min_samples: int = 10
    cam_bias_lambda: float = 0.05      # ridge reg of camera whitening (ref la=0.05)
    tta_flip: bool = True
    smooth_tracklet_alpha: float = 0.1 # ref inference_utils.py:27
    # top-S approximate Jaccard min-sum (0 = exact dense path). Big-gallery
    # mode: 2.1x at N=23k with S=256; exact when the k-reciprocal expansion
    # support fits in S (ops/rerank.py _minsum_topk).
    rerank_sparse_s: int = 0
    # gallery-size search policy (ops/policy.py — the faiss search_option
    # 0-3 role, ref faiss_utils.py:121-181): "auto" picks dense / top-S
    # sparse by N (IVF is explicit opt-in only — measured slower than the
    # brute-force MXU kNN); explicit "dense"/"sparse"/"ivf" override.
    search_option: str = "auto"


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    retrieval: RetrievalConfig = dataclasses.field(
        default_factory=RetrievalConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
