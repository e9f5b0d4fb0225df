"""Command-line entries of the port: tracking, retrieval evaluation,
image training, video training and the GAN's two programs.

Counterparts of `reid_tpu/cli.py:track_main`, `inference_main`,
`train_main`, `video_main`, `gan_main` and `lsro_main` with the same
flags. Each runs on the card;
`device="cpu"` runs the same program on the CPU with the kernels' plain
versions.

  * `track_main`: a frame directory, video file or webcam index in ->
    detections (a MOT det file with `--detections`, else the built-in
    detector: CenterNetLite, or YOLOv5 with `--detector yolov5`, its trunk
    in int8 under `--int8`) -> the `--backbone` embed (bf16, or int8 with
    `--int8`), whose width the tracker takes from a probe forward ->
    tracker -> MOT txt [+ annotated frames with `--save_vid`] [+
    CLEAR/Identity/HOTA against `--gt`]. The transformers embed crops of
    `--crop_hw`: ViT's position table is built for that size, and Swin
    needs a grid that halves three times into whole 7x7 windows (448 224
    or 224 224).
    Camera-motion compensation (botsort's default, `--gmc on|off`)
    estimates each chunk's affines on the device; the step path (`--chunk
    1`, and every run with a built-in detector or `--save_vid`) estimates
    them per frame on the host.
  * `inference_main`: a Market-style split -> `--backbone` embeddings
    (f32 with TTA flip, or the int8 serving embed with `--int8`) -> camera
    de-bias -> k-reciprocal Jaccard re-rank -> DBSCAN + tracklet
    smoothing -> re-rank -> CMC and mAP (`--no-rerank`: dot-product
    scores). `--ckpt` is the
    `.npz` of the flax variable tree; `--artifact` serves a `.pt2` written
    by `eval.serving.export_reid_artifact` (torch.export, f32 or int8) in
    its place, where the JAX package reads StableHLO. `--search_option
    ivf` ranks through the IVF index, `--attributes_mat` adds the Market
    attribute prior. The classifier's width is read from `--ckpt`. The
    transformers embed at 448x224 (Market, Duke) or 224x224 (VeRi), as
    the JAX package's `_base_cfg` sizes them. The port's retrieval runs on
    one device.
  * `train_main`: a `--backbone` on a Market-style train split (PK
    batches, device augmentation, the hybrid loss, Adam + center SGD, DCC
    tables, `--xbm`), the `.npz` checkpoint
    `checkpoint/cnn_net_checkpoint_{dataset}.npz` (where the JAX package
    writes orbax), `--ckpt` warm start, `--continual` pseudo-labelling of
    `--target_dataset` and continual training, `--export` a `.pt2`
    serving artifact. One device. `--renorm` puts BatchRenorm into the
    SERes18 family's trunk (the JAX package takes the flag and drops it);
    the other backbones refuse it. The serving entries read a `--renorm`
    checkpoint into plain BatchNorm, as the JAX package does. OSNet
    trains through the same loop; `--backbone plr_osnet` is refused (its
    dual-branch loop is the library `train/plr_train.py`, which the JAX
    package's `train_main` never reaches either), and so are vit,
    swin_v1 and swin_v2: the JAX package's `train_main` fails on them
    (ViT's 384-wide feature meets loss tables sized by feat_dim = 512;
    Swin's step passes cams to a model initialised without its SIE
    table). Their step is the library (`train.state.make_optimizers`,
    `train.steps.make_train_step` with feat_dim at the model's width).
  * `video_main`: video ReID training on MOT16 tracklets (`--gt_paths`
    gt.txt files, frames under `--prefix`): the 3-D `video_resnet50` in
    bf16, the hybrid loss and MADGRAD without a clip
    (`train/video_train.py`); prints the final loss and returns the flax
    variable tree. One device.
  * `gan_main`: synthetic person images from a Market-style tree (train
    + gallery, 128x64): DCGAN per k-means appearance group (`--groups`,
    the colour-pyramid representation, or a local torchvision ResNet-50
    `.pt` with `--embed_ckpt`; one EMA and one `gan_group{g}.npz`
    checkpoint under `--ckpt_dir` a group) or the VAE-GAN (`--vae
    [--wasserstein]`); writes `--n_images` gen_*.jpg to `--out`
    (`gan/driver.py`). One device.
  * `lsro_main`: the `--backbone` classifier (baseline) on the real train
    split + `--gen_dir`'s gen_* images under the LSRO loss, SGD with
    momentum 0.9; `--ckpt` writes the flax variable tree as `.npz`.

`--backbone` of the three image CLIs takes the image names
`models.build_model` has (seres18, cares18, emares18, baseline, resnet50,
agw, osnet, osnet_x1_0, osnet_x0_5, osnet_x0_25, plr_osnet, vit, swin_v1,
swin_v2). The video models (video_resnet50, video_resnet18) take clips,
not images: the JAX package's image CLIs accept their names and then fail
inside the model on the 4-D crops, so these refuse them at the parser;
they train through `video_main`. Other names raise KeyError.

    python -m reid_tpu_torch.cli --detections det.txt --frames_dir frames \
        --int8 --chunk 32 --save_txt out.txt
    python -m reid_tpu_torch.cli --source video.mp4 --detector yolov5 \
        --int8 --save_txt out.txt --save_vid annotated/ --gt gt.txt
    python -m reid_tpu_torch.image_reid_inference --root market1501 \
        --ckpt model.npz
    python -m reid_tpu_torch.image_reid_train --root market1501 \
        --epochs 60 --export reid.pt2
    python -m reid_tpu_torch.video_reid_train \
        --gt_paths MOT16/train/MOT16-02/gt/gt.txt --prefix MOT16/train/
    python -m reid_tpu_torch.synthetic_main --root market1501 --groups 2
    python -m reid_tpu_torch.train_baseline --root market1501 \
        --gen_dir synthetic_images
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional

import numpy as np
import torch

_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
_STD = np.asarray((0.229, 0.224, 0.225), np.float32)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("track")
    p.add_argument("--source", default="",
                   help="video file | frame directory (images or .npy "
                        "dumps) | webcam index")
    p.add_argument("--detections", default="",
                   help="MOT-format det file; omit to run the built-in "
                        "detector (--detector) on --source frames")
    p.add_argument("--frames_dir", default="",
                   help="alias for --source <frame directory>")
    p.add_argument("--ckpt", default="",
                   help=".npz of the flax variable tree, '/'-joined keys "
                        "(params/block11/conv1/kernel)")
    p.add_argument("--detector", default="centernet",
                   choices=["centernet", "yolov5"],
                   help="built-in detector family")
    p.add_argument("--yolo_variant", default="yolov5s",
                   help="yolov5 width/depth variant (n/s/m/l/x or p)")
    p.add_argument("--det_ckpt", default="",
                   help="detector checkpoint: .npz of the flax variable "
                        "tree")
    p.add_argument("--det_torch", default="",
                   help="published yolov5*.pt state_dict (ultralytics "
                        "names)")
    p.add_argument("--det_size", type=int, nargs=2, default=(288, 512),
                   metavar=("H", "W"), help="detector input resolution")
    p.add_argument("--det_base", type=int, default=32,
                   help="CenterNetLite width (must match --det_ckpt)")
    p.add_argument("--backbone", default="seres18")
    p.add_argument("--num_classes", type=int, default=751)
    p.add_argument("--tracking_method", default="strongsort",
                   choices=["strongsort", "deepocsort", "ocsort",
                            "bytetrack", "botsort"])
    p.add_argument("--save_txt", default="out.txt")
    p.add_argument("--save_vid", default="",
                   help="annotated output: .avi/.mp4 file or image "
                        "directory")
    p.add_argument("--conf_thres", type=float, default=0.5)
    p.add_argument("--max_dets", type=int, default=64)
    p.add_argument("--crop_downsample", type=int, default=1)
    p.add_argument("--frame_crop_cap", type=int, default=0,
                   help="crop/embed only the top-N valid boxes per frame "
                        "(0 = every det slot)")
    p.add_argument("--gmc", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--embed_every", type=int, default=1,
                   help="appearance cadence: embed crops only on every "
                        "k-th frame; --chunk needs chunk %% k == 0")
    p.add_argument("--crop_hw", type=int, nargs=2, default=(256, 128),
                   metavar=("H", "W"),
                   help="ReID crop size; the transformers want their "
                        "grid: 448 224 or 224 224 (swin's window 7 needs "
                        "the grid to halve three times)")
    p.add_argument("--max_frames", type=int, default=0,
                   help="stop after N frames (0 = all)")
    p.add_argument("--chunk", type=int, default=1,
                   help="frames per chunk of the chunked path; 1 = the "
                        "per-frame step path")
    p.add_argument("--int8", action="store_true",
                   help="serve the ReID embed (and the yolov5 detector "
                        "trunk, when selected) in post-training int8, "
                        "calibrated on the first 8 source frames")
    p.add_argument("--gt", default="",
                   help="MOT16 gt.txt (9 columns): score the run with "
                        "CLEAR/Identity/HOTA after tracking")
    p.add_argument("--benchmark", default="MOT16",
                   choices=["MOT16", "MOT17", "MOT20"],
                   help="gt scoring benchmark: MOT20 widens the distractor "
                        "set")
    return p


def calibration_crops(source: str, crop_hw, device) -> torch.Tensor:
    """ImageNet-normalized crops drawn from the first 8 source frames with
    `np.random.default_rng(0)`, as `reid_tpu.cli.track_main` draws them;
    uniform noise when the source has no frames."""
    from .tracking.pipeline import resize_bilinear_matmul
    from .tracking.sources import iter_frames

    rng_np = np.random.default_rng(0)
    frames = [fr for _, fr in iter_frames(source, 8)] if source else []
    if not frames:
        calib = (rng_np.random((32, *crop_hw, 3), dtype=np.float32)
                 - _MEAN) / _STD
        return torch.from_numpy(calib).to(device)
    patches = []
    for frame0 in frames:
        h0, w0 = frame0.shape[:2]
        for _ in range(max(32 // len(frames), 4)):
            y = rng_np.integers(0, max(h0 - crop_hw[0], 1))
            x = rng_np.integers(0, max(w0 - crop_hw[1], 1))
            patch = frame0[y:y + crop_hw[0], x:x + crop_hw[1]]
            patch = resize_bilinear_matmul(
                torch.as_tensor(patch, dtype=torch.float32), crop_hw)
            patches.append(patch.numpy() / 255.0)
    return torch.from_numpy((np.stack(patches) - _MEAN) / _STD).to(device)


# crops a transformer embeds in one forward: their activations at 448x224
# outgrow the card at a chunk's 2,048 crops (Swin's stage-1 MLP alone is
# 9.9 GB in bf16, ViT's int8 stem im2col 30 GB), so the track embed takes
# them in slices of this many
TRANSFORMER_EMBED_SLICE = 256


def build_embed(backbone: str, num_classes: int, crop_hw, device,
                ckpt: str = "", int8: bool = False, source: str = ""):
    """The serve-path embed: fn(crops (N,ch,cw,3)) -> L2-normalized
    [feat || logits] (N, F), or the feature alone for a dual-head model
    (plr_osnet: 2,560), and the module it runs (the quantized copy under
    int8). The model computes in bf16, as the CLI's flax model does;
    without a checkpoint its weights are a random init from a generator
    seeded 0. The transformers take the crops in slices of
    TRANSFORMER_EMBED_SLICE (each row's embedding is its own; a slice's
    GEMMs may round another way than the whole batch's)."""
    from .models import build_model
    from .models.factory import TRANSFORMERS

    model = build_model(backbone, num_classes=num_classes,
                        dtype=torch.bfloat16, device=device,
                        input_hw=tuple(crop_hw))
    if ckpt:
        from .utils.flax_bridge import load_flax_variables
        load_flax_variables(model, ckpt)
    net = model
    if int8:
        from .utils.quantize import quantize, quantized_model
        qstate = quantize(model, [calibration_crops(source, crop_hw,
                                                    device)])
        net = quantized_model(model, qstate)

    def embed_one(crops):
        feat, logits = net(crops.to(torch.bfloat16))
        if isinstance(logits, tuple):
            # the reference's eval path emits the part feature only (ref
            # plr_osnet.py:107-110)
            f = feat.to(torch.float32)
        else:
            f = torch.cat([feat.to(torch.float32),
                           logits.to(torch.float32)], dim=1)
        return f / torch.clamp(torch.linalg.norm(f, dim=1, keepdim=True),
                               min=1e-12)

    def embed_fn(crops):
        if backbone in TRANSFORMERS and \
                crops.shape[0] > TRANSFORMER_EMBED_SLICE:
            return torch.cat([embed_one(c) for c in
                              crops.split(TRANSFORMER_EMBED_SLICE)])
        return embed_one(crops)

    return embed_fn, net


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and cuDNN convolutions; the caller's settings
    come back afterwards."""
    backends = torch.backends
    tf32 = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
    backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = tf32


@torch.inference_mode()
def track(argv=None, device: Optional[str] = "cuda"):
    """Track a source (detections from a file or the built-in detector)
    and write the MOT rows; returns the `TrackingPipeline` with its
    results, timing and, under `--gt`, `metrics`."""
    p = _parser()
    args = p.parse_args(argv)
    if not args.source and args.frames_dir:
        args.source = args.frames_dir
    if not args.source and not args.detections:
        p.error("need --source and/or --detections")
    refuse_video_backbone(p, args.backbone, "track_main")
    # the crop products and the tracker run in full f32
    with full_f32():
        return _track(args, device)


def refuse_video_backbone(p: argparse.ArgumentParser, backbone: str,
                          cli: str) -> None:
    """Stop at the parser on a video model's name: the JAX package's image
    CLIs take it and then fail inside the 3-D model on the 4-D crops."""
    from .models.factory import VIDEO
    if backbone in VIDEO:
        p.error(f"--backbone {backbone}: a 3-D video model takes (N, T, H, "
                f"W, 3) clips, not the image crops of {cli} (the JAX "
                "package's takes the name and then fails inside the "
                "model); train it with video_main (python -m "
                "reid_tpu_torch.video_reid_train)")


def yolo_calibration_frames(source: str, det_hw) -> np.ndarray:
    """The first 8 source frames, stacked; `np.random.default_rng(0)`
    uint8 noise at `det_hw` where the source gives none (or frames of
    different sizes), as `reid_tpu.cli.track_main` calibrates."""
    from .tracking.sources import iter_frames
    try:
        frames = [fr for _, fr in iter_frames(source, 8)]
        if not frames:
            raise ValueError("empty source")
        return np.stack(frames)
    except ValueError:
        return np.random.default_rng(0).integers(
            0, 255, (8, *det_hw, 3)).astype(np.uint8)


def build_yolo_detector(args, device):
    """The YOLOv5 of a run without `--detections`: bf16, a random init
    from a generator seeded 1 unless `--det_torch` or `--det_ckpt` gives
    weights; returns (model, QuantState of its trunk under `--int8`, else
    None)."""
    from .models.yolo import build_yolo, load_yolov5_state_dict, quantize_yolo

    det_hw = tuple(args.det_size)
    model = build_yolo(args.yolo_variant, num_classes=1,
                       dtype=torch.bfloat16, device=device)
    if args.det_torch:
        load_yolov5_state_dict(model, args.det_torch)
    elif args.det_ckpt:
        from .utils.flax_bridge import load_flax_variables
        load_flax_variables(model, args.det_ckpt)
    qstate = None
    if args.int8:
        qstate = quantize_yolo(
            model, yolo_calibration_frames(args.source, det_hw), det_hw)
    return model, qstate


def build_detector(args, max_dets: int, device):
    """fn(frame (H,W,3) uint8) -> (tlwh, conf, valid), the built-in
    detector that `--detector` names."""
    det_hw = tuple(args.det_size)
    if args.detector == "yolov5":
        from .models.yolo import make_yolo_detector_fn
        model, qstate = build_yolo_detector(args, device)
        return make_yolo_detector_fn(model, det_hw, max_dets=max_dets,
                                     conf_thres=args.conf_thres,
                                     qstate=qstate)
    from .models.detector import CenterNetLite
    from .train.detector_train import make_detector_fn
    model = CenterNetLite(base=args.det_base).init_weights(
        torch.Generator().manual_seed(1))
    if args.det_ckpt:
        from .utils.flax_bridge import load_flax_variables
        load_flax_variables(model, args.det_ckpt)
    return make_detector_fn(model.to(device).eval(), det_hw,
                            max_dets=max_dets)


def track_config(args):
    """The tracker configuration of a `track` run's parsed flags."""
    from .tracking.methods import method_config

    return method_config(args.tracking_method,
                         min_confidence=args.conf_thres,
                         max_dets=args.max_dets,
                         crop_hw=tuple(args.crop_hw),
                         crop_downsample=args.crop_downsample,
                         frame_crop_cap=args.frame_crop_cap or None,
                         embed_every=max(1, args.embed_every),
                         gmc={"auto": None, "on": True,
                              "off": False}[args.gmc])


def _track(args, device):
    from .tracking.mot import load_mot_detections
    from .tracking.pipeline import TrackingPipeline

    cfg = track_config(args)
    embed_fn, _ = build_embed(args.backbone, args.num_classes, cfg.crop_hw,
                              device, ckpt=args.ckpt, int8=args.int8,
                              source=args.source)
    probe = embed_fn(torch.zeros((1, *cfg.crop_hw, 3), device=device))
    pipe = TrackingPipeline(cfg, embed_fn, int(probe.shape[-1]),
                            device=device)

    # detections: a MOT file, or the built-in detector
    dets = detect = None
    if args.detections:
        dets = load_mot_detections(args.detections, cfg.max_dets,
                                   min_conf=args.conf_thres)
    else:
        detect = build_detector(args, cfg.max_dets, device)

    # frame source (video / dir / webcam), or blanks for det-only runs
    if args.source:
        from .tracking.sources import iter_frames, source_fps
        frame_iter = iter_frames(args.source, args.max_frames)
        vid_fps = source_fps(args.source)
    else:
        n_frames = max(dets) if dets else 0
        if args.max_frames:
            n_frames = min(n_frames, args.max_frames)
        blank = np.zeros((64, 64, 3), np.uint8)
        frame_iter = ((i, blank) for i in range(1, n_frames + 1))
        vid_fps = 30

    writer = None
    if args.save_vid:
        from .tracking.annotate import AnnotatedVideoWriter
        writer = AnnotatedVideoWriter(args.save_vid, fps=vid_fps)

    empty = (np.zeros((cfg.max_dets, 4), np.float32),
             np.zeros(cfg.max_dets, np.float32),
             np.zeros(cfg.max_dets, bool))
    if args.chunk > 1 and dets is not None and writer is None:
        items = list(frame_iter)
        f_ids = [i for i, _ in items]
        frames_np = np.stack([f for _, f in items])
        t_total = len(items)
        tlwh_np = np.zeros((t_total, cfg.max_dets, 4), np.float32)
        conf_np = np.zeros((t_total, cfg.max_dets), np.float32)
        valid_np = np.zeros((t_total, cfg.max_dets), bool)
        for i, f_idx in enumerate(f_ids):
            tlwh_np[i], conf_np[i], valid_np[i] = dets.get(f_idx, empty)
        pipe.run_sequence(frames_np, tlwh_np, conf_np, valid_np,
                          chunk=args.chunk, first_frame=f_ids[0],
                          frame_crop_cap=args.frame_crop_cap or None)
    else:
        if args.chunk > 1:
            print("--chunk needs --detections (and no --save_vid); "
                  "falling back to the per-frame path")
        pipe.timing.setdefault("detect", 0.0)
        for f_idx, frame in frame_iter:
            if dets is not None:
                tlwh, conf, valid = dets.get(f_idx, empty)
            else:
                # the detector returns host arrays: the card is done
                t0 = time.perf_counter()
                tlwh, conf, valid = detect(frame)
                dt = time.perf_counter() - t0
                pipe.timing["detect"] += dt
                pipe.timing["total"] += dt
            out = pipe.step(f_idx, frame, tlwh, conf, valid)
            if writer is not None:
                writer.write(frame, out["tlwh"], out["ids"], out["valid"])
    if writer is not None:
        writer.close()
        print(f"annotated output -> {args.save_vid}")
    rows = pipe.write(args.save_txt)
    print(f"{rows} rows -> {args.save_txt}; "
          f"timing: {pipe.timing_summary()}")
    if args.gt:
        from .tracking.metrics import evaluate_mot16
        pipe.metrics = evaluate_mot16(args.gt, args.save_txt,
                                      benchmark=args.benchmark)
        print("  ".join(f"{k}: {v:.2f}" for k, v in pipe.metrics.items()
                        if not k.startswith("_")))
    return pipe


def track_main(argv=None, device: Optional[str] = "cuda"):
    """`track`, returning the metrics dict under `--gt`, else the number of
    MOT rows written."""
    pipe = track(argv, device)
    if pipe.metrics is not None:
        return pipe.metrics
    return sum(int(np.sum(r["valid"])) for r in pipe.results)


def _inference_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("image_reid_inference")
    p.add_argument("--root", default="data")
    p.add_argument("--dataset", default="market1501",
                   choices=["market1501", "dukemtmc", "veri"])
    p.add_argument("--backbone", default="seres18")
    p.add_argument("--ckpt", default="",
                   help=".npz of the flax variable tree, '/'-joined keys")
    p.add_argument("--artifact", default="",
                   help="serving artifact: run checkpoint-free from the "
                        "exported embed step (ref --onnx, "
                        "image_reid_inference.py:239). A .pt2 written by "
                        "this package's export_reid_artifact (torch.export), "
                        "on the device it serves; the JAX package's "
                        "StableHLO files are not read")
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--height", type=int, default=0,
                   help="override input height (0 = dataset default)")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--no-rerank", action="store_true")
    p.add_argument("--rerank_sparse_s", type=int, default=0,
                   help="top-S Jaccard min-sum (0 = exact dense path)")
    p.add_argument("--search_option", default="auto",
                   choices=["auto", "dense", "sparse", "ivf"],
                   help="gallery-size search policy (the faiss "
                        "search_option role): auto picks dense or top-S "
                        "by N; ivf takes an IVF approximate ranking")
    p.add_argument("--eps", type=float, default=0.55)
    p.add_argument("--attributes_mat", default="",
                   help="market_attribute.mat: add the Market-1501 "
                        "attribute prior to the Jaccard distances")
    p.add_argument("--int8", action="store_true",
                   help="serve the embed post-training-quantized to int8, "
                        "calibrated on the first gallery batch")
    return p


def _input_hw(args):
    """The input size of `reid_tpu/cli.py:_base_cfg`: 256x128 (VeRi
    224x224), the transformers 448x224 (VeRi 224x224); `--height` /
    `--width` override it."""
    from .models.factory import TRANSFORMERS

    sizes = {"market1501": (256, 128), "dukemtmc": (256, 128),
             "veri": (224, 224)}
    h, w = sizes.get(args.dataset, (256, 128))
    if args.backbone in TRANSFORMERS:
        h, w = (448, 224) if args.dataset in ("market1501", "dukemtmc") \
            else (224, 224)
    return args.height or h, args.width or w


def _base_cfg(args, num_classes: int):
    """The retrieval run's configuration (`reid_tpu/cli.py:_base_cfg`,
    the fields inference reads)."""
    from .config import (Config, DataConfig, ModelConfig, RetrievalConfig,
                         TrainConfig)

    h, w = _input_hw(args)
    n_cams = {"market1501": 6, "dukemtmc": 8, "veri": 20}.get(args.dataset, 6)
    return Config(
        model=ModelConfig(backbone=args.backbone, num_classes=num_classes,
                          num_cams=n_cams),
        train=TrainConfig(batch_size=args.bs),
        data=DataConfig(dataset=args.dataset, root=args.root, height=h,
                        width=w),
        retrieval=RetrievalConfig(dbscan_eps=args.eps,
                                  rerank_sparse_s=args.rerank_sparse_s,
                                  search_option=args.search_option))


@torch.inference_mode()
def inference(argv=None, device: Optional[str] = "cuda", splits=None,
              timing=None, keep=None, mesh=None):
    """The body of `inference_main`; returns (CMC, mAP). `mesh` (a
    `parallel.Mesh`) row-shards both Jaccard calls over its ranks.

    `splits` = (query, gallery, num_train_pids) takes the place of the
    dataset under `--root` (in-memory splits); without `--ckpt` or
    `--artifact` such a run uses a random init from a generator seeded 0
    (build_model's). `timing` and `keep` are
    handed to `run_inference` (stage seconds; embeddings and distances)."""
    from .data.dataset import ReIDDataset
    from .eval.inference import run_inference
    from .models import build_model

    p = _inference_parser()
    args = p.parse_args(argv)
    refuse_video_backbone(p, args.backbone, "inference_main")
    if args.int8 and args.artifact:
        p.error("--int8 needs --ckpt (export an int8 artifact instead via "
                "export_reid_artifact(int8_calib=...))")
    if splits is None:
        if not args.ckpt and not args.artifact:
            p.error("need --ckpt (the .npz of the flax variable tree) or "
                    "--artifact")
        from .data.datasets import build_dataset
        raw = build_dataset(args.dataset, args.root)
        num_pids = raw.num_train_pids
    else:
        query, gallery, num_pids = splits
    cfg = _base_cfg(args, num_pids)
    if splits is None:
        h, w = cfg.data.height, cfg.data.width
        query = ReIDDataset(raw.query, num_pids, h, w)
        gallery = ReIDDataset(raw.gallery, num_pids, h, w)

    attribute_dist = None
    if args.attributes_mat and args.dataset == "market1501":
        from .eval.attributes import get_attribute_dist, get_attributes
        ids, attrs = get_attributes(args.attributes_mat)
        pids = np.concatenate([gallery.labels, query.labels])
        attribute_dist = get_attribute_dist(ids, attrs, pids)

    # the reference embeds and re-ranks in full f32 (the JAX CLI builds the
    # model in f32)
    with full_f32():
        model = embed_fn = None
        if args.artifact:
            from .eval.serving import load_serving_fn
            embed_fn = load_serving_fn(args.artifact)
        else:
            variables, num_classes = None, num_pids
            if args.ckpt:
                from .utils.flax_bridge import (classifier_width,
                                                load_flax_variables,
                                                load_npz)
                variables = load_npz(args.ckpt)
                # a continual run's checkpoint has a wider classifier
                num_classes = classifier_width(variables["params"])
            model = build_model(cfg.model.backbone, num_classes=num_classes,
                                num_cams=cfg.model.num_cams,
                                dtype=torch.float32, device=device,
                                input_hw=(cfg.data.height, cfg.data.width))
            if variables is not None:
                load_flax_variables(model, variables)
        if args.int8:
            from .eval.serving import make_int8_embed_fn
            # the eval loader's first batch of min(bs, 32), wrap-padded
            cb, idx = min(args.bs, 32), np.arange(len(gallery))
            first = np.concatenate([idx[:cb], idx[:cb - len(idx[:cb])]])
            calib = torch.from_numpy(gallery.gather(first)["images"]).to(
                device)
            embed_fn = make_int8_embed_fn(model, calib,
                                          tta_flip=cfg.retrieval.tta_flip)
        return run_inference(model, query, gallery, cfg,
                             rerank=not args.no_rerank, embed_fn=embed_fn,
                             device=device, timing=timing, keep=keep,
                             attribute_dist=attribute_dist, mesh=mesh)


def inference_main(argv=None, device: Optional[str] = "cuda"):
    """Retrieval evaluation (ref image_reid_inference.py main :161-320);
    returns (CMC, mAP). Under `torchrun` the ranks of the process group
    share the re-ranking (`parallel.mesh_from_env`), where the JAX
    package's `run_inference` takes a mesh; one device otherwise."""
    from .parallel.mesh import mesh_from_env
    return inference(argv, device, mesh=mesh_from_env(device=device))


def _train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("image_reid_train")
    p.add_argument("--root", default="data")
    p.add_argument("--dataset", default="market1501",
                   choices=["market1501", "dukemtmc", "veri"])
    p.add_argument("--backbone", default="seres18")
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--instance", type=int, default=4)
    p.add_argument("--margin", type=float, default=0.0)
    p.add_argument("--epsilon", type=float, default=0.0)
    p.add_argument("--center_lamda", type=float, default=5e-4)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--cam_factor", type=float, default=-1.0)
    p.add_argument("--renorm", action="store_true",
                   help="BatchRenorm in the SERes18 family's trunk")
    p.add_argument("--xbm", action="store_true")
    p.add_argument("--continual", action="store_true")
    p.add_argument("--target_dataset", default="dukemtmc")
    p.add_argument("--target_root", default="data")
    p.add_argument("--eps", type=float, default=0.55)
    p.add_argument("--height", type=int, default=0,
                   help="override input height (0 = dataset default)")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--ckpt", default="",
                   help="warm start: .npz of the flax variable tree")
    p.add_argument("--export", default="",
                   help="write the serving artifact (.pt2, torch.export) "
                        "here after training (ref to_onnx, "
                        "train_prepare.py:14-47)")
    p.add_argument("--seed", type=int, default=0)
    return p


def _train_cfg(args, num_classes: int):
    """The training run's configuration (`reid_tpu/cli.py:_base_cfg` for
    the CNN backbones)."""
    from .config import (Config, DataConfig, LossConfig, ModelConfig,
                         RetrievalConfig, TrainConfig)
    from .models.factory import TRANSFORMERS

    h, w = _input_hw(args)
    n_cams = {"market1501": 6, "dukemtmc": 8, "veri": 20}.get(args.dataset, 6)
    return Config(
        model=ModelConfig(backbone=args.backbone, num_classes=num_classes,
                          num_cams=n_cams, cam_factor=args.cam_factor,
                          renorm=args.renorm),
        # the SIE XBM trainer gates at epoch > 10, the CNN one at > 25
        loss=LossConfig(margin=args.margin, center_lamda=args.center_lamda,
                        epsilon=args.epsilon, tao=args.temperature,
                        xbm=args.xbm,
                        xbm_start_epoch=10 if args.backbone in TRANSFORMERS
                        else 25),
        train=TrainConfig(batch_size=args.bs, num_instances=args.instance,
                          epochs=args.epochs, seed=args.seed),
        data=DataConfig(dataset=args.dataset, root=args.root, height=h,
                        width=w),
        retrieval=RetrievalConfig(dbscan_eps=args.eps))


def train_main(argv=None, device: Optional[str] = "cuda",
               ckpt_dir: str = "checkpoint"):
    """Image-ReID training (ref image_reid_train.py main :595-697) with the
    continual branch; returns the train state. The checkpoint goes to
    `ckpt_dir`. As the JAX package's `train_cnn` defaults to a mesh over
    every local device, under `torchrun` (WORLD_SIZE set) the loop is
    data parallel over the process group's ranks that divide the batch
    (`parallel.fit_mesh`), with rank 0 writing the checkpoint and the
    artifact, and a rank outside that group returns None at once
    (`parallel.sits_out`); without it, one device."""
    p = _train_parser()
    args = p.parse_args(argv)
    refuse_video_backbone(p, args.backbone, "train_main")
    if args.backbone == "plr_osnet":
        # the JAX package's train_main sends it to train_cnn, whose first
        # step fails on the pair of features
        p.error("--backbone plr_osnet: its dual-branch loop is the library "
                "reid_tpu_torch.train.plr_train (create_plr_train_state, "
                "make_plr_train_step); train_main does not run it, as the "
                "JAX package's does not")
    from .models.factory import TRANSFORMERS
    if args.backbone in TRANSFORMERS:
        # the JAX package's train_main fails on both (ROADMAP C)
        p.error(f"--backbone {args.backbone}: the JAX package's train_main "
                "cannot train it (ViT's 384-wide feature meets loss tables "
                "sized by feat_dim = 512; Swin's step passes cams to a "
                "model initialised without its SIE table), so neither "
                "does this one; the transformer step is the library "
                "(train.state.make_optimizers, train.steps.make_train_step "
                "with cfg.model.feat_dim at the model's width)")
    if args.renorm:
        from .models.factory import supports_renorm
        if not supports_renorm(args.backbone):
            p.error(f"--renorm: backbone '{args.backbone}' has no "
                    "BatchRenorm (the SERes18 family has: seres18, cares18, "
                    "emares18)")
    from .data.dataset import ReIDDataset
    from .data.datasets import build_dataset
    from .parallel.mesh import mesh_from_env, sits_out
    from .train.image_train import (produce_pseudo_data, train_cnn,
                                    train_continual)

    mesh = mesh_from_env(args.bs, device)
    if sits_out(mesh, args.bs):
        return None
    raw = build_dataset(args.dataset, args.root)
    cfg = _train_cfg(args, raw.num_train_pids)
    h, w = cfg.data.height, cfg.data.width
    if mesh is not None:
        print(f"data parallel over {mesh.size} rank(s) of the process "
              "group", flush=True)
    dataset = ReIDDataset(raw.train, raw.num_train_pids, h, w)
    state, _ = train_cnn(cfg, dataset, use_xbm=args.xbm, ckpt=args.ckpt,
                         ckpt_dir=ckpt_dir, device=device, mesh=mesh)
    if args.continual:
        t_raw = build_dataset(args.target_dataset, args.target_root)
        target = ReIDDataset(t_raw.train, t_raw.num_train_pids, h, w)
        records, centroids, k = produce_pseudo_data(state, target, cfg,
                                                    mesh=mesh)
        state, _ = train_continual(cfg, state, dataset, records, centroids,
                                   k, ckpt_dir=ckpt_dir, mesh=mesh)
    if args.export and (mesh is None or mesh.rank == 0):
        from .eval.serving import export_reid_artifact
        export_reid_artifact(state.model.eval(), args.export, h, w)
        print(f"serving artifact -> {args.export}")
    print("training complete")
    return state


def video_main(argv=None, device: Optional[str] = "cuda"):
    """Video ReID training (ref video_reid_train.py main :198-231), the
    flags and defaults of `reid_tpu/cli.py:video_main`; prints the final
    loss and returns the flax variable tree. Under `torchrun` the loop is
    data parallel over the ranks that divide `--bs`, and the other ranks
    return None, as in `train_main`."""
    p = argparse.ArgumentParser("video_reid_train")
    p.add_argument("--gt_paths", nargs="+", required=True)
    p.add_argument("--prefix", default="datasets/MOT16/train/")
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--seq_len", type=int, default=10)
    p.add_argument("--crop_factor", type=float, default=1.0)
    args = p.parse_args(argv)

    from .config import Config
    from .parallel.mesh import mesh_from_env, sits_out
    from .train.video_train import VideoTrackletDataset, train_video

    mesh = mesh_from_env(args.bs, device)
    if sits_out(mesh, args.bs):
        return None
    ds = VideoTrackletDataset(args.gt_paths, seq_len=args.seq_len,
                              lamda=args.crop_factor,
                              prefix_image_path=args.prefix)
    # the JAX CLI passes no mesh (one device, or all of them by default)
    variables, losses = train_video(Config(), ds, epochs=args.epochs,
                                    batch_size=args.bs,
                                    seq_len=args.seq_len, device=device,
                                    **({} if mesh is None else
                                       {"mesh": mesh}))
    print(f"video training complete; final loss {losses[-1]:.4f}")
    return variables


def gan_main(argv=None, device: Optional[str] = "cuda"):
    """Synthetic images (ref gan/synthetic_main.py main :454-506), the flags
    and defaults of `reid_tpu/cli.py:gan_main`: DCGAN per appearance
    group or the VAE-GAN, then `--n_images` samples written as
    gen_{i:05d}.jpg under `--out`; returns them, (n, 128, 64, 3) in
    [-1, 1]."""
    p = argparse.ArgumentParser("synthetic_main")
    p.add_argument("--root", default="data")
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--nz", type=int, default=100)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--groups", type=int, default=1,
                   help="k-means appearance groups (ref --k)")
    p.add_argument("--embed_ckpt", default="",
                   help="a local torchvision resnet50 .pt for the grouping "
                        "features (ref kmeans_.py:16-34 ImageNet trunk); "
                        "default: pooled colour-pyramid representation")
    p.add_argument("--vae", action="store_true",
                   help="train the VAE-GAN instead of DCGAN (ref --vae)")
    p.add_argument("--wasserstein", action="store_true",
                   help="Wasserstein D + gradient penalty (ref --Wassertein "
                        "--gp)")
    p.add_argument("--n_images", type=int, default=1000,
                   help="synthetic images to sample (ref --instances)")
    p.add_argument("--ckpt_dir", default="checkpoint",
                   help="per-group generator checkpoints (ref checkpoint/)")
    p.add_argument("--out", default="synthetic_images")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import os

    from PIL import Image

    from .data import Market1501, ReIDDataset
    from .gan import (generate_group_images, get_groups, sample_vaegan,
                      train_gan_groups, train_vaegan)

    raw = Market1501(args.root)
    ds = ReIDDataset(raw.train + raw.gallery, raw.num_train_pids, 128, 64)
    # uint8 in host RAM (PIL, as the JAX package decodes them); the drivers
    # scale each batch to [-1, 1] on the device
    images = np.stack([ds.load_image(i) for i in range(len(ds))])
    if args.vae:
        vae, _ = train_vaegan(images, epochs=args.epochs, batch_size=args.bs,
                              lr=args.lr, wasserstein=args.wasserstein,
                              seed=args.seed, device=device)
        imgs = sample_vaegan(vae, args.n_images)
    else:
        groups = None
        if args.groups > 1:
            embed_fn = None
            if args.embed_ckpt:
                from .gan import make_resnet_embed_fn
                embed_fn = make_resnet_embed_fn(args.embed_ckpt, device)
            groups = get_groups(images, args.groups, embed_fn=embed_fn,
                                device=device)
            print("group sizes:", np.bincount(groups, minlength=args.groups))
        _, group_states = train_gan_groups(
            images, groups, k=args.groups, epochs=args.epochs,
            batch_size=args.bs, nz=args.nz, ngf=args.ngf, ndf=args.ndf,
            lr=args.lr, seed=args.seed, checkpoint_dir=args.ckpt_dir,
            device=device)
        per_group = (args.n_images + args.groups - 1) // args.groups
        imgs = generate_group_images(group_states, per_group,
                                     nz=args.nz)[:args.n_images]

    os.makedirs(args.out, exist_ok=True)
    for i, im in enumerate(((imgs + 1) * 127.5).clip(0, 255).astype("uint8")):
        Image.fromarray(im).save(os.path.join(args.out, f"gen_{i:05d}.jpg"))
    print(f"wrote {len(imgs)} images to {args.out}")
    return imgs


def lsro_main(argv=None, device: Optional[str] = "cuda"):
    """The LSRO baseline (ref gan/train_baseline.py :214-343), the flags and
    defaults of `reid_tpu/cli.py:lsro_main`: the `--backbone` classifier
    on the real train split + the gen_* images of `--gen_dir` (resized to
    64x128); `--ckpt` writes the flax variable tree as `.npz`. Returns
    (variables, history)."""
    p = argparse.ArgumentParser("train_baseline")
    p.add_argument("--root", default="data")
    p.add_argument("--gen_dir", required=True,
                   help="directory of generated gen_*.jpg images "
                        "(ref dcganDataset gen_0000 flags)")
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--backbone", default="baseline")
    p.add_argument("--ckpt", default="",
                   help="save the trained baseline here (.npz)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import glob
    import os

    from PIL import Image

    from .data import Market1501, ReIDDataset
    from .gan import train_lsro_baseline

    raw = Market1501(args.root)
    ds = ReIDDataset(raw.train, raw.num_train_pids, 128, 64)
    real = np.stack([ds.load_image(i) for i in range(len(ds))])
    gen_files = sorted(glob.glob(os.path.join(args.gen_dir, "gen_*")))
    if not gen_files:
        p.error(f"no gen_* images under {args.gen_dir}")
    gen = np.stack([
        np.asarray(Image.open(f).convert("RGB").resize((64, 128)))
        for f in gen_files])
    variables, history = train_lsro_baseline(
        real, ds.labels, gen, num_classes=raw.num_train_pids,
        epochs=args.epochs, batch_size=args.bs, lr=args.lr,
        backbone=args.backbone, seed=args.seed, device=device)
    if args.ckpt:
        from .utils.flax_bridge import save_npz
        save_npz(args.ckpt, variables)
    print(f"final: loss={history[-1]['loss']:.4f} "
          f"acc={history[-1]['acc']:.4f}")
    return variables, history


if __name__ == "__main__":
    track_main()
