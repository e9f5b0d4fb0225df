"""Command-line entries of the port: tracking and retrieval evaluation.

Counterparts of `reid_tpu/cli.py:track_main` and `inference_main` with the
same flags. Both run on the card; `device="cpu"` runs the same program on
the CPU with the kernels' plain versions.

  * `track_main`: a frame directory, video file or webcam index in ->
    detections (a MOT det file with `--detections`, else the built-in
    detector: CenterNetLite, or YOLOv5 with `--detector yolov5`, its trunk
    in int8 under `--int8`) -> SERes18 embed (bf16, or int8 with
    `--int8`) -> tracker -> MOT txt [+ annotated frames with
    `--save_vid`] [+ CLEAR/Identity/HOTA against `--gt`]. Camera-motion
    compensation (botsort's default, `--gmc on|off`) estimates each
    chunk's affines on the device; the step path (`--chunk 1`, and every
    run with a built-in detector or `--save_vid`) estimates them per frame
    on the host.
  * `inference_main`: a Market-style split -> SERes18 embeddings (f32 with
    TTA flip, or the int8 serving embed with `--int8`) -> camera de-bias ->
    k-reciprocal Jaccard re-rank -> DBSCAN + tracklet smoothing -> re-rank
    -> CMC and mAP (`--no-rerank`: dot-product scores). `--ckpt` is the
    `.npz` of the flax variable tree.

Retrieval flags that belong to later slices of the port raise an error
naming the slice: `--artifact` (a serving artifact), `--search_option ivf`
and `--attributes_mat`. The port's retrieval runs on one device.

    python -m reid_tpu_torch.cli --detections det.txt --frames_dir frames \
        --int8 --chunk 32 --save_txt out.txt
    python -m reid_tpu_torch.cli --source video.mp4 --detector yolov5 \
        --int8 --save_txt out.txt --save_vid annotated/ --gt gt.txt
    python -m reid_tpu_torch.image_reid_inference --root market1501 \
        --ckpt model.npz
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
                   metavar=("H", "W"))
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


def build_embed(backbone: str, num_classes: int, crop_hw, device,
                ckpt: str = "", int8: bool = False, source: str = ""):
    """The serve-path embed: fn(crops (N,ch,cw,3)) -> L2-normalized
    [feat || logits] (N, F), and the module it runs (the quantized copy
    under int8). The model computes in bf16, as the CLI's flax model does;
    without a checkpoint its weights are a random init from a generator
    seeded 0."""
    from .models import build_model

    model = build_model(backbone, num_classes=num_classes,
                        dtype=torch.bfloat16, device=device)
    if ckpt:
        from .utils.flax_bridge import load_flax_variables
        load_flax_variables(model, ckpt)
    net = model
    if int8:
        from .utils.quantize import quantize, quantized_model
        qstate = quantize(model, [calibration_crops(source, crop_hw,
                                                    device)])
        net = quantized_model(model, qstate)

    def embed_fn(crops):
        feat, logits = net(crops.to(torch.bfloat16))
        f = torch.cat([feat.to(torch.float32), logits.to(torch.float32)],
                      dim=1)
        return f / torch.clamp(torch.linalg.norm(f, dim=1, keepdim=True),
                               min=1e-12)

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
    # the crop products and the tracker run in full f32
    with full_f32():
        return _track(args, device)


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


def _track(args, device):
    from .tracking.methods import method_config
    from .tracking.mot import load_mot_detections
    from .tracking.pipeline import TrackingPipeline

    cfg = method_config(args.tracking_method,
                        min_confidence=args.conf_thres,
                        max_dets=args.max_dets,
                        crop_hw=tuple(args.crop_hw),
                        crop_downsample=args.crop_downsample,
                        frame_crop_cap=args.frame_crop_cap or None,
                        embed_every=max(1, args.embed_every),
                        gmc={"auto": None, "on": True,
                             "off": False}[args.gmc])
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
    p.add_argument("--artifact", default="")
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
                        "by N")
    p.add_argument("--eps", type=float, default=0.55)
    p.add_argument("--attributes_mat", default="")
    p.add_argument("--int8", action="store_true",
                   help="serve the embed post-training-quantized to int8, "
                        "calibrated on the first gallery batch")
    return p


def _later_inference(p: argparse.ArgumentParser, args) -> None:
    if args.artifact:
        p.error("--artifact: serving artifacts (StableHLO in reid_tpu; "
                "torch.export here) are ported in a later slice; use --ckpt")
    if args.search_option == "ivf":
        p.error("--search_option ivf: IVF search (ops/ivf.py) is ported in "
                "a later slice")
    if args.attributes_mat:
        p.error("--attributes_mat: the Market attribute prior "
                "(eval/attributes.py) is ported in a later slice")


def _base_cfg(args, num_classes: int):
    """The retrieval run's configuration (`reid_tpu/cli.py:_base_cfg`,
    the fields inference reads)."""
    from .config import (Config, DataConfig, ModelConfig, RetrievalConfig,
                         TrainConfig)

    sizes = {"market1501": (256, 128), "dukemtmc": (256, 128),
             "veri": (224, 224)}
    h, w = sizes.get(args.dataset, (256, 128))
    h, w = args.height or h, args.width or w
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
              timing=None, keep=None):
    """The body of `inference_main`; returns (CMC, mAP).

    `splits` = (query, gallery, num_train_pids) takes the place of the
    dataset under `--root` (in-memory splits); without `--ckpt` such a run
    uses a random init from a generator seeded 0. `timing` and `keep` are
    handed to `run_inference` (stage seconds; embeddings and distances)."""
    from .data.dataset import ReIDDataset
    from .eval.inference import run_inference
    from .models import build_model

    p = _inference_parser()
    args = p.parse_args(argv)
    _later_inference(p, args)
    if splits is None:
        if not args.ckpt:
            p.error("need --ckpt (the .npz of the flax variable tree)")
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

    # the reference embeds and re-ranks in full f32 (the JAX CLI builds the
    # model in f32)
    with full_f32():
        model = build_model(cfg.model.backbone, num_classes=num_pids,
                            num_cams=cfg.model.num_cams,
                            dtype=torch.float32, device=device)
        if args.ckpt:
            from .utils.flax_bridge import load_flax_variables
            load_flax_variables(model, args.ckpt)
        embed_fn = None
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
                             device=device, timing=timing, keep=keep)


def inference_main(argv=None, device: Optional[str] = "cuda"):
    """Retrieval evaluation (ref image_reid_inference.py main :161-320);
    returns (CMC, mAP)."""
    return inference(argv, device)


if __name__ == "__main__":
    track_main()
