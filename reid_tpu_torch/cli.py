"""Command-line entries of the port: tracking and retrieval evaluation.

Counterparts of `reid_tpu/cli.py:track_main` and `inference_main` with the
same flags. Both run on the card; `device="cpu"` runs the same program on
the CPU with the kernels' plain versions.

  * `track_main`: MOT detections + frames in -> SERes18 embed (bf16, or
    int8 with `--int8`) -> tracker -> MOT txt. Camera-motion compensation
    (botsort's default, `--gmc on|off`) estimates each chunk's affines on
    the device; the step path (`--chunk 1`) estimates them per frame on
    the host.
  * `inference_main`: a Market-style split -> SERes18 embeddings (f32 with
    TTA flip, or the int8 serving embed with `--int8`) -> camera de-bias ->
    k-reciprocal Jaccard re-rank -> DBSCAN + tracklet smoothing -> re-rank
    -> CMC and mAP (`--no-rerank`: dot-product scores). `--ckpt` is the
    `.npz` of the flax variable tree.

Flags that belong to later slices of the port raise an error naming the
slice: for tracking `--gt` (scoring), `--save_vid` (annotation) and the
built-in detectors (no `--detections`); for retrieval
`--artifact` (a serving artifact), `--search_option ivf` and
`--attributes_mat`. The port's retrieval runs on one device.

    python -m reid_tpu_torch.cli --detections det.txt --frames_dir frames \
        --int8 --chunk 32 --save_txt out.txt
    python -m reid_tpu_torch.image_reid_inference --root market1501 \
        --ckpt model.npz
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Optional

import numpy as np
import torch

_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
_STD = np.asarray((0.229, 0.224, 0.225), np.float32)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("track")
    p.add_argument("--source", default="",
                   help="frame directory (images or .npy dumps)")
    p.add_argument("--detections", default="",
                   help="MOT-format det file (required in this slice)")
    p.add_argument("--frames_dir", default="",
                   help="alias for --source <frame directory>")
    p.add_argument("--ckpt", default="",
                   help=".npz of the flax variable tree, '/'-joined keys "
                        "(params/block11/conv1/kernel)")
    p.add_argument("--detector", default="centernet",
                   choices=["centernet", "yolov5"])
    p.add_argument("--yolo_variant", default="yolov5s")
    p.add_argument("--det_ckpt", default="")
    p.add_argument("--det_torch", default="")
    p.add_argument("--det_size", type=int, nargs=2, default=(288, 512),
                   metavar=("H", "W"))
    p.add_argument("--det_base", type=int, default=32)
    p.add_argument("--backbone", default="seres18")
    p.add_argument("--num_classes", type=int, default=751)
    p.add_argument("--tracking_method", default="strongsort",
                   choices=["strongsort", "deepocsort", "ocsort",
                            "bytetrack", "botsort"])
    p.add_argument("--save_txt", default="out.txt")
    p.add_argument("--save_vid", default="")
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
                   help="serve the ReID embed in post-training int8, "
                        "calibrated on the first 8 source frames")
    p.add_argument("--gt", default="")
    p.add_argument("--benchmark", default="MOT16",
                   choices=["MOT16", "MOT17", "MOT20"])
    return p


def _later(p: argparse.ArgumentParser, args) -> None:
    if args.gt:
        p.error("--gt: MOT scoring (tracking/metrics.py) is ported in a "
                "later slice")
    if args.save_vid:
        p.error("--save_vid: annotated output (tracking/annotate.py) is "
                "ported in a later slice")
    if not args.detections:
        p.error("the built-in detectors are ported in a later slice; pass "
                "--detections")


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
    """Track a detection file over a frame directory and write the MOT
    rows; returns the `TrackingPipeline` with its results and timing."""
    p = _parser()
    args = p.parse_args(argv)
    if not args.source and args.frames_dir:
        args.source = args.frames_dir
    _later(p, args)
    # the crop products and the tracker run in full f32
    with full_f32():
        return _track(args, device)


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

    dets = load_mot_detections(args.detections, cfg.max_dets,
                               min_conf=args.conf_thres)
    if args.source:
        from .tracking.sources import iter_frames
        frame_iter = iter_frames(args.source, args.max_frames)
    else:
        n_frames = max(dets) if dets else 0
        if args.max_frames:
            n_frames = min(n_frames, args.max_frames)
        blank = np.zeros((64, 64, 3), np.uint8)
        frame_iter = ((i, blank) for i in range(1, n_frames + 1))

    empty = (np.zeros((cfg.max_dets, 4), np.float32),
             np.zeros(cfg.max_dets, np.float32),
             np.zeros(cfg.max_dets, bool))
    if args.chunk > 1:
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
        for f_idx, frame in frame_iter:
            tlwh, conf, valid = dets.get(f_idx, empty)
            pipe.step(f_idx, frame, tlwh, conf, valid)
    rows = pipe.write(args.save_txt)
    print(f"{rows} rows -> {args.save_txt}; "
          f"timing: {pipe.timing_summary()}")
    return pipe


def track_main(argv=None, device: Optional[str] = "cuda") -> int:
    """`track`, returning the number of MOT rows written."""
    return sum(int(np.sum(r["valid"])) for r in track(argv, device).results)


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
