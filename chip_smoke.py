#!/usr/bin/env python3
"""Smoke run of `reid_tpu_torch` on one NVIDIA card: the quickest proof that
the port builds its kernels and runs its main path there.

    python3 chip_smoke.py             # on one card, about 14 min of command
    python3 chip_smoke.py --profile   # the same, tracing the track runs,
                                      # a chunk of each stream operating
                                      # point and the retrieval run

Phases, one JSON line each:
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build    nvcc of every kernel source in reid_tpu_torch/csrc, all
              started together, into reid_tpu_torch/_build; each kernel's
              registers and spill bytes from the -Xptxas -v logs (no kernel
              may spill);
  3. kernels  each kernel at each call site of the track path, on a batch of
              B = 2048 crops (a 32-frame chunk of 64 detection slots). K1
              (`conv3x3_s8`, csrc/qconv.cu) and K2's three GEMMs
              (`se_basic_block_s8`, csrc/qblock.cu) run on the Hopper
              mainloop of csrc/wgmma_s8.cuh: a persistent grid, one producer
              thread issuing per tap and 64 or 128 channels a 4-D TMA box of
              the NHWC activation (the SAME halo zero-filled by the
              hardware) and a 2-D box of the packed weight into a 3-6 stage
              mbarrier ring, two consumer warpgroups on wgmma m64nNk32 s8
              (N = 256 where Cout allows), each with its own epilogue; K2's
              keep the IBN statistics, the SE pooling and the residual on
              chip where a tile holds what they need. K3 and K5 run on the
              same mainloop, one launch a call: K3 with N tiles of the nine
              taps of 16 channels and a box of whole image rows plus a
              halo row above and below, its product summed over the taps
              on chip (along x by shuffles, along y through shared
              memory) while the other consumer warpgroup runs its
              products; K5 with TMA's im2col mode loading each tap's rows
              of 128 or 256 flat output pixels; K4 with A read by
              ldmatrix from one TMA-loaded slab of a tile's rows and
              their halo per K chunk, for all nine taps, and fed to
              wgmma from registers. Each is held
              against its plain PyTorch version (conv3x3_s8 exactly, the
              fused SE block at rtol = atol = 1e-4 on >= 99.9% of elements
              and 5e-2 on all, and whether it is bit-equal), and timed with
              CUDA events (median of 20 after warm-up) beside the plain
              version, the least time the card could take, and the one
              PyTorch call that computes the same function where there is
              one; K1 and K2 also back to back (`queued_ms`, and the
              wrapper's `host_ms`). K2's rows add its time before the wgmma
              design (`before_ms`), a torch.profiler split of one call's
              launches with the bytes each must move, their count and sum
              (`launches_per_call`, `design_bytes`), and where images span
              tiles the share of outputs that the per-tile summation order
              moves against one part an image (`moved_by_tile_order`).
              The fused block is also
              compared, without a limit, with its plain version summed in
              torch's order (`share_tight_torch_order`), which shows how
              much room the limit has when the summation orders differ.
              At K1's call sites K3-K5 (`conv3x3_s8_ncat`, `_bitshift`,
              `_dma`) too, each held equal to its plain version and to K1
              and timed the same way, with its time before this design
              (`before_ms`), a torch.profiler split of one call's launches
              (`launches_per_call`) and the device memory a call allocates
              beside its output (`scratch_bytes`, 0 for each);
  3b. probe   `reid_tpu_torch.qconv_probe.run()`, the path of K3-K5: the
              bf16 conv, `torch._int_mm` and K1/K3/K4/K5 at the probe's
              four layer shapes (B = 512), every kernel exact against its
              plain version and K1; launch counts zeroed just before the
              run and read just after it;
  4. track    `reid_tpu_torch.cli.track` (the body of `track_main`, which
              returns the pipeline) on a synthetic MOT16-load
              scene (1920x1080, 50 moving boxes in 64 slots, 128 track
              slots, 256x128 crops, SERes18 with 751 classes, --int8):
              --chunk 32 over 64 frames, then the per-frame step path over
              8 frames; launch counts are zeroed just before each run and
              read just after it. Then the same with botsort and its
              camera-motion compensation on a scene whose textured
              background the camera pans by PAN px a frame: the chunked
              path's device affines within 1 px of the pan and within
              1e-3 px of the CPU's on the same frames, the step path's
              (`estimate_affine` on the host) within 1 px of the pan; then
              strongsort --chunk 32 once more without --int8, the default
              bf16 embed (cuDNN), its fps and stage split;
  4b. track with the built-in detectors, on phase 4's scene, the step
              path: YOLOv5s with its trunk in int8 (DET_ARGS: --det_size
              288 512, --conf_thres 0.25, random weights from a generator
              seeded 1, calibrated on the first 8 frames) over 16 frames:
              fps, the detector's ms a frame (timed around it, the device
              synchronised), crop_embed and associate, valid detections a
              frame, and K1's launches at the detector's sites, zeroed
              just before the run and read just after (5 at 1x18x32 c128
              and 2 at 1x9x16 c256 a frame, exactly). Then the detector on
              the card against the same weights and QuantState on the CPU
              on 2 frames: equal valid counts and each card box within
              0.5 px of the CPU's box of the same candidate (the share
              within 0.02 px, and of output slots holding the same box,
              reported: the random init scores every cell within ~1e-4 of
              0.25, so which candidates NMS keeps turns on last bits);
              K1 at the two sites (exact, timed as in phase 3); one
              frame's launches and device time (torch.profiler); and
              `nms_fixed` alone. CenterNetLite (f32, no kernel of ours)
              over 8 frames: fps and detections a frame;
  4c. gauntlet `reid_tpu_torch.gauntlet`: its 300-frame distractor scene
              (rendered while the kernels build), the five methods
              through `track_main --gt` (--chunk 16, --conf_thres 0.3,
              --max_dets 64): MOTA, IDF1 and HOTA of each against its
              CHECK_BANDS, which it must not leave;
  4d. streams multi-stream tracking (`tracking.streams.make_stream_tracker`)
              with the CLI's int8 embed at the two operating points of
              STREAM_POINTS, each stream its own seeded scene:
              multistream8 (8 streams, --chunk 64, 2 chunks, 480x640, 16
              boxes in 32 slots, 64 track slots: one embed call of 8,192
              crops a chunk) and mot16_load_multistream8 (8 streams,
              --chunk 8, 3 chunks, 1080p, 50 boxes in 64 slots, 128 track
              slots: 3,200 crops),
              then botsort with GMC at the second on PAN scenes (each
              stream's device affines within 1 px of the pan). Each chunk's
              seconds, stage split (crop_embed, gmc, associate) and host
              reads; aggregate fps (all frames of the chunks after the
              first over their seconds) beside one stream's fps alone,
              counted alike; peak device memory;
              K1/K2 launches zeroed just before and read just after (2 and
              4 a chunk: one embed call for all streams); every stream held
              against its own single-stream run (ids and valid identical,
              tlwh within 1e-4; bit-equality reported). Then K1 and K2 at
              the stream batch (B = 8,192) against their plain versions,
              with the limits of phase 3, and timed;
  5. embed    the card's int8 embed against the same quantized model on the
              CPU (plain kernel versions), cosine of [feat || logits];
  6. retrieval `reid_tpu_torch.cli.inference` (the body of
              `inference_main`) on an in-memory synthetic split of
              Market-1501's size drawn on the card (`market_splits`):
              3,368 queries and 19,732 gallery images
              of 256x128, 750 ids, 6 cameras; SERes18 in f32 with 751
              classes (D = 1,263) and random weights (seed 0); --bs 64,
              TTA flip, camera de-bias, k1 = 20, k2 = 6, eps 0.55,
              --search_option dense. CMC@1/5/10, mAP, seconds per stage and
              peak device memory; launch counts are zeroed just before the
              run and read just after it;
  7. retrieval --int8: the same run with the int8 serving embed, whose
              f32 trunk runs both int8 kernels in their f32-in, f32-out
              form; its launch counts likewise, and the cosine of its
              gallery embeddings to phase 6's reported;
  8. kernels, f32 form: as phase 3 (the same limits) at each call site of
              the `--int8` retrieval trunk, on one embed batch of 128
              images (64 query images and their flips);
  9. distance kernels, held against their plain versions (rtol = atol =
              1e-4 for sqeuclidean, 1e-5 for l1) and timed like phase 3.
              sqeuclidean (K6) is a pipelined SIMT f32 GEMM: transposed,
              zero-padded copies of both operands (in its time), 128 x 144
              tiles streamed through a 4-stage cp.async ring, 8 x 9 outputs
              a thread read as float4 quads, each output summed by fmaf
              over k ascending; l1 (K7) is the 128 x 128 SIMT tile kernel.
              Both run on
              the operands of phase 6's first Jaccard call: sqeuclidean at
              the path's query block (1,024 of the de-biased unit features
              against all 23,100, D = 1,263), with the share of rows whose
              top-20 indices match; l1 on the V encoding recomputed from
              those features, a slab of 1,024 rows against N = D = 23,100,
              and one full 23,100^3 call;
 10. retrieval on the card against the CPU: the post-embed half
              (`evaluate_features`) on the same 1,024 features (160
              queries, 864 gallery images: ids 0-31), dense and sparse:
              CMC within 1/Q at every rank and mAP within 1e-2, with the
              share of Jaccard entries within 1e-4 reported, and a second
              card run equal to the first bit for bit; from the same
              features and ranking the Jaccard within 1e-5 everywhere, and
              the top-20 sets equal on >= 99.9% of rows (near-ties: see
              `phase_retrieval_cpu`); then the f32 and the int8 TTA embed,
              card against CPU, on 16 images: cosine >= 0.99999 and
              >= 0.999;
 11. ivf      IVF search (`ops/ivf.py`) on phase 6's de-biased unit
              features (N = 23,100) with `choose_search`'s plan for
              --search_option ivf (nlist 512, nprobe 64): seconds of
              k-means, bucketing and `ivf_topk`, recall@20 against the
              exact top-20 (K6), CMC/mAP of the post-embed half with the
              IVF plan beside phase 6's dense (K6/K7 launches counted
              around it); card against CPU on phase 10's 1,024 features
              with one k-means init: bucket ids equal, distances within
              1e-5, differing rankings (near-ties) reported;
 12. artifact the f32 and the int8 serving artifact (torch.export, K1
              and K2 as custom ops) of SERes18 at 256x128 with a dynamic
              batch: export seconds and file sizes; loaded, at B = 1, 3
              and 64, bit-equal to serving in process, K1/K2 launches
              counted (2 and 4 a call for int8); then `inference
              --artifact` (f32, equal to the in-process model) and the
              int8 artifact with `--attributes_mat` (a .mat written here)
              on an in-memory split of 64 queries and 256 gallery images;
 13. train    `cli.train_main` on a synthetic Market-shaped JPEG
              tree written to a temporary directory (751 ids of 8
              images, two colours an id, 1 query and 2 gallery images an
              id): SERes18-IBN in bf16 at 256x128, 751 classes, --bs 64
              --instance 4, one epoch, --export. The step period on the
              device's clock (CUDA events between steps; median, 5th and
              95th percentile, min, max), images/s, the host's wait on
              the loader, the DCC seeding's seconds, peak memory and the
              logged losses, which must fall; the `.npz` checkpoint read
              back by `inference_main --ckpt`, the artifact against
              serving in process (cosine >= 0.999);
 14. train step card vs cpu: one f32 step from one state on the card and
              on the CPU, SERes18 at 256x128, 751 classes, a batch of 16,
              the same augmentation draws, TF32 off; the limits are in
              `phase_train_card_vs_cpu`;
 15. continual `produce_pseudo_data` on a synthetic DukeMTMC-sized target
              (16,522 images of 702 ids at 256x128, on disk) with the
              dense search plan, so K6 ranks and K7 sums (the "auto" plan
              takes the top-S min-sum above 15,000 rows), then
              `train_continual` for one epoch over every 24th record
              of the merged split (CONTINUAL_EVERY, a cut for the
              clock): the
              clusters, the Jaccard's seconds, peak memory, and the K6/K7
              launches zeroed just before and read just after
              (`launches_continual_run` in their rows); last, five train
              steps under torch.profiler (conv/GEMM against other device
              time, launches a step).
The torchvision-style ResNets, in the same run:
 16. kernels  K1 at ZOO_K1_SITES, B = 2048 crops through the quantized
              bf16 trunk (after phase 3): resnet50's layer2_1 / layer3_1 /
              layer4_0 conv2 (32x16 c128, 16x8 c256, 16x8 c512) and
              baseline's layer4_0.conv1 (16x8, 256 -> 512), each exact
              against its plain version and timed as in phase 3; each
              trunk's K1 route on exactly its ZOO_K1_COUNT convs, no fused
              block;
 17. track    `--backbone resnet50` at phase 4's operating point, --chunk
              32 over 48 frames (ZOO_TRACK_FRAMES), bf16 then `--int8`:
              fps, stage split and
              launches (K1 only under --int8, zeroed just before each run);
 18. embed    baseline and agw (non-local `w_bn` non-zero) in bf16, card
              against CPU on 8 crops; the `--int8` embed of each of the
              three against its f32 embed on the card, with baseline's K1
              launches in one embed call;
 19. retrieval `--backbone agw --int8` on half of phase 6's split
              (ZOO_SPLIT_PART, N = 11,550; D = 2,799):
              seconds, CMC/mAP, peak memory, launches; K6 and K7 held
              against their plain versions on that run's operands and timed
              (phase 9 without its full N x N call);
 20. train    `train_main --backbone resnet50`, one epoch of a 64-id tree
              (8 steps of 64 at 256x128, bf16): step period, images/s,
              peak memory; then phase 14's card-vs-CPU step for resnet50;
              last, five traced steps (`step_profile`): launches, device
              time and the idle share of a step, after one step under the
              sync debug mode "error".
CARes18 (triplet attention) and EMARes18 (EMA), in the same run:
 21. kernels  K1 at ATTN_K1_SITES, B = 2048 crops through each quantized
              bf16 trunk (after phase 16): cares18's block22.conv1 (32x16
              c128) and emares18's block41.conv1 (16x8, 256 -> 512), exact
              against the plain version and timed as in phase 3; each
              trunk's K1 route on exactly 10 convs, no fused block;
 22. track    `--backbone cares18`, then `emares18`, as phase 17: bf16 then
              `--int8`, fps, stage split and launches: K1 exactly 10 an
              embed call, K2 none;
 23. embed    both in bf16, card against CPU on 8 crops, and each
              `--int8` embed against its f32 embed on the card, as phase
              18;
 24. train    `train_main --backbone cares18 --renorm` on phase 20's tree
              (after phase 20's card-vs-CPU step): step period, images/s,
              peak memory, every BatchRenorm counter at the steps taken;
              phase 14's card-vs-CPU step for cares18 with BatchRenorm
              past warm-up and for emares18 (limits as resnet50's); last
              (after phase 20's), five traced steps of the renorm run with
              the sync check, as phase 20.
OSNet and PLR-OSNet, in the same run:
 25. track    `--backbone osnet`, then `plr_osnet`, as phase 17: bf16 then
              `--int8`, fps, the crop_embed ms a frame and the stage
              split; K1 and K2 launch 0 times (OSNet's 3x3 convs are
              depthwise: the int8 route sums them exactly in an f32 conv);
 26. embed    both in bf16, card against CPU on 8 crops (cosine >= 0.999
              a row; PLR-OSNet embeds its 2,560-wide feature alone), and
              each `--int8` embed against its f32 embed on the card
              (cosine >= 0.99, no K1 or K2 launch);
 27. retrieval `--backbone plr_osnet` in f32 on phase 19's split (D =
              2,560): seconds, CMC/mAP, peak memory, launches; K6 (D =
              2,560) and K7 held against their plain versions on that
              run's operands and timed, as phase 19;
 28. train    `train_main --backbone osnet` on phase 20's tree: step
              period, images/s, peak memory; then PLR-OSNet's
              dual-branch step (`train/plr_train.py`) at 256x128, batch 64
              in bf16, under both optimizer branches (MADGRAD without PK
              sampling, Adam with it): ms a step on the device's clock,
              launches, device time and idle share, the sync check;
              phase 14's card-vs-CPU f32 step for osnet and for PLR-OSNet
              (its Adam branch), the limits at twice the CPU-to-CPU
              spread where that exceeds SERes18's (`spread`).
ViT-t with SIE and Swin-T v1 / v2 at 448x224, in the same run:
 29. track    `--backbone vit`, then `swin_v1`, as phase 17 with
              `--crop_hw 448 224` (ZOO_TRACK_FRAMES frames, --chunk 32):
              bf16 then `--int8`, and `swin_v2` in bf16 (TRANSFORMER_TRACK):
              fps, the crop_embed ms a frame, the stage split and peak
              memory; K1 and K2 launch 0 times (no conv of theirs is 3x3
              with 128-multiple channels); the embed takes the crops in
              slices of `cli.TRANSFORMER_EMBED_SLICE`;
 30. embed    the three in bf16 at full width, card against CPU on 8
              crops of 448x224 (cosine >= 0.999 a row), and each `--int8`
              embed against its f32 embed on the card (cosine >= 0.99, no
              K1 or K2 launch), as phase 26;
 31. retrieval `--backbone vit` in f32 on a split of phase 19's sizes,
              ids and cameras at 448x224 (`market_splits`; D = 1,135):
              seconds, CMC/mAP, peak memory, launches;
              K6 at D = 1,135 and K7 held against their plain versions on
              that run's operands and timed, as phase 19;
 32. train    the transformer step (`make_train_step`, the library the
              JAX package can run, with `cfg.model.feat_dim` at the
              model's width; `train_main` refuses these backbones) of ViT
              with cams and of Swin v1 at 448x224, batch 64, bf16,
              dropout 0.1 drawn on the card, under plain SGD (PK
              sampling) and Adam: ms a step on the device's clock,
              launches, device time, idle share and the sync check
              (`phase_train_transformer`); before it, phase 14's
              card-vs-CPU f32 step of each at a batch of 8 with dropout 0,
              the limits as phase 28's (`spread`);
 33. video    `cli.video_main` at its defaults (bs 8, seq_len 10,
              256x128, bf16, the 3-D video_resnet50) for one epoch of 4
              steps on a synthetic MOT16-shaped tree of two sequences of
              1080p JPEG frames with 32 pedestrian tracks and a distractor
              (`write_mot_tree`): the step period on the device's clock,
              the loader's seconds a step (whole-frame JPEG decode, as the
              reference's loader), peak memory, finite losses; then the
              step alone on a kept batch (median of 10 after 3), the sync
              check, launches, device time and idle share a step, and
              its FLOP rate (`phase_video_train`);
 34. video    one f32 video step (MADGRAD without a clip) card against
              CPU on VideoResNet(blocks=(1, 1, 1, 1)) at 2 x 4 x 64 x 32,
              under phase 14's limits or twice the CPU's own spread, and
              the bf16 eval forward of video_resnet50 on 2 clips of 10 x
              256 x 128, card against CPU, cosine >= 0.999 a row
              (`phase_video_card_vs_cpu`). No kernel of K1-K7 lies on the
              video path (3-D convs, no --int8).
The GAN programs and detector training, in the same run; no
kernel of K1-K7 lies on these paths (their launches counted, 0):
 35. gan      `cli.gan_main` at its defaults (the spectral DCGAN, nz 100,
              ngf = ndf = 64, batch 64, 128x64, Adam b1 0.5) with --groups
              2 and --n_images 64, one epoch (the default is 120), on a
              synthetic Market tree of 72 ids in two colour families
              (`write_gan_tree`: 1,008 train + gallery images, two
              k-means groups of about 504, 7 batches each): group sizes,
              steps, the step period on the device's clock, peak memory,
              the 64 images and 2 checkpoints written (the last read back
              by `load_gan_state`); the step alone (median of 5 after 2),
              one step under the sync debug mode "error", launches,
              device time and idle share (`gan_step_profile`);
 36. gan      `gan_main --vae --wasserstein` (the VAE, zdim 128, and the
              Wasserstein D with its gradient penalty), one epoch at
              batch 64 (15 steps), as phase 35;
 37. gan      `cli.lsro_main` (baseline, 72 classes, batch 32, SGD) over
              the tree's 576 train images and phase 35's 64 generated
              ones, one epoch (20 steps): step period, peak memory, the
              epoch's loss and real-only accuracy, the `.npz` written;
              the step alone on a batch drawn on the card, as phase 35;
 38. detector `train_detector` at its defaults (det_hw 288x512, base 32,
              batch 8, Adam) on 16 1080p frames of phase 4's scene with
              their 50 boxes each, one epoch (2 steps); the step alone,
              the sync check, launches, device time, idle share;
 39. gan card vs cpu: one f32 step of each of the four trainers from one
              state on the card and on the CPU, TF32 off (the DCGAN step
              with G's update at full width, the VAE-GAN step with the
              gradient penalty, `train_lsro_baseline`, `train_detector`),
              under phase 14's limits or twice the CPU's own spread
              between its two convolution algorithms
              (`phase_gan_card_vs_cpu`).
 40. parallel a world-1 NCCL process group on loopback around each part
              (`process_group`), left after it; (a) after phase 13,
              `train_cnn(mesh=)` on it against `train_cnn` without one over
              the training tree's first 32 ids, cuDNN deterministic:
              losses and weights bit for bit, the collectives called;
              later, beside phase 28's and 32's card-vs-CPU steps,
              `image_reid_train` under `torch.distributed.run
              --standalone --nproc_per_node=1` on a tree of that size;
              (b) after phase 7, the row-sharded Jaccard at world 1 on the
              retrieval run's features (N = 23,100) against the dense
              one, seconds and peak memory of both, K7 at its sharded call
              site held against `l1_plain` on 1,024 rows of the slab, and
              the post-embed half of `run_inference(mesh=)` against the
              dense run's mAP; (c) in phase 4d, one chunk of the
              MOT16-load streams through `make_stream_tracker(mesh=)`
              against the meshless tracker; (d) last, DeepLabV3-ResNet50
              at torchvision's widths on 64 crops of 256x128 (f32 and
              bf16 forward, card against CPU on 2 crops), SegUNet's
              `batched_extraction` and two epochs of `train_segmenter`.
 41. artifact the tracking chunk exported with torch.export
              (`pipeline.chunk_serving_fn`: the 13 state tensors and the
              chunk's inputs in, the new state and the outputs out; the
              assignment loops, the ORU replay and the frame loop as
              `while_loop` nodes), right after phase 4 on its scene:
              `--int8`, strongsort, greedy_rounds, ARTIFACT_CHUNK frames a
              chunk (K1 and K2 at B = 2,048 inside the graph), exported
              on the card from the first chunk, loaded in a fresh process
              (`artifact_worker`: only `load_serving_fn` imports the
              kernels' ops; started after phase 39, it loads beside
              the GAN card-vs-CPU checks and then runs the chunks alone
              on the card) and run
              over 2 chunks from one state against
              the eager chunk: ids and valid equal, tlwh within 1e-4, K1
              and K2 launched 2 and 4 times a chunk (counted; the K1 / K2
              track rows' `launches_artifact_run`); export seconds, bytes,
              `while_loop` nodes, ms a frame of the artifact and of the
              eager chunk. After phase 5, on its panned scene: botsort in
              bf16 with device GMC (the FFT in the graph), 2 chunks of
              ARTIFACT_GMC_CHUNK, loaded in process, held the same way.
The training trees of phases 10 and 11 and the gauntlet's scene are
written by a process of their own while the kernels build
(`write_data`). Then the `kernels`
line, the nvidia-smi line and, last, the result line.
Everything is also written to chiprun_out/chip_smoke.json.
"""

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from reid_tpu_torch.utils.timing import (bound, peaks, time_ms,
                                         time_queued_ms)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# Call sites of each kernel on the main path: module path (and, for
# conv3x3_s8, the per-image shape H, W, Cin, Cout).
K1_SITES = [("block21/conv2", (32, 16, 128, 128)),
            ("block31/conv2", (16, 8, 256, 256))]
K2_SITES = ["block22", "block32", "block41", "block42"]
# the detector in the loop: YOLOv5s with its trunk in int8 at the CLI's
# default --det_size, one image a call. K1 runs at the seven bottleneck 3x3
# convs with 128 or 256 channels: five at 18x32 with 128 (l6.m0-m2,
# l13.m0, l20.m0) and two at 9x16 with 256 (l8.m0, l23.m0)
DET_ARGS = ["--detector", "yolov5", "--yolo_variant", "yolov5s",
            "--det_size", "288", "512", "--int8", "--conf_thres", "0.25",
            "--max_dets", "64", "--num_classes", "751", "--crop_hw", "256",
            "128"]
DET_K1_SITES = [("l6/m0/cv2/conv", (18, 32, 128, 128)),
                ("l8/m0/cv2/conv", (9, 16, 256, 256))]
DET_K1_PER_FRAME = {(18, 32, 128, 128): 5, (9, 16, 256, 256): 2}
K1_SOURCE, K1_REPLACES = ("reid_tpu_torch/csrc/qconv.cu",
                          "reid_tpu/ops/qconv.py:116")
# K3-K5: the other forms of K1's convolution, on the qconv probe's path
VARIANT_SOURCE = "reid_tpu_torch/csrc/qconv_variants.cu"
VARIANT_REPLACES = {"conv3x3_s8_ncat": "reid_tpu/ops/qconv.py:188",
                    "conv3x3_s8_bitshift": "reid_tpu/ops/qconv.py:273",
                    "conv3x3_s8_dma": "reid_tpu/ops/qconv.py:355"}
# the botsort scene's camera pan in px per frame: one bin of the device
# estimator's 4x downscaled plane at 1080p in each axis
PAN = (4, -4)
# K3-K5's ms at K1_SITES (B = 2048, bf16) and at the probe's four
# configurations (B = 512) before their wgmma designs (K3, K5: two
# launches a call on the mma.sync core, the product or the im2col buffer
# in device memory; K4: one mma.sync slab kernel), measured as here on an
# NVIDIA H100 80GB HBM3 at 700 W
VARIANT_BEFORE_MS = {
    "conv3x3_s8_ncat": {"block21/conv2": 4.536, "block31/conv2": 2.550,
                        "stage2 32x16 c128": 1.216,
                        "stage3 16x8  c256": 0.6505,
                        "stage4 16x8  c512": 1.558,
                        "fc-stage4 8x4 c512": 0.4273},
    "conv3x3_s8_bitshift": {"block21/conv2": 0.7787,
                            "block31/conv2": 0.6965,
                            "stage2 32x16 c128": 0.2319,
                            "stage3 16x8  c256": 0.2202,
                            "stage4 16x8  c512": 0.6303,
                            "fc-stage4 8x4 c512": 0.2023},
    "conv3x3_s8_dma": {"block21/conv2": 1.554, "block31/conv2": 1.164,
                       "stage2 32x16 c128": 0.4560,
                       "stage3 16x8  c256": 0.3327,
                       "stage4 16x8  c512": 0.9920,
                       "fc-stage4 8x4 c512": 0.2762}}
K2_SOURCE, K2_REPLACES = ("reid_tpu_torch/csrc/qblock.cu",
                          "reid_tpu/ops/qblock.py:313")
# K2's ms at K2_SITES before its wgmma design (the launch sequence on the
# mma.sync core of csrc/igemm_s8.cuh), measured as here on an NVIDIA H100
# 80GB HBM3 at 700 W: bf16 at B = 2048, f32 at B = 128
K2_BEFORE_MS = {"torch.bfloat16": (3.618, 2.480, 5.726, 6.522),
                "torch.float32": (0.3817, 0.2940, 0.5333, 0.5523)}
K6_REPLACES = "reid_tpu/ops/distance.py:85"
K7_REPLACES = "reid_tpu/ops/distance.py:149"
DIST_SOURCE = "reid_tpu_torch/csrc/distance.cu"
# the retrieval operating point: Market-1501's test split
N_QUERY, N_GALLERY, N_IDS, N_CAMS, N_CLASSES = 3368, 19732, 750, 6, 751
# the other backbones' retrievals (agw --int8, plr_osnet, vit) run on
# 1 / ZOO_SPLIT_PART of it (1,684 + 9,866 images, N = 11,550), each with
# K6 at its width and K7 held on its own operands: the smoke's clock
ZOO_SPLIT_PART = 2
# the multi-stream operating points (bench.py:315-386, :390, :908-911):
# S streams, `n_real` boxes a frame in `max_dets` slots; each stream's crop
# budget is chunk x n_real, so a chunk embeds S x chunk x n_real crops;
# `n_chunks` chunks a run, all but the first timed (a few seconds; cut
# from 4 and 6 to 3 and 4, then to 2 and 3, then to 2 and 2, for the
# smoke's time limit)
STREAM_POINTS = {
    "multistream8": dict(streams=8, chunk=64, hw=(480, 640), n_real=16,
                         max_dets=32, max_tracks=64, n_chunks=2),
    "mot16_load_multistream8": dict(streams=8, chunk=8, hw=(1080, 1920),
                                    n_real=50, max_dets=64,
                                    max_tracks=128, n_chunks=2)}

# phase 41: the tracking chunk as a torch.export artifact, at phase 4's
# load (--int8, chunk 32: K1 and K2 at B = 2,048 inside the graph) and
# botsort in bf16 with device GMC on phase 5's panned scene, two chunks
# of each
ARTIFACT_CHUNK, ARTIFACT_GMC_CHUNK = 32, 8

RESULTS = {}
# the script's start, for each line's seconds since it (`t_s`)
T0 = time.perf_counter()


def emit(phase, **kw):
    kw["t_s"] = time.perf_counter() - T0
    RESULTS[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


def agreement(got, want, tight=1e-4, loose=5e-2):
    """(share of elements within rtol = atol = `tight`, max abs err,
    whether all are within `loose`)."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ok = (err <= tight + tight * want.abs()).double().mean().item()
    return ok, err.max().item(), bool((err <= loose + loose * want.abs())
                                      .all())


def within(got, want, share=0.999):
    """The fused block's tolerance; returns (share within tight, max err)."""
    ok, err, all_loose = agreement(got, want)
    if ok < share or not all_loose:
        raise AssertionError(f"kernel vs plain: {ok:.6f} within 1e-4, "
                             f"max err {err}")
    return ok, err


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, peaks=peaks(kind))
    return smi, kind


def ptxas_kernels(log):
    """Registers and spill bytes of each kernel that `nvcc -Xptxas -v`
    compiled, from its log: [{kernel, registers, spill_stores,
    spill_loads}] in the log's order, names demangled where c++filt is
    installed."""
    import re
    import shutil
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = dict(kernel=m.group(1))
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            check=True).stdout.splitlines()
        for r, name in zip(rows, names):
            r["kernel"] = name.split("(")[0]
    return rows


def phase_build():
    """Every kernel source built at once; each kernel's registers and
    spills from ptxas. No kernel may spill: the wgmma consumers of K1,
    K2 and K5 hold 128 s32 accumulators a thread, K3's 144."""
    from reid_tpu_torch.ops import _lib
    names = sorted(f[:-3] for f in os.listdir(_lib.CSRC) if f.endswith(".cu"))
    res = _lib.build(names)
    ptxas = {}
    for n in names:
        with open(os.path.join(_lib.BUILD_DIR, n + ".log")) as f:
            ptxas[n] = ptxas_kernels(f.read())
    emit("build", kernels=names, built=res["built"], seconds=res["seconds"],
         ptxas=ptxas)
    for n in names:
        assert ptxas[n], (n, "no ptxas report: was the library rebuilt?")
        for k in ptxas[n]:
            assert k["spill_stores"] == 0 and k["spill_loads"] == 0, k


def quantized_trunk(dev, dtype, calib, crops, num_classes=751,
                    backbone="seres18", sites=None):
    """The quantized `backbone` of a path (bf16 for tracking, f32 for
    retrieval), calibrated on `calib`, and the input each kernel call site
    (`sites`, module paths; SERes18's K1 and K2 sites by default) receives
    when it embeds the batch `crops`."""
    import torch
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.quantize import quantize, quantized_model

    model = build_model(backbone, num_classes=num_classes, dtype=dtype,
                        device=dev)
    qm = quantized_model(model, quantize(model, [calib]))
    del model
    seen = {}

    def grab(name):
        def hook(_m, args):
            seen[name] = args[0]
        return hook

    if sites is None:
        sites = [k for k, _ in K1_SITES] + K2_SITES
    hooks = [qm.get_submodule(s.replace("/", ".")).register_forward_pre_hook(
        grab(s)) for s in sites]
    with torch.inference_mode():
        qm(crops)
    for h in hooks:
        h.remove()
    return qm, seen


def k1_row(kind, mod, xq, dtype, name, path):
    """K1 (`conv3x3_s8`) on `xq`, the int8 input of the quantized conv
    `mod` at a call site: exactly equal to its plain version, timed beside
    the plain version and `torch._int_mm` on a ready im2col (20 calls
    each, and 20 back to back). Returns the kernels-line row (emitted)
    and the kernel's output."""
    import torch
    from reid_tpu_torch.ops import qconv
    from reid_tpu_torch.utils.quantize import _im2col

    b, h, w, cin = xq.shape
    cout = mod.mm.wt.shape[0]
    esize = torch.finfo(dtype).bits // 8
    args = (xq, mod.mm.wt, mod.scale, dtype)
    got = qconv.conv3x3_s8(*args)
    want = qconv.conv3x3_s8_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, want), (name, err)
    del want
    cols, _ = _im2col(xq, 3, 1, 1, 9 * cin)
    wcol = mod.mm.wt.T
    m = b * h * w
    ms = time_ms(lambda: qconv.conv3x3_s8(*args))
    plain_ms = time_ms(lambda: qconv.conv3x3_s8_plain(*args))
    lib_ms = time_ms(lambda: torch._int_mm(cols, wcol))
    queued = time_queued_ms(lambda: qconv.conv3x3_s8(*args))
    lib_queued = time_queued_ms(lambda: torch._int_mm(cols, wcol))
    del cols
    bms, by = bound(2 * m * cout * 9 * cin,
                    m * cin + cout * 9 * cin + 4 * cout + esize * m * cout,
                    kind)
    row = dict(name=name, route="cuda", source=K1_SOURCE,
               replaces=K1_REPLACES, path=path, site=[h, w, cin, cout],
               batch=b, out_dtype=str(dtype), max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=lib_ms, queued_ms=queued[0], host_ms=queued[1],
               library_queued_ms=lib_queued[0],
               library_host_ms=lib_queued[1])
    emit(f"kernel {name}", **row)
    return row, got


def phase_kernels(kind, dtype, calib, crops, path, suffix="",
                  variants=False):
    """K1 and K2 at each call site of `path`'s quantized trunk (`dtype`
    in and out), on the inputs that embedding `crops` gives them; with
    `variants`, K3-K5 at K1's call sites too, each held equal to its plain
    version and to K1."""
    import torch
    from reid_tpu_torch import qconv_probe
    from reid_tpu_torch.ops import qblock, qconv
    from reid_tpu_torch.utils.quantize import quantize_input

    qm, seen = quantized_trunk(crops.device, dtype, calib, crops)
    esize = torch.finfo(dtype).bits // 8
    rows, split_later = [], []
    with torch.inference_mode():
        for site, (h, w, cin, cout) in K1_SITES:
            mod = qm.get_submodule(site.replace("/", "."))
            assert mod.route, site
            xq = quantize_input(seen[site], mod.sx).contiguous()
            assert tuple(xq.shape[1:]) == (h, w, cin), xq.shape
            row, got = k1_row(kind, mod, xq, dtype,
                              f"conv3x3_s8 {site}{suffix}", path)
            rows.append(row)
            bms, by, lib_ms = row["bound_ms"], row["bound_by"], \
                row["library_ms"]
            wn = qconv.pack_ncat_weight(mod.mm.wt)
            for kernel, plain_fn, vname in (
                    qconv_probe.KERNELS.values() if variants else []):
                if vname == qconv.NAME:
                    continue
                vargs = (xq, mod.mm.wt, wn, mod.scale, dtype)
                scratch = scratch_bytes(lambda: kernel(*vargs))
                vgot, vwant = kernel(*vargs), plain_fn(*vargs)
                torch.cuda.synchronize()
                verr = (vgot.float() - vwant.float()).abs().max().item()
                assert torch.equal(vgot, vwant), (vname, site, verr)
                assert torch.equal(vgot, got), (vname, site)
                del vgot, vwant
                rows.append(dict(
                    name=f"{vname} {site}{suffix}", route="cuda",
                    source=VARIANT_SOURCE, replaces=VARIANT_REPLACES[vname],
                    path="qconv probe", site=[h, w, cin, cout],
                    batch=xq.shape[0], out_dtype=str(dtype), max_abs_err=verr,
                    ms=time_ms(lambda: kernel(*vargs)),
                    before_ms=VARIANT_BEFORE_MS.get(vname, {}).get(site),
                    plain_ms=time_ms(lambda: plain_fn(*vargs), reps=3,
                                     warm=1),
                    bound_ms=bms, bound_by=by, library_ms=lib_ms,
                    scratch_bytes=scratch))
                assert scratch == 0, rows[-1]
                # launches counted after every timing of the phase (a
                # torch.profiler trace slows the process's later launches)
                split_later.append((rows[-1], kernel, vargs))
            del got
        for i, site in enumerate(K2_SITES):
            mod = qm.get_submodule(site)
            x = seen[site].contiguous()
            p, ibn = mod.p, mod.ibn
            bsz, h, w, cin = x.shape
            cout, mip = p.w2.shape[0], p.wfc1.shape[1]
            assert x.dtype == dtype, (site, x.dtype)

            def call():
                return qblock.se_basic_block_s8(x, p, ibn, dtype)
            got = call()
            want = qblock.se_basic_block_s8_plain(x, p, ibn, dtype)
            torch.cuda.synchronize()
            share, err = within(got.float(), want.float())
            bit_equal = bool(torch.equal(got, want))
            del want
            share_t, err_t, loose_t = agreement(
                got.float(), qblock.se_basic_block_s8_plain(
                    x, p, ibn, dtype, kernel_order=False).float())
            # where images span tiles: the share of outputs that the
            # per-tile summation order moves against one part an image
            moved = None
            if len(qblock.tile_segments(h, w, cout)) > 1:
                one = plain_one_part(x, p, ibn, dtype)
                moved = (got != one).double().mean().item()
                del one
            ms = time_ms(call)
            plain_ms = time_ms(
                lambda: qblock.se_basic_block_s8_plain(x, p, ibn, dtype))
            queued = time_queued_ms(call)
            m = bsz * h * w
            down = p.wd is not None
            ops = (2 * m * cout * 9 * (cin + cout)
                   + (2 * m * cout * cin if down else 0)
                   + 4 * bsz * cout * mip)
            nbytes = (esize * m * cin + 9 * cout * (cin + cout)
                      + (cout * cin if down else 0) + 4 * cout * mip
                      + 4 * 9 * cout + esize * m * cout)
            bms, by = bound(ops, nbytes, kind)
            split = launch_split(call)
            for k, n in zip(split, k2_launch_bytes(
                    [k[0] for k in split], bsz, h, w, cin, cout, mip, down,
                    esize)):
                k.append(n)
            rows.append(dict(name=f"se_basic_block_s8 {site}{suffix}",
                             route="cuda", source=K2_SOURCE,
                             replaces=K2_REPLACES, path=path,
                             site=[h, w, cin, cout, int(ibn)], batch=bsz,
                             down=down, max_abs_err=err, bit_equal=bit_equal,
                             moved_by_tile_order=moved,
                             share_tight=share,
                             share_tight_torch_order=share_t,
                             max_abs_err_torch_order=err_t,
                             within_loose_torch_order=loose_t, ms=ms,
                             before_ms=K2_BEFORE_MS[str(dtype)][i],
                             plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, library_ms=None,
                             queued_ms=queued[0], host_ms=queued[1],
                             launches_per_call=len(split),
                             design_bytes=sum(k[2] for k in split),
                             device_split_ms=split))
            emit(f"kernel {rows[-1]['name']}", **rows[-1])
            del got
        for row, kernel, vargs in split_later:
            row["launches_per_call"] = len(launch_split(
                lambda: kernel(*vargs)))
            assert row["launches_per_call"] == 1, row
            emit(f"kernel {row['name']}", **row)
    del seen, qm, split_later
    torch.cuda.empty_cache()
    return rows


def textured_background(rng, h, w, grain=2):
    """Uniform noise on a grid of `grain` px, bilinearly upsampled: a
    texture with detail at every scale the GMC estimator samples."""
    import torch
    coarse = torch.from_numpy(rng.integers(
        0, 256, (h // grain + 2, w // grain + 2, 3)).astype(np.float32))
    up = torch.nn.functional.interpolate(
        coarse.permute(2, 0, 1)[None], scale_factor=grain, mode="bilinear",
        align_corners=False)[0].permute(1, 2, 0)[:h, :w]
    return up.clamp(0, 255).to(torch.uint8).numpy()


def scene(n_frames, n_real=50, hw=(1080, 1920), seed=0, pan=None):
    """MOT16-load scene: frames (T, H, W, 3) uint8 and boxes (T, n_real, 4)
    tlwh of `n_real` boxes of person aspect moving across a noisy
    background, each painted its own colour. With `pan` = (px, py) the
    background is a fixed texture that the camera pans across, so its
    content and the boxes move by (px, py) px per frame."""
    rng = np.random.default_rng(seed)
    h, w = hw
    px, py = pan or (0, 0)
    heights = np.exp(rng.uniform(np.log(60), np.log(260), n_real))
    widths = heights * 0.41
    x0 = rng.uniform(0, w - widths - 200 - abs(px) * n_frames, n_real)
    y0 = rng.uniform(max(0, -py * n_frames),
                     h - heights - 10 - max(0, py * n_frames), n_real)
    vx = rng.normal(0, 3.0, n_real)
    colors = rng.integers(40, 255, (n_real, 3), dtype=np.uint8)
    if pan:
        mh, mw = abs(py) * n_frames, abs(px) * n_frames
        bg = textured_background(rng, h + mh, w + mw)
        # frame t shows the window at (oy - py*t, ox - px*t)
        oy, ox = (mh if py > 0 else 0), (mw if px > 0 else 0)
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    boxes = np.empty((n_frames, n_real, 4))
    for t in range(n_frames):
        if pan:
            y_t, x_t = oy - py * t, ox - px * t
            frame = bg[y_t:y_t + h, x_t:x_t + w].copy()
        else:
            frame = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        for j in range(n_real):
            x = float(np.clip(x0[j] + (vx[j] + px) * t, 0,
                              w - widths[j] - 1))
            y = float(np.clip(y0[j] + py * t, 0, h - heights[j] - 1))
            frame[int(y):int(y + heights[j]), int(x):int(x + widths[j])] = \
                colors[j]
            boxes[t, j] = (x, y, widths[j], heights[j])
        frames[t] = frame
    return frames, boxes


def write_scene(root, n_frames, n_real=50, hw=(1080, 1920), seed=0,
                pan=None):
    """`scene` as .npy frames plus det.txt (confidence 0.9)."""
    frames, boxes = scene(n_frames, n_real, hw, seed, pan)
    fdir = os.path.join(root, "frames")
    os.makedirs(fdir)
    lines = []
    for t in range(n_frames):
        for x, y, w, h in boxes[t]:
            lines.append(f"{t + 1},-1,{x:.2f},{y:.2f},{w:.2f},{h:.2f},0.9")
        np.save(os.path.join(fdir, f"{t + 1:06d}.npy"), frames[t])
    det = os.path.join(root, "det.txt")
    with open(det, "w") as f:
        f.write("\n".join(lines) + "\n")
    return fdir, det


def device_kernels(prof):
    """[name, launches, device ms] of each kernel (and copy) a finished
    torch.profiler trace holds on the card, by device time: read from the
    trace's raw events, since `key_averages()` builds an event object for
    every record (~0.2 ms each, tens of seconds on a traced train step)."""
    import torch
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_hidden_event", lambda: False)():
            continue
        t = totals.setdefault(e.name(), [0, 0.0])
        t[0] += 1
        t[1] += (e.end_ns() - e.start_ns()) / 1e6
    return sorted(([k, n, ms] for k, (n, ms) in totals.items()),
                  key=lambda r: -r[2])


def profiled(fn, path):
    """fn() under torch.profiler; the device kernels by total time go to
    `path`, and their summed time is returned in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy_ms = sum(ms for _, _, ms in kernels)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(path, "w") as f:
        f.write(f"device kernel time {busy_ms:.3f} ms\n")
        for name, n, ms in kernels:
            f.write(f"{ms:10.3f} ms {n:7d}x  {name[:150]}\n")
    return out, busy_ms


def launch_split(fn, reps=5):
    """[name, device ms] of each CUDA kernel launch of one fn() call, in
    launch order: one call traced by torch.profiler at a time, after one
    untraced call, and the median over the `reps` traces that caught the
    most launches (a trace can miss a short kernel's record)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    traces = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        traces.append(sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start))
    n = max(len(t) for t in traces)
    full = [t for t in traces if len(t) == n]
    return [[full[0][i].name[:90], statistics.median(
        t[i].time_range.elapsed_us() / 1e3 for t in full)]
        for i in range(n)]


def scratch_bytes(fn):
    """Device memory that one fn() call allocates beside its result (the
    caching allocator's peak over the call, less the result's blocks)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - base  # the result's blocks
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak - kept


def k2_launch_bytes(names, b, h, w, cin, cout, mip, down, esize):
    """The bytes that each of K2's launches `names` (one call's, in launch
    order, as `launch_split` saw them) must move: its inputs read once and
    its outputs written once, the per-channel vectors left out. The GEMM
    launches are conv1, conv2 and the down GEMM in that order; conv1
    writes y1 in f32 and the partial sums where an IBN pass follows it."""
    from reid_tpu_torch.ops import qblock
    m = b * h * w
    part = 4 * b * len(qblock.tile_segments(h, w, cout)) * cout
    gate = 4 * b * cout
    y1 = any("ibn_apply_kernel" in n for n in names)
    per_kernel = {
        "quant_kernel": esize * m * cin + m * cin * (2 if down else 1),
        "ibn_apply_kernel": 2 * part + 5 * m * cout,
        "se_gate_kernel": part + 4 * cout * mip + gate,
        "resid_kernel": 4 * m * cout + gate + 2 * esize * m * cout}
    gemms = iter([
        m * cin + 9 * cin * cout + (2 * part + 4 * m * cout if y1
                                    else m * cout),
        m * cout + 9 * cout * cout + part + 4 * m * cout,
        m * cin + cin * cout + 4 * m * cout + gate + esize * m * cout])
    out = []
    for name in names:
        key = next((k for k in per_kernel if k in name), None)
        out.append(per_kernel[key] if key else next(gemms))
    return out


def plain_one_part(x, p, ibn, dtype):
    """The fused block's plain version with each image summed in one set of
    8 stripes over all its rows, as before an image's rows were split
    across tiles: the order that `moved_by_tile_order` compares with."""
    import torch
    from reid_tpu_torch.ops import qblock
    from reid_tpu_torch.ops.qconv import conv_acc_plain, quantize_s8

    def mean(v):
        b, h, w, c = v.shape
        rows = v.reshape(b, h * w, c)
        acc = rows.new_zeros((b, 8, c))
        for r0 in range(0, h * w, 8):
            part = rows[:, r0:r0 + 8]
            acc[:, :part.shape[1]] += part
        total = acc[:, 0]
        for s in range(1, 8):
            total = total + acc[:, s]
        return (total / (h * w))[:, None, None, :]

    cout = p.w2.shape[0]
    acc1 = conv_acc_plain(quantize_s8(x, p.inv_sx1), p.w1, 3)
    if ibn:
        y1 = acc1 * p.dq1_vec
        mu = mean(y1)
        var = torch.clamp(mean(y1 * y1) - mu * mu, min=0.0)
        y_in = (y1 - mu) * (1.0 / torch.sqrt(var + 1e-5)) * p.in_scale \
            + p.in_bias
        ch = torch.arange(cout, device=x.device)
        h1 = torch.relu(torch.where(ch < cout // 2, y_in,
                                    y1 * p.a1 + p.c1))
    else:
        h1 = torch.relu(acc1 * p.a1 + p.c1)
    y2 = conv_acc_plain(quantize_s8(h1, p.inv_sx2), p.w2, 3) * p.a2 + p.c2
    s = qblock._fc_warp(mean(y2)[:, 0, 0, :].to(torch.bfloat16).float(),
                        p.wfc1.float())
    s = torch.relu(s.to(torch.bfloat16)).float()
    gate = torch.reciprocal(1.0 + torch.exp(-qblock._fc_serial(
        s, p.wfc2.float())))
    if p.wd is not None:
        branch = conv_acc_plain(quantize_s8(x, p.inv_sxd), p.wd, 1) * p.ad \
            + p.cd
    else:
        branch = x.to(torch.float32)
    return torch.relu(y2 * gate[:, None, None, :] + branch).to(dtype)


def run_track(argv, profile_to=None):
    """One run of the track path with the launch counts zeroed just before
    and read just after; traced with torch.profiler when `profile_to`
    names a file."""
    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.ops import _lib

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    busy_ms = None
    if profile_to:
        pipe, busy_ms = profiled(lambda: cli.track(argv, device="cuda"),
                                 profile_to)
    else:
        pipe = cli.track(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _lib.launch_counts()
    sites = _lib.site_launch_counts()
    rows = sum(int(np.sum(r["valid"])) for r in pipe.results)
    ids = {int(i) for r in pipe.results for i in r["ids"][r["valid"]]}
    boxes = np.concatenate([r["tlwh"][r["valid"]] for r in pipe.results])
    assert np.all(np.isfinite(boxes)) and boxes.shape[1] == 4
    assert all(np.all(r["ids"][r["valid"]] > 0) for r in pipe.results)
    return dict(frames=pipe.frames, rows=rows, distinct_ids=len(ids),
                timing_ms_per_frame=pipe.timing_summary(),
                fps=pipe.frames / pipe.timing["total"], wall_s=wall,
                gmc_s=pipe.timing["gmc"], device_kernel_ms=busy_ms,
                launches=counts,
                site_launches={f"{n} {list(s)}": c
                               for (n, s), c in sites.items()},
                affines=np.asarray(pipe.affines))


def phase_track(tmp, n_frames, chunk, step_frames, profile=False):
    fdir, det = write_scene(tmp, n_frames)
    base = ["--detections", det, "--frames_dir", fdir, "--int8",
            "--max_dets", "64", "--num_classes", "751", "--crop_hw", "256",
            "128"]

    def trace(name):
        return os.path.join(OUT_DIR, f"profile_{name}.txt") if profile \
            else None
    chunked = run_track(base + ["--chunk", str(chunk), "--save_txt",
                                os.path.join(tmp, "chunk.txt")],
                        trace("chunked"))
    chunked.pop("affines")
    emit("track chunked", chunk=chunk, **chunked)
    step = run_track(base + ["--chunk", "1", "--max_frames", str(step_frames),
                             "--save_txt", os.path.join(tmp, "step.txt")],
                     trace("step"))
    step.pop("affines")
    emit("track step", **step)
    for run, name in ((chunked, "chunked"), (step, "step")):
        assert run["rows"] > 0 and run["distinct_ids"] >= 40, (name, run)
        for k in ("conv3x3_s8", "se_basic_block_s8"):
            assert run["launches"].get(k, 0) > 0, (name, k, run["launches"])
    # the default bf16 embed (cuDNN convolutions): no int8 kernel runs
    bf16 = run_track([a for a in base if a != "--int8"]
                     + ["--chunk", str(chunk), "--save_txt",
                        os.path.join(tmp, "chunk_bf16.txt")])
    bf16.pop("affines")
    emit("track chunked bf16", chunk=chunk, **bf16)
    assert bf16["rows"] > 0 and bf16["distinct_ids"] >= 40, bf16
    assert not bf16["launches"], bf16["launches"]
    return chunked, step


def phase_gmc(tmp, n_frames, chunk, step_frames):
    """botsort with camera-motion compensation on a scene panned by PAN px
    a frame: `--chunk` with the device estimator, then the step path
    (per-frame `estimate_affine` on the host). The chunked affines must
    recover the pan within 1 px and equal the CPU's
    `chunk_affines_translation` of the same frames within 1e-3 px; the
    step path's within 1 px of the pan."""
    import torch
    from reid_tpu_torch.tracking import gmc
    from reid_tpu_torch.tracking.gmc import chunk_affines_translation
    from reid_tpu_torch.tracking.sources import iter_frames

    fdir, det = write_scene(tmp, n_frames, pan=PAN)
    base = ["--detections", det, "--frames_dir", fdir, "--int8",
            "--max_dets", "64", "--num_classes", "751", "--crop_hw", "256",
            "128", "--tracking_method", "botsort"]
    chunk_argv = base + ["--chunk", str(chunk), "--save_txt",
                         os.path.join(tmp, "botsort_chunk.txt")]
    chunked = run_track(chunk_argv)
    # the same run again: cuFFT loaded and its plans made
    again = run_track(chunk_argv)
    again.pop("affines")
    step = run_track(base + ["--chunk", "1", "--max_frames", str(step_frames),
                             "--save_txt",
                             os.path.join(tmp, "botsort_step.txt")])
    aff_c, aff_s = chunked.pop("affines"), step.pop("affines")
    frames = torch.from_numpy(np.stack([f for _, f in iter_frames(fdir)]))
    cpu = np.concatenate([chunk_affines_translation(
        frames[s - 1] if s else frames[0], frames[s:s + chunk]).numpy()
        for s in range(0, n_frames, chunk)])
    pan = np.asarray(PAN, np.float32)
    eye = np.eye(2, dtype=np.float32)
    # the estimator alone on a warm card: one 32-frame chunk
    dev_frames = frames[:chunk + 1].cuda()
    warm_ms = time_ms(lambda: chunk_affines_translation(dev_frames[0],
                                                        dev_frames[1:]))
    del dev_frames
    res = dict(
        pan=list(PAN), cv2=gmc._HAS_CV2,
        chunk_max_err_to_pan=float(np.abs(aff_c[1:, :, 2] - pan).max()),
        chunk_max_err_to_cpu=float(np.abs(aff_c[:, :, 2]
                                          - cpu[:, :, 2]).max()),
        chunk_linear_is_identity=bool((aff_c[:, :, :2] == eye).all()),
        step_max_err_to_pan=float(np.abs(aff_s[1:, :, 2] - pan).max()),
        gmc_ms_per_chunk=1e3 * chunked["gmc_s"] * chunk / n_frames,
        gmc_ms_per_chunk_again=1e3 * again["gmc_s"] * chunk / n_frames,
        fps_again=again["fps"],
        gmc_ms_per_chunk_warm=warm_ms,
        step_gmc_ms_per_frame=1e3 * step["gmc_s"] / step_frames)
    emit("track botsort chunked", chunk=chunk, **chunked)
    emit("track botsort step", **step)
    emit("gmc", **res)
    assert res["chunk_max_err_to_pan"] <= 1.0, res
    assert res["chunk_max_err_to_cpu"] <= 1e-3, res
    assert res["chunk_linear_is_identity"], res
    assert res["step_max_err_to_pan"] <= 1.0, res
    for run, name in ((chunked, "chunked"), (step, "step")):
        assert run["rows"] > 0 and run["distinct_ids"] >= 40, (name, run)
        for k in ("conv3x3_s8", "se_basic_block_s8"):
            assert run["launches"].get(k, 0) > 0, (name, k, run["launches"])
    return res


def scene_argv(tmp, *extra):
    """`cli.track`'s flags for the MOT16-load scene that `write_scene`
    wrote under `tmp`."""
    return ["--detections", os.path.join(tmp, "det.txt"), "--frames_dir",
            os.path.join(tmp, "frames"), "--max_dets", "64", "--num_classes",
            "751", "--crop_hw", "256", "128", *extra]


def chunk_run_inputs(argv, n_frames, dev):
    """What `cli.track argv` tracks, built as `cli._track` builds it: the
    tracker configuration, the embed (its `--int8` calibration on the
    source's frames) and its width, and the first `n_frames` frames and
    MOT detections as (T, ...) tensors on `dev`."""
    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.tracking.mot import load_mot_detections
    from reid_tpu_torch.tracking.sources import iter_frames

    args = cli._parser().parse_args(argv)
    cfg = cli.track_config(args)
    embed_fn, _ = cli.build_embed(args.backbone, args.num_classes,
                                  cfg.crop_hw, dev, int8=args.int8,
                                  source=args.frames_dir)
    with torch.inference_mode():
        feat_dim = int(embed_fn(torch.zeros((1, *cfg.crop_hw, 3),
                                            device=dev)).shape[-1])
    dets = load_mot_detections(args.detections, cfg.max_dets,
                               min_conf=args.conf_thres)
    items = list(iter_frames(args.frames_dir, n_frames))
    empty = (np.zeros((cfg.max_dets, 4), np.float32),
             np.zeros(cfg.max_dets, np.float32),
             np.zeros(cfg.max_dets, bool))
    tlwh, conf, valid = (np.stack(x) for x in zip(
        *[dets.get(i, empty) for i, _ in items]))
    data = [torch.from_numpy(np.stack([f for _, f in items])),
            torch.from_numpy(tlwh).float(), torch.from_numpy(conf).float(),
            torch.from_numpy(valid)]
    return cfg, embed_fn, feat_dim, [x.to(dev) for x in data]


def run_chunks(fn, state, chunks, gmc):
    """The flat chunk function `fn` (`pipeline.chunk_serving_fn` or its
    loaded artifact) over `chunks` of (frames, tlwh, conf, valid) from the
    flat `state`, each chunk's GMC anchored on the frame before it (its
    own first frame for the first): (each chunk's outputs (tlwh, ids,
    valid), the last state)."""
    from reid_tpu_torch.tracking.tracker import TrackerState
    n = len(TrackerState._fields)
    outs, prev = [], None
    for frames, tlwh, conf, valid in chunks:
        anchor = (frames[0] if prev is None else prev,) if gmc else ()
        res = fn(*state, frames, tlwh, conf, valid, *anchor)
        state, prev = res[:n], frames[-1]
        outs.append(res[n:])
    return outs, state


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def start_process(fn, *args, **popen):
    """`chip_smoke.<fn>(*args)` (strings) in a new Python process, started
    from the repo's root without waiting for it."""
    return subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         f"chip_smoke.{fn}(*sys.argv[1:])", *args], cwd=ROOT, **popen)


def stop(procs):
    """Ends each process of `procs` that still runs."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def artifact_runs(fn, state, chunks, gmc, dev):
    """The chunks through the loaded chunk artifact `fn` from `state`, its
    kernels' launches counted, then once more timed: the outputs, the
    last state, the launches and the seconds of both passes."""
    import torch
    from reid_tpu_torch.ops import _lib
    with torch.inference_mode():
        sync(dev)
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        outs, last = run_chunks(fn, state, chunks, gmc)
        sync(dev)
        first_s = time.perf_counter() - t0
        counts = _lib.launch_counts()
        sites = {f"{n} {list(s)}": c
                 for (n, s), c in _lib.site_launch_counts().items()}
        t0 = time.perf_counter()
        run_chunks(fn, state, chunks, gmc)
        sync(dev)
        timed_s = time.perf_counter() - t0
    return {"outs": outs, "state": last, "launches": counts,
            "site_launches": sites, "first_s": first_s, "timed_s": timed_s}


def artifact_worker(path, inputs_path, out_path, device="cuda", go=None):
    """Phase 41's fresh process: load the chunk artifact at `path` (only
    `load_serving_fn` imports the port's kernels and registers their
    ops) and the chunks saved at `inputs_path`; then, once the file `go`
    exists (at once without one), run the chunks through the artifact
    (`artifact_runs`) and save what it gives at `out_path`. It gives up
    when the process that started it is gone."""
    import torch
    parent = os.getppid()
    ops_before = "reid_tpu_torch.ops" in sys.modules
    from reid_tpu_torch.utils.export import load_serving_fn
    t0 = time.perf_counter()
    fn = load_serving_fn(path)
    load_s = time.perf_counter() - t0
    dev = torch.device(device)
    saved = torch.load(inputs_path)
    state = [t.to(dev) for t in saved["state"]]
    chunks = [[t.to(dev) for t in c] for c in saved["chunks"]]
    t0 = time.perf_counter()
    while go and not os.path.exists(go):
        if os.getppid() != parent:
            sys.exit("artifact_worker: its parent is gone")
        time.sleep(0.05)
    wait_s = time.perf_counter() - t0
    # the track path's settings (`cli.full_f32`)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = artifact_runs(fn, state, chunks, saved["gmc"], dev)
    got.update(outs=[[t.cpu() for t in o] for o in got["outs"]],
               state=[t.cpu() for t in got["state"]], load_s=load_s,
               wait_s=wait_s, ops_imported_before_load=ops_before)
    torch.save(got, out_path)


def export_chunk_artifact(tmp, argv, chunk, n_chunks, dev="cuda"):
    """Phase 41's export: the tracking chunk of `cli.track argv` as a
    `torch.export` artifact (`pipeline.chunk_serving_fn`, flat tensors in
    and out, static shapes), exported on the card from its first chunk
    into `tmp`, after `n_chunks` chunks through the eager chunk from a
    fresh state, twice (the second pass timed). Returns the job that
    `hold_chunk_artifact` holds: the artifact's path, the inputs, the
    eager outputs and what was measured (export seconds, bytes, the
    graph's `while_loop` nodes and host reads)."""
    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.tracking.pipeline import (chunk_serving_fn,
                                                  make_chunked_tracker)
    from reid_tpu_torch.tracking.tracker import Tracker
    from reid_tpu_torch.utils.export import export_serving_fn

    dev = torch.device(dev)
    t_frames = chunk * n_chunks
    cfg, embed_fn, feat_dim, data = chunk_run_inputs(argv, t_frames, dev)
    chunks = [[x[i:i + chunk] for x in data]
              for i in range(0, t_frames, chunk)]
    chunked = make_chunked_tracker(cfg, embed_fn, cfg.crop_hw, chunk)
    serving = chunk_serving_fn(chunked)
    gmc = chunked.use_gmc
    state = tuple(Tracker(cfg, feat_dim, dev).init_state())
    res = dict(chunk=chunk, chunks=n_chunks, method=cfg.method)
    with full_f32():
        with torch.inference_mode():
            want, want_state = run_chunks(serving, state, chunks, gmc)
            sync(dev)
            t0 = time.perf_counter()
            run_chunks(serving, state, chunks, gmc)
            sync(dev)
            res["eager_ms_per_frame"] = 1e3 * (time.perf_counter()
                                               - t0) / t_frames
        path = os.path.join(tmp, f"chunk_{cfg.method}.pt2")
        anchor = (chunks[0][0][0],) if gmc else ()
        sync(dev)
        t0 = time.perf_counter()
        ep = export_serving_fn(serving, state + tuple(chunks[0]) + anchor,
                               path, dynamic_batch=False)
        res["export_s"] = time.perf_counter() - t0
    res["bytes"] = os.path.getsize(path)
    targets = [str(n.target) for _, m in ep.graph_module.named_modules()
               for n in m.graph.nodes if n.op == "call_function"]
    res["while_loop_nodes"] = sum("while_loop" in t for t in targets)
    res["host_reads_in_graph"] = sum("_local_scalar_dense" in t
                                     for t in targets)
    res["graph_nodes"] = len(targets)
    return dict(res=res, path=path, dev=dev, state=state, chunks=chunks,
                gmc=gmc, want=want, want_state=want_state)


class ArtifactWorker:
    """Phase 41's fresh process (`artifact_worker`) for an exported job:
    started at once, so that it imports, loads the artifact and its
    inputs while the smoke runs a phase it does not time; `result()` lets
    it run the chunks, alone on the card, and returns what it gave;
    `stop()` ends it."""

    def __init__(self, job, tmp):
        import torch
        self.inputs = os.path.join(tmp, "chunk_worker_in.pt")
        self.out = os.path.join(tmp, "chunk_worker_out.pt")
        self.go = os.path.join(tmp, "chunk_worker.go")
        torch.save({"state": [t.cpu() for t in job["state"]],
                    "chunks": [[t.cpu() for t in c] for c in job["chunks"]],
                    "gmc": job["gmc"]}, self.inputs)
        self.t0 = time.perf_counter()
        self.proc = start_process("artifact_worker", job["path"],
                                  self.inputs, self.out, job["dev"].type,
                                  self.go)

    def result(self):
        import torch
        with open(self.go, "w"):
            pass
        rc = self.proc.wait(timeout=600)
        assert rc == 0, f"artifact_worker exited {rc}"
        got = torch.load(self.out)
        got["process_s"] = time.perf_counter() - self.t0
        os.remove(self.inputs)
        return got

    def stop(self):
        stop([self.proc])


def run_chunk_artifact(job):
    """The in-process form of phase 41's run: the exported job's artifact
    loaded here and its chunks run through it (`artifact_runs`)."""
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.utils.export import load_serving_fn
    t0 = time.perf_counter()
    fn = load_serving_fn(job["path"])
    load_s = time.perf_counter() - t0
    with full_f32():
        got = artifact_runs(fn, job["state"], job["chunks"], job["gmc"],
                            job["dev"])
    got["load_s"] = load_s
    return got


def hold_chunk_artifact(name, job, got, per_chunk):
    """Phase 41's check of an exported job against what its loaded
    artifact gave (`got`, from `ArtifactWorker` or `run_chunk_artifact`):
    ids and valid equal to the eager chunk's, tlwh within 1e-4, no host
    read and at least two `while_loop` nodes in the graph, the kernels'
    ops not imported before the load in a fresh process, and `per_chunk`
    (K1, K2) launches a chunk; ms a frame of the artifact (a second,
    timed pass) beside the eager chunk's. Emits and returns the result."""
    import torch
    from reid_tpu_torch.tracking.tracker import TrackerState
    res, want = job["res"], job["want"]
    t_frames = res["chunk"] * res["chunks"]
    res.update(fresh_process="process_s" in got, load_s=got["load_s"],
               first_pass_ms_per_frame=1e3 * got["first_s"] / t_frames,
               ms_per_frame=1e3 * got["timed_s"] / t_frames,
               launches=got["launches"], site_launches=got["site_launches"],
               ops_imported_before_load=got.get("ops_imported_before_load"))
    for key in ("process_s", "wait_s"):
        if key in got:
            res[key] = got[key]
    equal, tlwh_err, rows = True, 0.0, 0
    for (tl, ids, vd), (wtl, wids, wvd) in zip(got["outs"], want):
        wvd = wvd.cpu()
        equal &= torch.equal(ids.cpu(), wids.cpu()) and \
            torch.equal(vd.cpu(), wvd)
        if wvd.any():
            tlwh_err = max(tlwh_err, float((tl.cpu()[wvd]
                                            - wtl.cpu()[wvd]).abs().max()))
        rows += int(wvd.sum())
    res.update(ids_valid_equal=bool(equal), tlwh_max_err=tlwh_err,
               rows=rows, outputs_bit_equal=all(
                   torch.equal(a.cpu(), b.cpu())
                   for o, w in zip(got["outs"], want) for a, b in zip(o, w)),
               state_leaves_not_bit_equal=[
                   f for f, a, b in zip(TrackerState._fields, got["state"],
                                        job["want_state"])
                   if not torch.equal(a.cpu(), b.cpu())])
    emit(f"chunk artifact {name}", **res)
    assert res["ids_valid_equal"] and res["tlwh_max_err"] <= 1e-4, res
    assert res["rows"] > 0 and res["host_reads_in_graph"] == 0, res
    assert res["while_loop_nodes"] >= 2, res
    assert not res["ops_imported_before_load"], res
    got = (res["launches"].get("conv3x3_s8", 0),
           res["launches"].get("se_basic_block_s8", 0))
    assert got == tuple(n * res["chunks"] for n in per_chunk), (got, res)
    return res


def phase_probe(kind):
    """The qconv probe (`reid_tpu_torch.qconv_probe.run`) at its four
    configurations, the path of K3-K5: launch counts zeroed just before
    and read just after. Every kernel row must be exact against its plain
    version and K1. Returns the kernel rows and the path's counts."""
    import torch
    from reid_tpu_torch import qconv_probe
    from reid_tpu_torch.ops import _lib

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        results = qconv_probe.run()
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    emit("qconv probe", wall_s=time.perf_counter() - t0, launches=counts,
         configs=results)
    rows = []
    for res in results:
        for row in res["rows"]:
            if "kernel" not in row:
                continue
            assert row["exact"] and row["equals_k1"] and row["plain_exact"], \
                (res["config"], row)
            name = row["kernel"]
            k1 = name == "conv3x3_s8"
            assert row["launches_per_call"] == 1, (res["config"], row)
            rows.append(dict(
                name=f"{name} probe {res['config']}", route="cuda",
                source=K1_SOURCE if k1 else VARIANT_SOURCE,
                replaces=K1_REPLACES if k1 else VARIANT_REPLACES[name],
                path="qconv probe", shape=res["shape"],
                before_ms=VARIANT_BEFORE_MS.get(name, {}).get(res["config"]),
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "tops", "x_bf16",
                                       "launches_per_call")}))
    for name in ("conv3x3_s8",) + tuple(VARIANT_REPLACES):
        assert counts.get(name, 0) > 0, (name, counts)
    return rows, counts


def phase_embed():
    """The card's int8 embed against the CPU's on the same quantized model
    and the same 16 crops; the CPU runs every kernel's plain version."""
    import torch
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.quantize import (QuantState, quantize,
                                               quantized_model)

    gen = torch.Generator().manual_seed(1)
    crops = torch.randn((16, 256, 128, 3), generator=gen)
    cpu = build_model("seres18", num_classes=751, dtype=torch.bfloat16,
                      device="cpu")
    qs = quantize(cpu, [crops])
    q_cpu = quantized_model(cpu, qs)
    card = build_model("seres18", num_classes=751, dtype=torch.bfloat16,
                       device="cuda")
    card.load_state_dict(cpu.state_dict())
    q_card = quantized_model(card, QuantState(
        {k: v.cuda() for k, v in qs.kernels.items()},
        {k: v.cuda() for k, v in qs.w_scales.items()}, qs.act_scales))
    with torch.inference_mode():
        e_c = torch.cat(q_cpu(crops), 1).float()
        e_g = torch.cat(q_card(crops.cuda()), 1).float().cpu()
    cos = torch.nn.functional.cosine_similarity(e_c, e_g, dim=1)
    emit("embed", crops=16, min_cosine=cos.min().item(), threshold=0.999)
    assert cos.min().item() >= 0.999, cos


class Split:
    """Labels, cameras and sequences of a subset of a split."""

    def __init__(self, ds, rows):
        self.labels, self.cams, self.seqs = (ds.labels[rows], ds.cams[rows],
                                             ds.seqs[rows])


def phase_retrieval(query, gallery, make_s, profile_to=None, int8=False,
                    backbone="seres18"):
    """The retrieval path once, at the operating point (with `int8`, its
    `--int8` serving embed; `backbone` its `--backbone`), with the launch
    counts zeroed just before and read just after; traced with
    torch.profiler when `profile_to` names a file."""
    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.ops import _lib

    argv = ["--search_option", "dense", "--bs", "64", "--backbone",
            backbone] + (["--int8"] if int8 else [])
    timing, keep = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    def run():
        return cli.inference(argv, device="cuda",
                             splits=(query, gallery, N_CLASSES),
                             timing=timing, keep=keep)

    t0 = time.perf_counter()
    busy_ms = None
    if profile_to:
        (cmc, mean_ap), busy_ms = profiled(run, profile_to)
    else:
        cmc, mean_ap = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _lib.launch_counts()
    sites = {f"{n} {list(s)}": c
             for (n, s), c in _lib.site_launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    dists = keep.pop("dists")
    n = len(query) + len(gallery)
    dim = keep["qf"].shape[1]
    name = "retrieval" + ("" if backbone == "seres18" else f" {backbone}")
    emit(name + (" --int8" if int8 else ""), n_query=len(query),
         n_gallery=len(gallery), dim=dim, cmc1=float(cmc[0]),
         cmc5=float(cmc[4]), cmc10=float(cmc[9]), mAP=mean_ap,
         stage_s=timing, wall_s=wall, data_s=make_s, peak_mem_gb=peak / 1e9,
         device_kernel_ms=busy_ms, launches=counts, site_launches=sites)
    width = {"agw": 2048 + N_CLASSES, "plr_osnet": 2560,
             "vit": 384 + N_CLASSES}.get(backbone, 512 + N_CLASSES)
    assert dim == width and tuple(dists.shape) == (n, n)
    assert bool(torch.isfinite(dists).all()) and float(dists.min()) >= 0.0
    assert np.all(np.isfinite(cmc)) and np.all(np.diff(cmc) >= 0)
    assert 0.0 < mean_ap <= 1.0 and cmc[-1] <= 1.0
    fused = backbone == "seres18"
    for k in ("sqeuclidean", "l1") + (
            ("conv3x3_s8",) + (("se_basic_block_s8",) if fused else ())
            if int8 else ()):
        assert counts.get(k, 0) > 0, (k, counts)
    if not fused:
        assert "se_basic_block_s8" not in counts, counts
    del dists
    return keep, counts, sites


def retrieval_batch(query, gallery, dev):
    """The `--int8` retrieval trunk's calibration batch (the first 32
    gallery images and their flips, as `cli.inference` calibrates) and one
    embed batch (--bs 64 query images and their flips: 128)."""
    import torch
    from reid_tpu_torch.data.transforms import inference_batch

    def both(split, k):
        x = inference_batch(torch.from_numpy(
            split.gather(np.arange(k))["images"]).to(dev))
        return torch.cat([x, torch.flip(x, dims=(2,))])
    return both(gallery, 32), both(query, 64)


def timed_once(fn):
    """(fn(), its ms on CUDA events): one call, no warm-up, for a plain
    version that takes seconds a call."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def phase_distance_kernels(kind, keep, suffix="", path="retrieval",
                           full=True):
    """K6 and K7 against their plain versions on the operands the first
    Jaccard call gave them, timed beside the plain version, the bound and
    torch.cdist: the run's de-biased unit features (K6), and the V encoding
    recomputed from them and their ranking (K7); with `full`, one full
    N x N L1 call of the kernel too."""
    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.ops import distance as dist
    from reid_tpu_torch.ops import rerank
    from reid_tpu_torch.ops.camera import diminish_camera_bias
    from reid_tpu_torch.utils.timing import StageTimer

    rows = []
    with full_f32(), torch.inference_mode():
        # K6: one query block of the first Jaccard's initial ranking
        cams = torch.cat([torch.as_tensor(keep["gallery_cams"]),
                          torch.as_tensor(keep["query_cams"])]).cuda()
        feats = diminish_camera_bias(torch.cat([keep["gf"], keep["qf"]]),
                                     cams)
        feats = (feats / feats.norm(dim=1, keepdim=True)).contiguous()
        x = feats[:1024]
        m, d = x.shape
        n = feats.shape[0]
        got = dist.sqeuclidean(x, feats)
        want = dist.sqeuclidean_plain(x, feats)
        torch.cuda.synchronize()
        err = (got - want).abs()
        assert bool((err <= 1e-4 + 1e-4 * want.abs()).all()), err.max()
        top_g = torch.sort(got, dim=1, stable=True).indices[:, :20]
        top_w = torch.sort(want, dim=1, stable=True).indices[:, :20]
        topk_share = (top_g == top_w).all(1).double().mean().item()
        self_first = (top_g[:, 0] == torch.arange(m, device="cuda")).double()\
            .mean().item()
        del got, want, top_g, top_w
        bms, by = bound(2 * m * n * d, 4 * (m * d + n * d + m * n), kind,
                        "fp32")
        rows.append(dict(
            name="sqeuclidean topk block" + suffix, route="cuda",
            source=DIST_SOURCE, replaces=K6_REPLACES, site=[m, n, d],
            path=path,
            max_abs_err=err.max().item(), top20_rows_equal=topk_share,
            self_first=self_first,
            ms=time_ms(lambda: dist.sqeuclidean(x, feats)),
            plain_ms=time_ms(lambda: dist.sqeuclidean_plain(x, feats)),
            library_ms=time_ms(lambda: torch.cdist(x, feats)),
            bound_ms=bms, bound_by=by))
        rows[-1]["queued_ms"], rows[-1]["host_ms"] = time_queued_ms(
            lambda: dist.sqeuclidean(x, feats))
        rows[-1]["library_queued_ms"], _ = time_queued_ms(
            lambda: torch.cdist(x, feats))
        # the row norms, the transposed copies and the tile kernel apart
        rows[-1]["device_split_ms"] = launch_split(
            lambda: dist.sqeuclidean(x, feats))
        del err, x
        emit(f"kernel {rows[-1]['name']}", **rows[-1])

        # K7: a 1,024-row slab of the min-sum, then one full call
        _, rank = dist.topk_neighbors(feats, feats, k=20)
        v = rerank._query_expansion(rerank._v_rows(
            feats, rank, 20, 0, feats.shape[0], StageTimer(None, "cuda")),
            rank, 6)
        del feats, rank
        nnz = (v > 0).sum(1)
        slab = v[:1024]
        m, (n, d) = slab.shape[0], v.shape
        got = dist.l1(slab, v)
        # the plain version takes ~5.6 s a call: the comparison's own call
        # is the timed one
        want, plain_ms = timed_once(lambda: dist.l1_plain(slab, v))
        err = (got - want).abs()
        assert bool((err <= 1e-5 + 1e-5 * want.abs()).all()), err.max()
        del got, want
        bms, by = bound(2 * m * n * d, 4 * (m * d + n * d + m * n), kind,
                        "fp32_alu")
        row = dict(
            name="l1 min-sum slab" + suffix, route="cuda",
            source=DIST_SOURCE, replaces=K7_REPLACES, site=[m, n, d],
            path=path,
            v_nonzeros_per_row_mean=nnz.double().mean().item(),
            v_nonzeros_per_row_max=int(nnz.max()),
            max_abs_err=err.max().item(),
            ms=time_ms(lambda: dist.l1(slab, v)), plain_ms=plain_ms,
            library_ms=time_ms(lambda: torch.cdist(slab, v, p=1),
                               reps=2 if full else 1,
                               warm=1 if full else 0),
            bound_ms=bms, bound_by=by)
        del err, nnz
        if full:
            # torch.cdist's full call (21.4 s, PR 6) is no longer timed here:
            # the smoke's time limit
            row["full_ms"] = time_ms(lambda: dist.l1(v, v), reps=1, warm=0)
            row["full_bound_ms"], _ = bound(2 * n * n * d,
                                            4 * (2 * n * d + n * n), kind,
                                            "fp32_alu")
        rows.append(row)
        del v, slab
        emit(f"kernel {row['name']}", **row)
    torch.cuda.empty_cache()
    return rows


def phase_retrieval_cpu(keep, query, gallery):
    """The post-embed half on the card (kernels) and on the CPU (plain
    versions), on the same 1,024 features (ids 0-31), dense and sparse.

    Near-ties in the top-k ranking make this comparison chaotic where it
    is not a test of arithmetic: a pair of neighbours whose distances lie
    within rounding of each other can swap places, which moves them across
    the k1/2 + 1 and k2 cuts and changes whole rows of J, and DBSCAN plus
    smoothing pull each cluster's embeddings together (0.9 x the mean), so
    the second Jaccard meets ten times closer ties. So the end-to-end
    results are held loosely (CMC within 1/Q at every rank, mAP within
    1e-2) and the share of J entries within 1e-4 is reported without a
    limit, and the arithmetic is held tightly on its own: from the same
    de-biased features and the same ranking, the card's Jaccard equals the
    CPU's within 1e-5 everywhere, and the two rankings hold the same
    top-20 sets on >= 99.9% of rows."""
    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.config import Config, RetrievalConfig
    from reid_tpu_torch.eval.inference import evaluate_features
    from reid_tpu_torch.ops import _lib, rerank
    from reid_tpu_torch.ops.camera import diminish_camera_bias
    from reid_tpu_torch.ops.distance import topk_neighbors

    qr = np.flatnonzero(query.labels < 32)
    gr = np.flatnonzero(gallery.labels < 32)
    qf, gf = keep["qf"][qr].cpu(), keep["gf"][gr].cpu()
    q, g = Split(query, qr), Split(gallery, gr)
    out = {}
    for option in ("dense", "sparse"):
        cfg = Config(retrieval=RetrievalConfig(search_option=option))
        res = []
        for dev in ("cuda", "cpu", "cuda"):
            k = {}
            t0 = time.perf_counter()
            _lib.reset_launch_counts()
            with full_f32(), torch.inference_mode():
                cmc, mean_ap = evaluate_features(
                    qf.to(dev), gf.to(dev), q, g, cfg, verbose=False, keep=k)
            res.append((cmc, mean_ap, k["dists"].cpu(),
                        time.perf_counter() - t0, _lib.launch_counts()))
        (cmc_g, map_g, j_g, s_g, n_g), (cmc_c, map_c, j_c, s_c, n_c), \
            (cmc_r, map_r, j_r, _, _) = res
        err = (j_g - j_c).abs()
        # the card repeats itself bit for bit
        repeat = bool(torch.equal(j_g, j_r) and np.array_equal(cmc_g, cmc_r)
                      and map_g == map_r)
        out[option] = dict(rows=len(qr) + len(gr),
                           share_within_1e4=(err <= 1e-4).double().mean()
                           .item(), max_abs_err=err.max().item(),
                           cmc_max_diff=float(np.abs(cmc_g - cmc_c).max()),
                           mAP_card=map_g, mAP_cpu=map_c, card_s=s_g,
                           cpu_s=s_c, card_launches=n_g,
                           card_repeat_bit_equal=repeat)
        assert not n_c and n_g.get("sqeuclidean", 0) > 0, (n_c, n_g)
        assert repeat, out[option]
        assert out[option]["cmc_max_diff"] <= 1.0 / len(qr) + 1e-6
        assert abs(map_g - map_c) <= 1e-2, out[option]

    # the arithmetic alone: same features, same ranking
    with full_f32(), torch.inference_mode():
        cams = torch.as_tensor(np.concatenate([g.cams, q.cams]))
        x = diminish_camera_bias(torch.cat([gf, qf]), cams)
        x = x / x.norm(dim=1, keepdim=True)
        _, r_c = topk_neighbors(x, x, k=20)
        _, r_g = topk_neighbors(x.cuda(), x.cuda(), k=20)
        r_g = r_g.cpu()
        same = {"order": (r_g == r_c).all(1).double().mean().item(),
                "set": (torch.sort(r_g, 1).values == torch.sort(r_c, 1).values
                        ).all(1).double().mean().item()}
        for s in (None, 512):
            j_g = rerank._jaccard_from_rank(x.cuda(), r_c.cuda(), 20, 6,
                                            sparse_s=s).cpu()
            j_c = rerank._jaccard_from_rank(x, r_c, 20, 6, sparse_s=s)
            same[f"jaccard_max_abs_err_s{s}"] = (j_g - j_c).abs().max().item()
            assert same[f"jaccard_max_abs_err_s{s}"] <= 1e-5, same
    assert same["set"] >= 0.999, same
    emit("retrieval vs cpu", **out, same_ranking=same)
    return out


def phase_embed_retrieval(query):
    """The f32 and the int8 TTA serving embed of the retrieval path, card
    against CPU, on 16 query images: the same weights and, for int8, the
    same QuantState."""
    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.eval.serving import (calibrate_serving_qstate,
                                             make_embed_fn,
                                             make_int8_embed_fn)
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.utils.quantize import QuantState

    imgs = torch.from_numpy(query.gather(np.arange(16))["images"])
    res = {}
    with full_f32(), torch.inference_mode():
        cpu = build_model("seres18", num_classes=N_CLASSES, device="cpu")
        card = build_model("seres18", num_classes=N_CLASSES, device="cuda")
        card.load_state_dict(cpu.state_dict())
        qs = calibrate_serving_qstate(cpu, imgs)
        qs_card = QuantState({k: v.cuda() for k, v in qs.kernels.items()},
                             {k: v.cuda() for k, v in qs.w_scales.items()},
                             qs.act_scales)
        for name, f_cpu, f_card, lim in (
                ("f32", make_embed_fn(cpu), make_embed_fn(card), 0.99999),
                ("int8", make_int8_embed_fn(cpu, qstate=qs),
                 make_int8_embed_fn(card, qstate=qs_card), 0.999)):
            e_c = f_cpu(imgs.float())
            e_g = f_card(imgs.float().cuda()).cpu()
            cos = (e_c * e_g).sum(1) / (e_c.norm(dim=1) * e_g.norm(dim=1))
            res[name] = dict(min_cosine=cos.min().item(), threshold=lim)
            assert cos.min().item() >= lim, (name, cos)
    emit("embed retrieval", images=16, **res)


@contextlib.contextmanager
def timed_detector(calls):
    """While active, the CLI's built-in detector is wrapped: each call
    appends (seconds between device synchronisations, valid
    detections)."""
    import torch
    from reid_tpu_torch import cli

    build = cli.build_detector

    def wrapped(*a, **kw):
        detect = build(*a, **kw)

        def timed(frame):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = detect(frame)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0, int(out[2].sum())))
            return out
        return timed

    cli.build_detector = wrapped
    try:
        yield
    finally:
        cli.build_detector = build


def frame_boxes(cand, scale, pad):
    """Candidates (N, 6) cx, cy, w, h in letterbox pixels -> tlwh (N, 4)
    in frame pixels, as the detector undoes the letterbox."""
    import torch
    from reid_tpu_torch.models.yolo import inv_f32
    tl = cand[:, :2] - 0.5 * cand[:, 2:4]
    tlwh = torch.cat([tl, cand[:, 2:4]], dim=1)
    shift = torch.tensor([pad[1], pad[0], 0.0, 0.0], device=cand.device)
    return ((tlwh - shift) * inv_f32(scale)).cpu().numpy()


def phase_detector_card_vs_cpu(argv, frames, kind, launches):
    """The YOLOv5s int8 detector of `argv` built as the CLI builds it
    (seed 1, calibrated on the source's first 8 frames), on the card and,
    with the same weights and QuantState, on the CPU (the plain kernel
    versions), on `frames`: valid counts equal, and every card box within
    0.5 px of the CPU's box of the same candidate (anchor cell). The share
    of boxes within 0.02 px and of output slots that hold the same box are
    reported, with the head maps' largest difference against their
    largest value and cosine. Then one frame's device launches and device
    time (torch.profiler) beside its time, `nms_fixed` alone on the card,
    and K1 at DET_K1_SITES on the first frame's inputs (exact against its
    plain version, timed). Returns the K1 rows."""
    import copy

    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.models import yolo
    from reid_tpu_torch.utils.quantize import (QuantState, quantize_input,
                                               quantized_model)

    args = cli._parser().parse_args(argv)
    det_hw = tuple(args.det_size)
    rows, res = [], dict(frames=len(frames))
    with torch.inference_mode(), cli.full_f32():
        model, qs = cli.build_yolo_detector(args, "cuda")
        cpu_model = copy.deepcopy(model).cpu()
        cpu_qs = QuantState({k: v.cpu() for k, v in qs.kernels.items()},
                            {k: v.cpu() for k, v in qs.w_scales.items()},
                            dict(qs.act_scales))
        kw = dict(max_dets=args.max_dets, conf_thres=args.conf_thres)
        keep_g, keep_c = {}, {}
        det_g = yolo.make_yolo_detector_fn(model, det_hw, qstate=qs,
                                           keep=keep_g, **kw)
        det_c = yolo.make_yolo_detector_fn(cpu_model, det_hw, qstate=cpu_qs,
                                           keep=keep_c, **kw)
        per = []
        for frame in frames:
            tg, cg, vg = det_g(frame)
            tc, cc, vc = det_c(frame)
            scale, _, pad = yolo.letterbox_geometry(frame.shape[:2], det_hw)
            cand_g = frame_boxes(keep_g["candidates"][0], scale, pad)
            cand_c = frame_boxes(keep_c["candidates"][0], scale, pad)
            # each card box's candidate, and the CPU's box of it
            errs = []
            for box in tg[vg]:
                j = int(np.abs(cand_g - box).max(1).argmin())
                assert np.abs(cand_g[j] - box).max() < 1e-3, box
                errs.append(float(np.abs(cand_c[j] - box).max()))
            errs = np.asarray(errs)
            same_slot = (vg == vc) & (np.abs(tg - tc).max(1) <= 0.02)
            heads = []
            for a, b in zip(keep_g["preds"], keep_c["preds"]):
                a, b = a.float().cpu().double(), b.float().double()
                heads.append(dict(
                    max_err_over_max=((a - b).abs().max()
                                      / b.abs().max()).item(),
                    cosine=((a * b).sum() / (a.norm() * b.norm())).item()))
            per.append(dict(valid_card=int(vg.sum()), valid_cpu=int(vc.sum()),
                            max_box_err_px=float(errs.max(initial=0.0)),
                            share_within_0_02px=float(
                                (errs <= 0.02).mean()) if len(errs) else 1.0,
                            share_slots_equal=float(same_slot[vg].mean())
                            if vg.any() else 1.0,
                            heads=heads))
        res["per_frame"] = per
        res["nms_rounds_per_frame"] = keep_g["rounds"] / len(frames)
        # nms_fixed alone on the card, on the last frame's candidates: each
        # round ends on a host read of its exit test
        xywh, sc, cl = yolo.decode_yolo(keep_g["preds"])
        res["nms_ms"] = time_ms(lambda: yolo.nms_fixed(
            xywh[0], sc[0], cl[0], conf_thres=args.conf_thres,
            max_dets=args.max_dets))
        # K1 at the detector's call sites, on the first frame's inputs
        net = quantized_model(model, qs)
        seen = {}
        hooks = [net.get_submodule(
            p.replace("/", ".")).register_forward_pre_hook(
                lambda m, a, p=p: seen.__setitem__(p, a[0]))
            for p, _ in DET_K1_SITES]
        fr = torch.as_tensor(frames[0]).cuda()
        net(yolo.letterbox(fr[None], det_hw))
        for h in hooks:
            h.remove()
        for path, (h, w, cin, cout) in DET_K1_SITES:
            mod = net.get_submodule(path.replace("/", "."))
            assert mod.route, path
            xq = quantize_input(seen[path], mod.sx).contiguous()
            assert tuple(xq.shape) == (1, h, w, cin), xq.shape
            row, _ = k1_row(kind, mod, xq, torch.bfloat16,
                            f"conv3x3_s8 {path} 1x{h}x{w} c{cin}",
                            "track --detector yolov5 --int8")
            row["launches"] = launches[(h, w, cin, cout)]
            rows.append(row)
        # one frame's time, then its device launches and their summed device
        # time (torch.profiler; traced last, as a trace slows later calls)
        res["host_clock_ms_per_frame"] = time_ms(lambda: det_g(frames[0]),
                                                 reps=5, warm=1)
        split = launch_split(lambda: det_g(frames[0]))
        res["launches_per_frame"] = len(split)
        res["device_ms_per_frame"] = sum(k[1] for k in split)
    emit("yolov5 card vs cpu", **res)
    for f in per:
        assert f["valid_card"] == f["valid_cpu"], per
        assert f["max_box_err_px"] <= 0.5, per
    return rows


def phase_track_yolo(tmp, kind, n_frames=16):
    """`track` with the built-in YOLOv5s detector in int8 (DET_ARGS) on
    phase 4's scene, the step path over `n_frames` frames: fps, per-frame
    ms of the detector (timed around it, the device synchronised), of
    crop_embed and associate, valid detections a frame and K1's launches
    at the detector's sites (DET_K1_PER_FRAME a frame, exactly); then the
    detector card against CPU on 2 frames. Returns the K1 rows."""
    from reid_tpu_torch.tracking.sources import iter_frames

    fdir, _ = write_scene(tmp, n_frames)
    argv = ["--source", fdir, *DET_ARGS, "--save_txt",
            os.path.join(tmp, "yolo.txt")]
    calls = []
    with timed_detector(calls):
        run = run_track(argv)
    run.pop("affines")
    k1 = {s: run["site_launches"].get(f"conv3x3_s8 {list(s)}", 0)
          for s in DET_K1_PER_FRAME}
    t = run["timing_ms_per_frame"]
    emit("track yolov5 int8",
         detect_ms_per_frame=1e3 * sum(c[0] for c in calls) / len(calls),
         crop_embed_ms_per_frame=t["crop_embed"],
         associate_ms_per_frame=t["associate"],
         valid_detections_per_frame=sum(c[1] for c in calls) / len(calls),
         k1_detector_launches={str(list(s)): n for s, n in k1.items()},
         **run)
    assert len(calls) == n_frames == run["frames"], (len(calls), run)
    assert all(c[1] > 0 for c in calls), calls
    for s, per_frame in DET_K1_PER_FRAME.items():
        assert k1[s] == per_frame * n_frames, (s, k1)
    frames = [f for i, f in iter_frames(fdir) if i in (1, n_frames // 2 + 1)]
    return phase_detector_card_vs_cpu(argv, frames, kind, k1)


def phase_track_centernet(tmp, n_frames=8):
    """`track` with the built-in CenterNetLite (f32, no kernel of ours) on
    phase 4's scene, the step path over `n_frames` frames: fps and valid
    detections a frame."""
    fdir, _ = write_scene(tmp, n_frames)
    calls = []
    with timed_detector(calls):
        run = run_track(["--source", fdir, "--detector", "centernet",
                         "--conf_thres", "0.1", "--max_dets", "64",
                         "--num_classes", "751", "--crop_hw", "256", "128",
                         "--save_txt", os.path.join(tmp, "centernet.txt")])
    run.pop("affines")
    emit("track centernet", detect_ms_per_frame=1e3 * sum(
        c[0] for c in calls) / len(calls),
         valid_detections_per_frame=sum(c[1] for c in calls) / len(calls),
         **run)
    assert len(calls) == n_frames == run["frames"], run
    assert not run["launches"], run["launches"]


def phase_gauntlet(scene_dir):
    """`reid_tpu_torch.gauntlet`: its 300-frame scene, rendered into
    `scene_dir` by `write_data`, the five methods through `track_main
    --gt` on the card; each method's MOTA, IDF1 and HOTA inside its
    CHECK_BANDS."""
    from reid_tpu_torch import gauntlet

    t0 = time.perf_counter()
    results = gauntlet.run(scene_dir=scene_dir, device="cuda")
    for method, m in results.items():
        emit(f"gauntlet {method}", MOTA=m["MOTA"], IDF1=m["IDF1"],
             HOTA=m["HOTA"], IDSW=m["IDSW"], band=gauntlet.CHECK_BANDS[method],
             seconds=m["seconds"])
    bad = gauntlet.band_failures(results)
    emit("gauntlet", methods=list(results), outside_band=bad,
         seconds=time.perf_counter() - t0)
    assert not bad, bad


def stream_data(point, dev, pan=None):
    """The inputs of an operating point of `STREAM_POINTS`: each stream its
    own scene (`scene`, seed 100 + s), `n_real` boxes of confidence 0.9 in
    `max_dets` slots, over `n_chunks` chunks."""
    import torch
    n_s, t = point["streams"], point["chunk"] * point["n_chunks"]
    h, w = point["hw"]
    n, d = point["n_real"], point["max_dets"]
    frames = torch.empty((n_s, t, h, w, 3), dtype=torch.uint8, device=dev)
    tlwh = torch.zeros((n_s, t, d, 4), device=dev)
    for s in range(n_s):
        fr, boxes = scene(t, n, (h, w), seed=100 + s, pan=pan)
        frames[s] = torch.from_numpy(fr).to(dev)
        tlwh[s, :, :n] = torch.from_numpy(boxes.astype(np.float32)).to(dev)
    conf = torch.zeros((n_s, t, d), device=dev)
    conf[:, :, :n] = 0.9
    return frames, tlwh, conf, conf > 0


def stream_cfg(point, method="strongsort"):
    """bench.py:315-386's tracker: n_init 2, the per-frame crop cap at the
    boxes a frame, 256x128 crops."""
    from reid_tpu_torch.tracking.methods import method_config
    return method_config(method, max_tracks=point["max_tracks"],
                         max_dets=point["max_dets"], n_init=2,
                         crop_hw=(256, 128), frame_crop_cap=point["n_real"])


def run_streams(name, point, embed, data, method="strongsort",
                profile_to=None):
    """All streams of `point` through `make_stream_tracker` (a crop budget
    of chunk x n_real a stream, as bench.py), chunk by chunk, with the
    launch counts and peak memory reset just before and read just after;
    then each stream alone through the one-stream tracker, held against
    its part of the batched run: ids and valid identical, tlwh within
    1e-4, bit-equality reported. fps (aggregate, and one stream's alone,
    the median of the streams) count every chunk after the first: all
    their frames over all their seconds. With `profile_to`, one more run of the
    first chunk from fresh states is traced by torch.profiler into that
    file, after everything is measured. Returns the emitted result and
    the batched run's site launches."""
    import torch
    from reid_tpu_torch.ops import _lib
    from reid_tpu_torch.tracking import assignment
    from reid_tpu_torch.tracking.pipeline import make_chunked_tracker
    from reid_tpu_torch.tracking.streams import (init_stream_states,
                                                 make_stream_tracker)
    from reid_tpu_torch.tracking.tracker import init_tracker_state

    cfg = stream_cfg(point, method)
    n_s, chunk = point["streams"], point["chunk"]
    n_chunks = point["n_chunks"]
    budget = chunk * point["n_real"]
    dev = data[0].device
    run = make_stream_tracker(cfg, embed, (256, 128), chunk=chunk,
                              crop_budget=budget, device=dev)
    feat_dim = 512 + N_CLASSES

    def chunks(x, s=None):
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            yield [d[:, sl] if s is None else d[s, sl] for d in x]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    st = init_stream_states(n_s, point["max_tracks"], feat_dim, device=dev)
    per_chunk, outs, prev = [], [], None
    for c, x in enumerate(chunks(data)):
        timing = {}
        assignment.reset_host_reads()
        t0 = time.perf_counter()
        st, o = run(st, *x, prev_frame=prev, timing=timing)
        o = {k: v.cpu() for k, v in o.items()}
        per_chunk.append(dict(
            s=time.perf_counter() - t0, host_reads=assignment.host_reads(),
            **{f"{k}_ms": 1e3 * v for k, v in timing.items()}))
        outs.append(o)
        prev = x[0][:, -1]
    counts = _lib.launch_counts()
    sites = {f"{n} {list(s)}": c
             for (n, s), c in _lib.site_launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    got = {k: torch.cat([o[k] for o in outs], 1) for k in outs[0]}

    # each stream alone, on the same frames and anchors
    single = make_chunked_tracker(cfg, embed, (256, 128), chunk,
                                  crop_budget=budget)
    single_s, bit_equal, same = [], [], []
    for s in range(n_s):
        one, ref, prev = init_tracker_state(point["max_tracks"], feat_dim,
                                            device=dev), [], None
        for c, x in enumerate(chunks(data, s)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one, o = single(one, *x, prev_frame=prev)
            ref.append({k: v.cpu() for k, v in o.items()})
            if c == 1:
                single_s.append(0.0)
            if c >= 1:
                single_s[-1] += time.perf_counter() - t0
            prev = x[0][-1]
        want = {k: torch.cat([o[k] for o in ref]) for k in ref[0]}
        v = want["valid"]
        same.append(bool(torch.equal(got["valid"][s], v)
                         and torch.equal(got["ids"][s], want["ids"])
                         and (got["tlwh"][s][v] - want["tlwh"][v]).abs()
                         .max().item() <= 1e-4))
        bit_equal.append(all(torch.equal(got[k][s], want[k]) for k in want))
    busy_ms = None
    if profile_to:
        first = next(chunks(data))
        _, busy_ms = profiled(lambda: run(init_stream_states(
            n_s, point["max_tracks"], feat_dim, device=dev), *first),
            profile_to)
    timed = chunk * (n_chunks - 1)
    res = dict(method=method, **{k: point[k] for k in (
                   "streams", "chunk", "hw", "n_real", "max_dets",
                   "max_tracks", "n_chunks")},
               embed_batch=n_s * budget, chunks=per_chunk,
               fps_aggregate=n_s * timed / sum(c["s"] for c in per_chunk[1:]),
               fps_single_stream=timed / float(np.median(single_s)),
               peak_mem_gb=peak / 1e9, launches=counts,
               site_launches=sites, device_kernel_ms_first_chunk=busy_ms,
               valid_rows=int(got["valid"].sum()),
               distinct_ids_per_stream=[
                   len(set(got["ids"][s][got["valid"][s]].tolist()))
                   for s in range(n_s)],
               streams_equal_single=same, streams_bit_equal=bit_equal)
    emit(f"streams {name}", **res)
    assert all(same), res
    assert np.all(np.isfinite(got["tlwh"][got["valid"]].numpy()))
    assert min(res["distinct_ids_per_stream"]) >= point["n_real"] * 0.8, res
    for k in ("conv3x3_s8", "se_basic_block_s8"):
        assert counts.get(k, 0) == 2 * n_chunks * (k == "conv3x3_s8") \
            + 4 * n_chunks * (k != "conv3x3_s8"), (k, counts)
    return res, sites


def k2_row(kind, mod, x, dtype, name, path):
    """K2 at one call site, held against its plain version (the limits of
    phase 3; bit-equality reported) and timed beside it (3 calls of the
    plain version)."""
    import torch
    from reid_tpu_torch.ops import qblock

    p, ibn = mod.p, mod.ibn
    bsz, h, w, cin = x.shape
    cout, mip = p.w2.shape[0], p.wfc1.shape[1]
    esize = torch.finfo(dtype).bits // 8

    def call():
        return qblock.se_basic_block_s8(x, p, ibn, dtype)
    got = call()
    want = qblock.se_basic_block_s8_plain(x, p, ibn, dtype)
    torch.cuda.synchronize()
    share, err = within(got.float(), want.float())
    bit_equal = bool(torch.equal(got, want))
    del got, want
    m = bsz * h * w
    down = p.wd is not None
    ops = (2 * m * cout * 9 * (cin + cout) + (2 * m * cout * cin if down
                                              else 0) + 4 * bsz * cout * mip)
    nbytes = (esize * m * cin + 9 * cout * (cin + cout)
              + (cout * cin if down else 0) + 4 * cout * mip + 4 * 9 * cout
              + esize * m * cout)
    bms, by = bound(ops, nbytes, kind)
    row = dict(name=name, route="cuda", source=K2_SOURCE,
               replaces=K2_REPLACES, path=path,
               site=[h, w, cin, cout, int(ibn)], batch=bsz, down=down,
               max_abs_err=err, bit_equal=bit_equal, share_tight=share,
               ms=time_ms(call, reps=10),
               plain_ms=time_ms(lambda: qblock.se_basic_block_s8_plain(
                   x, p, ibn, dtype), reps=3, warm=1),
               bound_ms=bms, bound_by=by, library_ms=None)
    emit(f"kernel {name}", **row)
    return row


def phase_streams(kind, dev, profile=False):
    """Phase 4d: multi-stream tracking at both operating points of
    `STREAM_POINTS` with the CLI's int8 embed (`cli.build_embed`), and
    botsort streams with GMC on phase 4's pan (PAN) at the MOT16-load
    point; phase 40 (c) with the same embed; then K1 and K2 at the
    stream batch (B = 8192), held against their plain versions."""
    import torch
    from reid_tpu_torch.cli import build_embed, full_f32
    from reid_tpu_torch.utils.quantize import quantize_input

    embed, _ = build_embed("seres18", N_CLASSES, (256, 128), dev, int8=True)
    out, sites8 = {}, None
    with full_f32(), torch.inference_mode():
        for name, point in STREAM_POINTS.items():
            data = stream_data(point, dev)
            out[name], sites = run_streams(
                name, point, embed, data, profile_to=os.path.join(
                    OUT_DIR, f"profile_streams_{name}.txt")
                if profile else None)
            if name == "multistream8":
                sites8 = sites
            del data
        point = STREAM_POINTS["mot16_load_multistream8"]
        data = stream_data(point, dev, pan=PAN)
        out["botsort"], _ = run_streams("mot16_load_multistream8 botsort",
                                        point, embed, data, "botsort")
        # the device affines of each stream's second chunk against the pan
        from reid_tpu_torch.tracking.gmc import chunk_affines_translation
        aff = chunk_affines_translation(data[0][:, point["chunk"] - 1],
                                        data[0][:, point["chunk"]:])
        err = (aff[..., 2] - torch.tensor(PAN, dtype=torch.float32,
                                          device=dev)).abs().max().item()
        emit("streams botsort gmc", pan=list(PAN), max_err_to_pan=err)
        assert err <= 1.0, err
        del data
        with process_group("streams") as mesh:
            phase_streams_mesh(embed, dev, mesh)
    torch.cuda.empty_cache()

    # K1 and K2 at the stream batch: every crop of a multistream8 chunk
    gen = torch.Generator(device=dev).manual_seed(0)
    point = STREAM_POINTS["multistream8"]
    b = point["streams"] * point["chunk"] * point["n_real"]
    crops = torch.randn((b, 256, 128, 3), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    qm, seen = quantized_trunk(dev, torch.bfloat16, crops[:32], crops)
    del crops
    rows = []
    with torch.inference_mode():
        for site, _ in K1_SITES:
            mod = qm.get_submodule(site.replace("/", "."))
            xq = quantize_input(seen.pop(site), mod.sx).contiguous()
            row, got = k1_row(kind, mod, xq, torch.bfloat16,
                              f"conv3x3_s8 {site} streams", "streams")
            rows.append(row)
            del got, xq
        for site in K2_SITES:
            rows.append(k2_row(kind, qm.get_submodule(site),
                               seen.pop(site).contiguous(), torch.bfloat16,
                               f"se_basic_block_s8 {site} streams",
                               "streams"))
    del seen, qm
    torch.cuda.empty_cache()
    set_launches(rows, sites8)
    return out, rows


def phase_ivf(keep, query, gallery):
    """Phase 11: IVF search on phase 6's features (the first Jaccard's
    de-biased unit rows, N = 23,100), with the plan `choose_search` makes
    for `--search_option ivf`: seconds of k-means, bucketing and
    `ivf_topk`, recall@k1 of its ranking against the exact top-k1 (K6),
    then CMC/mAP of the whole post-embed half with the IVF plan beside
    phase 6's dense, K7's launches counted around it; and card against CPU
    on phase 10's 1,024 features with one shared k-means init: bucket ids
    equal, rankings equal but for near-ties (reported)."""
    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.config import Config, RetrievalConfig
    from reid_tpu_torch.eval.inference import evaluate_features
    from reid_tpu_torch.ops import _lib
    from reid_tpu_torch.ops.camera import diminish_camera_bias
    from reid_tpu_torch.ops.distance import topk_neighbors
    from reid_tpu_torch.ops.ivf import build_ivf, ivf_topk
    from reid_tpu_torch.ops.policy import choose_search

    def unit_rows(qf, gf, q_cams, g_cams):
        cams = torch.as_tensor(np.concatenate([g_cams, q_cams]),
                               device=gf.device)
        x = diminish_camera_bias(torch.cat([gf, qf]), cams)
        return x / x.norm(dim=1, keepdim=True)

    k1 = 20
    res = {}
    with full_f32(), torch.inference_mode():
        x = unit_rows(keep["qf"], keep["gf"], query.cams, gallery.cams)
        plan = choose_search(x.shape[0], "ivf")
        timing = {}
        index = build_ivf(x, nlist=plan.nlist, timing=timing)
        t0 = time.perf_counter()
        _, rank = ivf_topk(index, x, k=k1, nprobe=plan.nprobe)
        torch.cuda.synchronize()
        timing["ivf_topk"] = time.perf_counter() - t0
        _, exact = topk_neighbors(x, x, k=k1)
        hits = (rank[:, :, None] == exact[:, None, :]).any(2)
        res.update(n=x.shape[0], nlist=plan.nlist, nprobe=plan.nprobe,
                   lists=int(index.centroids.shape[0]),
                   bucket_rows=int(index.buckets.shape[1]), stage_s=timing,
                   recall_at_k1=hits.double().mean().item(),
                   rows_exact=(rank == exact).all(1).double().mean().item())
        del x, index, rank, exact, hits
        torch.cuda.empty_cache()

        cfg = Config(retrieval=RetrievalConfig(search_option="ivf"))
        steps = {}
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        cmc, mean_ap = evaluate_features(keep["qf"], keep["gf"], query,
                                         gallery, cfg, verbose=False,
                                         timing=steps)
        torch.cuda.synchronize()
        dense = RESULTS["retrieval"]
        res.update(post_embed_s=time.perf_counter() - t0, steps_s=steps,
                   launches=_lib.launch_counts(), cmc1=float(cmc[0]),
                   cmc5=float(cmc[4]), cmc10=float(cmc[9]), mAP=mean_ap,
                   dense_cmc1=dense["cmc1"], dense_mAP=dense["mAP"])
        assert np.all(np.isfinite(cmc)) and 0.0 < mean_ap <= 1.0, res

        # card against CPU, one k-means init (a CPU generator seeded 0)
        qr = np.flatnonzero(query.labels < 32)
        gr = np.flatnonzero(gallery.labels < 32)
        xs = unit_rows(keep["qf"][qr].cpu(), keep["gf"][gr].cpu(),
                       query.cams[qr], gallery.cams[gr])
        small = choose_search(xs.shape[0], "ivf")
        idx_c = build_ivf(xs, nlist=small.nlist)
        dev = keep["qf"].device
        idx_g = build_ivf(xs.to(dev), nlist=small.nlist)
        d_c, r_c = ivf_topk(idx_c, xs, k=k1, nprobe=small.nprobe)
        d_g, r_g = ivf_topk(idx_g, xs.to(dev), k=k1, nprobe=small.nprobe)
        d_g, r_g = d_g.cpu(), r_g.cpu()
        differ = ~(r_g == r_c).all(1)
        # a differing row is a near-tie where the distances stay within
        # rounding at every rank
        gap = (d_g - d_c).abs().max().item()
        res["card_vs_cpu"] = dict(
            rows=xs.shape[0], nlist=small.nlist, nprobe=small.nprobe,
            bucket_ids_equal=bool(torch.equal(idx_g.bucket_ids.cpu(),
                                              idx_c.bucket_ids)),
            rows_differing=int(differ.sum()), max_dist_diff=gap)
    emit("ivf", **res)
    assert res["card_vs_cpu"]["bucket_ids_equal"], res
    assert res["card_vs_cpu"]["max_dist_diff"] <= 1e-5, res
    assert res["launches"].get("l1", 0) + res["launches"].get(
        "sqeuclidean", 0) > 0, res
    return res


def write_attributes(path, n_ids):
    """A market_attribute.mat of `n_ids` ids (1..n_ids), age and 26 binary
    attributes drawn from a generator seeded 0 (the published file's
    layout: a struct with a test and a train table)."""
    from scipy import io as scipy_io
    rng = np.random.default_rng(0)
    table = {"image_index": np.asarray(
        [[f"{i:04d}" for i in range(1, n_ids + 1)]], dtype=object),
        "age": rng.integers(1, 5, (1, n_ids)).astype(float)}
    for a in range(26):
        table[f"attr{a:02d}"] = rng.integers(1, 3, (1, n_ids)).astype(float)
    scipy_io.savemat(path, {"market_attribute": {"test": table,
                                                 "train": table}})
    return path


def phase_artifact(gallery, tmp, dev):
    """Phase 12: serving artifacts. The f32 and the int8 export (one
    QuantState, calibrated as `--int8` calibrates: the first 32 gallery
    images) of SERes18 (751 classes, random weights seed 0) at 256x128
    with a dynamic batch: seconds and file sizes; each loaded artifact at
    B = 1, 3 and 64 against serving the model in process, bit for bit,
    with K1/K2 launches counted around the artifact's calls; then
    `inference --artifact` (f32 against the same weights in process, CMC
    and mAP equal) and the int8 artifact with `--attributes_mat` on a
    small in-memory split."""
    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.data import synthetic_dataset
    from reid_tpu_torch.eval.serving import (calibrate_serving_qstate,
                                             export_reid_artifact,
                                             load_serving_fn, make_embed_fn)
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.ops import _lib
    from reid_tpu_torch.utils.quantize import quantized_model

    res, paths = {}, {}
    with cli.full_f32():
        model = build_model("seres18", num_classes=N_CLASSES, device=dev)
        calib = torch.from_numpy(gallery.gather(np.arange(32))["images"]).to(
            dev).float()
        qs = calibrate_serving_qstate(model, calib)
        imgs = torch.from_numpy(gallery.gather(np.arange(64, 128))[
            "images"]).to(dev).float()
        for name, q in (("f32", None), ("int8", qs)):
            paths[name] = os.path.join(tmp, f"reid_{name}.pt2")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            export_reid_artifact(model, paths[name], 256, 128, qstate=q)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = load_serving_fn(paths[name])
            load_s = time.perf_counter() - t0
            eager = make_embed_fn(model if q is None
                                  else quantized_model(model, q))
            runs = {}
            with torch.inference_mode():
                for b in (1, 3, 64):
                    want = eager(imgs[:b])
                    _lib.reset_launch_counts()
                    got = loaded(imgs[:b])
                    torch.cuda.synchronize()
                    runs[b] = dict(bit_equal=bool(torch.equal(got, want)),
                                   launches=_lib.launch_counts())
                runs["ms_b64"] = time_ms(lambda: loaded(imgs), reps=5)
                runs["eager_ms_b64"] = time_ms(lambda: eager(imgs), reps=5)
            res[name] = dict(export_s=export_s, load_s=load_s,
                             bytes=os.path.getsize(paths[name]), runs=runs)
            for b in (1, 3, 64):
                assert runs[b]["bit_equal"], (name, b, runs)
                n1 = runs[b]["launches"].get("conv3x3_s8", 0)
                n2 = runs[b]["launches"].get("se_basic_block_s8", 0)
                assert (n1, n2) == ((2, 4) if q is not None else (0, 0)), \
                    (name, b, runs[b])
        del model, qs, calib, imgs
    torch.cuda.empty_cache()

    # the CLI on a small split: 64 queries, 256 gallery images, 32 ids
    query = synthetic_dataset(64, num_pids=32, height=256, width=128,
                              num_cams=N_CAMS, seed=11, palette_seed=3)
    small = synthetic_dataset(256, num_pids=32, height=256, width=128,
                              num_cams=N_CAMS, seed=12, palette_seed=3)
    query.records = [(p, pid, (c + 3) % N_CAMS, 0)
                     for p, pid, c, _ in query.records]
    mat = write_attributes(os.path.join(tmp, "market_attribute.mat"), 32)
    splits = (query, small, N_CLASSES)
    runs = {}
    for name, argv in (("direct", []), ("artifact f32",
                                         ["--artifact", paths["f32"]]),
                       ("artifact int8 + attributes",
                        ["--artifact", paths["int8"], "--attributes_mat",
                         mat])):
        _lib.reset_launch_counts()
        cmc, mean_ap = cli.inference(argv + ["--bs", "64"], device=dev,
                                     splits=splits)
        runs[name] = dict(cmc1=float(cmc[0]), cmc5=float(cmc[4]),
                          mAP=mean_ap, launches=_lib.launch_counts())
        assert np.all(np.isfinite(cmc)) and 0.0 < mean_ap <= 1.0, runs
    res["cli"] = runs
    emit("artifact", **res)
    assert runs["artifact f32"]["cmc1"] == runs["direct"]["cmc1"], runs
    assert runs["artifact f32"]["mAP"] == runs["direct"]["mAP"], runs
    assert runs["artifact int8 + attributes"]["launches"].get(
        "se_basic_block_s8", 0) > 0, runs
    return res


# the training operating point: Market-1501's train split (751 ids; its
# 12,936 images as 17 an id), SERes18-IBN at 256x128 in bf16, PK batches
# of 64 = 16 ids x 4, one epoch (of two before); the depth cut for the
# smoke's time limit: 8 images an id (6,008, 17 before), two PK groups
# of 4 an id, half the epoch's steps (93; the loss is logged every 50)
TRAIN_IDS, TRAIN_PER_ID, TRAIN_EPOCHS = 751, 8, 1
# the continual phase's target: DukeMTMC-reID's train split, 16,522 images
# of 702 ids (376 ids of 24 images and 326 of 23)
DUKE_IDS, DUKE_COUNTS = 702, [24] * 376 + [23] * 326


def write_data(root):
    """The data the smoke reads from disk, under `root`: the synthetic
    trees of phases 10 and 11, the training tree (`TRAIN_*`) as `market`
    and the continual target (`DUKE_*`) as `duke`, and the gauntlet's
    scene as `gauntlet`. Run by a process of its own (`start_process`)
    while the kernels build: the smoke's clock."""
    from reid_tpu_torch import gauntlet
    from reid_tpu_torch.data.datasets import write_synthetic_tree
    write_synthetic_tree(os.path.join(root, "market"), "market1501",
                         TRAIN_IDS, TRAIN_PER_ID, query_per_id=1,
                         gallery_per_id=2)
    write_synthetic_tree(os.path.join(root, "duke"), "dukemtmc", DUKE_IDS,
                         DUKE_COUNTS, num_cams=8, seed=1)
    gauntlet.write_gauntlet(os.path.join(root, "gauntlet"))


# the card-vs-CPU step: SERes18 at 256x128 with 751 classes, a batch of 16
# (4 ids x 4); OSNet's and PLR-OSNet's of 8 (2 x 4): the CPU's second
# step, with ATen's own convolution for the spread, takes ~55 s at 16 (its
# depthwise convolutions)
CARD_CPU_BATCH = 16
CARD_CPU_BATCH_OSNET = 8


@contextlib.contextmanager
def patched(module, name, wrap):
    """module.name replaced by wrap(module.name) inside the block."""
    old = getattr(module, name)
    setattr(module, name, wrap(old))
    try:
        yield
    finally:
        setattr(module, name, old)


class TrainClock:
    """Wraps `make_train_step` and `make_train_loader` as `train_cnn` calls
    them: a CUDA event after each step (consecutive events give the step
    period on the device's clock without a synchronisation), the host
    seconds each step waited for its batch, the epoch of each step, the
    first batches of the run (kept for a later trace) and what
    `train_cnn` was called with and returned."""

    def __init__(self, keep_batches=8):
        self.events, self.waits, self.epochs = [], [], []
        self.epoch, self.keep, self.batches = -1, keep_batches, []
        self.calls = []

    def make_step(self, make):
        import torch

        def make_step(*a, **k):
            step = make(*a, **k)

            def timed(state, batch):
                out = step(state, batch)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                self.epochs.append(self.epoch)
                return out
            return timed
        return make_step

    def make_loader(self, make):
        clock = self

        class Timed:
            def __init__(self, loader):
                self.loader = loader

            def __len__(self):
                return len(self.loader)

            def __iter__(self):
                it = iter(self.loader)
                while True:
                    t = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    clock.waits.append(time.perf_counter() - t)
                    if len(clock.batches) < clock.keep:
                        clock.batches.append(batch)
                    yield batch

        def make_loader(*a, **k):
            self.epoch += 1
            return Timed(make(*a, **k))
        return make_loader

    def train_cnn(self, fn):
        def train_cnn(cfg, dataset, **kw):
            state, losses = fn(cfg, dataset, **kw)
            self.calls.append((cfg, dataset, losses))
            return state, losses
        return train_cnn

    def step_ms(self):
        """Step periods (ms) within each epoch, the run's first step left
        out (it waits on the first batch and the first cuDNN plans)."""
        self.events[-1].synchronize()
        return [a.elapsed_time(b) for a, b, ea, eb in zip(
            self.events, self.events[1:], self.epochs, self.epochs[1:])
            if ea == eb]


def step_profile(state, cfg, batches, reps=5, step=None,
                 name="train_step"):
    """`reps` train steps on kept batches under torch.profiler, after two
    untraced ones and one under torch.cuda's sync debug mode "error" (it
    fails if the step reads anything back or copies from the host): device
    ms a step in convolution and GEMM kernels
    (cuDNN, cuBLAS, CUTLASS) and in the rest, launches a step, and the
    host ms a step (the wall clock of the traced steps, which the trace
    slows); each kernel's share to OUT_DIR/profile_{name}.txt. `step`
    replaces the CNN train step (PLR-OSNet's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from reid_tpu_torch.train.steps import make_train_step

    if step is None:
        step = make_train_step(cfg, generator=torch.Generator("cuda")
                               .manual_seed(7))
    batches = [{k: b[k] for k in ("images", "labels", "cams") if k in b}
               for b in batches]
    for b in batches[:2]:
        step(state, b)
    torch.cuda.synchronize()
    # one more step that must read nothing back nor copy from the host
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, batches[2 % len(batches)])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            step(state, batches[(2 + i) % len(batches)])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    heavy = ("conv", "cudnn", "gemm", "xmma", "cutlass", "wgrad", "dgrad",
             "sm90", "nchwToNhwc", "nhwcToNchw")
    split = {"conv_gemm_ms": 0.0, "other_ms": 0.0}
    launches = 0
    kernels = device_kernels(prof)
    for kname, n, ms in kernels:
        key = "conv_gemm_ms" if any(h in kname.lower() for h in heavy) \
            else "other_ms"
        split[key] += ms / reps
        launches += n
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
        f.write(f"{reps} train steps, device ms a step and launches a "
                "step by kernel\n")
        for kname, n, ms in kernels:
            f.write(f"{ms / reps:10.4f} ms {n / reps:8.1f}x  "
                    f"{kname[:140]}\n")
    return dict(split, host_syncs_in_step=0, launches_per_step=launches / reps,
                device_ms_per_step=split["conv_gemm_ms"] + split["other_ms"],
                traced_wall_ms_per_step=wall)


def phase_train(tmp, trees):
    """`cli.train_main` on a synthetic Market-shaped tree on the card: two
    epochs of SERes18-IBN bf16 at 256x128, 751 classes, --bs 64
    --instance 4, then --export; the step period on the device's clock,
    images/s, the host's wait on the loader, peak memory and the logged
    losses (which must fall); the `.npz` checkpoint read back by
    `inference_main --ckpt`, the artifact against serving in process.
    The tree is `write_data`'s under `tmp`, from the process `trees`
    (data_s: the wait for it). Returns what the continual phase starts
    from: (state, cfg, source dataset, kept batches)."""
    import copy
    import statistics

    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.eval.serving import load_serving_fn, make_embed_fn
    from reid_tpu_torch.train import image_train
    from reid_tpu_torch.utils.flax_bridge import load_npz

    market = os.path.join(tmp, "market")
    t0 = time.perf_counter()
    assert trees.wait(timeout=600) == 0, "write_data failed"
    data_s = time.perf_counter() - t0
    pt2, ckpt_dir = os.path.join(tmp, "reid.pt2"), os.path.join(tmp, "ckpt")
    clock = TrainClock()
    seed_s = []

    def timed_seed(fn):
        def seed(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seed_s.append(time.perf_counter() - t)
            return out
        return seed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(image_train, "make_train_step", clock.make_step), \
            patched(image_train, "make_train_loader", clock.make_loader), \
            patched(image_train, "train_cnn", clock.train_cnn), \
            patched(image_train, "seed_dcc_luts", timed_seed):
        state = cli.train_main(
            ["--root", market, "--epochs", str(TRAIN_EPOCHS), "--bs", "64",
             "--instance", "4", "--export", pt2], device="cuda",
            ckpt_dir=ckpt_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cfg, dataset, losses = clock.calls[0]
    steps = clock.step_ms()
    med = statistics.median(steps)
    q = statistics.quantiles(steps, n=20)
    n_steps = len(clock.events)
    waits = clock.waits[1:]
    assert len(losses) >= 2 and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    for p in state.model.parameters():
        assert bool(torch.isfinite(p).all())

    npz = image_train.checkpoint_path(ckpt_dir, "market1501")
    assert load_npz(npz)["params"]["classifier"]["kernel"].shape == \
        (512, TRAIN_IDS)
    cmc, mean_ap = cli.inference_main(["--root", market, "--ckpt", npz,
                                       "--bs", "64"], device="cuda")
    assert np.all(np.isfinite(cmc)) and 0.0 < mean_ap <= 1.0
    x = clock.batches[0]["images"][:16].to(torch.float32)
    want = make_embed_fn(state.model)(x)
    got = load_serving_fn(pt2)(x)
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float())
    assert float(cos.min()) >= 0.999, cos.min()
    emit("train seres18 bf16", ids=TRAIN_IDS, images=len(dataset),
         epochs=TRAIN_EPOCHS, batch=64, steps=n_steps, data_s=data_s,
         wall_s=wall, dcc_seed_s=seed_s,
         steps_s=sum(steps) / 1e3, step_ms_median=med, step_ms_p5=q[0],
         step_ms_p95=q[-1],
         step_ms_min=min(steps), step_ms_max=max(steps),
         images_per_s=64 * 1e3 / med,
         loader_wait_ms_median=statistics.median(waits) * 1e3,
         loader_wait_share=sum(waits) / max(sum(steps) / 1e3, 1e-9),
         peak_mem_gb=peak / 1e9, loss_first=losses[0], loss_last=losses[-1],
         losses=losses, ckpt_reload_cmc1=float(cmc[0]),
         ckpt_reload_mAP=mean_ap,
         artifact_min_cosine=float(cos.min()),
         artifact_bit_equal=bool(torch.equal(got, want)))
    return state, cfg, dataset, copy.deepcopy(state), clock.batches


def phase_train_card_vs_cpu(backbone="seres18", spread=False,
                            renorm=False):
    """One f32 train step from one state on the card and on the CPU:
    `backbone` (SERes18, CARes18, EMARes18, ResNet50, OSNet or
    PLR-OSNet, whose dual-branch step takes the batch normalized and
    unaugmented and runs Adam under PK sampling; with `renorm` its
    BatchRenorm trunk, every counter past warm-up at 750 steps, so r and
    d range over [1/2, 2] and [-2.5, 2.5], not fixed at 1 and 0) at
    256x128, 751 classes, a
    batch of 16 (4 ids x 4; 8 for the OSNets, CARD_CPU_BATCH_OSNET) of uint8
    images under the same augmentation draws, TF32 off. The largest
    relative differences of the loss (1e-4), the BatchNorm statistics,
    the centers and the DCC tables (1e-3 of each tensor's largest
    magnitude); the gradient (Adam's first moment, 0.1 g after one step)
    within 1e-3 of its norm (the two sum each convolution in their own
    order); the parameter update at a cosine >= 0.9994 and within 3.5% of
    its norm: Adam's first step moves each element by lr g / (|g| + 1e-8),
    a sign, so elements whose gradient is rounding noise step opposite
    ways. Two card runs read a cosine of 0.999467 and 3.27% of the
    update's norm at this batch (tests/test_torch_train_step.py holds
    0.9995 and 3% at 64x32, where it reads 1.7%); the limits sit just
    above. The gradient's limit is what tells a wrong step apart.

    With `spread` the CPU also takes the step with ATen's own convolution
    in place of oneDNN's, and the gradient and update limits widen to
    twice that CPU-to-CPU spread where it exceeds them: at a random init
    the ResNet50 step is ill-conditioned (deep residual sums without SE
    gates ahead of train-mode norms), so that two CPU convolution
    algorithms leave its gradient 2.7% apart (a CPU reading) where
    SERes18's sits within 1e-3; the card read 2.0% against the CPU. OSNet
    and PLR-OSNet are more so (depthwise convs and ~40 train-mode norms in
    series; PLR-OSNet's max-pooled local branch): the two CPU algorithms
    read 1.7% / 1.5% of the gradient's norm, update cosines 0.9950 /
    0.9957 and 10% / 9.2% of its norm (CPU readings).

    The transformers (`TRANSFORMER_WIDTH`) take their step as the library
    the JAX package can run: `cfg.model.feat_dim` at the model's width, at
    448x224 with a batch of 8, ViT with cams, on their Adam branch (no
    PK sampling); both sides are built with dropout 0, since the card's
    and the CPU's generators draw different masks."""
    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.config import Config, ModelConfig, TrainConfig
    from reid_tpu_torch.data.transforms import augment_draws
    from reid_tpu_torch.losses import DCCState
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.train.plr_train import (create_plr_train_state,
                                                make_plr_train_step)
    from reid_tpu_torch.train.state import create_train_state
    from reid_tpu_torch.train.steps import make_train_step
    from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                                  load_flax_variables)

    small = backbone in OSNET_BACKBONES + tuple(TRANSFORMER_WIDTH)
    b = CARD_CPU_BATCH_OSNET if small else CARD_CPU_BATCH
    c = N_CLASSES
    transformer = backbone in TRANSFORMER_WIDTH
    hw = TRANSFORMER_HW if transformer else (256, 128)
    extra = dict(dropout=0.0) if transformer else {}
    # the transformers' Adam branch is the one without PK sampling; its
    # first moment gives the gradient as the other backbones' Adam does
    cfg = Config(model=ModelConfig(
        backbone=backbone, num_classes=c, dtype="float32", renorm=renorm,
        feat_dim=TRANSFORMER_WIDTH.get(backbone, 512)),
        train=TrainConfig(batch_size=b,
                          num_instances=0 if transformer else 4))
    variables = flax_variables(build_model(
        backbone, c, dtype=torch.float32, device="cpu",
        generator=torch.Generator().manual_seed(0), renorm=renorm, **extra))

    def past_warmup(node):
        for k, v in node.items():
            if isinstance(v, dict):
                past_warmup(v)
            elif k == "steps":
                node[k] = np.int32(750)
    past_warmup(variables["batch_stats"])
    rng = np.random.default_rng(0)
    lut = rng.normal(size=(2, c, c)).astype(np.float32)
    lut /= np.linalg.norm(lut, axis=2, keepdims=True)
    images = rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8)
    labels = np.repeat(np.arange(0, 4 * 37, 37)[:b // 4], 4).astype(
        np.int32)
    cams = (np.arange(b) % N_CAMS).astype(np.int32)
    draws = augment_draws(torch.Generator().manual_seed(1), b, *hw,
                          device="cpu")
    out = {}

    def one_step(dev):
        plr = backbone == "plr_osnet"
        if plr:
            # the dual-branch step: both branches' centers and tables, the
            # images fed normalized, as the PLR loop takes them
            state = create_plr_train_state(cfg, 100,
                                           torch.Generator().manual_seed(2),
                                           device=dev)
            model = state.model
            load_flax_variables(model, variables)
            state.opt_state = state.tx.init(state.params())
            for br in ("loss1", "loss2"):
                setattr(state, br, getattr(state, br)._replace(
                    dcc=DCCState(*(torch.from_numpy(t).to(dev)
                                   for t in lut))))
            batch = {"images": torch.from_numpy(
                (images.astype(np.float32) / 255 - 0.45) / 0.225).to(dev),
                "labels": torch.from_numpy(labels).to(dev)}
            step = make_plr_train_step(cfg)
        else:
            model = build_model(backbone, c, dtype=torch.float32,
                                device=dev, renorm=renorm, **extra)
            load_flax_variables(model, variables)
            state = create_train_state(model, cfg, 100,
                                       torch.Generator().manual_seed(2))
            state.loss_state = state.loss_state._replace(dcc=DCCState(
                *(torch.from_numpy(t).to(dev) for t in lut)))
            batch = {"images": torch.from_numpy(images).to(dev),
                     "labels": torch.from_numpy(labels).to(dev),
                     "aug_draws": {k: v.to(dev) for k, v in draws.items()}}
            if backbone == "vit":
                batch["cams"] = torch.from_numpy(cams).to(dev)
            step = make_train_step(cfg)
        start = [p.detach().clone() for p in model.parameters()]
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        losses = [state.loss1, state.loss2] if plr else [state.loss_state]
        return dict(
            loss=loss, s=time.perf_counter() - t0,
            mu=torch.cat([t.ravel() for t in state.opt_state["mu"]])
            .cpu().double(),
            update=torch.cat([(p.detach() - s).ravel() for p, s in zip(
                model.parameters(), start)]).cpu().double(),
            stats=[t.cpu() for t in model.buffers()],
            centers=torch.cat([ls.centers.ravel() for ls in losses]).cpu(),
            dcc=[t.cpu() for ls in losses for t in ls.dcc])

    runs = [("cpu", True), ("cuda", True)] + (
        [("cpu_aten", False)] if spread else [])
    with full_f32():
        for name, mkldnn in runs:
            dev = "cuda" if name == "cuda" else "cpu"
            with torch.backends.mkldnn.flags(enabled=mkldnn):
                out[name] = one_step(dev)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    def apart(got, want):
        u_g, u_c = got["update"], want["update"]
        return dict(
            grad_rel_norm=float((got["mu"] - want["mu"]).norm()
                                / want["mu"].norm()),
            update_cosine=float(u_g @ u_c / (u_g.norm() * u_c.norm())),
            update_rel_norm=float((u_g - u_c).norm() / u_c.norm()))
    cpu, card = out["cpu"], out["cuda"]
    u_c, u_g = cpu["update"], card["update"]
    res = dict(
        loss_card=card["loss"], loss_cpu=cpu["loss"],
        loss_rel=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
        **apart(card, cpu),
        params_max_abs_diff=float((u_g - u_c).abs().max()),
        batch_stats_rel=max(rel(a, b) for a, b in zip(card["stats"],
                                                      cpu["stats"])),
        centers_rel=rel(card["centers"], cpu["centers"]),
        dcc_rel=max(rel(a, b) for a, b in zip(card["dcc"], cpu["dcc"])),
        cpu_step_s=cpu["s"])
    limits = dict(grad_rel_norm=1e-3, update_cosine=0.9994,
                  update_rel_norm=0.035)
    if spread:
        cpu_cpu = apart(out["cpu_aten"], cpu)
        limits = dict(
            grad_rel_norm=max(1e-3, 2 * cpu_cpu["grad_rel_norm"]),
            update_cosine=min(0.9994,
                              1 - 2 * (1 - cpu_cpu["update_cosine"])),
            update_rel_norm=max(0.035, 2 * cpu_cpu["update_rel_norm"]))
        res.update(cpu_spread=cpu_cpu, cpu_aten_step_s=out["cpu_aten"]["s"])
    res["limits"] = limits
    emit("train step card vs cpu" + ("" if backbone == "seres18"
                                     else f" {backbone}")
         + (" --renorm" if renorm else ""),
         backbone=backbone, renorm=renorm, batch=b, classes=c,
         hw=list(hw), **res)
    assert res["loss_rel"] <= 1e-4, res
    assert res["grad_rel_norm"] <= limits["grad_rel_norm"], res
    assert res["update_cosine"] >= limits["update_cosine"] and \
        res["update_rel_norm"] <= limits["update_rel_norm"], res
    assert max(res["batch_stats_rel"], res["centers_rel"],
               res["dcc_rel"]) <= 1e-3, res


# the continual epoch's depth cut for the smoke's time limit: every
# CONTINUAL_EVERY-th record of the merged split (4, then 12 before)
CONTINUAL_EVERY = 24


def phase_continual(state, cfg, source, tmp):
    """`produce_pseudo_data` on a synthetic DukeMTMC-sized target (16,522
    images of 702 ids at 256x128, on disk), dense search plan (K6 ranks,
    K7 sums), then `train_continual` for one epoch over every
    CONTINUAL_EVERY-th record of the merged split;
    K6/K7 launches zeroed just before and read just after. Then K6's first
    query block and a 1,024-row slab of K7's min-sum, as the run computed
    them, against their plain versions on the run's own operands, at phase
    9's tolerances; and the Jaccard again with the default "auto" plan,
    timed and held against the dense one. Returns the launch counts and
    each kernel's check on this path."""
    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.config import RetrievalConfig
    from reid_tpu_torch.data.dataset import ReIDDataset
    from reid_tpu_torch.data.datasets import build_dataset
    from reid_tpu_torch.ops import _lib, rerank
    from reid_tpu_torch.ops import distance as dist
    from reid_tpu_torch.train import image_train

    # written with the training tree (`write_data`); data_s reads it
    duke = os.path.join(tmp, "duke")
    t0 = time.perf_counter()
    raw = build_dataset("dukemtmc", duke, verbose=False)
    target = ReIDDataset(raw.train, raw.num_train_pids, 256, 128)
    data_s = time.perf_counter() - t0
    cfg = cfg.replace(retrieval=RetrievalConfig(search_option="dense"))
    jac_s, jac_args, seen = [], [], {}

    def timed_jaccard(fn):
        def jaccard(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            jac_s.append(time.perf_counter() - t)
            jac_args.append((a, k))
            return out
        return jaccard

    def first_call(name, rows):
        """The kernel's operands at its first call and the first `rows`
        rows of its output, copied before the caller reuses it in place
        (the min-sum's output becomes J)."""
        def wrap(fn):
            def kernel(x, y):
                out = fn(x, y)
                if name not in seen:
                    seen[name] = (x[:rows], y, out[:rows].clone())
                return out
            return kernel
        return wrap
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    with patched(rerank, "jaccard_distance", timed_jaccard), \
            patched(dist, "sqeuclidean", first_call("sqeuclidean", 1024)), \
            patched(dist, "l1", first_call("l1", 1024)):
        records, centroids, k = image_train.produce_pseudo_data(
            state, target, cfg)
    torch.cuda.synchronize()
    pseudo_s = time.perf_counter() - t0
    # includes V (N x N f32), held past the call for the check below
    pseudo_peak = torch.cuda.max_memory_allocated()
    # depth cut for the smoke's clock: the epoch runs over every
    # CONTINUAL_EVERY-th record of the source split and of the pseudo
    # records (all 751 + k classes stay)
    source = ReIDDataset(source.records[::CONTINUAL_EVERY],
                         source.num_train_pids, source.height, source.width)
    t0 = time.perf_counter()
    state, losses = image_train.train_continual(
        cfg, state, source, records[::CONTINUAL_EVERY], centroids, k,
        epochs=1, ckpt_dir=os.path.join(tmp, "ckpt_continual"))
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    continual_s = time.perf_counter() - t0

    checks = {}
    with full_f32(), torch.inference_mode():
        for name, plain, tol in (("sqeuclidean", dist.sqeuclidean_plain,
                                  1e-4),
                                 ("l1", dist.l1_plain, 1e-5)):
            x, y, got = seen.pop(name)
            want = plain(x, y)
            err = (got - want).abs()
            assert bool((err <= tol + tol * want.abs()).all()), \
                (name, err.max())
            checks[name] = dict(site=[x.shape[0], y.shape[0], x.shape[1]],
                                max_abs_err=err.max().item())
            del x, y, got, want, err
        torch.cuda.empty_cache()
        (feats,), kw = jac_args.pop()
        dense = rerank.jaccard_distance(feats, **kw)
        kw = dict(kw, search_option="auto")
        torch.cuda.synchronize()
        t = time.perf_counter()
        auto = rerank.jaccard_distance(feats, **kw)
        torch.cuda.synchronize()
        auto_s = time.perf_counter() - t
        auto_vs_dense = (auto - dense).abs().max().item()
        del feats, dense, auto
    torch.cuda.empty_cache()
    n = len(target)
    emit("continual pseudo-label", target_images=n, target_ids=DUKE_IDS,
         data_s=data_s, clusters=k, pseudo_images=len(records),
         jaccard_s=jac_s, jaccard_auto_plan_s=auto_s,
         auto_vs_dense_max_abs=auto_vs_dense, pseudo_label_s=pseudo_s,
         dense_jaccard_gb=n * n * 4 / 1e9, peak_mem_gb_pseudo=pseudo_peak /
         1e9, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         continual_s=continual_s, continual_images=len(source),
         continual_losses=losses,
         classes=int(state.model.classifier.weight.shape[0]),
         launches=counts, kernel_checks=checks)
    assert k >= 0.2 * DUKE_IDS and len(jac_s) == 1
    assert all(np.isfinite(losses))
    # the two plans sum the same min-sums in their own orders
    assert auto_vs_dense <= 1e-4, auto_vs_dense
    for name in ("sqeuclidean", "l1"):
        assert counts.get(name, 0) > 0, (name, counts)
    return counts, checks


# The torchvision-style ResNets. K1 at one site of each of
# resnet50's three stages with channels that are multiples of 128 (the
# other sites of a stage share the shape), and at baseline's
# layer4_0.conv1, K1's one call with Cin != Cout: (backbone, module path,
# per-image H, W, Cin, Cout at 256x128 crops). ZOO_K1_COUNT: the stride-1
# 3x3 convs with Cin and Cout multiples of 128, each backbone's K1 sites.
ZOO_K1_SITES = [("resnet50", "layer2_1/conv2", (32, 16, 128, 128)),
                ("resnet50", "layer3_1/conv2", (16, 8, 256, 256)),
                ("resnet50", "layer4_0/conv2", (16, 8, 512, 512)),
                ("baseline", "layer4_0/conv1", (16, 8, 256, 512))]
ZOO_K1_COUNT = {"baseline": 10, "resnet50": 11, "agw": 11}
ZOO_TRAIN_IDS = 64
# the frames of the resnet50 / cares18 / emares18 track phases (17, 22),
# cut from 64 to keep the whole smoke inside its time limit: two chunks of
# 32 and 16, three embed calls with the probe's
ZOO_TRACK_FRAMES = 48
# the SERes18 family's other block attentions: K1 on the 10 stride-1 3x3
# convs with Cin and Cout multiples of 128, K2 on none (it fuses the SE
# gate only)
ATTN_K1_SITES = [("cares18", "block22/conv1", (32, 16, 128, 128)),
                 ("emares18", "block41/conv1", (16, 8, 256, 512))]
ATTN_K1_COUNT = {"cares18": 10, "emares18": 10}
# OSNet and PLR-OSNet: no 3x3 conv with groups 1 past the stem, so K1 and
# K2 take none of their convs
OSNET_BACKBONES = ("osnet", "plr_osnet")
# PLR-OSNet's train steps at the training operating point: timed steps
# after PLR_WARM untimed ones
PLR_BATCH, PLR_WARM, PLR_STEPS = 64, 2, 6
# ViT-t and Swin-T: their feature width (the train step's feat_dim) and
# the input size the JAX package gives them for Market and Duke
TRANSFORMER_WIDTH = {"vit": 384, "swin_v1": 96, "swin_v2": 96}
TRANSFORMER_HW = (448, 224)
# phase 29's runs of each transformer, and phase 32's backbones
TRANSFORMER_TRACK = {"vit": ("bf16", "int8"), "swin_v1": ("bf16", "int8"),
                     "swin_v2": ("bf16",)}
TRANSFORMER_STEP = ("vit", "swin_v1")


def nonzero_w_bn(model, seed=3, std=0.1):
    """agw's non-local blocks with `w_bn` scales drawn from N(0, std): at
    their init (zeros) the blocks are the identity."""
    import torch
    from reid_tpu_torch.models.baseline import NonLocalBlock
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, NonLocalBlock):
                m.w_bn.weight.copy_(torch.randn(
                    m.w_bn.weight.shape, generator=gen) * std)
    return model


def phase_zoo_kernels(kind, crops, table=None, counts=None):
    """K1 at the sites of `table` (ZOO_K1_SITES) on the inputs that
    embedding `crops` (B = 2048) through the quantized bf16 trunk gives
    them: exact against the plain version and timed as in phase 3; the K1
    route on exactly `counts` (ZOO_K1_COUNT) convs of each trunk and no
    fused SE block."""
    import torch
    from reid_tpu_torch.utils.quantize import QSEBasicBlock, quantize_input

    table = ZOO_K1_SITES if table is None else table
    counts = ZOO_K1_COUNT if counts is None else counts
    rows = []
    for backbone in dict.fromkeys(b for b, _, _ in table):
        sites = [(p, shp) for b, p, shp in table if b == backbone]
        qm, seen = quantized_trunk(crops.device, torch.bfloat16, crops[:32],
                                   crops, backbone=backbone,
                                   sites=[p for p, _ in sites])
        routed = [n for n, m in qm.named_modules()
                  if getattr(m, "route", False)]
        assert len(routed) == counts[backbone], routed
        assert not any(isinstance(m, QSEBasicBlock) for m in qm.modules())
        with torch.inference_mode():
            for site, (h, w, cin, cout) in sites:
                mod = qm.get_submodule(site.replace("/", "."))
                assert mod.route, site
                xq = quantize_input(seen[site], mod.sx).contiguous()
                assert tuple(xq.shape[1:]) == (h, w, cin), xq.shape
                row, got = k1_row(kind, mod, xq, torch.bfloat16,
                                  f"conv3x3_s8 {backbone} {site}",
                                  f"track {backbone} --int8")
                rows.append(row)
                del got, xq
        del qm, seen
        torch.cuda.empty_cache()
    return rows


def phase_track_zoo(tmp, scene, chunk, backbone="resnet50",
                    k1_per_call=None, k1=True, crop_hw=(256, 128),
                    modes=("bf16", "int8")):
    """The track path with `--backbone backbone` at phase 4's operating
    point on `scene` (`write_scene`'s frames directory and det.txt, written
    once for every backbone) with `crop_hw` crops, --chunk `chunk`, its
    track files written into `tmp`: the default bf16 embed
    (no kernel of ours) and `--int8` (K1 at the backbone's sites, no fused
    block; without `k1`, no launch of K1 or K2 at all), as `modes` names
    them; fps, the stage split and peak device memory of each. With
    `k1_per_call`, K1's launches must be exactly that many an embed call
    (the calls counted at the 256 -> 512 site, which each trunk of the
    SERes18 family has once). Returns the last mode's run."""
    import torch

    fdir, det = scene
    base = ["--detections", det, "--frames_dir", fdir, "--backbone",
            backbone, "--max_dets", "64", "--num_classes", "751",
            "--crop_hw", *map(str, crop_hw), "--chunk", str(chunk)]
    runs = {}
    for mode in modes:
        torch.cuda.reset_peak_memory_stats()
        run = run_track(base + (["--int8"] if mode == "int8" else [])
                        + ["--save_txt", os.path.join(tmp, mode + ".txt")])
        run["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        run.pop("affines")
        if mode == "int8" and k1_per_call:
            calls = run["site_launches"].get(
                "conv3x3_s8 [16, 8, 256, 512]", 0)
            run.update(embed_calls=calls,
                       k1_per_embed_call=run["launches"].get(
                           "conv3x3_s8", 0) / max(calls, 1),
                       k2_launches=run["launches"].get(
                           "se_basic_block_s8", 0))
        emit(f"track {backbone} {mode}", chunk=chunk, **run)
        assert run["rows"] > 0 and run["distinct_ids"] >= 40, run
        runs[mode] = run
    assert not runs["bf16"]["launches"], runs["bf16"]["launches"]
    if not k1:
        launches = runs[modes[-1]]["launches"]
        assert launches.get("conv3x3_s8", 0) == 0, launches
        assert launches.get("se_basic_block_s8", 0) == 0, launches
        return runs[modes[-1]]
    assert runs["int8"]["launches"].get("conv3x3_s8", 0) > 0, runs["int8"]
    assert "se_basic_block_s8" not in runs["int8"]["launches"]
    if k1_per_call:
        r = runs["int8"]
        assert r["embed_calls"] >= 3 and \
            r["k1_per_embed_call"] == k1_per_call, r["launches"]
    return runs["int8"]


# crops of the zoo's card-vs-CPU embeds (16 before: the smoke's clock)
EMBED_CROPS = 8


def phase_zoo_embed(card_vs_cpu=("baseline", "agw"), int8_counts=None,
                    label="embed zoo", int8_cosine=0.95, hw=(256, 128)):
    """Eval mode, card against CPU: the `card_vs_cpu` backbones (agw with
    its non-local `w_bn` non-zero) in bf16 embed the same EMBED_CROPS crops on
    both, [feat || logits] held by cosine (>= 0.999 a row) and by the
    largest difference (within 2^-5 of the largest magnitude). Then the
    `--int8` embed (the track CLI's `build_embed`) against the f32 embed
    of the same weights on the card, for each backbone of `int8_counts`
    (ZOO_K1_COUNT): cosine >= `int8_cosine` a row, and exactly its count
    of K1 launches in its int8 embed call and none of K2's. A dual-head
    model (PLR-OSNet) embeds its feature alone. The crops are `hw` (the
    transformers': 448x224). Returns each backbone's launches at its call
    sites in that call."""
    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.ops import _lib
    from reid_tpu_torch.utils.flax_bridge import save_npz, flax_variables

    crops = torch.randn((EMBED_CROPS, *hw, 3),
                        generator=torch.Generator().manual_seed(1))
    res = {}

    def embed(model, x):
        f, lg = model(x)
        if isinstance(lg, tuple):
            return f.float()
        return torch.cat([f.float(), lg.float()], 1)

    int8_counts = ZOO_K1_COUNT if int8_counts is None else int8_counts
    with torch.inference_mode():
        for backbone in card_vs_cpu:
            cpu = build_model(backbone, N_CLASSES, dtype=torch.bfloat16,
                              device="cpu")
            if backbone == "agw":
                nonzero_w_bn(cpu)
            card = build_model(backbone, N_CLASSES, dtype=torch.bfloat16,
                               device="cuda")
            card.load_state_dict(cpu.state_dict())
            e_c = embed(cpu, crops)
            e_g = embed(card, crops.cuda()).cpu()
            cos = torch.nn.functional.cosine_similarity(e_c, e_g, dim=1)
            rel = ((e_g - e_c).abs().max() / e_c.abs().max()).item()
            res[f"{backbone}_card_vs_cpu"] = dict(
                min_cosine=cos.min().item(), max_rel_err=rel)
            del cpu, card
    site_sets = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backbone in int8_counts:
            model = build_model(backbone, N_CLASSES, dtype=torch.float32,
                                device="cpu")
            if backbone == "agw":
                nonzero_w_bn(model)
            ckpt = os.path.join(tmp, backbone + ".npz")
            save_npz(ckpt, flax_variables(model))
            model = model.cuda()
            with torch.inference_mode(), cli.full_f32():
                f32 = embed(model, crops.cuda())
                fn, _ = cli.build_embed(backbone, N_CLASSES, hw,
                                        "cuda", ckpt=ckpt, int8=True)
                torch.cuda.synchronize()
                _lib.reset_launch_counts()
                got = fn(crops.cuda())
                torch.cuda.synchronize()
                site_sets[backbone] = {
                    f"{n} {list(sh)}": c for (n, sh), c in
                    _lib.site_launch_counts().items()}
            want = f32 / f32.norm(dim=1, keepdim=True)
            cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
            res[f"{backbone}_int8_vs_f32"] = dict(
                min_cosine=cos.min().item(), mean_cosine=cos.mean().item(),
                k1_launches=sum(c for k, c in site_sets[backbone].items()
                                if k.startswith("conv3x3_s8")))
            del model, fn
    torch.cuda.empty_cache()
    emit(label, crops=EMBED_CROPS, **res)
    for backbone in card_vs_cpu:
        r = res[f"{backbone}_card_vs_cpu"]
        assert r["min_cosine"] >= 0.999 and r["max_rel_err"] <= 2 ** -5, r
    for backbone, n in int8_counts.items():
        r = res[f"{backbone}_int8_vs_f32"]
        assert r["k1_launches"] == n and r["min_cosine"] >= int8_cosine, r
        assert not any(k.startswith("se_basic_block_s8")
                       for k in site_sets[backbone])
    return site_sets


def phase_train_zoo(tmp, backbone="resnet50", renorm=False):
    """`cli.train_main --backbone backbone [--renorm]` on the card: one
    epoch of a synthetic Market-shaped tree of ZOO_TRAIN_IDS ids x
    TRAIN_PER_ID images (8 steps of --bs 64 --instance 4, bf16,
    256x128), written once for the phases that train on it: step period
    on the device's clock, images/s, peak memory, the logged loss; with
    `renorm`, every BatchRenorm's `steps` counter at the steps taken. The
    state and the run's batches for `step_profile`."""
    import copy
    import statistics

    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.data.datasets import write_synthetic_tree
    from reid_tpu_torch.train import image_train

    from reid_tpu_torch.models.layers import BatchRenorm

    market = os.path.join(tmp, "market_zoo")
    if not os.path.isdir(market):
        write_synthetic_tree(market, "market1501", ZOO_TRAIN_IDS,
                             TRAIN_PER_ID, query_per_id=1, gallery_per_id=2)
    clock = TrainClock()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(image_train, "make_train_step", clock.make_step), \
            patched(image_train, "make_train_loader", clock.make_loader), \
            patched(image_train, "train_cnn", clock.train_cnn):
        state = cli.train_main(
            ["--root", market, "--backbone", backbone, "--epochs", "1",
             "--bs", "64", "--instance", "4"]
            + (["--renorm"] if renorm else []), device="cuda",
            ckpt_dir=os.path.join(tmp, "ckpt_zoo"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cfg, dataset, losses = clock.calls[0]
    steps = clock.step_ms()
    med = statistics.median(steps)
    assert all(np.isfinite(losses)), losses
    for p in state.model.parameters():
        assert bool(torch.isfinite(p).all())
    counters = [int(m.steps) for m in state.model.modules()
                if isinstance(m, BatchRenorm)]
    assert len(counters) == (20 if renorm else 0), counters
    assert set(counters) <= {len(clock.events)}, counters
    emit(f"train {backbone}{' --renorm' if renorm else ''} bf16",
         ids=ZOO_TRAIN_IDS, images=len(dataset), renorm_steps=counters[:1],
         batch=64, steps=len(clock.events), wall_s=wall,
         step_ms_median=med, step_ms_min=min(steps),
         step_ms_max=max(steps), images_per_s=64 * 1e3 / med,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         losses=losses)
    return copy.deepcopy(state), cfg, clock.batches, med


def phase_train_plr(instances):
    """PLR-OSNet's dual-branch train step (`train/plr_train.py`) on the
    card at 256x128, a batch of PLR_BATCH in bf16 with N_CLASSES classes:
    MADGRAD without PK sampling (`instances` 0), Adam with it (16 ids x 4).
    Four kept batches of normalized images made on the card; PLR_WARM
    untimed steps, then PLR_STEPS timed by CUDA events between steps
    (median, min, max), images/s and peak memory; then `step_profile`
    (the sync check, launches and device time a step) and the idle share.
    Returns the emitted numbers."""
    import statistics

    import torch
    from reid_tpu_torch.config import Config, ModelConfig, TrainConfig
    from reid_tpu_torch.train.plr_train import (create_plr_train_state,
                                                make_plr_train_step)

    b = PLR_BATCH
    cfg = Config(model=ModelConfig(backbone="plr_osnet",
                                   num_classes=N_CLASSES),
                 train=TrainConfig(batch_size=b, num_instances=instances))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = create_plr_train_state(cfg, 200, device="cuda")
    step = make_plr_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(11)
    batches = []
    for i in range(4):
        ids = torch.randperm(N_CLASSES, generator=gen, device="cuda")
        labels = ids[:b // 4].repeat_interleave(4) if instances else \
            torch.randint(0, N_CLASSES, (b,), generator=gen, device="cuda")
        batches.append({"images": torch.randn((b, 256, 128, 3),
                                              generator=gen, device="cuda"),
                        "labels": labels.to(torch.int32)})
    for i in range(PLR_WARM):
        state, m = step(state, batches[i % 4])
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(PLR_STEPS + 1)]
    events[0].record()
    losses = []
    for i in range(PLR_STEPS):
        state, m = step(state, batches[i % 4])
        events[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = [a.elapsed_time(e) for a, e in zip(events, events[1:])]
    losses = [float(x) for x in losses]
    assert all(np.isfinite(losses)), losses
    assert all(bool(torch.isfinite(p).all()) for p in state.params())
    med = statistics.median(ms)
    kind = "madgrad" if instances == 0 else "adam"
    res = dict(optimizer=kind, batch=b, classes=N_CLASSES, hw=[256, 128],
               steps=PLR_STEPS, step_ms_median=med, step_ms_min=min(ms),
               step_ms_max=max(ms), images_per_s=b * 1e3 / med,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses)
    # two traced steps: ~12,000 launches a step make the trace slow
    prof = step_profile(state, cfg, batches, reps=2, step=step,
                        name=f"train_step_plr_{kind}")
    res.update(prof, device_idle_share=1 - prof["device_ms_per_step"] / med)
    emit(f"train plr_osnet {kind}", **res)
    del state, batches
    torch.cuda.empty_cache()
    return res


def market_splits(hw=(256, 128), part=1):
    """Query and gallery of Market-1501's size at `hw` (448x224 for the
    transformers): 3,368 and 19,732 images of 750 ids (with `part`,
    1 / part of each), each identity's copies cycling over the 6
    cameras, the queries' 3 cameras after the gallery's. The pixels are drawn on the card: each identity's colour
    from one palette plus uniform noise in [-25, 25), as
    `synthetic_dataset` makes them (its host generator takes 24 s at
    256x128). Returns (query, gallery, seconds)."""
    import torch
    from reid_tpu_torch.data.dataset import ReIDDataset

    gen = torch.Generator("cuda").manual_seed(5)
    palette = torch.randint(40, 220, (N_IDS, 3), generator=gen,
                            device="cuda", dtype=torch.int16)

    def make(n, shift):
        images = np.empty((n, *hw, 3), np.uint8)
        pids = np.arange(n) % N_IDS
        for s0 in range(0, n, 2048):
            e = min(n, s0 + 2048)
            v = torch.randint(-25, 25, (e - s0, *hw, 3), generator=gen,
                              device="cuda", dtype=torch.int16)
            v += palette[torch.as_tensor(pids[s0:e], device="cuda")][
                :, None, None]
            images[s0:e] = v.clamp_(0, 255).to(torch.uint8).cpu().numpy()
        records = [(f"<synthetic-{i}>", int(pids[i]),
                    (i // N_IDS + shift) % N_CAMS, 0) for i in range(n)]
        return ReIDDataset(records, N_IDS, *hw).preload(images)

    t0 = time.perf_counter()
    query, gallery = make(N_QUERY // part, 3), make(N_GALLERY // part, 0)
    return query, gallery, time.perf_counter() - t0


def phase_train_transformer(backbone, instances):
    """The transformer train step (`train.steps.make_train_step`, the
    library the JAX package can run: `cfg.model.feat_dim` at the model's
    width, `train_main` refuses these backbones) on the card at 448x224,
    a batch of PLR_BATCH in bf16 with N_CLASSES classes, dropout 0.1
    drawn on the card: plain SGD without momentum under PK sampling
    (`instances` 4: 16 ids x 4), Adam without (0); ViT with cams (its
    SIE table), Swin without. Timed and traced as `phase_train_plr` (one
    traced step: a traced step takes ~4 s): ms a step on the device's
    clock (median, min, max), images/s, peak memory, the sync check,
    launches and device time a step, the idle share."""
    import statistics

    import torch
    from reid_tpu_torch.config import Config, ModelConfig, TrainConfig
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.train.state import create_train_state
    from reid_tpu_torch.train.steps import make_train_step

    b = PLR_BATCH
    cfg = Config(model=ModelConfig(backbone=backbone, num_classes=N_CLASSES,
                                   feat_dim=TRANSFORMER_WIDTH[backbone]),
                 train=TrainConfig(batch_size=b, num_instances=instances))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(backbone, N_CLASSES, dtype=torch.bfloat16,
                        device="cuda", input_hw=TRANSFORMER_HW)
    state = create_train_state(model, cfg, 200,
                               torch.Generator().manual_seed(2))
    assert state.tx.adam == (instances == 0) and not state.tx.momentum
    step = make_train_step(cfg, generator=torch.Generator("cuda")
                           .manual_seed(11))
    gen = torch.Generator(device="cuda").manual_seed(11)
    batches = []
    for i in range(4):
        ids = torch.randperm(N_CLASSES, generator=gen, device="cuda")
        labels = ids[:b // 4].repeat_interleave(4) if instances else \
            torch.randint(0, N_CLASSES, (b,), generator=gen, device="cuda")
        batch = {"images": torch.randn((b, *TRANSFORMER_HW, 3),
                                       generator=gen, device="cuda"),
                 "labels": labels.to(torch.int32)}
        if backbone == "vit":
            batch["cams"] = torch.randint(0, N_CAMS, (b,), generator=gen,
                                          device="cuda")
        batches.append(batch)
    for i in range(PLR_WARM):
        state, m = step(state, batches[i % 4])
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(PLR_STEPS + 1)]
    events[0].record()
    losses = []
    for i in range(PLR_STEPS):
        state, m = step(state, batches[i % 4])
        events[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = [a.elapsed_time(e) for a, e in zip(events, events[1:])]
    losses = [float(x) for x in losses]
    assert all(np.isfinite(losses)), losses
    assert all(bool(torch.isfinite(p).all()) for p in state.params())
    med = statistics.median(ms)
    kind = "adam" if instances == 0 else "sgd"
    res = dict(optimizer=kind, batch=b, classes=N_CLASSES,
               hw=list(TRANSFORMER_HW), cams=backbone == "vit",
               steps=PLR_STEPS, step_ms_median=med, step_ms_min=min(ms),
               step_ms_max=max(ms), images_per_s=b * 1e3 / med,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses)
    prof = step_profile(state, cfg, batches, reps=1, step=step,
                        name=f"train_step_{backbone}_{kind}")
    res.update(prof, device_idle_share=1 - prof["device_ms_per_step"] / med)
    emit(f"train {backbone} {kind}", **res)
    del state, batches
    torch.cuda.empty_cache()
    return res


# the video operating point (`video_main`'s defaults: bs 8, seq_len 10,
# 256x128 crops, bf16, video_resnet50): a MOT16-shaped tree of two
# sequences of 1920x1080 JPEG frames, VIDEO_IDS pedestrian tracks (half a
# sequence) and one distractor track (class 7) a sequence, one epoch of
# VIDEO_IDS / 8 steps (of the CLI's 25); the step alone on one kept batch,
# VIDEO_WARM untimed then VIDEO_STEPS timed
VIDEO_IDS, VIDEO_FRAMES, VIDEO_WARM, VIDEO_STEPS = 32, 24, 3, 10


def write_mot_tree(root, n_ids=VIDEO_IDS, n_frames=VIDEO_FRAMES, seed=0):
    """Two MOT16 sequences under `root` (MOT16-02, MOT16-04): 1080p JPEG
    frames of a textured background with person-shaped boxes painted on,
    and gt.txt grouped by track id (the relabelling needs it): n_ids / 2
    pedestrians a sequence, each in a run of 12-`n_frames` frames, and one
    distractor (class 7) in every frame. Returns the gt.txt paths."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths = []
    for name in ("MOT16-02", "MOT16-04"):
        seq = os.path.join(root, name)
        os.makedirs(os.path.join(seq, "gt"))
        os.makedirs(os.path.join(seq, "img1"))
        n = n_ids // 2
        hs = np.exp(rng.uniform(np.log(80), np.log(320), n + 1))
        ws = hs * 0.41
        xs = rng.uniform(0, 1920 - ws - 1)
        ys = rng.uniform(0, 1080 - hs - 1)
        first = rng.integers(1, n_frames - 11, n + 1)
        last = np.minimum(first + rng.integers(11, n_frames, n + 1),
                          n_frames)
        first[-1], last[-1] = 1, n_frames
        colors = rng.integers(40, 255, (n + 1, 3), dtype=np.uint8)
        bg = textured_background(rng, 1080, 1920, grain=8)
        for t in range(1, n_frames + 1):
            frame = bg.copy()
            for j in range(n + 1):
                if first[j] <= t <= last[j]:
                    frame[int(ys[j]):int(ys[j] + hs[j]),
                          int(xs[j]):int(xs[j] + ws[j])] = colors[j]
            Image.fromarray(frame).save(
                os.path.join(seq, "img1", f"{t:06d}.jpg"), quality=90)
        rows = [f"{t},{j + 1},{xs[j]:.2f},{ys[j]:.2f},{ws[j]:.2f},"
                f"{hs[j]:.2f},1,{7 if j == n else 1},1"
                for j in range(n + 1) for t in range(first[j], last[j] + 1)]
        path = os.path.join(seq, "gt", "gt.txt")
        with open(path, "w") as f:
            f.write("\n".join(rows) + "\n")
        paths.append(path)
    return paths


def conv_flops(model, x):
    """Multiply-adds x 2 of the convs and dense layers of one forward of
    `model` on `x` (from their output shapes)."""
    import torch
    from reid_tpu_torch.models.layers import Conv3d, Linear

    total = [0]

    def hook(m, inp, out):
        if isinstance(m, Conv3d):
            k = int(np.prod(m.kernel_size)) * m.in_channels
        else:
            k = m.in_features
        total[0] += 2 * out.numel() * k
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv3d, Linear))]
    try:
        with torch.no_grad():
            model(x, train=False)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def phase_video_train(tmp):
    """`cli.video_main` itself at its defaults (bs 8, seq_len 10, 256x128,
    bf16, the 3-D video_resnet50 with 32 classes) for one epoch of 4 steps
    on a synthetic MOT16-shaped tree (`write_mot_tree`); the loader cuts
    each crop from its whole decoded 1080p JPEG frame, as the reference
    does. Reports the step period on the device's clock (CUDA events
    after each step), the loader's host seconds a step, peak memory and
    the losses (finite). Then, on the run's state and its last batch: the
    step alone (median of VIDEO_STEPS after VIDEO_WARM), then
    `step_profile`: one step under torch.cuda's sync debug mode "error"
    (no host read, no host copy) and two traced steps for launches and
    device time a step, and the idle share; the forward's conv and dense
    FLOP (x3 for a step) over the step alone."""
    import statistics

    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.train import video_train

    root = os.path.join(tmp, "mot16")
    t0 = time.perf_counter()
    gts = write_mot_tree(root)
    data_s = time.perf_counter() - t0
    events, waits, kept = [], [], {}
    make, batches = video_train.make_video_train_step, \
        video_train.VideoTrackletDataset.batches

    def make_step(cfg, **kw):
        step = make(cfg, **kw)

        def timed(state, batch):
            out = step(state, batch)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            kept.update(state=state, batch=batch, step=step)
            return out
        return timed

    def timed_batches(self, batch_size, rng):
        it = batches(self, batch_size, rng)
        while True:
            t = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            waits.append(time.perf_counter() - t)
            yield b
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    train_video = video_train.train_video

    def keep_losses(*a, **k):
        v, ls = train_video(*a, **k)
        losses.extend(ls)
        return v, ls
    t0 = time.perf_counter()
    with patched(video_train, "make_video_train_step", lambda _: make_step), \
            patched(video_train.VideoTrackletDataset, "batches",
                    lambda _: timed_batches), \
            patched(video_train, "train_video", lambda _: keep_losses):
        variables = cli.video_main(["--gt_paths", *gts, "--prefix", root,
                                    "--epochs", "1"], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    assert len(losses) == VIDEO_IDS // 8 and all(np.isfinite(losses)), \
        losses
    assert variables["params"]["classifier"]["kernel"].shape == (2048,
                                                                  VIDEO_IDS)
    period = [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    state, batch, step = kept["state"], kept["batch"], kept["step"]
    for _ in range(VIDEO_WARM):
        step(state, batch)
    ms = []
    for _ in range(VIDEO_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _, loss = step(state, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    assert np.isfinite(float(loss))
    flop = 3 * conv_flops(state.model, batch["images"])
    med = statistics.median(ms)
    # step_profile's third step runs under the sync debug mode "error"
    prof = step_profile(state, None, [batch] * 3, reps=2, step=step,
                        name="video_train_step")
    emit("video train", ids=VIDEO_IDS, sequences=2, frames=VIDEO_FRAMES,
         batch=8, seq_len=10, hw=[256, 128], dtype="bfloat16",
         steps=len(losses), data_s=data_s, wall_s=wall,
         step_period_ms_median=statistics.median(period) if period else None,
         loader_s_per_step=statistics.median(waits),
         loader_s_total=sum(waits),
         step_ms_median=med, step_ms_min=min(ms), step_ms_max=max(ms),
         clips_per_s=8 * 1e3 / med, flop_per_step=flop,
         tflop_per_s=flop / med / 1e9, peak_mem_gb=peak / 1e9,
         losses=losses, **prof,
         device_idle_share=1 - prof["device_ms_per_step"] / med)


def phase_video_card_vs_cpu():
    """One f32 video train step (`make_video_train_step`: the hybrid loss,
    MADGRAD without a clip, the centers' step) from one state on the card
    and on the CPU, `VideoResNet(blocks=(1, 1, 1, 1))` (the model's
    widths, one block a stage) at 2 x 4 x 64 x 32 with 8 classes, TF32
    off: phase 14's limits (the loss 1e-4 relative, the gradient, here
    MADGRAD's first moment sum lr g, within 1e-3 of its norm, the update
    at a cosine >= 0.9994 and within 3.5% of its norm, statistics and
    centers within 1e-3 of their largest magnitude), or twice the CPU's
    own spread between two conv algorithms where that is wider (`spread`,
    as phase 28; here the loss's limit too: at this size the train-mode
    norms of the last stages take 16 values a channel, and the two CPU
    algorithms' losses lie 7.5e-4 apart, the card's 1.1e-3 from the
    CPU's, on an H100). Then the bf16 eval forward of `video_resnet50`
    (751 classes) on 2 clips of 10 x 256 x 128, card against CPU: a
    cosine >= 0.999 a row for the BNNeck feature and the logits."""
    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.config import Config, ModelConfig
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.models.video3d import VideoResNet
    from reid_tpu_torch.train.video_train import (create_video_train_state,
                                                  make_video_train_step)
    from reid_tpu_torch.utils.flax_bridge import (flax_variables,
                                                  load_flax_variables)

    c, shape = 8, (2, 4, 64, 32, 3)
    variables = flax_variables(VideoResNet(
        num_classes=c, blocks=(1, 1, 1, 1)).init_weights(
            torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    images = rng.random(shape, dtype=np.float32)
    labels = np.asarray([0, 5], np.int32)
    cfg = Config(model=ModelConfig(dtype="float32"))

    def one_step(dev):
        model = VideoResNet(num_classes=c, blocks=(1, 1, 1, 1)).to(dev)
        load_flax_variables(model, variables)
        state = create_video_train_state(model, c,
                                         torch.Generator().manual_seed(2))
        start = [p.detach().clone() for p in model.parameters()]
        t0 = time.perf_counter()
        state, loss = make_video_train_step(cfg)(state, {
            "images": torch.from_numpy(images).to(dev),
            "labels": torch.from_numpy(labels).to(dev)})
        loss = float(loss)
        return dict(
            loss=loss, s=time.perf_counter() - t0,
            mu=torch.cat([t.ravel() for t in state.opt_state["grad_sum"]])
            .cpu().double(),
            update=torch.cat([(p.detach() - s).ravel() for p, s in zip(
                model.parameters(), start)]).cpu().double(),
            stats=[t.cpu() for t in model.buffers()],
            centers=state.loss_state.centers.cpu())

    out = {}
    with full_f32():
        for name, mkldnn in (("cpu", True), ("cuda", True),
                             ("cpu_aten", False)):
            dev = "cuda" if name == "cuda" else "cpu"
            with torch.backends.mkldnn.flags(enabled=mkldnn):
                out[name] = one_step(dev)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    def apart(got, want):
        u_g, u_c = got["update"], want["update"]
        return dict(
            grad_rel_norm=float((got["mu"] - want["mu"]).norm()
                                / want["mu"].norm()),
            update_cosine=float(u_g @ u_c / (u_g.norm() * u_c.norm())),
            update_rel_norm=float((u_g - u_c).norm() / u_c.norm()))
    cpu, card = out["cpu"], out["cuda"]
    res = dict(loss_card=card["loss"], loss_cpu=cpu["loss"],
               loss_rel=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
               **apart(card, cpu),
               batch_stats_rel=max(rel(a, b) for a, b in
                                   zip(card["stats"], cpu["stats"])),
               centers_rel=rel(card["centers"], cpu["centers"]),
               cpu_step_s=cpu["s"], cpu_aten_step_s=out["cpu_aten"]["s"])
    spread = apart(out["cpu_aten"], cpu)
    spread["loss_rel"] = abs(out["cpu_aten"]["loss"] - cpu["loss"]) / abs(
        cpu["loss"])
    limits = dict(loss_rel=max(1e-4, 2 * spread["loss_rel"]),
                  grad_rel_norm=max(1e-3, 2 * spread["grad_rel_norm"]),
                  update_cosine=min(0.9994,
                                    1 - 2 * (1 - spread["update_cosine"])),
                  update_rel_norm=max(0.035,
                                      2 * spread["update_rel_norm"]))
    res.update(cpu_spread=spread, limits=limits)

    # the bf16 eval forward at the operating point, card against CPU
    gen = torch.Generator().manual_seed(3)
    cpu_model = build_model("video_resnet50", N_CLASSES,
                            dtype=torch.bfloat16, device="cpu",
                            generator=torch.Generator().manual_seed(4))
    card_model = build_model("video_resnet50", N_CLASSES,
                             dtype=torch.bfloat16, device="cuda")
    load_flax_variables(card_model, flax_variables(cpu_model))
    clips = torch.rand((2, 10, 256, 128, 3), generator=gen)
    with torch.no_grad():
        t0 = time.perf_counter()
        want = cpu_model(clips)
        cpu_s = time.perf_counter() - t0
        got = card_model(clips.to("cuda"))
    cos = [torch.nn.functional.cosine_similarity(
        g.float().cpu(), w.float(), dim=1).min().item()
        for g, w in zip(got, want)]
    res.update(eval_bf16_min_cosine_feature=cos[0],
               eval_bf16_min_cosine_logits=cos[1], eval_cpu_s=cpu_s)
    emit("video card vs cpu", batch=shape[0], seq_len=shape[1],
         hw=list(shape[2:4]), classes=c, **res)
    assert res["loss_rel"] <= limits["loss_rel"], res
    assert res["grad_rel_norm"] <= limits["grad_rel_norm"], res
    assert res["update_cosine"] >= limits["update_cosine"] and \
        res["update_rel_norm"] <= limits["update_rel_norm"], res
    assert max(res["batch_stats_rel"], res["centers_rel"]) <= 1e-3, res
    assert min(cos) >= 0.999, res


# the GAN tree (phases 35-37): GAN_IDS ids of GAN_TRAIN train and
# GAN_GALLERY gallery images at 128x64 (1,008 train + gallery images),
# the ids in two colour families, so that the two k-means groups of
# `gan_main --groups 2` hold about 504 each: 7 batches of 64 a group in
# its one epoch (`--epochs 1`: the depth cut; the default is 120)
GAN_IDS, GAN_TRAIN, GAN_GALLERY = 72, 8, 6
# the detector run (phase 38): frames of phase 4's scene
DET_TRAIN_FRAMES = 16


def write_gan_tree(root, n_ids=GAN_IDS, per_train=GAN_TRAIN,
                   per_gallery=GAN_GALLERY, seed=0):
    """A Market-1501-layout JPEG tree at 128x64 (bounding_box_train,
    query, bounding_box_test): each identity two colours (upper, lower
    half) with +-25 of noise a pixel, even ids warm (red high, blue low)
    and odd ids cool; returns the root."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(seed)
    jobs = []
    for pid in range(1, n_ids + 1):
        c = rng.integers(40, 120, (2, 3))
        c[:, 0 if pid % 2 == 0 else 2] += 120
        for sub, n in (("bounding_box_train", per_train), ("query", 1),
                       ("bounding_box_test", per_gallery)):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            for k in range(n):
                img = rng.integers(-25, 26, (128, 64, 3)) + np.repeat(
                    c, 64, axis=0)[:, None, :]
                jobs.append((os.path.join(
                    root, sub, f"{pid:04d}_c{k % 6 + 1}s1_{k:06d}_00.jpg"),
                    np.clip(img, 0, 255).astype(np.uint8)))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda j: Image.fromarray(j[1]).save(j[0]), jobs))
    return root


class StepClock:
    """Wraps a step maker: a CUDA event after each step of the run (the
    step period on the device's clock, no synchronisation), the number
    of steps, and the last step's function and arguments for a later
    trace."""

    def __init__(self):
        self.events, self.kept = [], {}

    def wrap(self, make):
        import torch

        def make_step(*a, **k):
            made = make(*a, **k)
            init, step = made if isinstance(made, tuple) else (None, made)

            def timed(state, *args):
                out = step(state, *args)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                self.kept.update(step=step, state=state, args=args)
                return out
            return (init, timed) if init else timed
        return make_step

    def periods(self):
        self.events[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events,
                                                  self.events[1:])]


def gan_step_profile(step, state, args, name, reps=3):
    """The kept step alone (median of 5 after 2), one more under the
    sync debug mode "error" (no host read, no host copy), and `reps`
    traced steps: launches and device ms a step, the idle share."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step(state, *args)
    ms = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(state, *args)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step(state, *args)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    device_ms = sum(k[2] for k in kernels) / reps
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
        for kname, n, kms in kernels:
            f.write(f"{kms / reps:10.4f} ms {n / reps:8.1f}x  "
                    f"{kname[:140]}\n")
    med = statistics.median(ms)
    return dict(step_ms_median=med, step_ms_min=min(ms),
                step_ms_max=max(ms), host_syncs_in_step=0,
                launches_per_step=sum(k[1] for k in kernels) / reps,
                device_ms_per_step=device_ms,
                device_idle_share=1 - device_ms / med)


def phase_gan(tmp):
    """Phases 35-37 on one GAN tree (`write_gan_tree`): `cli.gan_main` at
    its defaults (spectral DCGAN, nz 100, ngf = ndf = 64, batch 64,
    128x64) with --groups 2 (colour-pyramid k-means) and --n_images 64,
    one epoch; `gan_main --vae --wasserstein` (the VAE, zdim 128, and the
    Wasserstein D with its gradient penalty), one epoch at batch 64; and
    `cli.lsro_main` (baseline, batch 32) over the train split and the 64
    generated images, one epoch. For each: group sizes, steps, the step
    period on the device's clock, peak memory, the images and
    checkpoints written; then its step alone, the sync check, launches,
    device time and idle share (`gan_step_profile`). K1-K7 launch 0
    times on these paths (counted)."""
    import glob
    import statistics

    import torch
    from reid_tpu_torch import cli, gan
    from reid_tpu_torch.gan import driver
    from reid_tpu_torch.ops import launch_counts, reset_launch_counts
    from reid_tpu_torch.train import optim

    root = os.path.join(tmp, "gan_market")
    t0 = time.perf_counter()
    write_gan_tree(root)
    data_s = time.perf_counter() - t0
    out_dir, ckpt_dir = os.path.join(tmp, "gen"), os.path.join(tmp, "ckpt")
    results = {}

    # 35: DCGAN per appearance group
    clock, groups = StepClock(), {}
    get_groups = gan.get_groups

    def keep_groups(*a, **k):
        groups["labels"] = get_groups(*a, **k)
        return groups["labels"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with patched(driver, "make_dcgan_steps", clock.wrap), \
            patched(gan, "get_groups", lambda _: keep_groups):
        imgs = cli.gan_main(["--root", root, "--epochs", "1", "--groups",
                             "2", "--n_images", "64", "--out", out_dir,
                             "--ckpt_dir", ckpt_dir], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    sizes = np.bincount(groups["labels"], minlength=2).tolist()
    written = sorted(glob.glob(os.path.join(out_dir, "gen_*.jpg")))
    ckpts = sorted(glob.glob(os.path.join(ckpt_dir, "gan_group*.npz")))
    assert imgs.shape == (64, 128, 64, 3) and np.isfinite(imgs).all()
    assert len(written) == 64 and len(ckpts) == 2, (written, ckpts)
    assert min(sizes) >= 6 * 64, sizes
    state = driver.load_gan_state(ckpts[-1], device="cuda")
    assert state.step == len(clock.events), (state.step, clock.events)
    period = clock.periods()
    step, st, args = (clock.kept[k] for k in ("step", "state", "args"))
    prof = gan_step_profile(step, st, args, "dcgan_step")
    results["gan dcgan"] = dict(
        groups=sizes, steps=len(clock.events), images=len(written),
        checkpoints=[os.path.basename(c) for c in ckpts], wall_s=wall,
        data_s=data_s, step_period_ms_median=statistics.median(period),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches_k1_k7=counts, **prof)
    emit("gan dcgan", nz=100, ngf=64, ndf=64, batch=64, hw=[128, 64],
         **results["gan dcgan"])
    assert not counts, counts

    # 36: the VAE-GAN, Wasserstein with the gradient penalty
    clock = StepClock()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with patched(driver, "make_vaegan_steps", clock.wrap):
        imgs = cli.gan_main(["--root", root, "--epochs", "1", "--vae",
                             "--wasserstein", "--n_images", "64", "--out",
                             os.path.join(tmp, "gen_vae")], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    assert imgs.shape == (64, 128, 64, 3) and np.isfinite(imgs).all()
    assert len(clock.events) >= 2, clock.events
    period = clock.periods()
    step, st, args = (clock.kept[k] for k in ("step", "state", "args"))
    prof = gan_step_profile(step, st, args, "vaegan_gp_step")
    emit("gan vae wasserstein", zdim=128, batch=64, steps=len(clock.events),
         wall_s=wall, step_period_ms_median=statistics.median(period),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches_k1_k7=counts, **prof)
    assert not counts, counts

    # 37: the LSRO baseline over real and generated images
    events, kept = [], {}
    sgd_apply = optim.SGD.apply

    def timed_apply(self, params, grads, state):
        sgd_apply(self, params, grads, state)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    optim.SGD.apply = timed_apply
    try:
        variables, history = cli.lsro_main(
            ["--root", root, "--gen_dir", out_dir, "--epochs", "1",
             "--ckpt", os.path.join(tmp, "lsro.npz")], device="cuda")
    finally:
        optim.SGD.apply = sgd_apply
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    n_real = GAN_IDS * GAN_TRAIN
    assert len(events) == (n_real + 64) // 32, len(events)
    assert np.isfinite(history[0]["loss"]) and 0 <= history[0]["acc"] <= 1
    assert os.path.exists(os.path.join(tmp, "lsro.npz"))
    events[-1].synchronize()
    period = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the step alone, as the driver builds it (the model in train mode,
    # the LSRO loss, SGD), on a batch of 32 drawn on the card
    from reid_tpu_torch.gan.train import lsro_loss
    from reid_tpu_torch.models import build_model
    model = build_model("baseline", GAN_IDS, device="cuda")
    params = list(model.parameters())
    tx = optim.SGD(1e-3, momentum=0.9)
    opt = tx.init(params)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = (torch.rand((32, 128, 64, 3), generator=g, device="cuda") * 2
             - 1, torch.randint(0, GAN_IDS, (32,), generator=g,
                                device="cuda"),
             (torch.arange(32, device="cuda") % 10 == 0).float())

    def step(_, imgs, labs, flgs):
        loss = lsro_loss(model(imgs, train=True)[1], labs, flgs)
        tx.apply(params, torch.autograd.grad(loss, params), opt)
        return loss
    prof = gan_step_profile(step, None, batch, "lsro_step")
    emit("gan lsro", backbone="baseline", classes=GAN_IDS, batch=32,
         real=n_real, generated=64, steps=len(events), wall_s=wall,
         step_period_ms_median=statistics.median(period),
         peak_mem_gb=peak, history=history, launches_k1_k7=counts, **prof)
    assert not counts, counts


def phase_train_detector():
    """Phase 38: `train_detector` at its defaults (det_hw 288x512, base
    32, batch 8, Adam 1e-3) on DET_TRAIN_FRAMES 1080p frames of phase 4's
    scene with their 50 boxes each, one epoch (2 steps): the losses
    (finite), the step period, peak memory, K1-K7 launches (0); then the
    step alone, the sync check, launches, device time and idle share,
    on the run's last batch (resized on the device, as in the run)."""
    import torch
    from reid_tpu_torch.models.detector import (detection_loss,
                                                make_centernet_targets)
    from reid_tpu_torch.ops import launch_counts, reset_launch_counts
    from reid_tpu_torch.tracking.pipeline import resize_bilinear_matmul
    from reid_tpu_torch.train import detector_train
    from reid_tpu_torch.utils.quantize import inv_f32

    frames, boxes = scene(DET_TRAIN_FRAMES)
    valid = np.ones(boxes.shape[:2], bool)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    model, _, losses = detector_train.train_detector(
        frames, boxes, valid, epochs=1, log_fn=lambda *_: None,
        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    assert len(losses) == 1 and np.isfinite(losses[0]), losses
    peak = torch.cuda.max_memory_allocated() / 1e9
    dev = torch.device("cuda")
    params = list(model.parameters())
    tx = detector_train.Adam(1e-3)
    opt = tx.init(params)
    sx, sy = 512 / frames.shape[2], 288 / frames.shape[1]
    imgs = torch.from_numpy(frames[:8]).to(dev)
    tl = torch.from_numpy((boxes[:8] * [sx, sy, sx, sy]).astype(
        np.float32)).to(dev)
    vm = torch.ones(tl.shape[:2], dtype=torch.bool, device=dev)

    def step(_, imgs, tl, vm):
        x = resize_bilinear_matmul(imgs.to(torch.float32)
                                   * inv_f32(255.0), (288, 512))
        loss = detection_loss(model(x, train=True),
                              *make_centernet_targets(tl, vm, (288, 512)))
        tx.apply(params, torch.autograd.grad(loss, params), opt)
        return loss
    prof = gan_step_profile(step, None, (imgs, tl, vm), "detector_step")
    emit("train detector", det_hw=[288, 512], base=32, batch=8,
         frames=DET_TRAIN_FRAMES, frame_hw=list(frames.shape[1:3]),
         steps=DET_TRAIN_FRAMES // 8, losses=losses, wall_s=wall,
         peak_mem_gb=peak, launches_k1_k7=counts, **prof)
    assert not counts, counts


def phase_gan_card_vs_cpu():
    """Phase 39: one step of each of the slice's trainers from one state
    on the card and on the CPU in f32, TF32 off: the DCGAN step with G's
    update (spectral G and D at full width, batch 8, step 2 of the
    schedule, the same z), the VAE-GAN step with the Wasserstein D and
    its gradient penalty (batch 4, the same eps), `train_lsro_baseline`
    (baseline at 128x64, 8 real and 8 generated images, one SGD step) and
    `train_detector` (base 32 at 288x512, 2 frames of 576x1024, one Adam
    step), each from a seeded init. Phase 14's limits: losses 1e-4
    relative; the gradient (Adam's first moment after its step, SGD's
    trace) within 1e-3 of its norm; the update at a cosine >= 0.9994 and
    within 3.5% of its norm; statistics (BatchNorm's, the spectral u and
    sigma) within 1e-3 of each tensor's largest magnitude; or twice the
    CPU's own spread between its two convolution algorithms (oneDNN and
    ATen's) where that is wider, as phase 28 does."""
    import copy

    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.gan import driver, models, train as gtrain
    from reid_tpu_torch.train import detector_train
    from reid_tpu_torch.train.optim import Adam

    gen0 = models.Generator().init_weights(torch.Generator().manual_seed(0))
    disc0 = models.Discriminator().init_weights(
        torch.Generator().manual_seed(1))
    vae0 = models.VAE().init_weights(torch.Generator().manual_seed(2))
    wdisc0 = models.Discriminator(wasserstein=True).init_weights(
        torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    real = torch.rand((8, 128, 64, 3), generator=g) * 2 - 1
    z, z2 = torch.randn((8, 100), generator=g), torch.randn((8, 100),
                                                            generator=g)
    eps, gp_eps = torch.randn((4, 128), generator=g), torch.rand(
        (4, 1, 1, 1), generator=g)
    rng = np.random.default_rng(5)
    real16 = rng.integers(0, 255, (16, 128, 64, 3), np.uint8)
    frames, boxes = scene(2, hw=(576, 1024), seed=6)

    def flat(ts):
        return torch.cat([t.detach().double().cpu().ravel() for t in ts])

    def dcgan(dev):
        gen, disc = copy.deepcopy(gen0).to(dev), copy.deepcopy(disc0).to(dev)
        start = flat(list(gen.parameters()) + list(disc.parameters()))
        state, g_tx, d_tx = gtrain.create_gan_state(gen, disc)
        state.step = 2                       # G's step and the EMA follow
        state, m = gtrain.make_dcgan_steps(g_tx, d_tx)(
            state, real.to(dev), z.to(dev), z2.to(dev))
        return dict(loss=float(m["d_loss"]) + float(m["g_loss"]),
                    grad=flat(state.g_opt["mu"] + state.d_opt["mu"]),
                    update=flat(list(gen.parameters())
                                + list(disc.parameters())) - start,
                    stats=[b.cpu() for b in list(gen.buffers())
                           + list(disc.buffers())])

    def vaegan(dev):
        vae, disc = copy.deepcopy(vae0).to(dev), copy.deepcopy(wdisc0).to(dev)
        start = flat(list(vae.parameters()) + list(disc.parameters()))
        init, step = gtrain.make_vaegan_steps(
            Adam(2e-4, b1=0.5), Adam(2e-4, b1=0.5), wasserstein=True)
        state, m = step(init(vae, disc), real[:4].to(dev), eps.to(dev),
                        gp_eps.to(dev))
        return dict(loss=float(m["vae_loss"]) + float(m["d_loss"]),
                    grad=flat(state.vae_opt["mu"] + state.d_opt["mu"]),
                    update=flat(list(vae.parameters())
                                + list(disc.parameters())) - start,
                    stats=[b.cpu() for b in list(vae.buffers())
                           + list(disc.buffers())])

    def lsro(dev):
        from reid_tpu_torch.models import build_model
        from reid_tpu_torch.utils.flax_bridge import torch_state_dict
        start = flat(build_model("baseline", GAN_IDS, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
                     .parameters())
        variables, hist = driver.train_lsro_baseline(
            real16[:8], np.arange(8), real16[8:], GAN_IDS, epochs=1,
            batch_size=16, log_fn=lambda *_: None, device=dev)
        sd = torch_state_dict(variables)
        model = build_model("baseline", GAN_IDS, device="cpu")
        names = [n for n, _ in model.named_parameters()]
        update = flat([sd[n] for n in names]) - start
        return dict(loss=hist[0]["loss"], grad=update, update=update,
                    stats=[sd[n] for n, _ in model.named_buffers()])

    def detector(dev):
        from reid_tpu_torch.models.detector import CenterNetLite
        start = flat(CenterNetLite().init_weights(
            torch.Generator().manual_seed(0)).parameters())
        model, _, losses = detector_train.train_detector(
            frames, boxes, np.ones(boxes.shape[:2], bool), epochs=1,
            batch_size=2, log_fn=lambda *_: None, device=dev)
        update = flat(model.parameters()) - start
        return dict(loss=losses[0], grad=None, update=update,
                    stats=[b.cpu() for b in model.buffers()])

    def apart(got, want):
        u_g, u_c = got["update"], want["update"]
        out = dict(loss_rel=abs(got["loss"] - want["loss"])
                   / abs(want["loss"]),
                   update_cosine=float(u_g @ u_c / (u_g.norm() * u_c.norm())),
                   update_rel_norm=float((u_g - u_c).norm() / u_c.norm()),
                   stats_rel=max(float((a.double() - b.double()).abs().max()
                                       / max(b.double().abs().max(), 1e-30))
                                 for a, b in zip(got["stats"],
                                                 want["stats"])))
        if want["grad"] is not None:
            out["grad_rel_norm"] = float((got["grad"] - want["grad"]).norm()
                                         / want["grad"].norm())
        return out

    res = {}
    for name, fn in (("dcgan", dcgan), ("vaegan_gp", vaegan),
                     ("lsro", lsro), ("detector", detector)):
        out = {}
        t0 = time.perf_counter()
        with full_f32():
            for run, mkldnn in (("cpu", True), ("cuda", True),
                                ("cpu_aten", False)):
                with torch.backends.mkldnn.flags(enabled=mkldnn):
                    out[run] = fn("cuda" if run == "cuda" else "cpu")
        got, spread = apart(out["cuda"], out["cpu"]), apart(
            out["cpu_aten"], out["cpu"])
        limits = dict(loss_rel=max(1e-4, 2 * spread["loss_rel"]),
                      update_cosine=min(0.9994, 1 - 2 * (
                          1 - spread["update_cosine"])),
                      update_rel_norm=max(0.035,
                                          2 * spread["update_rel_norm"]),
                      stats_rel=max(1e-3, 2 * spread["stats_rel"]))
        if "grad_rel_norm" in got:
            limits["grad_rel_norm"] = max(1e-3, 2 * spread["grad_rel_norm"])
        res[name] = dict(card=got, cpu_spread=spread, limits=limits,
                         seconds=time.perf_counter() - t0)
    emit("gan card vs cpu", **res)
    for name, r in res.items():
        got, lim = r["card"], r["limits"]
        assert got["loss_rel"] <= lim["loss_rel"], (name, r)
        assert got.get("grad_rel_norm", 0) <= lim.get("grad_rel_norm", 1), \
            (name, r)
        assert got["update_cosine"] >= lim["update_cosine"], (name, r)
        assert got["update_rel_norm"] <= lim["update_rel_norm"], (name, r)
        assert got["stats_rel"] <= lim["stats_rel"], (name, r)


MESH_TRAIN_IDS = 32          # phase 40: the training tree's first ids


@contextlib.contextmanager
def process_group(part):
    """Phase 40: a world-1 NCCL process group on loopback (a free port)
    around one part of the phase, and its mesh; the group is left at the
    block's end, so the other phases run without one, as before."""
    import socket

    import torch
    from reid_tpu_torch.parallel import default_mesh, init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    rank = init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        mesh = default_mesh()
        assert rank == 0 and mesh.size == 1 and mesh.collective, mesh
        assert torch.distributed.get_backend() == "nccl"
        emit(f"process group {part}", backend="nccl", world=1, rank=rank,
             init_s=time.perf_counter() - t0)
        yield mesh
    finally:
        torch.distributed.destroy_process_group()


class CollectiveCount:
    """Counts the torch.distributed collectives called inside the block
    (the autograd all_gather and all_reduce call these too)."""

    NAMES = ("all_gather", "all_reduce", "broadcast", "reduce_scatter",
             "all_to_all")

    def __enter__(self):
        import torch.distributed as dist
        self.counts = {n: 0 for n in self.NAMES}
        self.old = {n: getattr(dist, n) for n in self.NAMES}

        def counted(name, fn):
            def call(*a, **k):
                self.counts[name] += 1
                return fn(*a, **k)
            return call
        for n in self.NAMES:
            setattr(dist, n, counted(n, self.old[n]))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for n, fn in self.old.items():
            setattr(dist, n, fn)


def phase_train_mesh(tmp, mesh):
    """Phase 40 (a): `train_cnn(mesh=)` on the world-1 NCCL group against
    `train_cnn` without a mesh, from one state over the training tree's
    first `MESH_TRAIN_IDS` ids (the CLI's bf16 configuration, --bs 64
    --instance 4, one epoch), cuDNN deterministic: losses and weights bit
    for bit, the collectives called (identities on one rank). Its CLI
    run is `start_torchrun_cli`'s."""
    import copy

    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.data.dataset import ReIDDataset
    from reid_tpu_torch.data.datasets import build_dataset
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.train.image_train import train_cnn
    from reid_tpu_torch.train.state import create_train_state

    market = os.path.join(tmp, "market")
    raw = build_dataset("market1501", market)
    records = [r for r in raw.train if r[1] < MESH_TRAIN_IDS]
    args = cli._train_parser().parse_args(
        ["--root", market, "--epochs", "1", "--bs", "64", "--instance", "4"])
    cfg = cli._train_cfg(args, MESH_TRAIN_IDS)
    ds = ReIDDataset(records, MESH_TRAIN_IDS, cfg.data.height,
                     cfg.data.width)
    gen = torch.Generator().manual_seed(cfg.train.seed)
    model = build_model(cfg.model.backbone, num_classes=MESH_TRAIN_IDS,
                        num_cams=cfg.model.num_cams,
                        dtype=getattr(torch, cfg.model.dtype), device="cuda",
                        generator=gen)
    state = create_train_state(model, cfg, max(len(ds) // 64, 1), gen)
    runs = {}
    det, bench = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        for name, m in (("one device", None), ("mesh", mesh)):
            with CollectiveCount() as cc:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, losses = train_cnn(cfg, ds, state=copy.deepcopy(state),
                                       log_every=1, device="cuda",
                                       ckpt_dir=os.path.join(tmp, "m_" +
                                                             name[0]),
                                       mesh=m)
                torch.cuda.synchronize()
            runs[name] = (st, losses, time.perf_counter() - t0, cc.counts)
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
    (a, la, sa, ca), (b, lb, sb, cb) = runs["one device"], runs["mesh"]
    same_w = all(torch.equal(p, q) for p, q in zip(
        a.model.parameters(), b.model.parameters()))
    same_b = all(torch.equal(p, q) for p, q in zip(a.model.buffers(),
                                                   b.model.buffers()))
    assert len(la) >= 3 and all(np.isfinite(la)), la
    assert sum(ca.values()) == 0 and cb["all_gather"] > 0 and \
        cb["all_reduce"] > 0, (ca, cb)
    emit("train_cnn mesh world 1", ids=MESH_TRAIN_IDS, images=len(ds),
         steps=len(lb), losses_one_device=la, losses_mesh=lb,
         losses_bit_equal=la == lb, weights_bit_equal=same_w,
         buffers_bit_equal=same_b, one_device_s=sa, mesh_s=sb,
         collectives_mesh=cb)
    assert la == lb and same_w and same_b, (la, lb, same_w, same_b)


def start_torchrun_cli(tmp):
    """Phase 40 (a)'s CLI run: `image_reid_train` under
    `torch.distributed.run --standalone --nproc_per_node=1` on a tree of
    `MESH_TRAIN_IDS` ids, started in a POSIX process group of its own (so
    that a timeout ends torchrun and its worker) and not waited for: it
    runs beside card-vs-CPU checks, which it does not time.
    `finish_torchrun_cli` holds it."""
    from reid_tpu_torch.data.datasets import write_synthetic_tree

    small = os.path.join(tmp, "market_small")
    write_synthetic_tree(small, "market1501", MESH_TRAIN_IDS, TRAIN_PER_ID,
                         query_per_id=1, gallery_per_id=2)
    work = os.path.join(tmp, "torchrun")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "reid_tpu_torch.image_reid_train",
         "--root", small, "--epochs", "1", "--bs", "64", "--instance", "4"],
        cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    return dict(proc=proc, work=work, t0=t0)


def stop_group(proc):
    """Ends `proc`'s process group if `proc` still runs."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)


def finish_torchrun_cli(job):
    """Waits for `start_torchrun_cli`'s run, which must join the group,
    train and write its checkpoint; ends it if it is still running."""
    proc = job["proc"]
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        stop_group(proc)
        out, err = proc.communicate()
    cli_s = time.perf_counter() - job["t0"]
    ckpt = os.path.join(job["work"], "checkpoint",
                        "cnn_net_checkpoint_market1501.npz")
    ok = (proc.returncode == 0 and "data parallel over 1 rank" in out
          and "training complete" in out and os.path.exists(ckpt))
    emit("train_cnn torchrun cli", rc=proc.returncode, seconds=cli_s,
         ok=ok, tail=out[-600:] + err[-600:])
    assert ok, (proc.returncode, out[-2000:], err[-2000:])


def phase_sharded_jaccard(kind, keep, mesh, query, gallery):
    """Phase 40 (b): the row-sharded Jaccard at world 1 on the retrieval
    run's de-biased features (N = 23,100, D = 1,263) against the dense
    one: both timed with their peak memory, the sharded run's launches
    counted; K7 at its new call site (the (N/p, N) min-sum slab) held
    against `l1_plain` on a 1,024-row slice of that slab's operands and
    timed; then the post-embed half of `run_inference(mesh=)`
    (`evaluate_features`) on the run's own embeddings against the dense
    run's mAP. Returns K7's row."""
    import torch
    from reid_tpu_torch import cli
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.eval.inference import evaluate_features
    from reid_tpu_torch.ops import _lib
    from reid_tpu_torch.ops import distance as dist
    from reid_tpu_torch.ops import rerank
    from reid_tpu_torch.ops.camera import diminish_camera_bias

    with full_f32(), torch.inference_mode():
        cams = torch.cat([torch.as_tensor(keep["gallery_cams"]),
                          torch.as_tensor(keep["query_cams"])]).cuda()
        feats = diminish_camera_bias(torch.cat([keep["gf"], keep["qf"]]),
                                     cams)
        n, d = feats.shape
        out = {}
        for name in ("dense", "sharded"):
            captured = {}

            def capture(fn):
                def minsum(v_rows, v_all, s):
                    captured.update(rows=v_rows, all=v_all)
                    return fn(v_rows, v_all, s)
                return minsum
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _lib.reset_launch_counts()
            timing = {}
            t0 = time.perf_counter()
            with patched(rerank, "_minsum_jaccard", capture):
                if name == "dense":
                    jac = rerank.compute_jaccard_distance(feats, 20, 6,
                                                          timing=timing)
                else:
                    jac = rerank.compute_jaccard_distance_sharded(
                        mesh, feats, 20, 6, timing=timing)
            torch.cuda.synchronize()
            out[name] = dict(jac=jac, s=time.perf_counter() - t0,
                             peak_gb=(torch.cuda.max_memory_allocated()
                                      - base) / 1e9,
                             counts=_lib.launch_counts(), steps_s=timing)
            if name == "sharded":
                v_rows, v_all = captured["rows"], captured["all"]
            del captured
        dense, sharded = out["dense"].pop("jac"), out["sharded"].pop("jac")
        diff = (sharded - dense).abs()
        rows_differ = int((diff > 0).any(1).sum())
        max_diff = diff.max().item()
        del diff
        counts = out["sharded"]["counts"]
        assert counts.get("l1", 0) == 1 and counts.get("sqeuclidean", 0) \
            >= 1, counts
        # K7 at the sharded site: its 1,024 first rows against the plain L1
        site = [v_rows.shape[0], v_all.shape[0], v_all.shape[1]]
        slab = v_rows[:1024]
        m = slab.shape[0]
        got = dist.l1(slab, v_all)
        want, plain_ms = timed_once(lambda: dist.l1_plain(slab, v_all))
        err = (got - want).abs()
        assert bool((err <= 1e-5 + 1e-5 * want.abs()).all()), err.max()
        del got, want
        bms, by = bound(2 * m * n * n, 4 * (m * n + n * n + m * n), kind,
                        "fp32_alu")
        row = dict(name="l1 min-sum sharded slab", route="cuda",
                   source=DIST_SOURCE, replaces=K7_REPLACES,
                   site=site, slab=[m, n, n], path="retrieval sharded world 1",
                   launches=counts["l1"], max_abs_err=err.max().item(),
                   ms=time_ms(lambda: dist.l1(slab, v_all)),
                   plain_ms=plain_ms,
                   library_ms=time_ms(lambda: torch.cdist(slab, v_all, p=1),
                                      reps=1, warm=0),
                   bound_ms=bms, bound_by=by,
                   site_ms=time_ms(lambda: dist.l1(v_rows, v_all), reps=1,
                                   warm=0))
        row["site_bound_ms"], _ = bound(
            2 * site[0] * n * n, 4 * (site[0] * n + n * n + site[0] * n),
            kind, "fp32_alu")
        del err, slab, v_rows, v_all, dense, sharded, feats
        torch.cuda.empty_cache()
        emit(f"kernel {row['name']}", **row)
        # the post-embed half of run_inference(mesh=)
        argv = ["--search_option", "dense", "--bs", "64"]
        cfg = cli._base_cfg(cli._inference_parser().parse_args(argv),
                            N_CLASSES)
        t0 = time.perf_counter()
        cmc, mean_ap = evaluate_features(keep["qf"], keep["gf"], query,
                                         gallery, cfg, verbose=False,
                                         mesh=mesh)
        eval_s = time.perf_counter() - t0
    want_ap = RESULTS["retrieval"]["mAP"]
    emit("jaccard sharded world 1", n=n, dim=d, dense_s=out["dense"]["s"],
         sharded_s=out["sharded"]["s"],
         dense_peak_gb=out["dense"]["peak_gb"],
         sharded_peak_gb=out["sharded"]["peak_gb"],
         sharded_steps_s=out["sharded"]["steps_s"],
         sharded_launches=counts, bit_equal=rows_differ == 0,
         rows_differ=rows_differ, max_abs_diff=max_diff,
         mesh_eval_s=eval_s, mAP_mesh=mean_ap, mAP_dense=want_ap,
         cmc1_mesh=float(cmc[0]), cmc1_dense=RESULTS["retrieval"]["cmc1"])
    assert rows_differ == 0, (max_diff, rows_differ)
    assert abs(mean_ap - want_ap) <= 1e-4, (mean_ap, want_ap)
    return row


def phase_streams_mesh(embed, dev, mesh):
    """Phase 40 (c): `make_stream_tracker(mesh=)` on the world-1 group
    for one chunk of phase 4d's MOT16-load scene (8 streams, int8 embed),
    against the meshless stream tracker: ids and valid equal, boxes
    within 1e-4 (bit-equality reported); K1 and K2 launched in the mesh
    run."""
    import torch
    from reid_tpu_torch.ops import _lib
    from reid_tpu_torch.tracking.streams import (init_stream_states,
                                                 make_stream_tracker)

    point = dict(STREAM_POINTS["mot16_load_multistream8"], n_chunks=1)
    data = stream_data(point, dev)
    cfg = stream_cfg(point)
    outs, counts, secs = {}, {}, {}
    for name, m in (("one process", None), ("mesh", mesh)):
        run = make_stream_tracker(cfg, embed, (256, 128),
                                  chunk=point["chunk"],
                                  crop_budget=point["chunk"] *
                                  point["n_real"], device=dev, mesh=m)
        st = init_stream_states(point["streams"], point["max_tracks"],
                                512 + N_CLASSES, device=dev)
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        with CollectiveCount() as cc:
            _, outs[name] = run(st, *data)
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts[name] = dict(_lib.launch_counts(), **{
            f"collective {k}": v for k, v in cc.counts.items() if v})
    a, b = outs["one process"], outs["mesh"]
    ids = torch.equal(a["ids"], b["ids"])
    valid = torch.equal(a["valid"], b["valid"])
    v = a["valid"]
    err = (a["tlwh"][v] - b["tlwh"][v]).abs().max().item() if bool(
        v.any()) else 0.0
    emit("streams mesh world 1", streams=point["streams"],
         frames=point["chunk"], ids_equal=ids, valid_equal=valid,
         tlwh_max_err=err, bit_equal=all(torch.equal(a[k], b[k]) for k in a),
         valid_tracks=int(v.sum()), seconds=secs, launches=counts)
    assert ids and valid and err <= 1e-4 and int(v.sum()) > 0
    for k in ("conv3x3_s8", "se_basic_block_s8", "collective all_gather"):
        assert counts["mesh"].get(k, 0) > 0, (k, counts)


DEEPLAB_CROPS = 64


def phase_deeplab():
    """Phase 40 (d): DeepLabV3-ResNet50 at torchvision's widths (width 64,
    head 256, 21 classes, 39.6M parameters without torchvision's
    auxiliary head; a random init from a seeded generator, BN statistics
    0 / 1) on 64 crops of 256x128: the forward timed in f32
    (TF32 off) and bf16 with peak memory; card against CPU on 2 crops in
    f32 (logits within 1e-4 of the CPU's largest, the person masks equal
    where the top two logits are more than 1e-5 of it apart); then
    `batched_extraction` with SegUNet(base=32) over the 64 crops and two
    epochs of `train_segmenter` on them (the crops' bright box the mask),
    whose loss must fall."""
    import copy

    import torch
    from reid_tpu_torch.cli import full_f32
    from reid_tpu_torch.data import segmentation as seg
    from reid_tpu_torch.models.deeplab import DeepLabV3, extract_foreground

    gen = torch.Generator().manual_seed(0)
    model = DeepLabV3(21, 64, 256).init_weights(gen).eval()
    n_params = sum(p.numel() for p in model.parameters())
    cpu = copy.deepcopy(model)
    model = model.cuda()
    # person crops: a bright box (the mask) on a darker textured ground
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 60, (DEEPLAB_CROPS, 256, 128, 3)).astype(
        np.uint8)
    masks = np.zeros((DEEPLAB_CROPS, 256, 128), np.float32)
    for i in range(DEEPLAB_CROPS):
        y, x = 40 + i % 24, 24 + i % 16
        imgs[i, y:y + 160, x:x + 64] = 200 + i % 40
        masks[i, y:y + 160, x:x + 64] = 1.0
    x = torch.from_numpy(imgs).cuda().to(torch.float32) / 255.0
    res = {}
    with torch.inference_mode():
        for name, dtype in (("f32", torch.float32), ("bf16",
                                                     torch.bfloat16)):
            m = model if dtype == torch.float32 else copy.deepcopy(model)
            if dtype != torch.float32:
                for mod in m.modules():
                    if hasattr(mod, "dtype"):
                        mod.dtype = dtype
            with full_f32():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                y = m(x)
                torch.cuda.synchronize()
                res[name] = dict(
                    ms=time_ms(lambda: m(x), reps=5, warm=1),
                    peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
            assert tuple(y.shape) == (DEEPLAB_CROPS, 256, 128, 21)
            assert bool(torch.isfinite(y).all()), name
            del y, m
        with full_f32():
            got = model(x[:2]).cpu()
        want = cpu(x[:2].cpu())
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= 1e-5 * scale
    same = extract_foreground(got) == extract_foreground(want)
    # the segmentation module on the card
    unet = seg.SegUNet(base=32).init_weights(
        torch.Generator().manual_seed(0)).cuda()
    with torch.inference_mode():
        comp = seg.batched_extraction(unet, x * 255.0)
        torch.cuda.synchronize()
        ext_ms = time_ms(lambda: seg.batched_extraction(unet, x * 255.0),
                         reps=5, warm=1)
    assert tuple(comp.shape) == tuple(x.shape) and bool(
        torch.isfinite(comp).all())
    t0 = time.perf_counter()
    _, losses = seg.train_segmenter(imgs, masks, epochs=2, batch_size=16,
                                    lr=3e-3, base=32, log_fn=lambda *_: None,
                                    device="cuda")
    train_s = time.perf_counter() - t0
    emit("deeplabv3 resnet50", params=n_params, crops=DEEPLAB_CROPS,
         hw=[256, 128], f32_ms=res["f32"]["ms"],
         f32_peak_gb=res["f32"]["peak_gb"], bf16_ms=res["bf16"]["ms"],
         bf16_peak_gb=res["bf16"]["peak_gb"],
         card_vs_cpu_max_err=err, card_vs_cpu_scale=scale,
         mask_agree=float(same.double().mean()),
         mask_agree_off_ties=bool(same[~near].all()),
         near_ties=int(near.sum()), segunet_extraction_ms=ext_ms,
         segmenter_losses=losses, segmenter_train_s=train_s)
    # torchvision's 42M count its auxiliary FCN head, which the
    # reference's segmenter does not run
    assert 39e6 < n_params < 40e6, n_params
    assert err <= 1e-4 * scale and bool(same[~near].all()), (err, scale)
    assert all(np.isfinite(losses)) and losses[1] < losses[0], losses


def set_launches(rows, sites):
    """Each K1/K2 row's launches at its call site in one run of its path."""
    for row in rows:
        kname = row["name"].split()[0]
        row["launches"] = sites.get(f"{kname} {row['site']}", 0)
        assert row["launches"] > 0, row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace both track runs, a chunk of each stream "
                         "operating point and the retrieval run with "
                         "torch.profiler into chiprun_out/profile_{chunked,"
                         "step,streams_*,retrieval}.txt")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    smi, kind = phase_device()
    # the training trees and the gauntlet's scene, written while the
    # kernels build
    train_dir = tempfile.TemporaryDirectory()
    trees = start_process("write_data", train_dir.name)
    try:
        run_phases(args, smi, kind, trees, train_dir.name)
    finally:
        stop([trees])
        train_dir.cleanup()


def run_phases(args, smi, kind, trees, train_dir):
    """The phases after the first, in order; `trees` is the process that
    writes the data on disk into `train_dir` (`write_data`)."""
    import torch
    from reid_tpu_torch.cli import full_f32

    phase_build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    crops = torch.randn((2048, 256, 128, 3), generator=gen, device=dev)
    rows = phase_kernels(kind, torch.bfloat16, crops[:32], crops, "track",
                         variants=True)
    zoo_rows = phase_zoo_kernels(kind, crops)
    attn_rows = phase_zoo_kernels(kind, crops, ATTN_K1_SITES, ATTN_K1_COUNT)
    del crops
    torch.cuda.empty_cache()
    probe_rows, probe_counts = phase_probe(kind)
    artifact_dir = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as tmp:
        chunked, _ = phase_track(tmp, 64, 32, 8, args.profile)
        # phase 41 on phase 4's scene: K1 and K2 inside the artifact, run
        # at the end in a fresh process (`ArtifactWorker`)
        int8_job = export_chunk_artifact(
            artifact_dir.name, scene_argv(tmp, "--int8"), ARTIFACT_CHUNK, 2)
    with tempfile.TemporaryDirectory() as tmp:
        phase_gmc(tmp, 64, 32, 8)
        # and on phase 5's panned scene: the FFT and the fused cost
        job = export_chunk_artifact(
            tmp, scene_argv(tmp, "--tracking_method", "botsort"),
            ARTIFACT_GMC_CHUNK, 2)
        hold_chunk_artifact("botsort gmc bf16", job,
                            run_chunk_artifact(job), per_chunk=(0, 0))
        del job
    with tempfile.TemporaryDirectory() as tmp:
        det_rows = phase_track_yolo(tmp, kind)
    with tempfile.TemporaryDirectory() as tmp:
        phase_track_centernet(tmp)
    assert trees.wait(timeout=600) == 0, "write_data failed"
    phase_gauntlet(os.path.join(train_dir, "gauntlet"))
    _, stream_rows = phase_streams(kind, dev, args.profile)
    phase_embed()
    # one scene for the track runs of phases 17-29
    zoo_dir = tempfile.TemporaryDirectory()
    tmp = zoo_dir.name
    scene = write_scene(tmp, ZOO_TRACK_FRAMES)
    zoo_track = phase_track_zoo(tmp, scene, 32)
    baseline_sites = phase_zoo_embed()["baseline"]
    for row in zoo_rows:
        set_launches([row], zoo_track["site_launches"]
                     if "resnet50" in row["name"] else baseline_sites)
    # phases 21-23: the triplet and EMA attention backbones
    attn_track = {}
    for backbone in ATTN_K1_COUNT:
        attn_track[backbone] = phase_track_zoo(
            tmp, scene, 32, backbone, k1_per_call=ATTN_K1_COUNT[backbone])
    for row in attn_rows:
        set_launches([row], attn_track[row["name"].split()[1]][
            "site_launches"])
    phase_zoo_embed(tuple(ATTN_K1_COUNT), ATTN_K1_COUNT, "embed attention")
    # phases 25-26: OSNet and PLR-OSNet, no K1 or K2 on their int8 route
    for backbone in OSNET_BACKBONES:
        phase_track_zoo(tmp, scene, 32, backbone, k1=False)
    phase_zoo_embed(OSNET_BACKBONES, {b: 0 for b in OSNET_BACKBONES},
                    "embed osnet", int8_cosine=0.99)
    # phases 29-30: ViT and Swin at 448x224, no K1 or K2 on their int8
    # route
    for backbone, modes in TRANSFORMER_TRACK.items():
        phase_track_zoo(tmp, scene, 32, backbone, k1=False,
                        crop_hw=TRANSFORMER_HW, modes=modes)
    zoo_dir.cleanup()
    phase_zoo_embed(tuple(TRANSFORMER_WIDTH),
                    {b: 0 for b in TRANSFORMER_WIDTH}, "embed transformers",
                    int8_cosine=0.99, hw=TRANSFORMER_HW)
    # K1/K2 launches at their call sites on the track path; K3-K5 (here and
    # in the probe's rows) and K1's probe rows: the probe path's launches
    track_rows = [r for r in rows if r["path"] == "track"]
    set_launches(track_rows, chunked["site_launches"])
    for row in [r for r in rows if r["path"] == "qconv probe"] + probe_rows:
        row["launches"] = probe_counts[row["name"].split()[0]]
    rows += probe_rows + det_rows + stream_rows + zoo_rows + attn_rows

    query, gallery, make_s = market_splits()
    keep, counts, _ = phase_retrieval(
        query, gallery, make_s, os.path.join(OUT_DIR, "profile_retrieval.txt")
        if args.profile else None)
    keep.update(query_cams=query.cams, gallery_cams=gallery.cams)
    keep8, _, sites8 = phase_retrieval(query, gallery, make_s, int8=True)
    cos = (keep8["gf"] * keep["gf"]).sum(1) / (
        keep8["gf"].norm(dim=1) * keep["gf"].norm(dim=1))
    emit("retrieval int8 vs f32 embed", gallery_min_cosine=cos.min().item(),
         gallery_mean_cosine=cos.mean().item())
    del keep8, cos
    with full_f32():
        calib, batch = retrieval_batch(query, gallery, dev)
        rows8 = phase_kernels(kind, torch.float32, calib, batch,
                              "retrieval --int8", suffix=" f32")
    del calib, batch
    set_launches(rows8, sites8)
    rows += rows8
    dist_rows = phase_distance_kernels(kind, keep)
    for row in dist_rows:
        row["launches"] = counts.get(row["name"].split()[0], 0)
        assert row["launches"] > 0, row
    rows += dist_rows
    with process_group("jaccard") as mesh:
        rows.append(phase_sharded_jaccard(kind, keep, mesh, query, gallery))
    phase_retrieval_cpu(keep, query, gallery)
    ivf = phase_ivf(keep, query, gallery)
    for row in dist_rows:
        row["launches_ivf_run"] = ivf["launches"].get(
            row["name"].split()[0], 0)
    del keep
    phase_embed_retrieval(query)
    with tempfile.TemporaryDirectory() as tmp:
        phase_artifact(gallery, tmp, dev)
    del query, gallery
    # the zoo's retrievals on ZOO_SPLIT_PART of the split: agw --int8,
    # K6/K7 held on its own operands
    query, gallery, make_s = market_splits(part=ZOO_SPLIT_PART)
    keep_a, counts_a, _ = phase_retrieval(query, gallery, make_s, int8=True,
                                          backbone="agw")
    keep_a.update(query_cams=query.cams, gallery_cams=gallery.cams)
    agw_rows = phase_distance_kernels(kind, keep_a, suffix=" agw",
                                      path="retrieval agw --int8",
                                      full=False)
    for row in agw_rows:
        row["launches"] = counts_a.get(row["name"].split()[0], 0)
        assert row["launches"] > 0, row
    rows += agw_rows
    del keep_a
    # phase 27: plr_osnet f32 on the zoo's split (D = 2,560)
    keep_p, counts_p, _ = phase_retrieval(query, gallery, make_s,
                                          backbone="plr_osnet")
    keep_p.update(query_cams=query.cams, gallery_cams=gallery.cams)
    plr_rows = phase_distance_kernels(kind, keep_p, suffix=" plr_osnet",
                                      path="retrieval plr_osnet",
                                      full=False)
    for row in plr_rows:
        row["launches"] = counts_p.get(row["name"].split()[0], 0)
        assert row["launches"] > 0, row
    assert plr_rows[0]["site"][2] == 2560, plr_rows[0]
    rows += plr_rows
    del keep_p, query, gallery
    torch.cuda.empty_cache()
    # phase 31: vit f32 on the zoo's split at 448x224 (D = 1,135)
    query, gallery, make_v = market_splits(TRANSFORMER_HW, ZOO_SPLIT_PART)
    keep_v, counts_v, _ = phase_retrieval(query, gallery, make_v,
                                          backbone="vit")
    keep_v.update(query_cams=query.cams, gallery_cams=gallery.cams)
    vit_rows = phase_distance_kernels(kind, keep_v, suffix=" vit",
                                      path="retrieval vit", full=False)
    for row in vit_rows:
        row["launches"] = counts_v.get(row["name"].split()[0], 0)
        assert row["launches"] > 0, row
    assert vit_rows[0]["site"][2] == 384 + N_CLASSES, vit_rows[0]
    rows += vit_rows
    del keep_v, query, gallery
    torch.cuda.empty_cache()
    tmp = train_dir
    state, cfg, source, trained, batches = phase_train(tmp, trees)
    with process_group("train") as mesh:
        phase_train_mesh(tmp, mesh)
    phase_train_card_vs_cpu()
    counts, checks = phase_continual(state, cfg, source, tmp)
    del state, source
    torch.cuda.empty_cache()
    for row in dist_rows:
        kname = row["name"].split()[0]
        row["launches_continual_run"] = counts.get(kname, 0)
        row["max_abs_err_continual_run"] = checks[kname]["max_abs_err"]
        row["site_continual_run"] = checks[kname]["site"]
    zoo_state, zoo_cfg, zoo_batches, zoo_step_ms = phase_train_zoo(tmp)
    phase_train_card_vs_cpu("resnet50", spread=True)
    # phase 24: CARes18 with BatchRenorm on the same tree
    ca_state, ca_cfg, ca_batches, ca_step_ms = phase_train_zoo(
        tmp, "cares18", renorm=True)
    phase_train_card_vs_cpu("cares18", renorm=True)
    phase_train_card_vs_cpu("emares18")
    # phase 28: OSNet through train_main, PLR-OSNet's dual-branch step
    phase_train_zoo(tmp, "osnet")
    torch.cuda.empty_cache()
    # phase 40 (a)'s CLI run beside the card-vs-CPU checks
    torchrun = start_torchrun_cli(tmp)
    try:
        phase_train_card_vs_cpu("osnet", spread=True)
        phase_train_card_vs_cpu("plr_osnet", spread=True)
        # phase 32's card-vs-CPU steps, before any trace
        for backbone in TRANSFORMER_STEP:
            phase_train_card_vs_cpu(backbone, spread=True)
        finish_torchrun_cli(torchrun)
    finally:
        stop_group(torchrun["proc"])
    # traced last: a trace slows the process's later launches
    emit("train step profile", **step_profile(trained, cfg, batches))
    del trained, batches
    prof = step_profile(zoo_state, zoo_cfg, zoo_batches)
    emit("train step profile resnet50", step_ms_median=zoo_step_ms,
         device_idle_share=1 - prof["device_ms_per_step"] / zoo_step_ms,
         **prof)
    del zoo_state, zoo_batches
    prof = step_profile(ca_state, ca_cfg, ca_batches)
    emit("train step profile cares18 --renorm", step_ms_median=ca_step_ms,
         device_idle_share=1 - prof["device_ms_per_step"] / ca_step_ms,
         **prof)
    del ca_state, ca_batches
    for instances in (0, 4):
        phase_train_plr(instances)
    # phase 32: the transformer step on both optimizer branches
    for backbone in TRANSFORMER_STEP:
        for instances in (4, 0):
            phase_train_transformer(backbone, instances)
    # phases 33-34: video ReID through video_main, then the card-vs-CPU
    # step and eval forward
    torch.cuda.empty_cache()
    phase_video_train(tmp)
    torch.cuda.empty_cache()
    phase_video_card_vs_cpu()
    # phases 35-39: the GAN programs, detector training, card vs CPU
    torch.cuda.empty_cache()
    phase_gan(tmp)
    phase_train_detector()
    # phase 41's fresh process loads the int8 artifact beside the GAN
    # card-vs-CPU checks, then runs its chunks alone on the card
    worker = ArtifactWorker(int8_job, artifact_dir.name)
    try:
        phase_gan_card_vs_cpu()
        artifact = hold_chunk_artifact("int8", int8_job, worker.result(),
                                       per_chunk=(2, 4))
    finally:
        worker.stop()
        artifact_dir.cleanup()
    del int8_job
    for row in track_rows:
        row["launches_artifact_run"] = artifact["site_launches"].get(
            f"{row['name'].split()[0]} {row['site']}", 0)
        assert row["launches_artifact_run"] > 0, row
    phase_deeplab()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K6/K7 on the continual run: its launches, and each held against its
    # plain version at the shape the run gave it
    CONTINUAL_KEYS = ("launches_continual_run", "max_abs_err_continual_run",
                      "site_continual_run", "launches_artifact_run")
    kernels = {"kernels": [
        {k: row[k] for k in keys + CONTINUAL_KEYS if k in row}
        for row in rows]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"results": RESULTS, **kernels}, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
