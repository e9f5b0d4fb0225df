"""PyTorch + CUDA port of `reid_tpu` for one NVIDIA H100.

The JAX package `reid_tpu` is the reference this port is tested against;
the port imports nothing of it, nor JAX. Two paths are ported: the int8
track serve path (`reid_tpu_torch.cli.track_main`: SERes18-IBN or a
torchvision-style ResNet (`--backbone baseline | resnet50 | agw`), the
tracker and the hand-written Hopper kernels `conv3x3_s8` and
`se_basic_block_s8`)
and retrieval evaluation (`reid_tpu_torch.cli.inference_main`: TTA
embeddings, camera de-bias, k-reciprocal re-ranking, DBSCAN, CMC/mAP, with
the distance kernels `sqeuclidean` and `l1`; IVF search, the Market
attribute prior and `torch.export` serving artifacts). Multi-stream
tracking on one card is `tracking.streams.make_stream_tracker`. The
kernels are CUDA C++ in `csrc/`; `conv3x3_s8` and `se_basic_block_s8` are
`torch.library` custom ops. Training is `cli.train_main`. Entry points run
on the card unless the caller passes `device="cpu"`.
"""
