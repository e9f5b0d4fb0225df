"""PyTorch + CUDA port of `reid_tpu` for one NVIDIA H100.

The JAX package `reid_tpu` is the reference this port is tested against;
the port imports nothing of it, nor JAX. This slice covers the int8 track
serve path: `reid_tpu_torch.cli.track_main`, SERes18-IBN, the tracker and
the two hand-written Hopper kernels in `csrc/` (`conv3x3_s8` and the fused
SE block `se_basic_block_s8`). Entry points run on the card unless the
caller passes `device="cpu"`.
"""
