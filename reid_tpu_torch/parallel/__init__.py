"""The port's distributed layer on torch.distributed
(counterpart of `reid_tpu/parallel/`)."""

from .mesh import (Mesh, all_gather_rows, all_reduce_mean_grads,
                   close_process_group, default_mesh, fit_mesh,
                   init_distributed, make_mesh, make_mesh_2d, mesh_from_env,
                   place_batch, replicate, shard_batch, shard_params_tp,
                   sharded_gallery_topk, sits_out)

# the JAX package's name for the bootstrap
init_multihost = init_distributed

__all__ = ["Mesh", "all_gather_rows", "all_reduce_mean_grads",
           "close_process_group", "default_mesh", "fit_mesh",
           "init_distributed", "init_multihost", "make_mesh", "make_mesh_2d",
           "mesh_from_env", "place_batch", "replicate", "shard_batch",
           "shard_params_tp", "sharded_gallery_topk", "sits_out"]
