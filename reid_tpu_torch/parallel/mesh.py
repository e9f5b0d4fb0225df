"""Process groups as meshes: the port's distributed layer.

Counterpart of `reid_tpu/parallel/mesh.py` on `torch.distributed`. Where
the JAX package shards arrays over a device `Mesh` and lets GSPMD insert
the collectives, here each rank is one process on one device and the
collectives are explicit:

  * data parallelism (ref nn.DataParallel / DDP, train_utils.py:45-77):
    every rank holds the whole model and its rows of each batch
    (`place_batch`: rows rank * B/p : (rank + 1) * B/p, JAX's P("data")
    order); BatchNorm reduces its statistics over the global batch
    (`models.layers.global_batch_stats`), the loss runs on the gathered
    global batch (`all_gather_rows(grad=True)`) and the gradients are
    summed over the ranks (`all_reduce_mean_grads`), so a step at world p
    is the step at world 1;
  * `sharded_gallery_topk` (the faiss IndexShards role, ref
    faiss_utils.py:121-139): each rank ranks its block of the gallery,
    one all_gather merges the candidates;
  * tensor-parallel placement of wide 2-D tables on a 2-D `DeviceMesh`
    (`make_mesh_2d`, `shard_params_tp`) with DTensor placements.

Without a process group the mesh has no group (`Mesh.group` None): every
collective below is then the identity and launches nothing, so the
meshless programs run unchanged. A process group of one rank (world 1
under `torchrun`) keeps its group: the collectives run, on one rank, and
leave every value as it is; BatchNorm keeps its local statistics there,
which are the global ones. The re-ranking shards only over more than
one rank (`ops.rerank.jaccard_distance`, as in the JAX package). The
card takes NCCL, the CPU gloo (`init_distributed`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# Per-sample batch entries (leading dim = batch); everything else in a
# batch dict (augmentation draws, the XBM gate) is whole on every rank.
_BATCH_KEYS = frozenset(
    {"images", "labels", "cams", "seqs", "weights", "conf", "valid", "tlwh"})


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that share one batch: `group` (None without a process
    group), `size`, this process's `rank` in it (-1 when it is not a
    member) and its `device`."""
    group: Optional[object]
    size: int
    rank: int
    device: torch.device

    @property
    def member(self) -> bool:
        return self.rank >= 0

    @property
    def collective(self) -> bool:
        """Whether the data-parallel programs run their collectives."""
        return self.group is not None

    @property
    def stats_group(self):
        """The group whose global batch BatchNorm reduces over: None at
        size 1, where the local statistics are the global ones."""
        return self.group if self.size > 1 else None

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of length `n` (divisible by
        the size)."""
        if n % self.size:
            raise ValueError(f"{n} rows not divisible by mesh size "
                             f"{self.size}")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def _local_device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        return torch.device("cpu")
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device="cuda") -> int:
    """Join the process group (role of the reference's `ddp_trigger`
    rendezvous, train_utils.py:45-77, and of `init_multihost`): from the
    `torchrun` environment (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT,
    LOCAL_RANK) when `init_method` is None, else from `init_method`
    (`tcp://127.0.0.1:<port>` or `file://...`), `world_size` and `rank`.
    NCCL on the card, each rank on its LOCAL_RANK's card; gloo only where
    `device` asks for the CPU. Raises when the card is asked for and
    CUDA is not there. Returns the rank."""
    on_card = torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: the card path (NCCL) needs "
                           "CUDA, which this process does not have")
    if on_card:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kw = {}
    if init_method is not None:
        kw = dict(init_method=init_method, world_size=world_size, rank=rank)
    dist.init_process_group("nccl" if on_card else "gloo", **kw)
    return dist.get_rank()


def make_mesh(n_devices: int = 0, device=None) -> Mesh:
    """A mesh over the first `n_devices` ranks of the process group (all
    of them with 0); every rank must call it, as `new_group` requires. No
    process group: the one-device mesh."""
    dev = _local_device(device)
    if not dist.is_initialized():
        return Mesh(None, 1, 0, dev)
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"{n} devices asked, the process group has {world}")
    me = dist.get_rank()
    if n == world:
        return Mesh(dist.group.WORLD, n, me, dev)
    group = dist.new_group(ranks=list(range(n)))
    return Mesh(group, n, me if me < n else -1, dev)


def default_mesh(device=None) -> Mesh:
    """The mesh over every rank of the process group (size 1 without
    one): the train and eval loops' default."""
    return make_mesh(0, device)


def fit_mesh(batch_size: int, device=None) -> Mesh:
    """The default mesh of a train loop: the largest world size that
    divides `batch_size`, over the first ranks (nn.DataParallel likewise
    splits whatever batch it gets over the GPUs that fit)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    while n > 1 and batch_size % n:
        n -= 1
    return make_mesh(n, device)


def mesh_from_env(batch_size: Optional[int] = None, device="cuda"
                  ) -> Optional[Mesh]:
    """The CLIs' mesh: under `torchrun` (WORLD_SIZE in the environment)
    the process group is joined if it is not yet, and the mesh is
    `fit_mesh(batch_size)` (every rank without a batch size); otherwise
    None, one device."""
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return None
        init_distributed(device=device)
    return fit_mesh(batch_size) if batch_size else default_mesh()


def sits_out(mesh: Optional[Mesh], batch_size: int) -> bool:
    """Whether this rank is outside `mesh`: under `torchrun`, `fit_mesh`
    keeps the first ranks whose count divides the batch, as the JAX
    package's `fit_mesh` uses fewer devices. The train CLIs then return
    without training or writing anything, and this rank says so in one
    line; it has already joined every collective that `make_mesh` needs
    (`new_group`), so the group trains as a world of its own size."""
    if mesh is None or mesh.member:
        return False
    print(f"rank {dist.get_rank()} of {dist.get_world_size()} sits this "
          f"run out: the batch of {batch_size} divides over the first "
          f"{mesh.size} rank(s) (fit_mesh)", flush=True)
    return True


def close_process_group() -> None:
    """Leave the process group, where this process joined one (the
    launchers' last step under `torchrun`)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _map(fn, tree):
    """`fn` applied to every tensor of a tree of dicts, lists, tuples and
    named tuples; other leaves kept."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def place_batch(mesh: Mesh, batch: dict) -> dict:
    """One train/eval batch on this rank: its rows of the per-sample
    entries (`_BATCH_KEYS`, leading dim = batch), the other entries whole,
    everything on the mesh's device."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            if k in _BATCH_KEYS and v.ndim >= 1:
                v = v[mesh.rows(v.shape[0])]
            v = v.to(mesh.device, non_blocking=True)
        out[k] = v
    return out


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every tensor of a tree (leading dim = batch)."""
    return _map(lambda t: t[mesh.rows(t.shape[0])].to(mesh.device), tree)


def replicate(mesh: Mesh, tree):
    """Rank 0's values on every rank, in place: a module's parameters and
    buffers, or every tensor of a tree, broadcast from the mesh's first
    rank. Returns the tree."""
    if mesh.group is None:
        return tree
    src = 0 if mesh.group is dist.group.WORLD else \
        dist.get_global_rank(mesh.group, 0)
    tensors = []
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        _map(tensors.append, tree)
    with torch.no_grad():
        for t in tensors:
            if t.dtype == torch.bool:
                u = t.to(torch.uint8)
                dist.broadcast(u, src, group=mesh.group)
                t.copy_(u.to(torch.bool))
            else:
                dist.broadcast(t.data, src, group=mesh.group)
    return tree


def all_gather_rows(t: torch.Tensor, mesh: Optional[Mesh],
                    grad: bool = False) -> torch.Tensor:
    """Every rank's `t` concatenated along dim 0 in rank order. With
    `grad`, through `torch.distributed.nn.functional.all_gather`, whose
    backward sums each rank's gradient of the gathered rows back to its
    owner. Identity without a group."""
    if mesh is None or mesh.group is None:
        return t
    if grad:
        import torch.distributed.nn.functional as dnn
        return torch.cat(dnn.all_gather(t.contiguous(), group=mesh.group))
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def all_reduce_mean_grads(grads, mesh: Optional[Mesh]) -> list:
    """The per-rank gradients of the replicated parameters, summed over
    the ranks in one flat all-reduce and divided by the size.

    Every rank computes the same global-batch loss L from the gathered
    rows, so the gathers' backward hands each rank p times its rows'
    share of dL/dtheta: the sum over ranks is p dL/dtheta, and the
    division (exact for a power of two) leaves world 1's gradient."""
    grads = list(grads)
    if mesh is None or mesh.group is None:
        return grads
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.group)
    flat.mul_(1.0 / mesh.size)
    return list(_unflatten_dense_tensors(flat, grads))


def make_mesh_2d(n_data: int, n_model: int,
                 axes: Tuple[str, str] = ("data", "model"), device=None):
    """A 2-D `DeviceMesh` (data x model) over the first n_data * n_model
    ranks, for combined data and tensor parallelism."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = _local_device(device)
    return init_device_mesh(dev.type, (n_data, n_model),
                            mesh_dim_names=tuple(axes))


def _tp_placements(shape, mesh_2d, min_size: int = 1 << 16,
                  model_axis: str = "model"):
    """The DTensor placements of one leaf, JAX's `shard_params_tp` rules:
    a 2-D leaf of at least `min_size` elements is sharded on dim 1 over
    the model axis where dim 1 divides by its size, else on dim 0 where
    dim 0 divides; everything else is replicated. The data axis always
    replicates."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_2d.mesh_dim_names
    size = mesh_2d.size(names.index(model_axis))
    model = Replicate()
    n = 1
    for s in shape:
        n *= s
    if len(shape) == 2 and n >= min_size:
        if shape[1] % size == 0:
            model = Shard(1)
        elif shape[0] % size == 0:
            model = Shard(0)
    return [model if name == model_axis else Replicate() for name in names]


def shard_params_tp(mesh_2d, params, min_size: int = 1 << 16,
                    model_axis: str = "model"):
    """Tensor-parallel placement of a tree of tensors (a module's state
    dict, centers, DCC tables): each leaf becomes a DTensor under
    `_tp_placements`; the classifier's matmul then runs column-parallel."""
    from torch.distributed.tensor import distribute_tensor

    def place(x):
        return distribute_tensor(
            x, mesh_2d, _tp_placements(tuple(x.shape), mesh_2d, min_size,
                                      model_axis))
    return _map(place, params)


def sharded_gallery_topk(mesh: Mesh, query: torch.Tensor,
                         gallery: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed brute-force kNN (JAX mesh.py:141-195): each rank takes
    its block of the gallery (N divisible by the size), ranks the
    squared distances |q|^2 + |g|^2 - 2 q.g (f32, no clamp, as JAX writes
    it outside Pallas) and keeps its top k, adds its block's base to the
    indices; one all_gather of the (Q, 2k) candidates, then the global
    top k of the p k candidates. Ties go to the lower index / the lower
    rank, as `lax.top_k`'s do. Returns (distances (Q, k) ascending,
    global indices (Q, k) int64), on every rank."""
    n = gallery.shape[0]
    rows = mesh.rows(n)
    qf = query.to(torch.float32)
    gf = gallery[rows].to(torch.float32)
    d = (torch.sum(qf * qf, 1, keepdim=True) + torch.sum(gf * gf, 1)[None]
         - 2.0 * (qf @ gf.T))
    vals, idx = torch.sort(d, dim=1, stable=True)
    vals, idx = vals[:, :k], idx[:, :k] + rows.start
    q = query.shape[0]
    all_d = all_gather_rows(vals.contiguous(), mesh)        # (p Q, k)
    all_i = all_gather_rows(idx.contiguous(), mesh)
    all_d = all_d.reshape(mesh.size, q, k).permute(1, 0, 2).reshape(q, -1)
    all_i = all_i.reshape(mesh.size, q, k).permute(1, 0, 2).reshape(q, -1)
    mv, mpos = torch.sort(all_d, dim=1, stable=True)
    return mv[:, :k], torch.gather(all_i, 1, mpos[:, :k])
