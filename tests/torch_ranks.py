"""Gloo ranks for the port's distributed tests on the CPU.

`launch(world, job)` starts `world` fresh interpreters as subprocesses
(never a fork of the test process, whose JAX threads a fork can deadlock
on). Each imports torch and the port, never JAX, takes two torch threads,
joins a gloo group at tcp://127.0.0.1:<free port> through
`parallel.init_distributed`, runs the programs that the job names, in
order, and saves its results; the parent returns them by rank. A run
past `timeout` seconds kills every rank and fails, so a hung collective
costs at most that.

The rank programs are in this module (it imports no JAX): each takes the
mesh over the whole group and the job's inputs, and returns what the
test compares.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def launch(world: int, job: dict, timeout: float = 120.0) -> list:
    """Run `job["programs"]` on `world` gloo ranks; a list (by rank) of
    {program name: result}."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        torch.save(job, os.path.join(d, "job.pt"))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO, HERE, os.environ.get("PYTHONPATH", "")]),
            RANKS_DIR=d, RANKS_PORT=str(port), WORLD_SIZE=str(world),
            OMP_NUM_THREADS="2")
        procs = []
        for r in range(world):
            log = open(os.path.join(d, f"log{r}.txt"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", "import torch_ranks; "
                 "torch_ranks._rank_main()"], env=dict(env, RANK=str(r)),
                stdout=log, stderr=subprocess.STDOUT, cwd=d), log))
        deadline = time.monotonic() + timeout
        try:
            for p, _ in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        logs = [open(os.path.join(d, f"log{r}.txt")).read()
                for r in range(world)]
        for r, (p, _) in enumerate(procs):
            assert p.returncode == 0, (
                f"rank {r} of {world} exited {p.returncode} (timeout "
                f"{timeout:.0f} s):\n{logs[r][-4000:]}")
        return [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False)
                for r in range(world)]


def _rank_main():
    from reid_tpu_torch.parallel import default_mesh, init_distributed

    torch.set_num_threads(2)
    d = os.environ["RANKS_DIR"]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    init_distributed(f"tcp://127.0.0.1:{os.environ['RANKS_PORT']}", world,
                     rank, device="cpu")
    job = torch.load(os.path.join(d, "job.pt"), weights_only=False)
    mesh = default_mesh("cpu")
    out = {}
    for name in job["programs"]:
        out[name] = PROGRAMS[name](mesh, job)
    torch.save(out, os.path.join(d, f"out{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


PROGRAMS = {}


def program(fn):
    PROGRAMS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------- parallel


@program
def topk(mesh, job):
    from reid_tpu_torch.parallel import sharded_gallery_topk
    q, g, k = job["topk"]
    return sharded_gallery_topk(mesh, torch.from_numpy(q),
                                torch.from_numpy(g), k)


@program
def jaccard(mesh, job):
    from reid_tpu_torch.ops.rerank import (compute_jaccard_distance_sharded,
                                           jaccard_distance)
    out = [compute_jaccard_distance_sharded(
        mesh, torch.from_numpy(f), k1=k1, k2=k2, sparse_s=s).numpy()
        for f, k1, k2, s in job["jaccard"]]
    f, k1, k2, _ = job["jaccard"][0]
    # the dispatcher: "ivf" degrades to the sharded sparse path
    out.append(jaccard_distance(torch.from_numpy(f), k1=k1, k2=k2,
                                search_option="ivf", mesh=mesh).numpy())
    return out


@program
def place(mesh, job):
    from reid_tpu_torch.parallel import place_batch, replicate, shard_batch
    batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    placed = place_batch(mesh, batch)
    tree = {"w": torch.full((3, 2), float(mesh.rank)),
            "b": [torch.arange(4) * (mesh.rank + 1),
                  torch.tensor([mesh.rank == 0, True])]}
    replicate(mesh, tree)
    return {"placed": placed, "replicated": tree,
            "sharded": shard_batch(mesh, {"x": batch["images"]})}


@program
def tp(mesh, job):
    from torch.distributed.tensor import Replicate, Shard
    from reid_tpu_torch.parallel import make_mesh_2d, shard_params_tp
    m2 = make_mesh_2d(1, mesh.size)
    params = {k: torch.zeros(shape) for k, shape in job["tp"].items()}
    placed = shard_params_tp(m2, params, min_size=1024)

    def name(pl):
        return ("model_1" if pl == Shard(1) else "model_0"
                if pl == Shard(0) else "none" if pl == Replicate() else
                str(pl))
    specs = {k: [name(pl) for pl in v.placements] for k, v in placed.items()}
    w = shard_params_tp(m2, {"k": torch.ones((256, 512))},
                        min_size=1024)["k"]
    x = torch.ones((8, 256))
    from torch.distributed.tensor import distribute_tensor
    out = torch.matmul(distribute_tensor(x, m2, [Replicate(), Replicate()]),
                       w)
    return {"specs": specs, "local": tuple(w.to_local().shape),
            "out": out.full_tensor(), "out_placements": [
                name(pl) for pl in out.placements]}


@program
def norms(mesh, job):
    """Train-mode BatchNorm and BatchRenorm on this rank's rows under
    global statistics: outputs, running statistics and input gradients."""
    from reid_tpu_torch.models.layers import BatchNorm, BatchRenorm
    return [norm_step(cls, mesh, job["norms"]) for cls in (BatchNorm,
                                                           BatchRenorm)]


def norm_step(cls, mesh, data):
    """One train-mode call of a fresh `cls` on this rank's rows of x (the
    whole batch at world 1), the upstream gradient g: (y rows, running
    mean, running var, dx rows)."""
    from reid_tpu_torch.models.layers import global_batch_stats
    x, g = (torch.from_numpy(a) for a in data)
    rows = slice(None) if mesh is None else mesh.rows(x.shape[0])
    norm = cls(x.shape[-1])
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.5, x.shape[-1]))
        norm.bias.copy_(torch.linspace(-0.2, 0.3, x.shape[-1]))
    xr = x[rows].clone().requires_grad_()
    with global_batch_stats(None if mesh is None else mesh.group):
        y = norm(xr, train=True)
    (y * g[rows]).sum().backward()
    return (y.detach(), norm.running_mean.clone(), norm.running_var.clone(),
            xr.grad)


def toy_embed(crops):
    m = crops.to(torch.float32).mean(dim=(1, 2))
    return torch.cat([m, m * 2.0, m * 0.5], dim=1)


def run_streams(mesh, data, method, chunk, max_tracks, max_dets, crop_hw):
    """The stream tracker over every chunk of `data` (frames, tlwh, conf,
    valid; numpy, a leading stream axis), sharded over `mesh` (None: one
    process); the outputs concatenated over time."""
    from reid_tpu_torch.tracking.methods import method_config
    from reid_tpu_torch.tracking.streams import (init_stream_states,
                                                 make_stream_tracker)
    cfg = method_config(method, max_tracks=max_tracks, max_dets=max_dets,
                        crop_hw=crop_hw)
    run = make_stream_tracker(cfg, toy_embed, crop_hw, chunk=chunk,
                              device="cpu", mesh=mesh)
    st = init_stream_states(data[0].shape[0], max_tracks, 9, device="cpu")
    outs = []
    for s in range(0, data[0].shape[1], chunk):
        st, o = run(st, *[torch.from_numpy(x[:, s:s + chunk]) for x in data])
        outs.append(o)
    return {k: torch.cat([o[k] for o in outs], 1).numpy() for k in outs[0]}


@program
def streams(mesh, job):
    return run_streams(mesh, *job["streams"])


# ------------------------------------------------------------------- train


def port_train_state(payload, tc, device="cpu"):
    """The port's train state from the test's flax variables, centers and
    DCC tables (numpy), with fresh optimizer state and one step an
    epoch, as the JAX state it mirrors was built."""
    from reid_tpu_torch.losses import DCCState
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.train.state import create_train_state
    from reid_tpu_torch.utils.flax_bridge import load_flax_variables
    model = build_model("seres18", num_classes=tc.model.num_classes,
                        dtype=torch.float32, device=device)
    load_flax_variables(model, payload["variables"])
    state = create_train_state(model, tc, 1, torch.Generator())
    state.loss_state = state.loss_state._replace(
        centers=torch.tensor(payload["centers"]),
        dcc=DCCState(*[torch.tensor(t) for t in payload["dcc"]]))
    return state


def replay_draws(draws):
    """`augment_draws` replaced by the test's global-batch draws, one set
    a step, in order."""
    from reid_tpu_torch.train import steps
    queue = list(draws)

    def next_draws(generator, b, h, w, pad=10, device="cpu"):
        d = queue.pop(0)
        assert d["flip_u"].shape[0] == b, (d["flip_u"].shape, b)
        return {k: torch.from_numpy(v) for k, v in d.items()}
    steps.augment_draws = next_draws


def run_train_cnn(mesh, job, ckpt_dir):
    from reid_tpu_torch.data.dataset import synthetic_dataset
    from reid_tpu_torch.train import steps
    from reid_tpu_torch.train.image_train import train_cnn
    tj = job["train_cnn"]
    tc = tj["config"]
    keep = steps.augment_draws
    replay_draws(tj["draws"])
    ds = synthetic_dataset(**tj["dataset"])
    state = port_train_state(tj, tc)
    try:
        state, losses = train_cnn(tc, ds, state=state, log_every=1,
                                  ckpt_dir=ckpt_dir, device="cpu",
                                  mesh=mesh)
    finally:
        steps.augment_draws = keep
    return {"losses": losses, "files": sorted(os.listdir(ckpt_dir))
            if os.path.isdir(ckpt_dir) else [],
            "centers": state.loss_state.centers,
            "params": [p.detach().clone() for p in state.model.parameters()]}


@program
def train_main(mesh, job):
    """`cli.train_main` (bf16 SERes18, the CLI's defaults) on a small
    Market-style tree at 64x32 that each rank writes for itself, joining
    the group's mesh through `mesh_from_env` as under `torchrun`: what it
    printed, whether it returned a state, the files it wrote and the
    trained parameters."""
    import contextlib
    import io
    from reid_tpu_torch.cli import train_main as cli_train_main
    from reid_tpu_torch.data.datasets import write_synthetic_tree
    d = os.path.join(os.environ["RANKS_DIR"], f"train_main{mesh.rank}")
    root = write_synthetic_tree(os.path.join(d, "market"), "market1501",
                                **job["train_main"]["tree"])
    ckpt_dir = os.path.join(d, "ckpt")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), \
            torch.backends.mkldnn.flags(enabled=False):
        state = cli_train_main(["--root", root] + job["train_main"]["flags"],
                               device="cpu", ckpt_dir=ckpt_dir)
    return {"printed": printed.getvalue().splitlines(),
            "trained": state is not None,
            "files": sorted(os.listdir(ckpt_dir))
            if os.path.isdir(ckpt_dir) else [],
            "params": [] if state is None else
            [p.detach().clone() for p in state.model.parameters()]}


@program
def train_cnn(mesh, job):
    return run_train_cnn(mesh, job, os.path.join(os.environ["RANKS_DIR"],
                                                  f"ckpt{mesh.rank}"))


def run_retrieval(mesh, job):
    """`run_inference` with re-ranking on the test's split."""
    from reid_tpu_torch.data.dataset import synthetic_dataset
    from reid_tpu_torch.eval.inference import run_inference
    from reid_tpu_torch.models import build_model
    rj = job["inference"]
    model = build_model("seres18", num_classes=4, dtype=torch.float32,
                        device="cpu",
                        generator=torch.Generator().manual_seed(0)).eval()
    query = synthetic_dataset(**rj["query"])
    gallery = synthetic_dataset(**rj["gallery"])
    with torch.inference_mode():
        cmc, mAP = run_inference(model, query, gallery, rj["config"],
                                 rerank=True, verbose=False, device="cpu",
                                 mesh=mesh)
    return {"cmc": np.asarray(cmc), "mAP": float(mAP)}


@program
def inference(mesh, job):
    return run_retrieval(mesh, job)


def run_video_step(mesh, job):
    """The video train step from one seeded model on each of the test's
    batches; this rank's rows under a mesh."""
    from reid_tpu_torch.config import Config
    from reid_tpu_torch.models import build_model
    from reid_tpu_torch.parallel import place_batch
    from reid_tpu_torch.train.video_train import (create_video_train_state,
                                                  make_video_train_step)
    vj = job["video"]
    model = build_model("video_resnet50", num_classes=vj["classes"],
                        dtype=torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(0),
                        blocks=(1, 1, 1, 1))
    state = create_video_train_state(model, vj["classes"],
                                     torch.Generator().manual_seed(1))
    step = make_video_train_step(Config(), mesh=mesh)
    losses = []
    for images, labels in vj["batches"]:
        batch = {"images": torch.from_numpy(images),
                 "labels": torch.from_numpy(labels)}
        if mesh is not None:
            batch = place_batch(mesh, batch)
        state, loss = step(state, batch)
        losses.append(float(loss))
    return {"losses": losses, "grad_sum": state.opt_state["grad_sum"],
            "params": [p.detach().clone() for p in model.parameters()],
            "centers": state.loss_state.centers}


@program
def video(mesh, job):
    return run_video_step(mesh, job)
