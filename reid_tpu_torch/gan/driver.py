"""GAN training drivers: per-group DCGAN, VAE-GAN and the LSRO baseline.
Counterpart of `reid_tpu/gan/driver.py`:

  * `get_groups` (ref `gan/kmeans_.py:16-49`): per-image appearance groups
    by k-means (`ops/kmeans.py`) over a representation, by default a
    pyramid of pooled colour statistics (`_default_repres`: no ImageNet
    weights may be downloaded); `make_resnet_embed_fn` gives the
    reference's ResNet-50 GAP features from a local torchvision-layout
    state dict;
  * `train_gan_groups` (ref `gan/synthetic_main.py:279-397`): one G / D
    pair trained over the k groups in turn, a fresh EMA for each group,
    and a checkpoint `gan_group{g}.npz` a group (`save_gan_state`; the
    reference's `Generate_model_trained_group{g}.pt`);
  * `generate_group_images`, `train_vaegan` (ref :103-266) and
    `sample_vaegan`;
  * `train_lsro_baseline` (ref `gan/train_baseline.py:214-303`): the
    `baseline` classifier over real + generated images, SGD with momentum
    0.9, generated samples flagged 1 and given the uniform target, the
    accuracy over real samples only.

The modules are built from `torch.Generator`s seeded from `seed`; the
batches come from `numpy.random.default_rng(seed)` as in the JAX package;
the steps' z and eps are drawn on the device from a generator seeded
`seed + 1`. Images stay uint8 on the host and are scaled to [-1, 1] on
the device a batch at a time. Losses are read back once an epoch.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import build_model
from ..train.optim import SGD, Adam
from .models import VAE, Discriminator, Generator
from .train import (GANState, create_gan_state, ema_generator,
                    generate_images, lsro_loss, make_dcgan_steps,
                    make_vaegan_steps)


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# appearance grouping (ref kmeans_.py)
# ---------------------------------------------------------------------------

def _default_repres(images: torch.Tensor) -> torch.Tensor:
    """Average pools of the image on 1x1, 4x2 and 8x4 grids, concatenated
    and L2-normalized (at least 1e-6): the colour and layout statistics
    that dominate appearance clusters on person crops, standing in for
    the reference's ImageNet ResNet-50 features (kmeans_.py:16-34)."""
    x = images.to(torch.float32)
    if x.ndim != 4:
        raise ValueError(f"expected (N,H,W,3), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    feats = []
    for gh, gw in ((1, 1), (4, 2), (8, 4)):
        ph, pw = h // gh, w // gw
        v = x[:, :gh * ph, :gw * pw, :].reshape(n, gh, ph, gw, pw, c)
        feats.append(v.mean(dim=(2, 4)).reshape(n, -1))
    f = torch.cat(feats, dim=1)
    return f / torch.clamp(torch.linalg.vector_norm(f, dim=1, keepdim=True),
                           min=1e-6)


def make_resnet_embed_fn(torch_ckpt: str, device="cuda"):
    """The reference's grouping representation: the BNNeck GAP features
    (N, 2048) of a ResNet-50 trunk (`ResNetReID`, bottleneck blocks, no
    bottleneck fc) loaded from a local torchvision-layout state dict
    (`torch.load`; ref kmeans_.py:16-34 loads ImageNet weights from the
    hub). Returns `embed_fn(images)` for `get_groups(..., embed_fn=)`;
    uint8 images are scaled to [-1, 1] first."""
    from ..models.baseline import ResNetReID
    from ..utils.torch_convert import convert_torchvision_resnet

    sd = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model = ResNetReID(num_classes=1, block="bottleneck", blocks=(3, 4, 6, 3),
                       pooling="avg", bottleneck_dim=0).init_weights(
                           _seeded(0))
    convert_torchvision_resnet(sd, model, blocks=(3, 4, 6, 3),
                               bottleneck=True)
    model = model.to(device).eval()

    @torch.no_grad()
    def embed_fn(images: torch.Tensor) -> torch.Tensor:
        x = images.to(torch.float32)
        if images.dtype == torch.uint8:
            x = x / 127.5 - 1.0
        feat, _ = model(x.to(device))
        return feat

    return embed_fn


def get_groups(images: np.ndarray, k: int,
               generator: Optional[torch.Generator] = None,
               embed_fn: Optional[Callable] = None, batch: int = 256,
               device="cuda") -> np.ndarray:
    """Per-image appearance-group labels in [0, k) (ref kmeans_.py:47-49):
    the representation of each batch of `batch` images on `device`, then
    k-means from the rows that `generator` draws (`ops.kmeans`)."""
    from ..ops.kmeans import kmeans

    fn = embed_fn or _default_repres
    with torch.no_grad():
        reps = torch.cat([fn(torch.from_numpy(np.ascontiguousarray(
            images[s:s + batch])).to(device)).to(torch.float32)
            for s in range(0, len(images), batch)])
        labels, _ = kmeans(reps, k, generator=generator)
    return labels.cpu().numpy()


# ---------------------------------------------------------------------------
# per-group DCGAN driver (ref synthetic_main.py:279-397)
# ---------------------------------------------------------------------------

def _epoch_batches(n: int, bs: int, rng: np.random.Generator):
    order = rng.permutation(n)
    for s in range(0, n - bs + 1, bs):
        yield order[s:s + bs]


def _as_pm1(batch: np.ndarray) -> np.ndarray:
    """uint8 -> [-1, 1] f32 on the host (floats pass as f32)."""
    if batch.dtype == np.uint8:
        return batch.astype(np.float32) / 127.5 - 1.0
    return np.asarray(batch, np.float32)


def to_pm1(batch: np.ndarray, device) -> torch.Tensor:
    """A host batch on `device` in [-1, 1] f32: uint8 as x / 127.5 - 1 (in
    f32, as the JAX package's `_as_pm1` on the host), floats as they
    are."""
    x = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 127.5 - 1.0
    return x.to(torch.float32)


def save_gan_state(path: str, state: GANState) -> None:
    """A GAN checkpoint `.npz` (`flax_bridge.save_npz`) in flax naming and
    layout: g_params, g_stats, ema_params, d_params, d_stats and step
    (the optimizer moments are not kept)."""
    from ..utils.flax_bridge import flax_variables, save_npz

    g = flax_variables(state.generator)
    d = flax_variables(state.discriminator)
    ema = flax_variables(ema_generator(state))["params"]
    save_npz(path, {"g_params": g["params"], "g_stats": g["batch_stats"],
                    "ema_params": ema, "d_params": d["params"],
                    "d_stats": d["batch_stats"],
                    "step": np.asarray(state.step, np.int32)})


def load_gan_state(path: str, nz: int = 100, ngf: int = 64, ndf: int = 64,
                   lr: float = 2e-4, device="cuda") -> GANState:
    """The state `save_gan_state` wrote, with fresh optimizer states."""
    from ..utils.flax_bridge import load_flax_variables, load_npz

    tree = load_npz(path)
    gen, disc = Generator(nz=nz, ngf=ngf), Discriminator(ndf=ndf)
    load_flax_variables(gen, {"params": tree["ema_params"],
                              "batch_stats": tree["g_stats"]})
    ema = [p.detach().clone().to(device) for p in gen.parameters()]
    load_flax_variables(gen, {"params": tree["g_params"],
                              "batch_stats": tree["g_stats"]})
    load_flax_variables(disc, {"params": tree["d_params"],
                               "batch_stats": tree["d_stats"]})
    state, _, _ = create_gan_state(gen.to(device), disc.to(device), lr)
    state.ema_params, state.step = ema, int(tree["step"])
    return state


def train_gan_groups(
    images: np.ndarray,
    groups: Optional[np.ndarray] = None,
    k: int = 1,
    epochs: int = 20,
    batch_size: int = 64,
    nz: int = 100,
    ngf: int = 64,
    ndf: int = 64,
    lr: float = 2e-4,
    seed: int = 0,
    checkpoint_dir: str = "",
    log_fn: Callable[[str], None] = print,
    device="cuda",
) -> Tuple[GANState, List[Optional[GANState]]]:
    """Train one G / D pair (spectral G and D at `ngf` / `ndf`) over the k
    appearance groups in turn. Returns (final state, a state a group:
    a copy at the group's end, None for a group with fewer images than
    a batch, which is skipped). Each group starts a fresh EMA (ref :309)
    and, under `checkpoint_dir`, writes `gan_group{g}.npz`."""
    images = np.asarray(images)
    if groups is None:
        groups = np.zeros(len(images), np.int64)
    gen = Generator(nz=nz, ngf=ngf).init_weights(_seeded(seed))
    disc = Discriminator(ndf=ndf).init_weights(_seeded(seed + 1))
    state, g_tx, d_tx = create_gan_state(gen.to(device), disc.to(device),
                                         lr)
    step = make_dcgan_steps(g_tx, d_tx)
    rng = np.random.default_rng(seed)
    draws = torch.Generator(device=device).manual_seed(seed + 1)
    group_states: List[Optional[GANState]] = []
    for g in range(k):
        idx = np.flatnonzero(groups == g)
        if len(idx) < batch_size:
            log_fn(f"group {g}: only {len(idx)} images (<bs); skipping")
            group_states.append(None)
            continue
        state.ema_params = [p.detach().clone()
                            for p in state.generator.parameters()]
        log_fn(f"Starting training loop for group {g} "
               f"({len(idx)} images)...")
        metrics = {}
        for epoch in range(epochs):
            for b in _epoch_batches(len(idx), batch_size, rng):
                z, z2 = (torch.randn((batch_size, nz), generator=draws,
                                     device=device) for _ in range(2))
                state, metrics = step(state, to_pm1(images[idx[b]], device),
                                      z, z2)
            if metrics:
                log_fn(f"[group {g}] epoch {epoch}: "
                       f"d={float(metrics['d_loss']):.3f} "
                       f"g={float(metrics['g_loss']):.3f}")
        group_states.append(copy.deepcopy(state))
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            save_gan_state(os.path.join(checkpoint_dir, f"gan_group{g}.npz"),
                           state)
    return state, group_states


def generate_group_images(group_states: Sequence[Optional[GANState]],
                          n_per_group: int, nz: int = 100, seed: int = 2,
                          use_ema: bool = True) -> np.ndarray:
    """n images from each trained group's EMA generator (ref generate(),
    synthetic_main.py:420-451), z from a generator seeded seed + g on
    its device; (k' n, 128, 64, 3) in [-1, 1]."""
    out = []
    for g, st in enumerate(group_states):
        if st is None:          # skipped in training (too few images)
            continue
        dev = next(st.generator.parameters()).device
        out.append(generate_images(
            st, n_per_group, nz=nz, use_ema=use_ema,
            rng=torch.Generator(device=dev).manual_seed(seed + g)))
    if not out:
        raise ValueError("no trained groups to sample from "
                         "(every group was skipped)")
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# VAE-GAN driver (ref synthetic_main.py:103-266)
# ---------------------------------------------------------------------------

def train_vaegan(
    images: np.ndarray,
    epochs: int = 20,
    batch_size: int = 64,
    zdim: int = 128,
    lr: float = 2e-4,
    wasserstein: bool = False,
    gp_weight: float = 10.0,
    seed: int = 0,
    log_fn: Callable[[str], None] = print,
    device="cuda",
):
    """Train the VAE-GAN (the VAE and `Discriminator(wasserstein=)` at its
    default width, each under Adam(lr, b1 = 0.5)); returns (vae, state).
    Sample with `sample_vaegan`."""
    images = np.asarray(images)
    if len(images) < batch_size:
        raise ValueError(
            f"train_vaegan: {len(images)} images < batch_size {batch_size}; "
            "no batch would ever run")
    vae = VAE(zdim=zdim).init_weights(_seeded(seed)).to(device)
    disc = Discriminator(wasserstein=wasserstein).init_weights(
        _seeded(seed + 1)).to(device)
    init, step = make_vaegan_steps(Adam(lr, b1=0.5), Adam(lr, b1=0.5),
                                   wasserstein=wasserstein,
                                   gp_weight=gp_weight)
    state = init(vae, disc)
    rng = np.random.default_rng(seed)
    draws = torch.Generator(device=device).manual_seed(seed + 1)
    metrics = {}
    for epoch in range(epochs):
        for b in _epoch_batches(len(images), batch_size, rng):
            eps = torch.randn((batch_size, zdim), generator=draws,
                              device=device)
            gp_eps = torch.rand((batch_size, 1, 1, 1), generator=draws,
                                device=device)
            state, metrics = step(state, to_pm1(images[b], device), eps,
                                  gp_eps)
        log_fn(f"epoch {epoch}: vae={float(metrics['vae_loss']):.3f} "
               f"recon={float(metrics['recon']):.3f} "
               f"d={float(metrics['d_loss']):.3f}")
    return vae, state


@torch.no_grad()
def sample_vaegan(vae: VAE, n: int, zdim: int = 128, seed: int = 3,
                  batch: int = 64) -> np.ndarray:
    """Decode prior samples (z from a generator seeded `seed` on the VAE's
    device, a batch at a time) to n images in [-1, 1] (ref generate()
    --vae), the decoder in eval mode."""
    dev = next(vae.parameters()).device
    draws = torch.Generator(device=dev).manual_seed(seed)
    out = [vae.decode(torch.randn((batch, zdim), generator=draws,
                                  device=dev)).cpu()
           for _ in range((n + batch - 1) // batch)]
    return torch.cat(out).numpy()[:n]


# ---------------------------------------------------------------------------
# LSRO baseline trainer (ref train_baseline.py:214-303)
# ---------------------------------------------------------------------------

def train_lsro_baseline(
    real_images: np.ndarray,
    real_labels: np.ndarray,
    gen_images: np.ndarray,
    num_classes: int,
    epochs: int = 5,
    batch_size: int = 32,
    lr: float = 1e-3,
    backbone: str = "baseline",
    seed: int = 0,
    log_fn: Callable[[str], None] = print,
    device="cuda",
):
    """The classifier `backbone` (f32, its init from a generator seeded
    `seed`) trained in train mode over real + generated images with the
    LSRO loss and optax's SGD (momentum 0.9). Generated samples carry
    flag 1 and label 0 (ref dcganDataset flags, train_baseline.py:92-146);
    each epoch's accuracy counts real samples only (ref :264-267).
    Returns (flax variable tree, history of {"loss", "acc"} an epoch)."""
    from ..utils.flax_bridge import flax_variables

    real_images = np.asarray(real_images)
    gen_images = np.asarray(gen_images)
    if real_images.dtype != gen_images.dtype:
        real_images, gen_images = _as_pm1(real_images), _as_pm1(gen_images)
    n_real, n_gen = len(real_images), len(gen_images)
    images = np.concatenate([real_images, gen_images])
    labels = np.concatenate([np.asarray(real_labels, np.int64),
                             np.zeros(n_gen, np.int64)])
    flags = np.concatenate([np.zeros(n_real, np.float32),
                            np.ones(n_gen, np.float32)])
    model = build_model(backbone, num_classes=num_classes, device=device,
                        generator=_seeded(seed))
    params = list(model.parameters())
    tx = SGD(lr, momentum=0.9)
    opt_state = tx.init(params)

    def step(imgs, labs, flgs):
        out = model(imgs, train=True)
        logits = out[1] if isinstance(out, tuple) else out
        loss = lsro_loss(logits, labs, flgs)
        tx.apply(params, torch.autograd.grad(loss, params), opt_state)
        real = 1.0 - flgs
        correct = torch.sum((logits.argmax(dim=-1) == labs) * real)
        return torch.stack([loss.detach(), correct, real.sum()])

    rng = np.random.default_rng(seed)
    history = []
    for epoch in range(epochs):
        sums = [step(to_pm1(images[b], device),
                     torch.from_numpy(labels[b]).to(device),
                     torch.from_numpy(flags[b]).to(device))
                for b in _epoch_batches(len(images), batch_size, rng)]
        tot = (torch.stack(sums).cpu().numpy().astype(np.float64)
               if sums else np.zeros((0, 3)))
        acc = float(tot[:, 1].sum() / max(tot[:, 2].sum(), 1.0))
        history.append({"loss": float(tot[:, 0].sum() / max(len(tot), 1)),
                        "acc": acc})
        log_fn(f"epoch {epoch}: loss={history[-1]['loss']:.4f} acc={acc:.4f}")
    return flax_variables(model), history
