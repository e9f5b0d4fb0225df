"""GAN training steps, the generator's EMA and the LSRO loss: counterpart of
`reid_tpu/gan/train.py` (ref `gan/synthetic_main.py`,
`gan/train_baseline.py`).

The DCGAN policy (ref train_gan :269-398): a D step every iteration on
real + fake with BCE, the labels flipped every 5th iteration; a G step
every 3rd, after which the parameter EMA of G follows (ref
gan_utils.py:64-95). The VAE-GAN step (ref synthetic_main.py:103-266):
the VAE minimizes reconstruction + KL + adversarial terms, D tells real
from reconstruction, with the Wasserstein loss and a gradient penalty
under `wasserstein`. `lsro_loss` (ref train_baseline.py:149-179) is CE
for real samples and the uniform target for generated ones.

The state holds the modules themselves (parameters, BatchNorm statistics,
the spectral `u` / `sigma`), optax's Adam state (b1 = 0.5) and G's EMA;
a step updates it in place and returns it. Every random draw of a step
is an argument (D's and G's z, the VAE's eps, the penalty's
interpolation weights), so a driver draws them from an explicit
`torch.Generator` and a test can feed in JAX's. The label flip follows
the step count, as in JAX. Statistics move in flax's order: the real
pass, then the fake pass from the statistics the real pass left; the
passes whose statistics flax discards (D inside G's and the VAE's loss,
the penalty's pass) run under `frozen_buffers`.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..train.optim import Adam

ADAM_B1, ADAM_B2 = 0.5, 0.999


@contextlib.contextmanager
def frozen_buffers(module: torch.nn.Module):
    """Run `module` (train-mode BatchNorm, spectral norms) and put its
    buffers back afterwards: flax's apply(..., mutable=[...]) whose
    updates the caller drops."""
    saved = [b.detach().clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)


@dataclasses.dataclass
class GANState:
    """G and D (parameters and statistics), their optimizer states, G's
    EMA parameters (in `generator.parameters()` order) and the step."""
    generator: torch.nn.Module
    discriminator: torch.nn.Module
    g_opt: dict
    d_opt: dict
    ema_params: List[torch.Tensor]
    step: int = 0


def create_gan_state(generator: torch.nn.Module,
                     discriminator: torch.nn.Module, lr: float = 2e-4):
    """(state, g_tx, d_tx) around initialized modules: Adam(lr, b1 = 0.5,
    b2 = 0.999) for each, the EMA starting at G's parameters."""
    g_tx = Adam(lr, b1=ADAM_B1, b2=ADAM_B2)
    d_tx = Adam(lr, b1=ADAM_B1, b2=ADAM_B2)
    g_params = list(generator.parameters())
    state = GANState(generator=generator, discriminator=discriminator,
                     g_opt=g_tx.init(g_params),
                     d_opt=d_tx.init(list(discriminator.parameters())),
                     ema_params=[p.detach().clone() for p in g_params])
    return state, g_tx, d_tx


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor],
               decay: float = 0.999) -> List[torch.Tensor]:
    """decay * e + (1 - decay) * p, in place on `ema` (ref gan_utils.py:
    64-95)."""
    new = torch._foreach_mul(ema, decay)
    torch._foreach_add_(new, torch._foreach_mul(list(params), 1.0 - decay))
    for e, n in zip(ema, new):
        e.copy_(n)
    return ema


def _bce(scores: torch.Tensor, target: float) -> torch.Tensor:
    s = torch.clamp(scores.reshape(-1), 1e-6, 1.0 - 1e-6)
    return -torch.mean(target * torch.log(s) + (1 - target) * torch.log(1 - s))


def make_dcgan_steps(g_tx, d_tx, flip_every: int = 5, g_every: int = 3,
                     ema_decay: float = 0.999):
    """step(state, real (B, 128, 64, 3) in [-1, 1], z (B, nz), z2 (B, nz))
    -> (state, {"d_loss", "g_loss"}): D's update on real and G(z) (G in
    train mode, its statistics kept), then at every `g_every`-th step
    G's update on G(z2) through D in train mode (D's statistics
    dropped), and the EMA. g_loss is 0 on the steps without G's update.
    The losses stay on the device."""

    def step(state: GANState, real, z, z2):
        gen, disc = state.generator, state.discriminator
        with torch.no_grad():
            fake = gen(z, train=True)
        flip = state.step % flip_every == flip_every - 1
        real_t = 0.0 if flip else 1.0
        d_params = list(disc.parameters())
        d_loss = _bce(disc(real, train=True), real_t) + \
            _bce(disc(fake, train=True), 1.0 - real_t)
        d_tx.apply(d_params, torch.autograd.grad(d_loss, d_params),
                   state.d_opt)
        g_loss = torch.zeros((), device=real.device)
        if state.step % g_every == g_every - 1:
            g_params = list(gen.parameters())
            fake = gen(z2, train=True)
            with frozen_buffers(disc):
                g_loss = _bce(disc(fake, train=True), 1.0)
            g_tx.apply(g_params, torch.autograd.grad(g_loss, g_params),
                       state.g_opt)
            ema_update(state.ema_params, g_params, ema_decay)
        state.step += 1
        return state, {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}

    return step


def ema_generator(state: GANState, use_ema: bool = True) -> torch.nn.Module:
    """A copy of G carrying its EMA parameters (or its own with `use_ema`
    False) and its statistics."""
    gen = copy.deepcopy(state.generator)
    if use_ema:
        with torch.no_grad():
            for p, e in zip(gen.parameters(), state.ema_params):
                p.copy_(e)
    return gen


@torch.no_grad()
def generate_images(state: GANState, n: int, nz: int = 100,
                    use_ema: bool = True, batch: int = 64,
                    rng: Optional[torch.Generator] = None) -> np.ndarray:
    """n images (n, 128, 64, 3) in [-1, 1] from the EMA generator in eval
    mode (ref :420-451), z drawn a batch at a time from `rng` (a
    generator on G's device seeded 0 when None)."""
    gen = ema_generator(state, use_ema)
    dev = next(gen.parameters()).device
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    out = [gen(torch.randn((batch, nz), generator=rng, device=dev)).cpu()
           for _ in range((n + batch - 1) // batch)]
    return torch.cat(out).numpy()[:n]


@dataclasses.dataclass
class VGState:
    """The VAE and D (parameters and statistics), their optimizer states
    and the step."""
    vae: torch.nn.Module
    discriminator: torch.nn.Module
    vae_opt: dict
    d_opt: dict
    step: int = 0


def _score(out):
    return out[0] if isinstance(out, tuple) else out


def make_vaegan_steps(vae_tx, d_tx, wasserstein: bool = False,
                      gp_weight: float = 10.0, recon_weight: float = 1.0,
                      kl_weight: float = 1e-3, adv_weight: float = 1e-2):
    """(init, step): init(vae, discriminator) -> VGState around
    initialized modules; step(state, real, eps (B, zdim) normal, gp_eps
    (B, 1, 1, 1) uniform) -> (state, {"vae_loss", "recon", "kl",
    "d_loss"}). The VAE's update: MSE reconstruction + KL (of var, as the
    reference) + the adversarial term through D in train mode (its
    statistics dropped). D's on real and the (old VAE's) reconstruction:
    BCE, or with `wasserstein` mean(fake) - mean(real) + gp_weight *
    mean((|grad_x D(x)| - 1)^2) at x = gp_eps real + (1 - gp_eps) fake, a
    gradient of a gradient (`create_graph`) through D's train-mode
    BatchNorm where D has one; `gp_eps` is unused without it."""

    def init(vae, discriminator) -> VGState:
        return VGState(vae=vae, discriminator=discriminator,
                       vae_opt=vae_tx.init(list(vae.parameters())),
                       d_opt=d_tx.init(list(discriminator.parameters())))

    def step(state: VGState, real, eps, gp_eps):
        vae, disc = state.vae, state.discriminator
        v_params = list(vae.parameters())
        mean, var, recon = vae(real, eps, train=True)
        rec = torch.mean(torch.square(recon - real))
        kl = 0.5 * torch.mean(mean ** 2 + var ** 2 - torch.log(
            torch.clamp(var ** 2, min=1e-8)) - 1.0)
        with frozen_buffers(disc):
            score = _score(disc(recon, train=True))
        if wasserstein:
            adv = -torch.mean(score)
        else:
            adv = -torch.mean(torch.log(torch.clamp(score, 1e-6, 1.0)))
        total = recon_weight * rec + kl_weight * kl + adv_weight * adv
        vae_tx.apply(v_params, torch.autograd.grad(total, v_params),
                     state.vae_opt)

        fake = recon.detach()
        d_params = list(disc.parameters())
        rs = _score(disc(real, train=True))
        fs = _score(disc(fake, train=True))
        if wasserstein:
            d_loss = torch.mean(fs) - torch.mean(rs)
            inter = (gp_eps * real + (1 - gp_eps) * fake).requires_grad_(True)
            with frozen_buffers(disc):
                s = _score(disc(inter, train=True)).sum()
            (g,) = torch.autograd.grad(s, inter, create_graph=True)
            gnorm = torch.sqrt(torch.sum(g ** 2, dim=(1, 2, 3)) + 1e-12)
            d_loss = d_loss + gp_weight * torch.mean((gnorm - 1.0) ** 2)
        else:
            d_loss = (-torch.mean(torch.log(torch.clamp(rs, 1e-6, 1.0)))
                      - torch.mean(torch.log(torch.clamp(1 - fs, 1e-6,
                                                         1.0))))
        d_tx.apply(d_params, torch.autograd.grad(d_loss, d_params),
                   state.d_opt)
        state.step += 1
        return state, {"vae_loss": total.detach(), "recon": rec.detach(),
                       "kl": kl.detach(), "d_loss": d_loss.detach()}

    return init, step


def lsro_loss(logits: torch.Tensor, labels: torch.Tensor,
              is_generated: torch.Tensor) -> torch.Tensor:
    """LSRO (ref train_baseline.py:149-179): CE for real samples, the
    uniform target distribution for generated ones, in f32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ce = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    uniform = -logp.mean(dim=-1)
    gen = is_generated.to(torch.float32)
    return torch.mean((1.0 - gen) * ce + gen * uniform)
