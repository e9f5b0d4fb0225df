"""The optimizers written out as `torch._foreach` updates in place: optax's
Adam moments (`adam_direction`, and `Adam` / `SGD` as the GAN and
detector drivers use `optax.adam` / `optax.sgd`), and MADGRAD (Defazio &
Jelassi 2021), the optimizer of PLR-OSNet's loop
without PK sampling (ref image_reid_train.py:201: lr 0.01, weight decay
5e-4, momentum 0.9) and of the video loop (ref video_reid_train.py:115:
lr 1e-4, weight decay 5e-4, momentum 0, no clip).

Counterpart of `reid_tpu/train/optim.py:madgrad`, inside the global-norm
clip (`optax.chain(clip_by_global_norm, madgrad)`) or, with `grad_clip`
None, bare as the video loop builds it; written as `torch._foreach`
updates on the parameters in place, as `state.ModelOptimizer` is:

    g     <- clip(g) + weight_decay * p     (L2 into the gradient)
    lamb   = lr(k) * sqrt(k + 1)            (k: updates so far)
    s     <- s + lamb * g
    v     <- v + lamb * g * g
    z      = x0 - s / (cbrt(v) + eps)       (dual averaging from x0)
    p     <- p + ((1 - c) p + c z - p),     c = 1 - momentum

in f32, lamb on the host as the JAX package's traced f32 schedule gives
it. The cube root is the one thing torch lacks: XLA computes it as libm's
powf(v, f32(1/3)); here v ** f32(1/3) is taken in float64 and rounded to
f32, which equals it but for ties of the f32 rounding (read: 0.06% of
values, 1 ulp; see tests/test_torch_plr_train.py).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .schedules import Schedule

_F = np.float32
_THIRD = float(_F(1.0) / _F(3.0))
_EPS = 1e-6                            # madgrad's default eps


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """optax's `clip_by_global_norm`: g, or (g / |g|) * max where the
    global norm |g| >= max (no epsilon), without a host read."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    grads = torch._foreach_div(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return grads


def cbrt(v: torch.Tensor) -> torch.Tensor:
    """The f32 cube root of v >= 0 (`jnp.cbrt` on XLA:CPU within 1 ulp)."""
    return v.to(torch.float64).pow(_THIRD).to(torch.float32)


class Madgrad:
    """optax.chain(clip_by_global_norm(grad_clip), madgrad(schedule,
    momentum, weight_decay)) over a list of parameters, or madgrad alone
    with `grad_clip` None; the state is {"count", "grad_sum",
    "grad_sum_sq", "x0"} (optax's `MadgradState`)."""

    def __init__(self, schedule: Schedule, weight_decay: float,
                 grad_clip: Optional[float], momentum: float = 0.9):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        ck = 1.0 - momentum
        self.keep, self.step_to = float(_F(1.0 - ck)), float(_F(ck))

    def init(self, params: List[torch.Tensor]) -> dict:
        return {"count": 0,
                "grad_sum": [torch.zeros_like(p) for p in params],
                "grad_sum_sq": [torch.zeros_like(p) for p in params],
                "x0": [p.detach().clone() for p in params]}

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: dict) -> None:
        """One update of `params` and `state`, in place."""
        if self.grad_clip is None:
            g = list(grads)
            if self.weight_decay:
                g = torch._foreach_add(g, params, alpha=self.weight_decay)
        else:
            g = clip_by_global_norm(list(grads), self.grad_clip)
            if self.weight_decay:
                torch._foreach_add_(g, params, alpha=self.weight_decay)
        k = state["count"]
        lamb = float(_F(self.schedule(k)) * np.sqrt(_F(k) + _F(1)))
        s, v = state["grad_sum"], state["grad_sum_sq"]
        lg = torch._foreach_mul(g, lamb)
        torch._foreach_add_(s, lg)
        torch._foreach_addcmul_(v, lg, g)
        # the cube roots of every moment in one pass over a flat copy
        flat = cbrt(torch.cat([t.reshape(-1) for t in v]))
        rms = [r.view_as(t) for r, t in
               zip(torch.split(flat, [t.numel() for t in v]), v)]
        torch._foreach_add_(rms, _EPS)
        z = torch._foreach_div(s, rms)
        z = torch._foreach_sub(state["x0"], z)
        new = torch._foreach_mul(params, self.keep)
        torch._foreach_add_(new, torch._foreach_mul(z, self.step_to))
        torch._foreach_sub_(new, params)
        torch._foreach_add_(params, new)
        state["count"] = k + 1


def adam_direction(g: List[torch.Tensor], mu: List[torch.Tensor],
                   nu: List[torch.Tensor], count: int, b1: float, b2: float,
                   eps: float) -> List[torch.Tensor]:
    """optax's `scale_by_adam`: moves the moments mu <- b1 mu + (1 - b1) g
    and nu <- b2 nu + (1 - b2) g^2 in place and returns mu_hat /
    (sqrt(nu_hat) + eps), bias-corrected at `count` (the incremented
    count) in f32 as optax computes 1 - b ** count."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
    bc1 = float(_F(1) - _F(b1) ** _F(count))
    bc2 = float(_F(1) - _F(b2) ** _F(count))
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, denom)
    return upd


class Adam:
    """optax.adam(lr, b1, b2, eps) over a list of parameters, a constant
    lr; the state is {"count", "mu", "nu"}."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: List[torch.Tensor]) -> dict:
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: dict) -> None:
        """One update of `params` and `state`, in place."""
        state["count"] += 1
        upd = adam_direction(list(grads), state["mu"], state["nu"],
                             state["count"], self.b1, self.b2, self.eps)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(params, upd)


class SGD:
    """optax.sgd(lr, momentum): the trace t <- g + momentum t (no
    Nesterov), the update -lr t; the state is {"count", "trace"}."""

    def __init__(self, lr: float, momentum: float = 0.9):
        self.lr, self.momentum = lr, momentum

    def init(self, params: List[torch.Tensor]) -> dict:
        return {"count": 0, "trace": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: dict) -> None:
        trace = state["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, list(grads))
        torch._foreach_add_(params, torch._foreach_mul(trace, -self.lr))
        state["count"] += 1
