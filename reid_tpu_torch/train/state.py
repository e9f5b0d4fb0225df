"""Train state: the model, the loss state, both optimizers and the step.

Counterpart of `reid_tpu/train/state.py` for every branch of
`make_optimizers`: the CNN loops', PLR-OSNet's and the transformers' (ref
image_reid_train.py:49-56, :87, :92-95, :196-201, :271-277). The model
optimizer is optax's chain written out as explicit updates on tensors:
`clip_by_global_norm(grad_clip)` (g * max / |g| only where |g| > max, the
norm without an epsilon; `clip_grad_norm_` adds 1e-6 and is not used) ->
`add_decayed_weights(weight_decay)` (L2 into the gradient, on every
parameter, norm scales included) -> Adam (eps 1e-8 outside the root,
bias correction at the incremented count), SGD with Nesterov momentum
0.9, or plain SGD without momentum (the transformers under PK
sampling); the lr is the schedule at the count before the increment.
PLR-OSNet without PK sampling takes MADGRAD inside the same clip
(`train/optim.py`). The centers take `scale(1 / lamda)` ->
`sgd(center_lr)`.
Updates run in place on the parameters and moments with `torch._foreach`
ops (a handful of multi-tensor launches a step) and read nothing back to
the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..config import Config
from ..losses import HybridLossState, XBMState, init_hybrid_state, init_xbm
from ..models.factory import TRANSFORMERS
from .optim import Madgrad, adam_direction, clip_by_global_norm
from .schedules import Schedule, warmup_cosine_schedule

_B1, _B2, _EPS = 0.9, 0.999, 1e-8      # optax.adam's defaults
_MOMENTUM = 0.9                        # the SGD branch (ref :55)


class ModelOptimizer:
    """optax.chain(clip_by_global_norm, add_decayed_weights, adam | sgd)
    over a list of parameters; the SGD has Nesterov momentum 0.9, or
    none with `momentum=False` (optax.sgd(schedule): no trace, the
    update is -lr g)."""

    def __init__(self, schedule: Schedule, weight_decay: float,
                 grad_clip: float, adam: bool, momentum: bool = True):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.adam = adam
        self.momentum = momentum

    def init(self, params: List[torch.Tensor]) -> dict:
        zeros = lambda: [torch.zeros_like(p) for p in params]   # noqa: E731
        if self.adam:
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        if not self.momentum:
            return {"count": 0}
        return {"count": 0, "trace": zeros()}

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: dict) -> None:
        """One update of `params` and `state`, in place."""
        g = clip_by_global_norm(list(grads), self.grad_clip)
        torch._foreach_add_(g, params, alpha=self.weight_decay)
        lr = self.schedule(state["count"])
        count = state["count"] + 1
        if self.adam:
            upd = adam_direction(g, state["mu"], state["nu"], count, _B1,
                                 _B2, _EPS)
        elif not self.momentum:
            upd = g
        else:
            trace = state["trace"]
            torch._foreach_mul_(trace, _MOMENTUM)
            torch._foreach_add_(trace, g)
            upd = torch._foreach_add(g, trace, alpha=_MOMENTUM)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        state["count"] = count


class CenterSGD:
    """optax.chain(scale(1 / lamda), sgd(lr)): stateless."""

    def __init__(self, lamda: float, lr: float):
        self.scale = 1.0 / lamda
        self.lr = lr

    @torch.no_grad()
    def apply(self, centers: torch.Tensor, grad: torch.Tensor
              ) -> torch.Tensor:
        return centers + (grad * self.scale) * -self.lr


def make_optimizers(cfg: Config, steps_per_epoch: int):
    """(model optimizer, center optimizer), per reference branch:

    * the CNN loops (ref image_reid_train.py:51-56): Adam(lr, wd) under PK
      sampling, else SGD-Nesterov, both under the WarmUpCosine schedule;
    * PLR-OSNet's loop (ref :196-201): Adam as above under PK sampling,
      else MADGRAD under its own WarmUpCosine from 0.01, weight decay
      5e-4, momentum 0.9;
    * the transformer loop (ref :271-277), the branch inverted: plain SGD
      without momentum from 0.008 under PK sampling, else Adam from 0.01,
      weight decay 1e-4 either way;

    each inside the global-norm clip; centers SGD(center_lr) after the
    1/lamda rescale (ref :310-312)."""
    backbone = cfg.model.backbone
    t = cfg.train
    center_tx = CenterSGD(cfg.loss.center_lamda, t.center_lr)
    if backbone in TRANSFORMERS:
        pk = t.num_instances > 0
        schedule = warmup_cosine_schedule(0.008 if pk else 0.01, t.epochs,
                                          steps_per_epoch, t.warmup_epochs,
                                          t.hold_epochs, t.eta_min)
        return ModelOptimizer(schedule, 1e-4, t.grad_clip, adam=not pk,
                              momentum=False), center_tx
    if backbone == "plr_osnet" and t.num_instances <= 0:
        schedule = warmup_cosine_schedule(0.01, t.epochs, steps_per_epoch,
                                          t.warmup_epochs, t.hold_epochs,
                                          t.eta_min)
        return Madgrad(schedule, 5e-4, t.grad_clip, momentum=0.9), center_tx
    schedule = warmup_cosine_schedule(t.lr, t.epochs, steps_per_epoch,
                                      t.warmup_epochs, t.hold_epochs,
                                      t.eta_min)
    tx = ModelOptimizer(schedule, t.weight_decay, t.grad_clip,
                        adam=t.num_instances > 0)
    return tx, center_tx


@dataclasses.dataclass
class ReIDTrainState:
    """What a train step reads and updates: the model (its parameters and
    BatchNorm statistics), centers and DCC tables, the optimizers and their
    state, the XBM ring, and the number of steps taken."""
    model: torch.nn.Module
    loss_state: HybridLossState
    opt_state: dict
    tx: ModelOptimizer
    center_tx: CenterSGD
    step: int = 0
    xbm: Optional[XBMState] = None

    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def create_train_state(model: torch.nn.Module, cfg: Config,
                       steps_per_epoch: int, generator: torch.Generator
                       ) -> ReIDTrainState:
    """A fresh state around `model`: centers drawn from `generator`, zero
    DCC tables, fresh optimizer state, and the XBM ring under
    `cfg.loss.xbm`, all on the model's device."""
    dev = next(model.parameters()).device
    tx, center_tx = make_optimizers(cfg, steps_per_epoch)
    loss_state = init_hybrid_state(cfg.model.num_classes, cfg.model.feat_dim,
                                   generator, dev)
    xbm = init_xbm(cfg.loss.xbm_size_mult * cfg.train.batch_size,
                   cfg.model.feat_dim, dev) if cfg.loss.xbm else None
    return ReIDTrainState(model=model, loss_state=loss_state,
                          opt_state=tx.init(list(model.parameters())),
                          tx=tx, center_tx=center_tx, xbm=xbm)
