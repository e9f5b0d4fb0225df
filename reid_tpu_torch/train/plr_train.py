"""PLR-OSNet's dual-branch training (ref `image_reid_train.py:190-260`,
train_plr_osnet).

Counterpart of `reid_tpu/train/plr_train.py`: two hybrid losses, one a
branch (the global 4-part feature of 4 x 512 with classifier1, the local
512-d feature with classifier2), each with its own centers and DCC
tables; the total loss is loss1 + loss2. The model optimizer is
`make_optimizers`' PLR-OSNet branch (MADGRAD without PK sampling, Adam
with it); both center tables take the stateless center SGD (the JAX
package keeps one optax state each, `copt1` / `copt2`, of an SGD without
momentum, which holds nothing). The step feeds the batch's images as they
are (no augmentation) and no camera. The JAX package's `train_main`
never reaches this loop (ROADMAP C), so it is a library, as there.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..config import Config
from ..losses import HybridLossState, hybrid_loss, init_hybrid_state, \
    update_dcc_luts
from ..models import build_model
from .state import CenterSGD, make_optimizers

# the widths of the two branches' features
GLOBAL_DIM, LOCAL_DIM = 4 * 512, 512


@dataclasses.dataclass
class PLRTrainState:
    """The model, the two branches' loss states, the optimizers and their
    state, and the number of steps taken."""
    model: torch.nn.Module
    loss1: HybridLossState          # global branch (4 x 512)
    loss2: HybridLossState          # local branch (512)
    opt_state: dict
    tx: object
    center_tx: CenterSGD
    step: int = 0

    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def create_plr_train_state(cfg: Config, steps_per_epoch: int,
                           generator: Optional[torch.Generator] = None,
                           device="cuda") -> PLRTrainState:
    """A fresh state: `plr_osnet` at `cfg.model`'s classes and dtype and
    both branches' centers drawn from `generator` (a fresh one seeded
    `cfg.train.seed` when None), zero DCC tables, fresh optimizer state,
    all on `device`."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    model = build_model("plr_osnet", num_classes=cfg.model.num_classes,
                        num_cams=cfg.model.num_cams,
                        dtype=getattr(torch, cfg.model.dtype), device=device,
                        generator=generator)
    tx, center_tx = make_optimizers(cfg, steps_per_epoch)
    n = cfg.model.num_classes
    return PLRTrainState(
        model=model,
        loss1=init_hybrid_state(n, GLOBAL_DIM, generator, device),
        loss2=init_hybrid_state(n, LOCAL_DIM, generator, device),
        opt_state=tx.init(list(model.parameters())), tx=tx,
        center_tx=center_tx)


def make_plr_train_step(cfg: Config):
    """step(state, batch) -> (state, metrics), updating `state` in place
    (ref :219-246): the train-mode forward gives (v1, v2), (y1, y2); loss
    = H1(v1, y1) + H2(v2, y2); gradients for the parameters and both
    center tables; the model update, the rescaled center updates, and
    both DCC tables from their branch's logits. batch: images (B, H, W, 3)
    normalized float, labels (B,). Nothing is read back to the host:
    metrics ("loss", "loss1", "loss2") are device scalars. Under PK
    sampling with K dividing B the DCC tables take K rounds
    (`make_train_step` says why), else B (the JAX package's scan over the
    batch; a round past a class's last instance writes nothing), so that
    no round count is read from the labels."""
    k = cfg.train.num_instances
    pk_rounds = k if k > 0 and cfg.train.batch_size % k == 0 else None

    def step(state: PLRTrainState, batch: dict):
        labels = batch["labels"]
        rounds = pk_rounds or labels.shape[0]
        (v1, v2), (y1, y2) = state.model(batch["images"], train=True)
        v1, v2 = v1.to(torch.float32), v2.to(torch.float32)
        y1, y2 = y1.to(torch.float32), y2.to(torch.float32)
        c1 = state.loss1.centers.detach().requires_grad_()
        c2 = state.loss2.centers.detach().requires_grad_()
        l1, _ = hybrid_loss(state.loss1._replace(centers=c1), v1, y1,
                            labels, cfg.loss)
        l2, _ = hybrid_loss(state.loss2._replace(centers=c2), v2, y2,
                            labels, cfg.loss)
        total = l1 + l2
        params = state.params()
        grads = torch.autograd.grad(total, params + [c1, c2],
                                    allow_unused=True,
                                    materialize_grads=True)
        state.tx.apply(params, grads[:-2], state.opt_state)
        m = cfg.loss.dcc_momentum
        with torch.no_grad():
            state.loss1 = HybridLossState(
                centers=state.center_tx.apply(c1.detach(), grads[-2]),
                dcc=update_dcc_luts(state.loss1.dcc, y1.detach(), labels,
                                    momentum=m, rounds=rounds))
            state.loss2 = HybridLossState(
                centers=state.center_tx.apply(c2.detach(), grads[-1]),
                dcc=update_dcc_luts(state.loss2.dcc, y2.detach(), labels,
                                    momentum=m, rounds=rounds))
        state.step += 1
        return state, {"loss": total.detach(), "loss1": l1.detach(),
                       "loss2": l2.detach()}

    return step
