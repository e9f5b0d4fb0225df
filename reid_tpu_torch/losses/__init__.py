"""Losses of the training slice: plain functions on tensors.

Counterpart of `reid_tpu/losses/` (utils, triplet, center, identification,
dcc, circle, ranked, xbm, hybrid). The stateful parts (centers, DCC
tables, the XBM ring) are explicit state of the train step, as in the JAX
package.
"""

from .center import center_loss
from .circle import circle_loss
from .dcc import DCCState, dcc_loss, init_dcc, update_dcc_luts
from .hybrid import HybridLossState, hybrid_loss, init_hybrid_state
from .identification import (cross_entropy_label_smooth, focal_loss,
                             label_smoothing_nll)
from .ranked import ranked_loss
from .triplet import (hard_example_mining, semi_hard_triplet, triplet_beta,
                      triplet_loss_batch_hard, weighted_regularized_triplet)
from .utils import cosine_dist, euclidean_dist, normalize, softmax_weights
from .xbm import XBMState, init_xbm, xbm_enqueue, xbm_triplet_loss

__all__ = [
    "center_loss", "circle_loss", "ranked_loss", "DCCState", "dcc_loss",
    "init_dcc", "update_dcc_luts",
    "HybridLossState", "hybrid_loss", "init_hybrid_state",
    "cross_entropy_label_smooth", "focal_loss", "label_smoothing_nll",
    "hard_example_mining", "semi_hard_triplet", "triplet_beta",
    "triplet_loss_batch_hard", "weighted_regularized_triplet",
    "cosine_dist", "euclidean_dist", "normalize", "softmax_weights",
    "XBMState", "init_xbm", "xbm_enqueue", "xbm_triplet_loss"]
