"""Constant-velocity Kalman filter batched over track slots.

Counterpart of `reid_tpu/tracking/kalman.py` (state [x, y, a, h, vx, vy, va,
vh], measurement [x, y, a, h], noise scaled by the box height). Every
function takes leading batch axes (streams, then track slots): the JAX
package vmaps the same functions over them. The Cholesky factor comes from
`torch.linalg.cholesky_ex`, which does not check `info` and so never waits
for the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

W_POS = 1.0 / 20.0
W_VEL = 1.0 / 160.0
# chi-square 0.95 quantile, 4 dof - the DeepSort gating threshold.
CHI2_GATE_4DOF = 9.4877


def _f(device) -> torch.Tensor:
    return (torch.eye(8, device=device)
            + torch.diag(torch.ones(4, device=device), 4))


def _diag(std: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(std * std)


def kalman_initiate(measurement: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """New tracks from xyah measurements (..., 4) -> mean (..., 8), cov
    (..., 8, 8)."""
    h = measurement[..., 3]
    mean = torch.cat([measurement, torch.zeros_like(measurement)], dim=-1)
    one = torch.ones_like(h)
    std = torch.stack([
        2 * W_POS * h, 2 * W_POS * h, 1e-2 * one, 2 * W_POS * h,
        10 * W_VEL * h, 10 * W_VEL * h, 1e-5 * one, 10 * W_VEL * h,
    ], dim=-1)
    return mean, _diag(std)


def _motion_noise(h):
    one = torch.ones_like(h)
    return _diag(torch.stack([W_POS * h, W_POS * h, 1e-2 * one, W_POS * h,
                              W_VEL * h, W_VEL * h, 1e-5 * one, W_VEL * h],
                             dim=-1))


def _measurement_noise(h):
    one = torch.ones_like(h)
    return _diag(torch.stack([W_POS * h, W_POS * h, 1e-1 * one, W_POS * h],
                             dim=-1))


def kalman_predict(mean: torch.Tensor, cov: torch.Tensor):
    """One step of x' = Fx: mean (..., 8), cov (..., 8, 8)."""
    f = _f(mean.device)
    q = _motion_noise(mean[..., 3])
    return mean @ f.T, f @ cov @ f.T + q


def _project(mean, cov, r):
    # H selects the position block: H m and H C H^T are slices
    return mean[..., :4], cov[..., :4, :4] + r


def kalman_update(mean, cov, measurement,
                  confidence: Optional[torch.Tensor] = None):
    """Measurement update; `confidence` (...,) enables StrongSort's NSA
    Kalman (measurement noise scaled by 1 - confidence)."""
    r = _measurement_noise(mean[..., 3])
    if confidence is not None:
        r = r * torch.clamp(1.0 - confidence, min=1e-4)[..., None, None]
    pm, pc = _project(mean, cov, r)
    chol = torch.linalg.cholesky_ex(pc).L
    # gain K = C H^T (H C H^T + R)^-1, via a Cholesky solve of (H C)
    k = torch.cholesky_solve(cov[..., :4, :], chol).transpose(-1, -2)
    innov = measurement - pm
    new_m = mean + (k @ innov[..., None])[..., 0]
    new_c = cov - k @ pc @ k.transpose(-1, -2)
    return new_m, new_c


def kalman_gating_distance(mean, cov, measurements):
    """Squared Mahalanobis distance of each measurement to each track:
    mean (..., T, 8), cov (..., T, 8, 8), measurements (..., D, 4) ->
    (..., T, D)."""
    pm, pc = _project(mean, cov, _measurement_noise(mean[..., 3]))
    chol = torch.linalg.cholesky_ex(pc).L
    d = measurements[..., None, :, :] - pm[..., :, None, :]    # (.., T, D, 4)
    z = torch.linalg.solve_triangular(chol, d.transpose(-1, -2), upper=False)
    return torch.sum(z * z, dim=-2)
