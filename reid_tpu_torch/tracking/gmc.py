"""Camera-motion compensation (GMC): the 2x3 affine between consecutive
frames that `tracker.apply_gmc` warps the tracks by (botsort).

Counterpart of `reid_tpu/tracking/gmc.py`:

  * `estimate_affine` (the per-frame `step()` path, and the chunked path's
    "host" mode) is a copy: sparse optical flow and a RANSAC partial affine
    with OpenCV where it is installed, else translation by phase
    correlation in NumPy, whole pixels of the downscaled plane;
  * `chunk_affines_translation` (the chunked path's "device" mode) is the
    batched phase correlation on tensors with `torch.fft` (the reference
    leaves its FFT to XLA), with the same automatic downscale and subpixel
    peak fit.
"""

from __future__ import annotations

import numpy as np
import torch

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def estimate_affine(prev: np.ndarray, curr: np.ndarray,
                    downscale: int = 2) -> np.ndarray:
    """Returns a 2x3 affine mapping prev-frame coords to curr-frame coords."""
    identity = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    if prev is None or curr is None:
        return identity

    def gray(img):
        img = np.asarray(img)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        if downscale > 1:
            img = img[::downscale, ::downscale]
        return img.astype(np.float32)

    g0, g1 = gray(prev), gray(curr)
    if _HAS_CV2:
        p0 = cv2.goodFeaturesToTrack(g0.astype(np.uint8), maxCorners=200,
                                     qualityLevel=0.01, minDistance=8)
        if p0 is None or len(p0) < 8:
            return identity
        p1, st, _ = cv2.calcOpticalFlowPyrLK(
            g0.astype(np.uint8), g1.astype(np.uint8), p0, None)
        good = st.reshape(-1) == 1
        if good.sum() < 8:
            return identity
        m, _ = cv2.estimateAffinePartial2D(p0[good], p1[good],
                                           method=cv2.RANSAC)
        if m is None:
            return identity
        m = m.astype(np.float32)
        m[:, 2] *= downscale
        return m

    # NumPy fallback: translation-only via phase correlation.
    f0 = np.fft.rfft2(g0 - g0.mean())
    f1 = np.fft.rfft2(g1 - g1.mean())
    cross = f0 * np.conj(f1)
    denom = np.maximum(np.abs(cross), 1e-9)
    corr = np.fft.irfft2(cross / denom, s=g0.shape)
    dy, dx = np.unravel_index(np.argmax(corr), corr.shape)
    if dy > g0.shape[0] // 2:
        dy -= g0.shape[0]
    if dx > g0.shape[1] // 2:
        dx -= g0.shape[1]
    out = identity.copy()
    out[0, 2] = -dx * downscale
    out[1, 2] = -dy * downscale
    return out


def auto_downscale(frame_h: int, frame_w: int) -> int:
    """The factor that keeps the correlation plane near 270x480."""
    return max(2, min(frame_h // 270, frame_w // 480))


def chunk_affines_translation(prev_last: torch.Tensor, frames: torch.Tensor,
                              downscale: int = 0) -> torch.Tensor:
    """Translation-only phase correlation between consecutive frames of a
    chunk, all T pairs in one batched FFT, on the device the frames lie on.

    prev_last (..., H, W, 3): the frame before the chunk (frames[..., 0,
    :, :, :] makes the first affine the identity); frames (..., T, H, W,
    3), where a leading axis is the stream axis of a batched tracker.
    Returns (..., T, 2, 3) f32 affines mapping frame t-1 coords to frame t
    coords. `downscale=0` picks `auto_downscale`; the correlation peak is
    refined to a fraction of a downscaled bin by a separable parabolic fit
    over its wrapped neighbours."""
    if downscale <= 0:
        downscale = auto_downscale(frames.shape[-3], frames.shape[-2])
    ds = downscale
    # subsample before the channel mean: the same values, a fraction of the
    # memory of a float copy of the full frames
    seq = torch.cat([prev_last[..., None, :, :, :], frames], dim=-4)[
        ..., ::ds, ::ds, :]
    g = seq.to(torch.float32).mean(dim=-1)
    g = g - g.mean(dim=(-2, -1), keepdim=True)
    f = torch.fft.rfft2(g)
    cross = f[..., :-1, :, :] * torch.conj(f[..., 1:, :, :])
    corr = torch.fft.irfft2(cross / torch.clamp(cross.abs(), min=1e-9),
                            s=g.shape[-2:])
    lead, (h, w) = corr.shape[:-2], corr.shape[-2:]
    flat = corr.reshape(*lead, h * w)
    idx = torch.argmax(flat, dim=-1)
    dy, dx = idx // w, idx % w

    def at(dyo, dxo):
        j = ((dy + dyo) % h) * w + (dx + dxo) % w
        return torch.gather(flat, -1, j[..., None])[..., 0]

    c0 = at(0, 0)
    cym, cyp = at(-1, 0), at(1, 0)
    cxm, cxp = at(0, -1), at(0, 1)

    def sub(cm, cc, cp):
        denom = cm - 2.0 * cc + cp
        off = torch.where(denom.abs() > 1e-12,
                          0.5 * (cm - cp) / torch.where(denom == 0, 1.0,
                                                        denom),
                          0.0)
        return torch.clamp(off, -0.5, 0.5)

    dy = torch.where(dy > h // 2, dy - h, dy).to(torch.float32)
    dx = torch.where(dx > w // 2, dx - w, dx).to(torch.float32)
    dy = dy + sub(cym, c0, cyp)
    dx = dx + sub(cxm, c0, cxp)
    eye = torch.eye(2, dtype=torch.float32, device=frames.device).expand(
        *lead, 2, 2)
    trans = torch.stack([-dx * ds, -dy * ds], dim=-1)
    return torch.cat([eye, trans[..., None]], dim=-1)
