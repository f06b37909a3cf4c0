"""Photometric-residual measurement channel (appearance-based EKF update).

JAX analog of the reference's render-based observation model
(SURVEY.md §2.1 #3/#4): the original rendered the deformed mesh with
OpenGL and computed per-perturbation residual norms and J^T z products in
CUDA. Here the "render" is the track's template patch from the previous
frame, warped by the predicted motion, and the residual is photometric:

    r(p) = I_next(p + u) - T(u),   u over a (W x W) window

Gauss-Newton on r gives the measurement: a few iterations of
    G d = b,  G = sum grad I grad I^T,  b = sum grad I (T - I)
starting at the PREDICTED position (the filter provides the warm start).
The converged position z enters the EKF as a position measurement with
per-track covariance R_k = sigma_I^2 * G^{-1} — the Gauss-Newton
covariance, so weakly textured patches automatically carry large R and
barely move the state (the matrix-free Jacobian trick: everything is one
batched window gather + elementwise reductions, no rendering).

Unlike the flow channels this reads the FRAMES, so it keeps tracking when
the dense flow field drops out (tested in test_photometric.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import EkfConfig
from ..ops.warp import bilinear_sample

_PREC = jax.lax.Precision.HIGHEST


def _patch_coords(pts: jnp.ndarray, win: int):
    """(K, 2) centers -> (K, W*W) x/y sample coords around each center."""
    r = win // 2
    off = jnp.arange(-r, r + 1, dtype=jnp.float32)
    oy, ox = jnp.meshgrid(off, off, indexing="ij")
    x = pts[:, 0:1] + ox.reshape(1, -1)
    y = pts[:, 1:2] + oy.reshape(1, -1)
    return x, y


def _image_gradients(img: jnp.ndarray):
    """Central-difference gradients (borders zeroed), full image."""
    gx = (jnp.roll(img, -1, axis=1) - jnp.roll(img, 1, axis=1)) * 0.5
    gy = (jnp.roll(img, -1, axis=0) - jnp.roll(img, 1, axis=0)) * 0.5
    gx = gx.at[:, 0].set(0).at[:, -1].set(0)
    gy = gy.at[0, :].set(0).at[-1, :].set(0)
    return gx, gy


def photometric_measure(prev_gray: jnp.ndarray, gray: jnp.ndarray,
                        p_prev: jnp.ndarray, p_pred: jnp.ndarray,
                        cfg: EkfConfig
                        ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched photometric position measurement.

    prev_gray/gray: (H, W) float32 frames. p_prev (K, 2): template centers
    (track positions in the previous frame). p_pred (K, 2): predicted
    positions (GN starting point). Returns (z (K, 2) measured positions,
    Rk (K, 2, 2) per-track measurement covariance, valid (K,) bool).
    """
    win = cfg.photo_win
    tx, ty = _patch_coords(p_prev, win)
    T = bilinear_sample(prev_gray, tx, ty)              # (K, W*W) template
    gx, gy = _image_gradients(gray)

    # one (H*W, 3) row-gather per sweep instead of three bilinear gathers
    # (a third of the gather indices; same batching as models/render.py)
    h, w = gray.shape
    planes = jnp.stack([gray, gx, gy], axis=-1).reshape(h * w, 3)

    def samp3(px, py):
        # shared stacked-plane gather (single owner of border semantics)
        from ..ops.warp import bilinear_sample_rows
        out = bilinear_sample_rows(planes, h, w, px, py)
        return out[..., 0], out[..., 1], out[..., 2]

    def gn_iter(p, _):
        px, py = _patch_coords(p, win)
        I, gxp, gyp = samp3(px, py)
        e = T - I
        Gxx = jnp.sum(gxp * gxp, axis=-1)
        Gxy = jnp.sum(gxp * gyp, axis=-1)
        Gyy = jnp.sum(gyp * gyp, axis=-1)
        bx = jnp.sum(gxp * e, axis=-1)
        by = jnp.sum(gyp * e, axis=-1)
        det = Gxx * Gyy - Gxy * Gxy
        idet = 1.0 / jnp.maximum(det, 1e-6)
        d = jnp.stack([(Gyy * bx - Gxy * by) * idet,
                       (Gxx * by - Gxy * bx) * idet], axis=-1)
        # reject unstable steps from degenerate structure tensors
        ok = (det > 1e-6)[:, None]
        d = jnp.clip(jnp.where(ok, d, 0.0), -cfg.photo_clip, cfg.photo_clip)
        return p + d, (Gxx, Gxy, Gyy)

    p = p_pred
    G = None
    for _ in range(max(cfg.photo_iters, 1)):
        p, G = gn_iter(p, None)
    Gxx, Gxy, Gyy = G

    # Gauss-Newton covariance: R = sigma_I^2 G^{-1}
    det = jnp.maximum(Gxx * Gyy - Gxy * Gxy, 1e-6)
    idet = 1.0 / det
    Rk = cfg.photo_r * idet[:, None, None] * jnp.stack(
        [jnp.stack([Gyy, -Gxy], axis=-1),
         jnp.stack([-Gxy, Gxx], axis=-1)], axis=-2)

    # texture gate: min eigenvalue of G per window pixel (cv2 pyrLK's
    # minEigThreshold convention, raw-u8 intensity scale)
    tr = Gxx + Gyy
    disc = jnp.sqrt(jnp.maximum((Gxx - Gyy) ** 2 + 4.0 * Gxy * Gxy, 0.0))
    emin = 0.5 * (tr - disc) / float(win * win)
    drift = jnp.linalg.norm(p - p_pred, axis=-1)
    valid = (emin > cfg.photo_min_eig) & (drift < cfg.photo_clip *
                                          max(cfg.photo_iters, 1))
    return p, Rk, valid


def photometric_step(state, prev_gray: jnp.ndarray, gray: jnp.ndarray,
                     cfg: EkfConfig, F: jnp.ndarray, Q: jnp.ndarray):
    """Predict + photometric update (measurement="photometric"): the
    appearance channel as THE measurement — no dense flow involved.
    Same (state', aux) contract as models.ekf.ekf_step."""
    from . import dynamics
    from .ekf import predict, update
    x_prev = state.x
    x_pred, P_pred = predict(state.x, state.P, F, Q,
                             q_scale=state.q_scale)
    z, Rk, valid = photometric_measure(prev_gray, gray, x_prev[:, 0:2],
                                       x_pred[:, 0:2], cfg)
    Hm = jnp.asarray(dynamics.position_H(cfg))
    y = z - x_pred[:, 0:2]
    x_new, P_new, nis = update(x_pred, P_pred, y, Hm, Rk)
    # valid=False (texture-poor patch / clipped drift) counts as a MISS
    # via the shared commit so the lifecycle gate can recycle the slot
    from .ekf import commit_update
    return commit_update(state, x_pred, P_pred, x_new, P_new, nis, cfg,
                         valid=valid)


def photometric_refine(state, aux, prev_gray: jnp.ndarray,
                       gray: jnp.ndarray, p_prev: jnp.ndarray,
                       cfg: EkfConfig):
    """Second sequential EKF update (measurement="flow_photometric"):
    applied AFTER the flow-channel update, linearized at the flow-updated
    state. aux["nis"] stays the flow channel's (the NIS gate's input);
    the photometric channel carries its own texture/drift validity gate.
    """
    from . import dynamics
    from .ekf import update
    z, Rk, valid = photometric_measure(prev_gray, gray, p_prev,
                                       state.x[:, 0:2], cfg)
    Hm = jnp.asarray(dynamics.position_H(cfg))
    y = z - state.x[:, 0:2]
    x_new, P_new, _nis = update(state.x, state.P, y, Hm, Rk)
    live = state.alive & valid
    m = live[:, None]
    x_out = jnp.where(m, x_new, state.x)
    P_out = jnp.where(m[..., None], P_new, state.P)
    return state._replace(x=x_out, P=P_out), aux


def photometric_measure_np(prev_gray, gray, p_prev, p_pred, cfg: EkfConfig):
    """NumPy twin of photometric_measure (float64) — the parity oracle."""
    prev_gray = np.asarray(prev_gray, np.float64)
    gray = np.asarray(gray, np.float64)
    h, w = gray.shape
    win = cfg.photo_win
    r = win // 2
    off = np.arange(-r, r + 1, dtype=np.float64)
    oy, ox = np.meshgrid(off, off, indexing="ij")
    ox = ox.reshape(-1)
    oy = oy.reshape(-1)

    def samp(img, x, y):
        x = np.clip(x, 0.0, w - 1.0)
        y = np.clip(y, 0.0, h - 1.0)
        x0 = np.clip(np.floor(x), 0, w - 2).astype(np.int64)
        y0 = np.clip(np.floor(y), 0, h - 2).astype(np.int64)
        fx = x - x0
        fy = y - y0
        return (img[y0, x0] * (1 - fx) * (1 - fy)
                + img[y0, x0 + 1] * fx * (1 - fy)
                + img[y0 + 1, x0] * (1 - fx) * fy
                + img[y0 + 1, x0 + 1] * fx * fy)

    gx = np.zeros_like(gray)
    gy = np.zeros_like(gray)
    gx[:, 1:-1] = (gray[:, 2:] - gray[:, :-2]) * 0.5
    gy[1:-1, :] = (gray[2:, :] - gray[:-2, :]) * 0.5

    K = p_prev.shape[0]
    z = np.array(p_pred, np.float64)
    Rk = np.zeros((K, 2, 2))
    valid = np.zeros(K, bool)
    for k in range(K):
        T = samp(prev_gray, p_prev[k, 0] + ox, p_prev[k, 1] + oy)
        p = z[k].copy()
        Gm = np.zeros((2, 2))
        for _ in range(max(cfg.photo_iters, 1)):
            I = samp(gray, p[0] + ox, p[1] + oy)
            gxp = samp(gx, p[0] + ox, p[1] + oy)
            gyp = samp(gy, p[0] + ox, p[1] + oy)
            e = T - I
            Gm = np.array([[np.sum(gxp * gxp), np.sum(gxp * gyp)],
                           [np.sum(gxp * gyp), np.sum(gyp * gyp)]])
            b = np.array([np.sum(gxp * e), np.sum(gyp * e)])
            det = Gm[0, 0] * Gm[1, 1] - Gm[0, 1] * Gm[1, 0]
            if det > 1e-6:
                d = np.array([Gm[1, 1] * b[0] - Gm[0, 1] * b[1],
                              Gm[0, 0] * b[1] - Gm[0, 1] * b[0]]) / det
            else:
                d = np.zeros(2)
            d = np.clip(d, -cfg.photo_clip, cfg.photo_clip)
            p = p + d
        z[k] = p
        det = max(Gm[0, 0] * Gm[1, 1] - Gm[0, 1] ** 2, 1e-6)
        Rk[k] = cfg.photo_r / det * np.array(
            [[Gm[1, 1], -Gm[0, 1]], [-Gm[0, 1], Gm[0, 0]]])
        tr = Gm[0, 0] + Gm[1, 1]
        disc = np.sqrt(max((Gm[0, 0] - Gm[1, 1]) ** 2
                           + 4 * Gm[0, 1] ** 2, 0.0))
        emin = 0.5 * (tr - disc) / (win * win)
        drift = np.linalg.norm(p - p_pred[k])
        valid[k] = (emin > cfg.photo_min_eig) and (
            drift < cfg.photo_clip * max(cfg.photo_iters, 1))
    return z, Rk, valid
