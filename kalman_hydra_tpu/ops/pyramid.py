"""Gaussian pyramids and OpenCV-compatible linear resize.

Two pyramid flavors, matching the two flows that consume them
(SURVEY.md §2.3):
  * `pyr_down` / `build_pyramid`: cv2.pyrDown semantics — 5-tap binomial
    [1,4,6,4,1]/16, BORDER_REFLECT_101, even-index decimation. Feeds LK.
  * `farneback_images`: per-level GaussianBlur(original) + INTER_LINEAR
    resize with cvRound sizes and the min_size=32 level clamp — exactly how
    cv2.calcOpticalFlowFarneback builds its level images.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import jax.numpy as jnp

from .filters import cv_round, gaussian_blur, sep_filter2d

_PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """cv2.pyrDown twin on (..., H, W) float32."""
    blurred = sep_filter2d(img, _PYR_K, _PYR_K, border="reflect101")
    return blurred[..., ::2, ::2]


def build_pyramid(img: jnp.ndarray, levels: int) -> List[jnp.ndarray]:
    """LK pyramid: `levels` images, level 0 = input."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def resize_linear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """cv2.resize(INTER_LINEAR) twin on (..., H, W[, C]) via explicit
    half-pixel-center bilinear sampling. Arrays whose last axis is <= 8 wide
    are treated as channel-last (e.g. flow fields (H, W, 2))."""
    return _resize_hw(img, out_h, out_w)


def _has_c(img) -> bool:
    return img.ndim >= 3 and img.shape[-1] <= 8


def resize_coeffs(n_out: int, n_in: int):
    """Half-pixel-center clamped bilinear coefficients (cv2 INTER_LINEAR):
    returns (i0, i1, frac) numpy arrays of length n_out. Single source of
    truth for the resize below."""
    scale = n_in / n_out
    s = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.clip(np.floor(s), 0, n_in - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = np.clip(s - i0, 0.0, 1.0)
    return i0, i1, f


def _resize_hw(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    channel_last = _has_c(img)
    if channel_last:
        h, w = img.shape[-3], img.shape[-2]
    else:
        h, w = img.shape[-2], img.shape[-1]
    # shapes are static: bake the clamped bilinear coefficients as
    # constants from the shared helper (single source of truth with the
    # band-matrix level-image kernel)
    y0n, y1n, fyn = resize_coeffs(out_h, h)
    x0n, x1n, fxn = resize_coeffs(out_w, w)
    y0 = jnp.asarray(y0n.astype(np.int32))
    x0 = jnp.asarray(x0n.astype(np.int32))
    y1 = jnp.asarray(y1n.astype(np.int32))
    x1 = jnp.asarray(x1n.astype(np.int32))
    fy = jnp.asarray(fyn.astype(np.float32))
    fx = jnp.asarray(fxn.astype(np.float32))

    ax_h = img.ndim - (3 if channel_last else 2)
    ax_w = img.ndim - (2 if channel_last else 1)
    top = jnp.take(img, y0, axis=ax_h)
    bot = jnp.take(img, y1, axis=ax_h)
    fy_shape = [1] * img.ndim
    fy_shape[ax_h] = out_h
    fyb = fy.reshape(fy_shape)
    rows = top * (1 - fyb) + bot * fyb
    left = jnp.take(rows, x0, axis=ax_w)
    right = jnp.take(rows, x1, axis=ax_w)
    fx_shape = [1] * img.ndim
    fx_shape[ax_w] = out_w
    fxb = fx.reshape(fx_shape)
    return left * (1 - fxb) + right * fxb


def farneback_levels(h: int, w: int, levels: int,
                     pyr_scale: float) -> List[Tuple[int, int, int, float, int]]:
    """Static per-level plan for cv2.calcOpticalFlowFarneback's pyramid.

    Returns [(k, level_h, level_w, sigma, ksize)] for k = levels_eff..0,
    replicating OpenCV's min_size=32 clamp, cvRound sizes, and the
    sigma = (1/scale - 1)*0.5, ksize = max(cvRound(sigma*5)|1, 3) blur plan.
    """
    min_size = 32
    k = 0
    scale = 1.0
    while k < levels:
        scale *= pyr_scale
        if w * scale < min_size or h * scale < min_size:
            break
        k += 1
    levels_eff = k
    plan = []
    for k in range(levels_eff, -1, -1):
        scale = pyr_scale ** k
        sigma = (1.0 / scale - 1.0) * 0.5
        ksize = max(cv_round(sigma * 5) | 1, 3)
        plan.append((k, cv_round(h * scale), cv_round(w * scale), sigma, ksize))
    return plan


def gaussian_blur_level(img: jnp.ndarray, cfg, k: int = 0) -> jnp.ndarray:
    """The blur (no resize) that produces Farneback's level-k image; for
    k=0 this is the fine-level input (sharded-Farneback helper)."""
    h, w = img.shape[-2], img.shape[-1]
    for (kk, _lh, _lw, sigma, ksize) in farneback_levels(
            h, w, cfg.levels, cfg.pyr_scale):
        if kk == k:
            return gaussian_blur(img.astype(jnp.float32), ksize, sigma,
                                 border="reflect101")
    raise ValueError(f"level {k} not in plan")


def farneback_images(img: jnp.ndarray, levels: int,
                     pyr_scale: float) -> List[jnp.ndarray]:
    """Level images for Farneback, coarsest first, each built from the
    ORIGINAL image (blur + resize), per OpenCV."""
    h, w = img.shape[-2], img.shape[-1]
    out = []
    for (_k, lh, lw, sigma, ksize) in farneback_levels(h, w, levels, pyr_scale):
        blurred = gaussian_blur(img.astype(jnp.float32), ksize, sigma,
                                border="reflect101")
        out.append(_resize_hw(blurred, lh, lw))
    return out
