"""Shi-Tomasi corner response and static-shape seeding / re-init pools.

JAX stand-in for cv2.goodFeaturesToTrack (SURVEY.md §2.1 #7: track
seeding replaces the reference's DistMesh vertex generation). The corner
response follows cv2.cornerMinEigenVal (Sobel-3 derivatives, box window,
min-eigenvalue of the structure tensor). Selection must be shape-static
under jit, so instead of cv2's greedy data-dependent NMS we use tile-max
suppression: one candidate per (min_distance x min_distance) tile, then
global top-k — a fixed-capacity corner pool for seeding and occlusion-gated
re-init (BASELINE.json:11).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..config import TrackConfig
from .filters import box_filter, correlate1d

_SOBEL = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SMOOTH = np.array([1.0, 2.0, 1.0], dtype=np.float32)


def min_eig_response(gray: jnp.ndarray, block_size: int = 3) -> jnp.ndarray:
    """cv2.cornerMinEigenVal twin on (H, W) float32.

    Sobel aperture 3 with OpenCV's 1/(2^(ap-1) * blockSize) = 1/(4*block)
    scale factor folded in, box-windowed structure tensor, then
    min-eig = (a+c)/2 - sqrt(((a-c)/2)^2 + b^2).
    """
    scale = 1.0 / (4.0 * 255.0 * block_size)
    gx = correlate1d(correlate1d(gray, _SOBEL, axis=-1, border="reflect101"),
                     _SMOOTH, axis=-2, border="reflect101") * scale
    gy = correlate1d(correlate1d(gray, _SOBEL, axis=-2, border="reflect101"),
                     _SMOOTH, axis=-1, border="reflect101") * scale
    def win(v):
        # cv2 boxFilter default border is BORDER_DEFAULT = REFLECT_101
        return box_filter(box_filter(v, block_size, axis=-2,
                                     border="reflect101", normalize=False),
                          block_size, axis=-1, border="reflect101",
                          normalize=False)
    a = win(gx * gx) * 0.5
    b = win(gx * gy) * 0.5
    c = win(gy * gy) * 0.5
    return (a + c) - jnp.sqrt((a - c) ** 2 + 4.0 * b * b)


def corner_pool(gray: jnp.ndarray, cfg: TrackConfig, pool_size: int = None,
                mask: jnp.ndarray = None):
    """Top-k corner candidates with tile-based spacing.

    Returns (pts (P, 2) float32 (x, y), score (P,) float32). Slots beyond
    the number of confident corners carry score <= 0; callers mask on score.
    `mask` optionally restricts candidates to a {0,1} region (segmented
    body seeding, SURVEY.md §2.1 #5/#7).
    """
    pool_size = pool_size or cfg.corner_pool
    resp = min_eig_response(gray, cfg.corner_block)
    if mask is not None:
        resp = jnp.where(mask > 0, resp, 0.0)
    h, w = resp.shape
    tile = max(int(cfg.min_distance), 1)
    ph = (tile - h % tile) % tile
    pw = (tile - w % tile) % tile
    rp = jnp.pad(resp, ((0, ph), (0, pw)), constant_values=-jnp.inf)
    th, tw = rp.shape[0] // tile, rp.shape[1] // tile
    tiles = rp.reshape(th, tile, tw, tile).transpose(0, 2, 1, 3).reshape(
        th, tw, tile * tile)
    tile_max = tiles.max(axis=-1)
    tile_arg = tiles.argmax(axis=-1)
    ty = tile_arg // tile
    tx = tile_arg % tile
    ys = (jnp.arange(th)[:, None] * tile + ty).astype(jnp.float32)
    xs = (jnp.arange(tw)[None, :] * tile + tx).astype(jnp.float32)
    flat_score = tile_max.reshape(-1)
    flat_x = xs.reshape(-1)
    flat_y = ys.reshape(-1)
    # quality threshold relative to global max (cv2 semantics)
    thresh = resp.max() * cfg.quality_level
    flat_score = jnp.where(flat_score >= thresh, flat_score, -jnp.inf)
    k = min(pool_size, flat_score.shape[0])
    top_score, idx = lax.top_k(flat_score, k)
    pts = jnp.stack([flat_x[idx], flat_y[idx]], axis=-1)
    score = jnp.where(jnp.isfinite(top_score), top_score, 0.0)
    if k < pool_size:
        pts = jnp.pad(pts, ((0, pool_size - k), (0, 0)))
        score = jnp.pad(score, (0, pool_size - k))
    return pts, score
