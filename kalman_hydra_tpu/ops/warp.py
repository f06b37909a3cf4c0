"""Bilinear sampling / warping (gather layer).

The gather-heavy part of the pipeline (SURVEY.md §7 "gather-heavy
warping"): dense warps are whole-image gathers; track sampling is a tiny
K-point gather. Both are expressed with `jnp.take`-style advanced indexing
and left to XLA's gather lowering.

Coordinate convention: (x, y) with x = column, matching OpenCV. Samples
outside the image are clamped to the border pixel.
"""

from __future__ import annotations

import jax.numpy as jnp


def bilinear_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """Sample (..., H, W) image at float coords; x/y broadcastable arrays.

    Returns samples with the query shape (leading image batch dims must be
    absent — use vmap for batches). Border: clamp.
    """
    h, w = img.shape[-2], img.shape[-1]
    x = jnp.clip(x, 0.0, w - 1.0)
    y = jnp.clip(y, 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(x), 0, w - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(y), 0, h - 2).astype(jnp.int32)
    fx = x - x0.astype(jnp.float32)
    fy = y - y0.astype(jnp.float32)
    i00 = img[..., y0, x0]
    i01 = img[..., y0, x0 + 1]
    i10 = img[..., y0 + 1, x0]
    i11 = img[..., y0 + 1, x0 + 1]
    return (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
            + i10 * (1 - fx) * fy + i11 * fx * fy)


def warp_image(img: jnp.ndarray, flow: jnp.ndarray) -> jnp.ndarray:
    """Backward-warp (H, W) image by (H, W, 2) flow: out(p) = img(p + flow(p))."""
    h, w = img.shape[-2], img.shape[-1]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    return bilinear_sample(img, xs + flow[..., 0], ys + flow[..., 1])


def sample_flow(flow: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Sample (H, W, 2) flow at (K, 2) (x, y) points -> (K, 2).

    Matches the oracle's clamp: queries clipped just inside the last pixel so
    the bilinear neighborhood stays in-bounds.
    """
    h, w = flow.shape[0], flow.shape[1]
    x = jnp.clip(pts[:, 0], 0.0, w - 1.001)
    y = jnp.clip(pts[:, 1], 0.0, h - 1.001)
    f = jnp.moveaxis(flow, -1, 0)  # (2, H, W)
    out = bilinear_sample(f, x, y)  # (2, K)
    return out.T


def sample_flow_with_grad(flow: jnp.ndarray, pts: jnp.ndarray):
    """Flow samples plus spatial Jacobian d(flow)/d(x,y) at each point.

    Needed by the implicit-flow EKF measurement (SURVEY.md §2.3: the
    H matrix includes flow-gradient terms). Gradients come from central
    differences of the flow field, themselves bilinearly sampled.
    Returns (vals (K, 2), jac (K, 2, 2)) with jac[:, i, j] = d flow_i / d p_j.
    """
    h, w = flow.shape[0], flow.shape[1]
    f = jnp.moveaxis(flow, -1, 0)  # (2, H, W)
    dx = (jnp.roll(f, -1, axis=2) - jnp.roll(f, 1, axis=2)) * 0.5
    dy = (jnp.roll(f, -1, axis=1) - jnp.roll(f, 1, axis=1)) * 0.5
    # zero the wrapped borders
    dx = dx.at[:, :, 0].set(0).at[:, :, -1].set(0)
    dy = dy.at[:, 0, :].set(0).at[:, -1, :].set(0)
    x = jnp.clip(pts[:, 0], 0.0, w - 1.001)
    y = jnp.clip(pts[:, 1], 0.0, h - 1.001)
    vals = bilinear_sample(f, x, y).T
    jx = bilinear_sample(dx, x, y).T  # (K, 2)
    jy = bilinear_sample(dy, x, y).T
    jac = jnp.stack([jx, jy], axis=-1)  # (K, 2 flow-comp, 2 spatial)
    return vals, jac


def bilinear_sample_rows(planes: jnp.ndarray, h: int, w: int,
                         x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sampling of row-stacked planes: `planes` is (H*W, C) — C
    image planes flattened row-major and stacked on the last axis — so the
    four bilinear corners cost ONE row-gather each instead of C separate
    gathers (C-wide rows, a quarter of the index work). Border: clamp.

    x, y: float query coordinates of any (matching) shape.
    Returns (*query_shape, C) samples. Single owner of the stacked-plane
    border/clamp semantics for the photometric and render channels.
    """
    c = planes.shape[-1]
    x = jnp.clip(x, 0.0, w - 1.0)
    y = jnp.clip(y, 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(x), 0, w - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(y), 0, h - 2).astype(jnp.int32)
    fx = (x - x0.astype(jnp.float32))[..., None]
    fy = (y - y0.astype(jnp.float32))[..., None]
    base = y0 * w + x0

    def g(i):
        return jnp.take(planes, i.reshape(-1), axis=0).reshape(
            i.shape + (c,))

    return (g(base) * (1 - fx) * (1 - fy) + g(base + 1) * fx * (1 - fy)
            + g(base + w) * (1 - fx) * fy + g(base + w + 1) * fx * fy)
