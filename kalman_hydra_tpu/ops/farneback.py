"""Dense Farneback optical flow, pure XLA (cv2.calcOpticalFlowFarneback twin).

Replicates the OpenCV algorithm structure end to end (SURVEY.md §2.3):

1. Level images: GaussianBlur(original, sigma=(1/scale-1)/2) + INTER_LINEAR
   resize with cvRound sizes and the min_size=32 level clamp
   (ops/pyramid.farneback_images).
2. Polynomial expansion per level image: weighted LSQ fit of
   f ~ c + b^T d + d^T A d over a (2n+1)^2 Gaussian-applicability window,
   computed as 9 separable 1-D correlations (moments m00..m02) and combined
   through the closed-form inverse-Gram coefficients ig11/ig03/ig33/ig55.
3. Per iteration: bilinear warp of the next frame's coefficient planes by
   the current flow, averaged-matrix residual
   db = -(b1 - b2_warped)/2 + A_avg d_prior, per-pixel normal equations
   M = (A^T A, A^T db) with edge damping, winsize box (or Gaussian)
   smoothing of M, and a closed-form 2x2 solve for the new ABSOLUTE flow.
4. x(1/pyr_scale) flow upsampling between levels.

The iteration solves for total flow (M . d_prior term), which is what makes
the scheme contractive — see the matching note in ops/lk.lk_dense.

All loop bounds/shapes are static per (H, W, FlowConfig): one jitted XLA
program per config; no host round-trips (BASELINE.json:5).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import FlowConfig
from .filters import box_filter, correlate1d, gaussian_kernel
from .pyramid import farneback_images, resize_linear

# Edge damping applied to the normal-equation inputs within 5 px of the
# image border, as in OpenCV's FarnebackUpdateMatrices.
_BORDER = 5
_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472],
                         dtype=np.float32)


@lru_cache(maxsize=32)
def _poly_inv_gram(n: int, sigma: float):
    """Closed-form inverse-Gram coefficients of the polynomial basis
    {1, x, y, x^2, y^2, xy} under the separable Gaussian applicability
    (OpenCV FarnebackPrepareGaussian)."""
    i = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(i * i) / (2.0 * sigma * sigma))
    g /= g.sum()
    G = np.zeros((6, 6), dtype=np.float64)
    for yk, wy in zip(i, g):
        for xk, wx in zip(i, g):
            w = wx * wy
            G[0, 0] += w
            G[1, 1] += w * xk * xk
            G[2, 2] += w * yk * yk
            G[3, 3] += w * xk ** 4
            G[4, 4] += w * yk ** 4
            G[5, 5] += w * xk * xk * yk * yk
            G[0, 3] += w * xk * xk
            G[0, 4] += w * yk * yk
            G[3, 4] += w * xk * xk * yk * yk
    G[3, 0] = G[0, 3]
    G[4, 0] = G[0, 4]
    G[4, 3] = G[3, 4]
    invG = np.linalg.inv(G)
    ig11 = invG[1, 1]
    ig03 = invG[0, 3]
    ig33 = invG[3, 3]
    ig55 = invG[5, 5]
    return (g.astype(np.float32), np.float32(ig11), np.float32(ig03),
            np.float32(ig33), np.float32(ig55))


def poly_expansion(img: jnp.ndarray, n: int, sigma: float) -> jnp.ndarray:
    """Quadratic-fit coefficient planes, (H, W, 5):
    channels [b_x, b_y, a_xx, a_yy, axy] where `axy` is the full xy
    coefficient (= 2 * A_offdiag)."""
    g, ig11, ig03, ig33, ig55 = _poly_inv_gram(n, float(sigma))
    i = np.arange(-n, n + 1, dtype=np.float32)
    xg = (i * g).astype(np.float32)
    xxg = (i * i * g).astype(np.float32)

    f = img.astype(jnp.float32)
    # vertical moment passes (correlation: kernel index k multiplies f(y+k))
    v0 = correlate1d(f, g, axis=-2, border="replicate")
    v1 = correlate1d(f, xg, axis=-2, border="replicate")
    v2 = correlate1d(f, xxg, axis=-2, border="replicate")
    # horizontal passes -> raw moments m_pq = sum w dx^p dy^q f
    m00 = correlate1d(v0, g, axis=-1, border="replicate")
    m10 = correlate1d(v0, xg, axis=-1, border="replicate")
    m20 = correlate1d(v0, xxg, axis=-1, border="replicate")
    m01 = correlate1d(v1, g, axis=-1, border="replicate")
    m11 = correlate1d(v1, xg, axis=-1, border="replicate")
    m02 = correlate1d(v2, g, axis=-1, border="replicate")

    b_x = m10 * ig11
    b_y = m01 * ig11
    a_xx = m00 * ig03 + m20 * ig33
    a_yy = m00 * ig03 + m02 * ig33
    axy = m11 * ig55
    return jnp.stack([b_x, b_y, a_xx, a_yy, axy], axis=-1)


def _warp_poly(R1: jnp.ndarray, flow: jnp.ndarray) -> jnp.ndarray:
    """Bilinear warp of (H, W, 5) coefficient planes by flow, clamped."""
    h, w = R1.shape[0], R1.shape[1]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    fx = jnp.clip(xs + flow[..., 0], 0.0, w - 1.0)
    fy = jnp.clip(ys + flow[..., 1], 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(fx), 0, w - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(fy), 0, h - 2).astype(jnp.int32)
    ax = (fx - x0.astype(jnp.float32))[..., None]
    ay = (fy - y0.astype(jnp.float32))[..., None]
    r00 = R1[y0, x0]
    r01 = R1[y0, x0 + 1]
    r10 = R1[y0 + 1, x0]
    r11 = R1[y0 + 1, x0 + 1]
    return (r00 * (1 - ax) * (1 - ay) + r01 * ax * (1 - ay)
            + r10 * (1 - ax) * ay + r11 * ax * ay)


def _border_damp(h: int, w: int) -> jnp.ndarray:
    """(H, W) multiplicative damping: OpenCV's border[] taper."""
    def axis_scale(n):
        s = np.ones(n, dtype=np.float32)
        b = min(_BORDER, n)
        s[:b] *= _BORDER_SCALE[:b]
        s[n - b:] *= _BORDER_SCALE[:b][::-1]
        return s
    return jnp.asarray(axis_scale(h)[:, None] * axis_scale(w)[None, :])


def update_matrices(R0: jnp.ndarray, R1: jnp.ndarray,
                    flow: jnp.ndarray, fast_warp: int = 0) -> jnp.ndarray:
    """Per-pixel normal-equation planes M = (G11, G12, G22, h1, h2):
    G = A^T A, h = A^T db with A the frame-averaged quadratic matrix and
    db = -(b1_warped - b0)/2 + A d_prior (absolute-flow form).

    fast_warp > 0 swaps the exact gather warp for the select-sum warp with
    that displacement clamp (see _warp_poly_selectsum)."""
    h, w = R0.shape[0], R0.shape[1]
    if fast_warp > 0:
        R1w = _warp_poly_selectsum(R1, flow, fast_warp)
    else:
        R1w = _warp_poly(R1, flow)
    dx = flow[..., 0]
    dy = flow[..., 1]

    a_xx = (R0[..., 2] + R1w[..., 2]) * 0.5
    a_yy = (R0[..., 3] + R1w[..., 3]) * 0.5
    axy = (R0[..., 4] + R1w[..., 4]) * 0.25  # half of averaged full coeff
    db_x = (R0[..., 0] - R1w[..., 0]) * 0.5
    db_y = (R0[..., 1] - R1w[..., 1]) * 0.5
    db_x = db_x + a_xx * dx + axy * dy
    db_y = db_y + axy * dx + a_yy * dy

    damp = _border_damp(h, w)
    a_xx = a_xx * damp
    a_yy = a_yy * damp
    axy = axy * damp
    db_x = db_x * damp
    db_y = db_y * damp

    g11 = a_xx * a_xx + axy * axy
    g12 = (a_xx + a_yy) * axy
    g22 = a_yy * a_yy + axy * axy
    h1 = a_xx * db_x + axy * db_y
    h2 = axy * db_x + a_yy * db_y
    return jnp.stack([g11, g12, g22, h1, h2], axis=-1)


def update_flow(M: jnp.ndarray, winsize: int, gaussian: bool) -> jnp.ndarray:
    """Smooth the normal equations over winsize and solve per pixel."""
    if gaussian:
        m = winsize // 2
        kern = gaussian_kernel(2 * m + 1, m * 0.3)
        Ms = correlate1d(correlate1d(M, kern, axis=-3, border="replicate"),
                         kern, axis=-2, border="replicate")
    else:
        Ms = box_filter(box_filter(M, winsize, axis=-3, border="replicate"),
                        winsize, axis=-2, border="replicate")
    g11 = Ms[..., 0]
    g12 = Ms[..., 1]
    g22 = Ms[..., 2]
    h1 = Ms[..., 3]
    h2 = Ms[..., 4]
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    fx = (g22 * h1 - g12 * h2) * idet
    fy = (g11 * h2 - g12 * h1) * idet
    return jnp.stack([fx, fy], axis=-1)


def _warp_poly_selectsum(R1: jnp.ndarray, flow: jnp.ndarray,
                         max_disp: int) -> jnp.ndarray:
    """Gather-free bilinear warp of (H, W, C) planes by one-hot select over
    +-max_disp shifted copies (shifted selects are elementwise work; no
    gather).

    Exact in the vertical pass. The horizontal pass reuses the vertically
    lerped field at neighbor columns, whose vertical displacement may
    differ by O(d_flow/dx) — sub-1e-2 px EPE on smooth fields (tested).
    Displacement is clamped to +-max_disp (choose >= the motion magnitude
    per level; coarse-to-fine keeps per-level totals small).
    """
    h, w = R1.shape[0], R1.shape[1]
    D = max_disp
    dxf = jnp.clip(flow[..., 0], -D, D)
    dyf = jnp.clip(flow[..., 1], -D, D)
    # emulate the exact warp's border clamp: a sample clamped to the image
    # edge equals an edge-padded shifted copy
    y_idx = jnp.floor(dyf).astype(jnp.int32)
    x_idx = jnp.floor(dxf).astype(jnp.int32)
    ay = (dyf - y_idx.astype(jnp.float32))[..., None]
    ax = (dxf - x_idx.astype(jnp.float32))[..., None]

    c = R1.shape[2]
    # rolled loops (fori_loop + dynamic_slice): identical work to the
    # unrolled one-hot sum but O(1) HLO size
    Rp = jnp.pad(R1, ((D + 1, D + 1), (0, 0), (0, 0)), mode="edge")

    def vbody(i, acc):
        vt, vb = acc
        d = i - D
        sh = lax.dynamic_slice(Rp, (i + 1, 0, 0), (h + 1, w, c))
        m = (y_idx == d)[..., None]
        vt = vt + jnp.where(m, sh[:h], 0.0)
        vb = vb + jnp.where(m, sh[1:], 0.0)
        return vt, vb

    vt, vb = lax.fori_loop(0, 2 * D + 1, vbody,
                           (jnp.zeros_like(R1), jnp.zeros_like(R1)))
    v = vt * (1 - ay) + vb * ay

    vp = jnp.pad(v, ((0, 0), (D + 1, D + 1), (0, 0)), mode="edge")

    def hbody(i, acc):
        ut, ub = acc
        e = i - D
        sh = lax.dynamic_slice(vp, (0, i + 1, 0), (h, w + 1, c))
        m = (x_idx == e)[..., None]
        ut = ut + jnp.where(m, sh[:, :w], 0.0)
        ub = ub + jnp.where(m, sh[:, 1:], 0.0)
        return ut, ub

    ut, ub = lax.fori_loop(0, 2 * D + 1, hbody,
                           (jnp.zeros_like(R1), jnp.zeros_like(R1)))
    return ut * (1 - ax) + ub * ax


def _warp_poly_planar(R1p: jnp.ndarray, flow_p: jnp.ndarray) -> jnp.ndarray:
    """Bilinear warp of (5, H, W) planes by (2, H, W) flow, clamped."""
    h, w = R1p.shape[1], R1p.shape[2]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    fx = jnp.clip(xs + flow_p[0], 0.0, w - 1.0)
    fy = jnp.clip(ys + flow_p[1], 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(fx), 0, w - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(fy), 0, h - 2).astype(jnp.int32)
    ax = (fx - x0.astype(jnp.float32))[None]
    ay = (fy - y0.astype(jnp.float32))[None]
    r00 = R1p[:, y0, x0]
    r01 = R1p[:, y0, x0 + 1]
    r10 = R1p[:, y0 + 1, x0]
    r11 = R1p[:, y0 + 1, x0 + 1]
    return (r00 * (1 - ax) * (1 - ay) + r01 * ax * (1 - ay)
            + r10 * (1 - ax) * ay + r11 * ax * ay)




# --------------------------------------------------------------- planar path
# Internal planar (C, H, W) layout: each plane is a contiguous (H, W)
# image, so every elementwise/cumsum pass runs over unit-stride rows
# instead of a 5-wide channel-last minor axis. The public API stays
# (H, W, 2).

def poly_expansion_p(img: jnp.ndarray, n: int, sigma: float) -> jnp.ndarray:
    """Planar twin of poly_expansion: (H, W) -> (5, H, W)."""
    g, ig11, ig03, ig33, ig55 = _poly_inv_gram(n, float(sigma))
    i = np.arange(-n, n + 1, dtype=np.float32)
    xg = (i * g).astype(np.float32)
    xxg = (i * i * g).astype(np.float32)
    f = img.astype(jnp.float32)
    v0 = correlate1d(f, g, axis=-2, border="replicate")
    v1 = correlate1d(f, xg, axis=-2, border="replicate")
    v2 = correlate1d(f, xxg, axis=-2, border="replicate")
    m00 = correlate1d(v0, g, axis=-1, border="replicate")
    m10 = correlate1d(v0, xg, axis=-1, border="replicate")
    m20 = correlate1d(v0, xxg, axis=-1, border="replicate")
    m01 = correlate1d(v1, g, axis=-1, border="replicate")
    m11 = correlate1d(v1, xg, axis=-1, border="replicate")
    m02 = correlate1d(v2, g, axis=-1, border="replicate")
    return jnp.stack([m10 * ig11, m01 * ig11,
                      m00 * ig03 + m20 * ig33,
                      m00 * ig03 + m02 * ig33,
                      m11 * ig55], axis=0)


def _warp_poly_selectsum_p(R1p: jnp.ndarray, flow_p: jnp.ndarray,
                           max_disp: int) -> jnp.ndarray:
    """Planar select-sum warp: (5, H, W) planes by (2, H, W) flow."""
    c, h, w = R1p.shape
    D = max_disp
    dxf = jnp.clip(flow_p[0].astype(jnp.float32), -D, D)
    dyf = jnp.clip(flow_p[1].astype(jnp.float32), -D, D)
    y_idx = jnp.floor(dyf).astype(jnp.int32)
    x_idx = jnp.floor(dxf).astype(jnp.int32)
    ay = (dyf - y_idx.astype(jnp.float32))[None].astype(R1p.dtype)
    ax = (dxf - x_idx.astype(jnp.float32))[None].astype(R1p.dtype)

    Rp = jnp.pad(R1p, ((0, 0), (D + 1, D + 1), (0, 0)), mode="edge")

    # unrolled one-hot sums: the full (2D+1)-term select chain fuses into
    # one XLA kernel instead of round-tripping the accumulator through
    # device memory every fori_loop iteration. Loads stay in the storage
    # dtype (bf16 mode reads half the bytes); selection/lerp run in f32
    # so the fused chain does not round in bf16.
    zero = jnp.zeros((), jnp.float32)
    ayf = ay.astype(jnp.float32)
    axf = ax.astype(jnp.float32)
    vt = None
    vb = None
    for i in range(2 * D + 1):
        m = (y_idx == (i - D))[None]
        t0 = jnp.where(m, Rp[:, i + 1:i + 1 + h, :].astype(jnp.float32),
                       zero)
        t1 = jnp.where(m, Rp[:, i + 2:i + 2 + h, :].astype(jnp.float32),
                       zero)
        vt = t0 if vt is None else vt + t0
        vb = t1 if vb is None else vb + t1
    v = vt * (1 - ayf) + vb * ayf
    vp = jnp.pad(v, ((0, 0), (0, 0), (D + 1, D + 1)), mode="edge")
    ut = None
    ub = None
    for i in range(2 * D + 1):
        m = (x_idx == (i - D))[None]
        t0 = jnp.where(m, vp[:, :, i + 1:i + 1 + w], zero)
        t1 = jnp.where(m, vp[:, :, i + 2:i + 2 + w], zero)
        ut = t0 if ut is None else ut + t0
        ub = t1 if ub is None else ub + t1
    return ut * (1 - axf) + ub * axf


def update_matrices_p(R0p: jnp.ndarray, R1p: jnp.ndarray,
                      flow_p: jnp.ndarray, fast_warp: int = 0) -> jnp.ndarray:
    """Planar twin of update_matrices: (5,H,W) x2 + (2,H,W) -> M (5,H,W)."""
    h, w = R0p.shape[1], R0p.shape[2]
    if fast_warp > 0:
        R1w = _warp_poly_selectsum_p(R1p, flow_p.astype(R1p.dtype), fast_warp)
    else:
        R1w = _warp_poly_planar(R1p, flow_p)
    # warp runs in the storage dtype (bf16 halves its bandwidth); the
    # normal-equation products are always f32
    R0p = R0p.astype(jnp.float32)
    R1w = R1w.astype(jnp.float32)
    dx = flow_p[0]
    dy = flow_p[1]
    a_xx = (R0p[2] + R1w[2]) * 0.5
    a_yy = (R0p[3] + R1w[3]) * 0.5
    axy = (R0p[4] + R1w[4]) * 0.25
    db_x = (R0p[0] - R1w[0]) * 0.5 + a_xx * dx + axy * dy
    db_y = (R0p[1] - R1w[1]) * 0.5 + axy * dx + a_yy * dy

    damp = _border_damp(h, w)
    a_xx = a_xx * damp
    a_yy = a_yy * damp
    axy = axy * damp
    db_x = db_x * damp
    db_y = db_y * damp

    M = jnp.stack([a_xx * a_xx + axy * axy,
                   (a_xx + a_yy) * axy,
                   a_yy * a_yy + axy * axy,
                   a_xx * db_x + axy * db_y,
                   axy * db_x + a_yy * db_y], axis=0)
    # store M in the plane dtype: in bf16 mode the winsize smoothing reads
    # half the bytes (EPE impact ~1e-3 px, tested)
    return M.astype(R1p.dtype)


def update_flow_p(Mp: jnp.ndarray, winsize: int, gaussian: bool
                  ) -> jnp.ndarray:
    """Planar twin of update_flow: M (5,H,W) -> flow (2,H,W)."""
    if gaussian:
        m = winsize // 2
        kern = gaussian_kernel(2 * m + 1, m * 0.3)
        Ms = correlate1d(correlate1d(Mp, kern, axis=-2, border="replicate"),
                         kern, axis=-1, border="replicate")
    else:
        Ms = box_filter(box_filter(Mp, winsize, axis=-2, border="replicate"),
                        winsize, axis=-1, border="replicate")
    Ms = Ms.astype(jnp.float32)
    g11, g12, g22, h1, h2 = Ms[0], Ms[1], Ms[2], Ms[3], Ms[4]
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return jnp.stack([(g22 * h1 - g12 * h2) * idet,
                      (g11 * h2 - g12 * h1) * idet], axis=0)


def polyexp_pyramid(img: jnp.ndarray, cfg: FlowConfig):
    """Per-level polynomial-expansion planes for one frame (coarsest
    first, matching farneback_levels order). The tracking pipeline caches
    this in its scan carry so each frame's pyramid+polyexp is computed
    once, not twice (SURVEY.md §3.1 hot-loop note)."""
    dt = jnp.bfloat16 if cfg.bf16_poly else jnp.float32
    with jax.named_scope("polyexp"):
        imgs = farneback_images(img, cfg.levels, cfg.pyr_scale)
        return tuple(poly_expansion_p(i, cfg.poly_n,
                                      cfg.poly_sigma).astype(dt)
                     for i in imgs)


def _iteration(cfg: FlowConfig):
    """One Farneback iteration (R0p, R1p, flow_p) -> flow_p; the named
    scopes tag its compiled fusions for trace attribution."""
    def it(R0p, R1p, flow_p):
        with jax.named_scope("matrices"):
            Mp = update_matrices_p(R0p, R1p, flow_p,
                                   fast_warp=cfg.fast_warp)
        with jax.named_scope("smooth_solve"):
            return update_flow_p(Mp, cfg.winsize, cfg.gaussian_win)
    return it


def farneback_from_pyramids(Rs_a, Rs_b, cfg: FlowConfig,
                            flow0: Optional[jnp.ndarray] = None):
    """Farneback iterations from precomputed PLANAR polyexp pyramids
    ((5, lh, lw) per level). Returns (H, W, 2)."""
    iteration = _iteration(cfg)
    flow_p = None
    for li in range(len(Rs_a)):
        R0p, R1p = Rs_a[li], Rs_b[li]
        lh, lw = R0p.shape[1], R0p.shape[2]
        if flow_p is None:
            if flow0 is not None:
                k = len(Rs_a) - 1
                f0 = jnp.moveaxis(flow0, -1, 0)
                flow_p = resize_linear(f0, lh, lw) * (cfg.pyr_scale ** k)
            else:
                flow_p = jnp.zeros((2, lh, lw), jnp.float32)
        else:
            flow_p = resize_linear(flow_p, lh, lw) * (1.0 / cfg.pyr_scale)
        with jax.named_scope(f"fb_level{len(Rs_a) - 1 - li}"):
            for _ in range(cfg.iterations):
                flow_p = iteration(R0p, R1p, flow_p)
    return jnp.moveaxis(flow_p, 0, -1)


def polyexp_pyramid_batch(grays: jnp.ndarray, cfg: FlowConfig):
    """Per-level polyexp planes for a (N, H, W) frame stack, coarsest
    first: tuple of (N, 5, lh, lw). The pair-batched pipeline's front
    end; per-frame math identical to polyexp_pyramid."""
    dt = jnp.bfloat16 if cfg.bf16_poly else jnp.float32
    imgs = farneback_images(grays, cfg.levels, cfg.pyr_scale)
    pe = jax.vmap(lambda im: poly_expansion_p(im, cfg.poly_n,
                                              cfg.poly_sigma))
    return tuple(pe(i).astype(dt) for i in imgs)


def farneback_pairs_from_pyramids(Rs_all, cfg: FlowConfig,
                                  clip_len: int = 0) -> jnp.ndarray:
    """Cold Farneback flow for ALL consecutive frame pairs of a clip (or
    of several chained clips) from batched polyexp pyramids.

    Rs_all: tuple per level (coarsest first) of (N, 5, lh, lw) plane
    stacks for N frames. Pair b uses frames (p, p+1) with p = b, or
    p = b + b // (clip_len - 1) when `clip_len` = T chains C clips as
    N = C * T. Returns (B, H, W, 2) flows, per-pair identical to
    farneback_from_pyramids (cold start, flow0=None)."""
    N = Rs_all[0].shape[0]
    if clip_len:
        ppc = clip_len - 1
        B = (N // clip_len) * ppc
        pidx = np.arange(B) + np.arange(B) // ppc
    else:
        B = N - 1
        pidx = np.arange(B)
    iteration = _iteration(cfg)
    flow_b = None
    for li in range(len(Rs_all)):
        Rl = Rs_all[li]
        lh, lw = Rl.shape[2], Rl.shape[3]
        if flow_b is None:
            flow_b = jnp.zeros((B, 2, lh, lw), jnp.float32)
        else:
            flow_b = jax.vmap(
                lambda f: resize_linear(f, lh, lw))(flow_b) \
                * (1.0 / cfg.pyr_scale)
        R0 = Rl[pidx]
        R1 = Rl[pidx + 1]
        for _ in range(cfg.iterations):
            flow_b = jax.vmap(iteration)(R0, R1, flow_b)
    return jnp.moveaxis(flow_b, 1, -1)


def farneback(prev: jnp.ndarray, nxt: jnp.ndarray, cfg: FlowConfig,
              flow0: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Dense flow prev -> next, (H, W, 2) float32, channel 0 = x."""
    Rs_a = polyexp_pyramid(prev, cfg)
    Rs_b = polyexp_pyramid(nxt, cfg)
    return farneback_from_pyramids(Rs_a, Rs_b, cfg, flow0=flow0)
