"""Pyramidal Lucas-Kanade optical flow (sparse + dense), pure XLA.

Sparse path replicates cv2.calcOpticalFlowPyrLK (SURVEY.md §2.3): Scharr/32
spatial derivatives computed once per level on the prev image, bilinear
fractional patches, structure tensor G per point, Gauss-Newton iterations
d = -G^-1 b with |d|^2 <= eps^2 early-out (masked, static trip count),
x2 propagation between levels, min-eigenvalue rejection.

Dense path is the same math with the integration window realized as
winsize box sums over the whole image (per-pixel G and b), iterated
coarse-to-fine — the BASELINE.json:7 config-1 flow. All loops are static;
everything jit-compiles to one XLA program.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import FlowConfig
from .filters import box_filter, correlate1d
from .pyramid import build_pyramid, resize_linear
from .warp import bilinear_sample, warp_image

_SCHARR_EDGE = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SCHARR_SMOOTH = np.array([3.0, 10.0, 3.0], dtype=np.float32) / 32.0


def scharr_gradients(img: jnp.ndarray):
    """cv2 pyrLK derivative convention: Scharr (3,10,3)/32 cross-smoothing."""
    gx = correlate1d(correlate1d(img, _SCHARR_EDGE, axis=-1, border="replicate"),
                     _SCHARR_SMOOTH, axis=-2, border="replicate")
    gy = correlate1d(correlate1d(img, _SCHARR_EDGE, axis=-2, border="replicate"),
                     _SCHARR_SMOOTH, axis=-1, border="replicate")
    return gx, gy


# --------------------------------------------------------------- sparse LK

def _patch(img_pad, cx, cy, w: int, half: float):
    """(w, w) bilinear patch centered at PADDED coords (cx, cy): ONE
    dynamic_slice of a (w+1, w+1) block + 4 static shifts — one gather
    index per patch instead of 4*w^2."""
    bx = jnp.floor(cx - half).astype(jnp.int32)
    by = jnp.floor(cy - half).astype(jnp.int32)
    fx = cx - half - bx.astype(jnp.float32)
    fy = cy - half - by.astype(jnp.float32)
    blk = lax.dynamic_slice(img_pad, (by, bx), (w + 1, w + 1))
    return (blk[:w, :w] * (1 - fx) * (1 - fy)
            + blk[:w, 1:] * fx * (1 - fy)
            + blk[1:, :w] * (1 - fx) * fy
            + blk[1:, 1:] * fx * fy)


def _track_point_level(img_a, img_b, gx, gy, pt, guess, cfg: FlowConfig):
    """One pyramid level of LK for one point.

    Inputs are PADDED images (replicate, pad = half+2) with pt/guess in
    padded coordinates, pre-clamped by the caller so every slice is
    in-bounds (identical sampling semantics to border-clamped
    bilinear_sample). Returns (new_guess, valid, min_eig).
    """
    w = cfg.lk_winsize
    half = (w - 1) * 0.5

    patch_a = _patch(img_a, pt[0], pt[1], w, half)
    pgx = _patch(gx, pt[0], pt[1], w, half)
    pgy = _patch(gy, pt[0], pt[1], w, half)

    g11 = jnp.sum(pgx * pgx)
    g12 = jnp.sum(pgx * pgy)
    g22 = jnp.sum(pgy * pgy)
    min_eig = ((g11 + g22) - jnp.sqrt((g11 - g22) ** 2 + 4.0 * g12 ** 2)) \
        * 0.5 / (w * w)
    det = g11 * g22 - g12 * g12
    ok = (min_eig > cfg.lk_min_eig) & (det > 1e-12)
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)

    eps2 = jnp.float32(cfg.lk_eps * cfg.lk_eps)
    h_pad, w_pad = img_b.shape
    lo = jnp.float32(half)
    hi_x = jnp.float32(w_pad - 1 - half - 2)
    hi_y = jnp.float32(h_pad - 1 - half - 2)

    def body(_i, carry):
        g, active = carry
        cx = jnp.clip(g[0], lo, hi_x)
        cy = jnp.clip(g[1], lo, hi_y)
        patch_b = _patch(img_b, cx, cy, w, half)
        diff = patch_b - patch_a
        b1 = jnp.sum(diff * pgx)
        b2 = jnp.sum(diff * pgy)
        dx = -(g22 * b1 - g12 * b2) * inv_det
        dy = -(g11 * b2 - g12 * b1) * inv_det
        d = jnp.stack([dx, dy])
        g_new = jnp.where(active, g + d, g)
        still = active & (jnp.sum(d * d) > eps2)
        return g_new, still

    guess, _ = lax.fori_loop(0, cfg.lk_max_iter, body, (guess, ok))
    return guess, ok, min_eig


def _gather_blocks(imgs: jnp.ndarray, by: jnp.ndarray, bx: jnp.ndarray,
                   size: int) -> jnp.ndarray:
    """Batched (K, C, size, size) block extraction from (C, Hp, Wp) images
    at per-point integer bases: one ROW gather (K*size row ids) + a
    one-hot column contraction. Replaces K*size^2 scalar gather indices /
    K dynamic-slices."""
    C, H, W = imgs.shape
    iy = jnp.clip(by[:, None] + jnp.arange(size)[None, :], 0, H - 1)
    rows = imgs[:, iy]                                    # (C, K, size, W)
    ix = jnp.clip(bx[:, None] + jnp.arange(size)[None, :], 0, W - 1)
    sel = (ix[:, :, None] == jnp.arange(W)[None, None, :]).astype(imgs.dtype)
    out = jnp.einsum("cksw,ktw->kcst", rows, sel,
                     precision=jax.lax.Precision.HIGHEST)
    return out                                            # (K, C, size, size)


def _gather_blocks_klast(imgs: jnp.ndarray, by: jnp.ndarray, bx: jnp.ndarray,
                         size: int) -> jnp.ndarray:
    """K-LAST twin of _gather_blocks: returns (C, size, size, K).

    K is the minor (contiguous) axis, so the downstream per-point
    iteration math runs elementwise over long unit-stride K vectors
    instead of small (size, size) patches."""
    C, H, W = imgs.shape
    iy = jnp.clip(by[:, None] + jnp.arange(size)[None, :], 0, H - 1)
    rows = imgs[:, iy]                                    # (C, K, size, W)
    ix = jnp.clip(bx[:, None] + jnp.arange(size)[None, :], 0, W - 1)
    sel = (ix[:, :, None] == jnp.arange(W)[None, None, :]).astype(imgs.dtype)
    out = jnp.einsum("cksw,ktw->cstk", rows, sel,
                     precision=jax.lax.Precision.HIGHEST)
    return out                                            # (C, size, size, K)


def _gather_blocks_klast_blocked(imgs: jnp.ndarray, by: jnp.ndarray,
                                 bx: jnp.ndarray, size: int) -> jnp.ndarray:
    """Blocked twin of _gather_blocks_klast (same output for ANY bases,
    including out-of-range ones — the per-element column clamp below
    reproduces the plain twin's edge replication exactly).

    The plain version materializes the full-width row gather
    (C, K, size, W) AND a (K, size, W) one-hot — ~300 MB each at
    1080p/K=1024 — before the contraction. Here the column offset is
    split into a 128-block index and a residual: a flat row+block gather
    fetches only the TWO 128-column blocks covering each window row
    ((C, K, size, 256) ≈ 40 MB), and the residual resolves via a small
    (K, size, 256) one-hot contraction. Identical math, ~8x smaller
    intermediates."""
    C, H, W = imgs.shape
    BL = 128
    nb = (W + BL - 1) // BL + 1          # +1 guard block for bb+1
    imgs_p = jnp.pad(imgs, ((0, 0), (0, 0), (0, nb * BL - W)))
    flat = imgs_p.reshape(C, H * nb, BL)
    bb = jnp.clip(bx, 0, W - 1) // BL                      # (K,)
    iy = jnp.clip(by[:, None] + jnp.arange(size)[None, :], 0, H - 1)
    rid = (iy[:, :, None] * nb + bb[:, None, None]
           + jnp.arange(2)[None, None, :])                 # (K, size, 2)
    win = flat[:, rid]                                     # (C,K,size,2,BL)
    win = win.reshape(C, win.shape[1], size, 2 * BL)
    # per-element column clamp (edge replication) expressed block-local:
    # every clipped target lies inside the two fetched blocks for
    # size <= 128, so this matches the plain twin for ANY bx
    ix = (jnp.clip(bx[:, None] + jnp.arange(size)[None, :], 0, W - 1)
          - (bb * BL)[:, None])                            # (K, size)
    sel = (ix[:, :, None] == jnp.arange(2 * BL)[None, None, :]).astype(
        imgs.dtype)
    return jnp.einsum("cksu,ktu->cstk", win, sel,
                      precision=jax.lax.Precision.HIGHEST)


def _bilinear_shift(blk: jnp.ndarray, fx, fy, out: int) -> jnp.ndarray:
    """(..., out+1, out+1) block -> (..., out, out) patch at fraction
    (fx, fy) via the 4 static corner shifts (no gathers)."""
    return (blk[..., :out, :out] * (1 - fx) * (1 - fy)
            + blk[..., :out, 1:out + 1] * fx * (1 - fy)
            + blk[..., 1:out + 1, :out] * (1 - fx) * fy
            + blk[..., 1:out + 1, 1:out + 1] * fx * fy)


def _select_subblock(blk: jnp.ndarray, dy, dx, size: int) -> jnp.ndarray:
    """(B, B) block -> (size, size) sub-block at traced integer offset
    (dy, dx) in [0, B-size], via masked sums over the static shifts
    (select-sum: elementwise work instead of a dynamic-slice)."""
    B = blk.shape[-1]
    nshift = B - size + 1
    rows = None
    for i in range(nshift):
        t = jnp.where(dy == i, blk[i:i + size, :], 0.0)
        rows = t if rows is None else rows + t
    out = None
    for j in range(nshift):
        t = jnp.where(dx == j, rows[:, j:j + size], 0.0)
        out = t if out is None else out + t
    return out


def _track_point_level_block(blk_b, patch_a, pgx, pgy, base, guess,
                             cfg: FlowConfig):
    """LK iterations for one point with frame B's halo'd block in hand.

    blk_b: (Bb, Bb) block of the next frame whose top-left maps to padded
    coords `base`; patch_a/pgx/pgy: (w, w) resolved template/gradient
    patches. Per-iteration displacement is clamped to the block (the
    lk_block_halo semantic bound, mirroring fast_warp). Returns
    (new_guess, valid, min_eig).
    """
    w = cfg.lk_winsize
    half = (w - 1) * 0.5
    D2 = blk_b.shape[0] - (w + 1)          # = 2 * halo

    g11 = jnp.sum(pgx * pgx)
    g12 = jnp.sum(pgx * pgy)
    g22 = jnp.sum(pgy * pgy)
    min_eig = ((g11 + g22) - jnp.sqrt((g11 - g22) ** 2 + 4.0 * g12 ** 2)) \
        * 0.5 / (w * w)
    det = g11 * g22 - g12 * g12
    ok = (min_eig > cfg.lk_min_eig) & (det > 1e-12)
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    eps2 = jnp.float32(cfg.lk_eps * cfg.lk_eps)

    def body(_i, carry):
        g, active = carry
        # patch top-left offset inside the block, clamped to the halo
        ox = jnp.clip(g[0] - half - base[0], 0.0, float(D2))
        oy = jnp.clip(g[1] - half - base[1], 0.0, float(D2))
        dx_i = jnp.floor(ox).astype(jnp.int32)
        dy_i = jnp.floor(oy).astype(jnp.int32)
        sub = _select_subblock(blk_b, dy_i, dx_i, w + 1)
        patch_b = _bilinear_shift(sub, ox - dx_i, oy - dy_i, w)
        diff = patch_b - patch_a
        b1 = jnp.sum(diff * pgx)
        b2 = jnp.sum(diff * pgy)
        dxs = -(g22 * b1 - g12 * b2) * inv_det
        dys = -(g11 * b2 - g12 * b1) * inv_det
        d = jnp.stack([dxs, dys])
        g_new = jnp.where(active, g + d, g)
        still = active & (jnp.sum(d * d) > eps2)
        return g_new, still

    guess, _ = lax.fori_loop(0, cfg.lk_max_iter, body, (guess, ok))
    return guess, ok, min_eig


def _bshift_klast(blk, fx, fy, w):
    """(..., n+1, n+1, K) -> (..., n, n, K) subpixel bilinear shift via
    the 4 static corner slices (no gathers; K stays the minor axis)."""
    return (blk[..., :w, :w, :] * (1 - fx) * (1 - fy)
            + blk[..., :w, 1:w + 1, :] * fx * (1 - fy)
            + blk[..., 1:w + 1, :w, :] * (1 - fx) * fy
            + blk[..., 1:w + 1, 1:w + 1, :] * fx * fy)


def _lk_level_prologue(pa, pb, pgx, pgy, pt_l, guess, cfg: FlowConfig):
    """Shared per-level setup for BOTH batched K-last solvers (plain
    Gauss-Newton and correlation-table): template/gradient patches at the
    fixed point location, Gram terms + gating, and the frame-B halo'd
    search blocks around the initial guess.

    blocked gather (FlowConfig.lk_blocked_gather, default True):
    bit-exact, and it avoids the plain full-width gather's ~300 MB
    intermediates at 1080p/1k tracks."""
    w = cfg.lk_winsize
    half = (w - 1) * 0.5
    D = cfg.lk_block_halo
    Bb = w + 1 + 2 * D
    Hp, Wp = pb.shape

    _gb = (_gather_blocks_klast_blocked if cfg.lk_blocked_gather
           else _gather_blocks_klast)
    abase_x = jnp.floor(pt_l[:, 0] - half).astype(jnp.int32)
    abase_y = jnp.floor(pt_l[:, 1] - half).astype(jnp.int32)
    stack_a = jnp.stack([pa, pgx, pgy], axis=0)
    blks_a = _gb(stack_a, abase_y, abase_x, w + 1)
    fax = (pt_l[:, 0] - half - abase_x)[None, None, :]
    fay = (pt_l[:, 1] - half - abase_y)[None, None, :]

    patches = _bshift_klast(blks_a, fax, fay, w)          # (3, w, w, K)
    patch_a, pgx_p, pgy_p = patches[0], patches[1], patches[2]

    g11 = jnp.sum(pgx_p * pgx_p, axis=(0, 1))             # (K,)
    g12 = jnp.sum(pgx_p * pgy_p, axis=(0, 1))
    g22 = jnp.sum(pgy_p * pgy_p, axis=(0, 1))
    min_eig = ((g11 + g22) - jnp.sqrt((g11 - g22) ** 2 + 4.0 * g12 ** 2)) \
        * 0.5 / (w * w)
    det = g11 * g22 - g12 * g12
    ok = (min_eig > cfg.lk_min_eig) & (det > 1e-12)
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    eps2 = jnp.float32(cfg.lk_eps * cfg.lk_eps)

    # frame-B halo'd blocks around the initial guess
    bbase_x = jnp.clip(jnp.floor(guess[:, 0] - half).astype(jnp.int32) - D,
                       0, Wp - Bb)
    bbase_y = jnp.clip(jnp.floor(guess[:, 1] - half).astype(jnp.int32) - D,
                       0, Hp - Bb)
    blk_b = _gb(pb[None], bbase_y, bbase_x, Bb)[0]
    return (patch_a, pgx_p, pgy_p, g11, g12, g22, min_eig, ok, inv_det,
            eps2, blk_b, bbase_x.astype(jnp.float32),
            bbase_y.astype(jnp.float32))


def _lk_level_batched_klast(pa, pb, pgx, pgy, pt_l, guess, cfg: FlowConfig):
    """One pyramid level for ALL points, K-LAST layout: the K point axis
    is the minor axis through every patch op, so each elementwise pass
    runs over K-long contiguous vectors (the vmapped K-leading variant
    iterates over small w-wide patches instead)."""
    w = cfg.lk_winsize
    half = (w - 1) * 0.5
    D = cfg.lk_block_halo
    D2 = 2 * D

    (patch_a, pgx_p, pgy_p, g11, g12, g22, min_eig, ok, inv_det,
     eps2, blk_b, base_x, base_y) = _lk_level_prologue(
        pa, pb, pgx, pgy, pt_l, guess, cfg)

    def bshift(blk, fx, fy):
        return _bshift_klast(blk, fx, fy, w)

    def body(_i, carry):
        gx_, gy_, active = carry
        ox = jnp.clip(gx_ - half - base_x, 0.0, float(D2))
        oy = jnp.clip(gy_ - half - base_y, 0.0, float(D2))
        dx_i = jnp.floor(ox).astype(jnp.int32)
        dy_i = jnp.floor(oy).astype(jnp.int32)
        # select-sum sub-block: static shifts on the leading axes, the
        # per-point one-hot select broadcasts over the K axis
        rows = None
        for i in range(D2 + 1):
            t = jnp.where(dy_i[None, None, :] == i,
                          blk_b[i:i + w + 1, :, :], 0.0)
            rows = t if rows is None else rows + t        # (w+1, Bb, K)
        sub = None
        for j in range(D2 + 1):
            t = jnp.where(dx_i[None, None, :] == j,
                          rows[:, j:j + w + 1, :], 0.0)
            sub = t if sub is None else sub + t           # (w+1, w+1, K)
        fx = (ox - dx_i)[None, None, :]
        fy = (oy - dy_i)[None, None, :]
        patch_b = bshift(sub, fx, fy)                     # (w, w, K)
        diff = patch_b - patch_a
        b1 = jnp.sum(diff * pgx_p, axis=(0, 1))
        b2 = jnp.sum(diff * pgy_p, axis=(0, 1))
        dxs = -(g22 * b1 - g12 * b2) * inv_det
        dys = -(g11 * b2 - g12 * b1) * inv_det
        gx_n = jnp.where(active, gx_ + dxs, gx_)
        gy_n = jnp.where(active, gy_ + dys, gy_)
        still = active & (dxs * dxs + dys * dys > eps2)
        return gx_n, gy_n, still

    gx_, gy_, _ = lax.fori_loop(
        0, cfg.lk_max_iter, body, (guess[:, 0], guess[:, 1], ok))
    return jnp.stack([gx_, gy_], axis=-1), ok, min_eig


def _corr_tables(blk_b: jnp.ndarray, t: jnp.ndarray, n_off: int, w: int,
                 use_conv: bool) -> jnp.ndarray:
    """All-integer-offset correlation of each point's block with its
    template: out[o1, o2, k] = sum_s blk_b[o1+s1, o2+s2, k] * t[s1, s2, k].

    use_conv realizes it as ONE depthwise (feature_group_count=K)
    correlation; otherwise as n_off^2 static slice-multiply-reduces
    (same math, two lowerings)."""
    K = blk_b.shape[-1]
    if use_conv:
        lhs = jnp.moveaxis(blk_b, -1, 0)[None]            # (1, K, Bb, Bb)
        rhs = jnp.moveaxis(t, -1, 0)[:, None]             # (K, 1, w, w)
        out = jax.lax.conv_general_dilated(
            lhs, rhs, window_strides=(1, 1), padding="VALID",
            feature_group_count=K,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST)          # (1, K, n, n)
        return jnp.moveaxis(out[0], 0, -1)                # (n, n, K)
    rows = []
    for o1 in range(n_off):
        cols = []
        for o2 in range(n_off):
            cols.append(jnp.sum(blk_b[o1:o1 + w, o2:o2 + w, :] * t,
                                axis=(0, 1)))
        rows.append(jnp.stack(cols))
    return jnp.stack(rows)                                # (n, n, K)


def _lut_bilinear(C: jnp.ndarray, dy, dx, fy, fx, n_off: int):
    """Per-point bilinear lookup into a (n_off, n_off, K) table at integer
    offsets (dy, dx) in [0, n_off-2] with fractions (fy, fx) — one-hot
    select-sums over the tiny leading axes (elementwise over K)."""
    top = None
    bot = None
    for i in range(n_off - 1):
        m = dy == i
        t0 = jnp.where(m, C[i], 0.0)
        t1 = jnp.where(m, C[i + 1], 0.0)
        top = t0 if top is None else top + t0
        bot = t1 if bot is None else bot + t1
    v = top * (1 - fy) + bot * fy                         # (n_off, K)
    lft = None
    rgt = None
    for j in range(n_off - 1):
        m = dx == j
        t0 = jnp.where(m, v[j], 0.0)
        t1 = jnp.where(m, v[j + 1], 0.0)
        lft = t0 if lft is None else lft + t0
        rgt = t1 if rgt is None else rgt + t1
    return lft * (1 - fx) + rgt * fx                      # (K,)


def _lk_level_batched_corr(pa, pb, pgx, pgy, pt_l, guess, cfg: FlowConfig,
                           use_conv: bool = False):
    """Correlation-table variant of _lk_level_batched_klast — EXACTLY the
    same math, restructured so the Gauss-Newton iterations cost O(K)
    instead of O(w^2 Bb K) each.

    Key identity: the bilinear-shifted patch is LINEAR in the block, so
    the residual projections b = sum((patch_b - patch_a) * grad) at any
    subpixel offset are bilinear interpolations of the integer-offset
    correlation tables corr_g(o) = sum_s blk_b[o+s] g[s]. The tables are
    built ONCE per level (the only O(w^2) work); each iteration is then a
    tiny per-point table lookup + 2x2 solve. Early exit: the masked
    updates already freeze converged points, so a while_loop on
    any(active) terminates early with bit-identical results.
    """
    w = cfg.lk_winsize
    half = (w - 1) * 0.5
    D2 = 2 * cfg.lk_block_halo
    n_off = D2 + 2

    (patch_a, pgx_p, pgy_p, g11, g12, g22, min_eig, ok, inv_det,
     eps2, blk_b, base_x, base_y) = _lk_level_prologue(
        pa, pb, pgx, pgy, pt_l, guess, cfg)

    # template-side constants + the two correlation tables (once per level)
    ca = jnp.sum(patch_a * pgx_p, axis=(0, 1))
    cb = jnp.sum(patch_a * pgy_p, axis=(0, 1))
    Cgx = _corr_tables(blk_b, pgx_p, n_off, w, use_conv)
    Cgy = _corr_tables(blk_b, pgy_p, n_off, w, use_conv)

    def cond(carry):
        i, _gx, _gy, active = carry
        return (i < cfg.lk_max_iter) & jnp.any(active)

    def body(carry):
        i, gx_, gy_, active = carry
        ox = jnp.clip(gx_ - half - base_x, 0.0, float(D2))
        oy = jnp.clip(gy_ - half - base_y, 0.0, float(D2))
        dx_i = jnp.floor(ox).astype(jnp.int32)
        dy_i = jnp.floor(oy).astype(jnp.int32)
        fx = ox - dx_i
        fy = oy - dy_i
        b1 = _lut_bilinear(Cgx, dy_i, dx_i, fy, fx, n_off) - ca
        b2 = _lut_bilinear(Cgy, dy_i, dx_i, fy, fx, n_off) - cb
        dxs = -(g22 * b1 - g12 * b2) * inv_det
        dys = -(g11 * b2 - g12 * b1) * inv_det
        gx_n = jnp.where(active, gx_ + dxs, gx_)
        gy_n = jnp.where(active, gy_ + dys, gy_)
        still = active & (dxs * dxs + dys * dys > eps2)
        return i + 1, gx_n, gy_n, still

    _i, gx_, gy_, _ = lax.while_loop(
        cond, body, (jnp.int32(0), guess[:, 0], guess[:, 1], ok))
    return jnp.stack([gx_, gy_], axis=-1), ok, min_eig


def _lk_level_batched(pa, pb, pgx, pgy, pt_l, guess, cfg: FlowConfig):
    """One pyramid level for ALL points: batched block extraction + vmapped
    gather-free iterations (cfg.lk_block_halo > 0 path)."""
    w = cfg.lk_winsize
    half = (w - 1) * 0.5
    D = cfg.lk_block_halo
    Bb = w + 1 + 2 * D

    Hp, Wp = pb.shape

    # template/gradient patches at the (fixed) point location
    abase_x = jnp.floor(pt_l[:, 0] - half).astype(jnp.int32)
    abase_y = jnp.floor(pt_l[:, 1] - half).astype(jnp.int32)
    stack_a = jnp.stack([pa, pgx, pgy], axis=0)
    blks_a = _gather_blocks(stack_a, abase_y, abase_x, w + 1)  # (K,3,w+1,w+1)
    fax = (pt_l[:, 0] - half - abase_x)[:, None, None, None]
    fay = (pt_l[:, 1] - half - abase_y)[:, None, None, None]
    patches = _bilinear_shift(blks_a, fax, fay, w)             # (K,3,w,w)

    # frame-B halo'd blocks around the initial guess (bases clamped so the
    # block — and therefore `base` — always matches the gathered rows)
    bbase_x = jnp.clip(jnp.floor(guess[:, 0] - half).astype(jnp.int32) - D,
                       0, Wp - Bb)
    bbase_y = jnp.clip(jnp.floor(guess[:, 1] - half).astype(jnp.int32) - D,
                       0, Hp - Bb)
    blks_b = _gather_blocks(pb[None], bbase_y, bbase_x, Bb)[:, 0]  # (K,Bb,Bb)
    base = jnp.stack([bbase_x, bbase_y], axis=-1).astype(jnp.float32)

    track = jax.vmap(lambda bb, p3, bs, g: _track_point_level_block(
        bb, p3[0], p3[1], p3[2], bs, g, cfg))
    return track(blks_b, patches, base, guess)


def lk_pyramid(img: jnp.ndarray, cfg: FlowConfig):
    """Pyramid + Scharr gradients for one frame — cacheable per frame
    (the pipeline carries the previous frame's tuple in its scan carry so
    each frame's pyramid is built once, not twice)."""
    pyr = build_pyramid(img.astype(jnp.float32), cfg.levels)
    grads = [scharr_gradients(a) for a in pyr]
    return tuple(pyr), tuple(grads)


def lk_sparse(prev: jnp.ndarray, nxt: jnp.ndarray, pts: jnp.ndarray,
              cfg: FlowConfig, prev_pyr=None, next_pyr=None):
    """Track (K, 2) float32 points from prev to nxt.

    Returns (new_pts (K, 2), status (K,) bool). Equivalent call:
    cv2.calcOpticalFlowPyrLK(prev, nxt, pts, winSize=(lk_winsize,)*2,
    maxLevel=levels-1, criteria=(lk_max_iter, lk_eps)). Precomputed
    `lk_pyramid` tuples can be passed to skip pyramid construction.
    """
    pyr_a, grads = prev_pyr if prev_pyr is not None else lk_pyramid(prev, cfg)
    pyr_b = (next_pyr[0] if next_pyr is not None
             else build_pyramid(nxt.astype(jnp.float32), cfg.levels))
    half = (cfg.lk_winsize - 1) // 2
    pad = half + 2   # replicate pad == border-clamped sampling semantics

    def prep(x):
        return jnp.pad(x, ((pad, pad), (pad, pad)), mode="edge")

    scale_top = 1.0 / (2 ** (cfg.levels - 1))
    guess = pts * scale_top
    status = jnp.ones(pts.shape[0], dtype=bool)
    for lvl in range(cfg.levels - 1, -1, -1):
        img_a, img_b = pyr_a[lvl], pyr_b[lvl]
        h, w = img_a.shape
        gx, gy = grads[lvl]
        pa, pb, pgx, pgy = prep(img_a), prep(img_b), prep(gx), prep(gy)
        pt_l = jnp.clip(pts * (1.0 / (2 ** lvl)),
                        0.0, jnp.asarray([w - 1.0, h - 1.0])) + pad
        guess_p = jnp.clip(guess, -float(pad // 2),
                           jnp.asarray([w - 1.0 + pad // 2,
                                        h - 1.0 + pad // 2])) + pad
        # the halo'd block must fit the (padded) level image; tiny coarse
        # levels (Wp < Bb) would make jnp.clip(base, 0, Wp - Bb) invalid
        # (min > max -> negative bases -> garbage patches), so they take
        # the per-point exact path instead — a static, shape-derived choice
        Bb = cfg.lk_winsize + 1 + 2 * cfg.lk_block_halo
        if cfg.lk_block_halo > 0 and min(pa.shape) >= Bb:
            if cfg.lk_solver in ("corr", "corr_conv"):
                guess_p, ok, _eig = _lk_level_batched_corr(
                    pa, pb, pgx, pgy, pt_l, guess_p, cfg,
                    use_conv=cfg.lk_solver == "corr_conv")
            else:
                guess_p, ok, _eig = _lk_level_batched_klast(
                    pa, pb, pgx, pgy, pt_l, guess_p, cfg)
        else:
            track = jax.vmap(
                lambda p, g: _track_point_level(pa, pb, pgx, pgy, p, g, cfg))
            guess_p, ok, _eig = track(pt_l, guess_p)
        guess = guess_p - pad
        # in-bounds check at base level
        if lvl == 0:
            inb = ((guess[:, 0] >= 0) & (guess[:, 0] <= w - 1)
                   & (guess[:, 1] >= 0) & (guess[:, 1] <= h - 1))
            status = status & ok & inb
        if lvl > 0:
            guess = guess * 2.0
    return guess, status


# ---------------------------------------------------------------- dense LK

def lk_dense(prev: jnp.ndarray, nxt: jnp.ndarray, cfg: FlowConfig):
    """Dense pyramidal LK flow, (H, W, 2) float32 (x, y displacement).

    Per-pixel window sums realized as box filters (winsize), iterated with
    backward warping of the next frame, coarse-to-fine with x2 upsampling.
    """
    a = prev.astype(jnp.float32)
    b = nxt.astype(jnp.float32)
    pyr_a = build_pyramid(a, cfg.levels)
    pyr_b = build_pyramid(b, cfg.levels)
    w = cfg.lk_winsize

    flow = None
    for lvl in range(cfg.levels - 1, -1, -1):
        ia, ib = pyr_a[lvl], pyr_b[lvl]
        h_l, w_l = ia.shape
        if flow is None:
            flow = jnp.zeros((h_l, w_l, 2), dtype=jnp.float32)
        else:
            flow = resize_linear(flow, h_l, w_l) * 2.0
        gx, gy = scharr_gradients(ia)

        def wsum(v):
            return box_filter(
                box_filter(v, w, axis=-2, border="replicate", normalize=False),
                w, axis=-1, border="replicate", normalize=False)

        gxx = gx * gx
        gxy = gx * gy
        gyy = gy * gy
        g11 = wsum(gxx)
        g12 = wsum(gxy)
        g22 = wsum(gyy)
        det = g11 * g22 - g12 * g12
        min_eig = ((g11 + g22)
                   - jnp.sqrt((g11 - g22) ** 2 + 4.0 * g12 ** 2)) * 0.5 / (w * w)
        ok = (min_eig > cfg.lk_min_eig) & (det > 1e-12)
        inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)

        def body(_i, fl):
            # Re-solve for the TOTAL flow each iteration (not an increment):
            # linearizing B(q+u) around the current per-pixel flow gives
            # window normal equations  G u_new = sum_w(grad grad^T u_old
            # - dI grad).  The absolute solve is contractive where the
            # incremental form has >1 loop gain through neighboring pixels
            # (same structure as Farneback's M . d_prior term).
            if cfg.fast_warp > 0:
                from .farneback import _warp_poly_selectsum
                warped = _warp_poly_selectsum(ib[..., None], fl,
                                              cfg.fast_warp)[..., 0]
            else:
                warped = warp_image(ib, fl)
            diff = warped - ia
            ux, uy = fl[..., 0], fl[..., 1]
            h1 = wsum(gxx * ux + gxy * uy - diff * gx)
            h2 = wsum(gxy * ux + gyy * uy - diff * gy)
            nx = (g22 * h1 - g12 * h2) * inv_det
            ny = (g11 * h2 - g12 * h1) * inv_det
            new = jnp.stack([nx, ny], axis=-1)
            return jnp.where(ok[..., None], new, fl)

        flow = lax.fori_loop(0, cfg.lk_max_iter, body, flow)
    return flow
