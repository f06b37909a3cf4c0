"""Spatial frame sharding: dense flow with row-band partitioning + halo
exchange (SURVEY.md §2.2 — the tensor-parallel / ring-attention analog for
this workload).

A frame's rows are sharded across the mesh; every windowed op needs only a
fixed-width band of neighbor rows, so each stage exchanges halos with
`lax.ppermute` (NCCL over NVLink on a multi-GPU host) instead of gathering
the full frame. Use when a single frame no longer fits (or saturates) one
device; at 1080p it is optional (SURVEY.md §1.2), and the mechanism is
exercised in tests on a fake 8-device CPU mesh.

Implemented pipeline: spatially-sharded dense pyramidal LK
(`lk_dense_sharded`) — pyrDown, Scharr gradients, window sums and the
warp are all local given halos; the warp's vertical displacement is
clamped to the halo width (documented semantic bound, default 8 px/level,
well above per-level LK updates).

Spatially-sharded Farneback is implemented below (`farneback_sharded`):
cv2's cvRound level sizes (1080 -> 540 -> 270 -> 135 -> 68 -> 34) stop
dividing by the mesh at level 3, so coarse levels compute replicated
(each device runs them on its full-frame copy — <25% of the pixels) and
the finest level runs row-sharded with `ppermute` flow-halo exchange
between iterations. Parity-tested on 2/4/8 fake devices.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import FlowConfig
from ..ops import lk as lk_ops
from ..ops.filters import correlate1d
from ..ops.pyramid import resize_linear

_PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def halo_exchange(x: jnp.ndarray, halo: int, axis_name: str,
                  pad_mode: str = "edge") -> jnp.ndarray:
    """Extend a row-sharded block with `halo` rows from each neighbor.

    x: (h_local, ...) block on each device. Edge devices synthesize the
    missing halo with `pad_mode` ('edge' = replicate, 'reflect' =
    REFLECT_101) so global border semantics match the unsharded op.
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    down = [(i, (i + 1) % n) for i in range(n)]   # send to next (row-below)
    up = [(i, (i - 1) % n) for i in range(n)]     # send to previous

    from_above = lax.ppermute(x[-halo:], axis_name, perm=down)
    from_below = lax.ppermute(x[:halo], axis_name, perm=up)

    pads = [(halo, halo)] + [(0, 0)] * (x.ndim - 1)
    x_pad = jnp.pad(x, pads, mode=pad_mode)
    top_is_edge = idx == 0
    bot_is_edge = idx == n - 1
    top = jnp.where(top_is_edge, x_pad[:halo], from_above)
    bot = jnp.where(bot_is_edge, x_pad[-halo:], from_below)
    return jnp.concatenate([top, x, bot], axis=0)


def _pyr_down_local(block: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Sharded cv2.pyrDown: 2-row halo exchange + local blur/decimate.

    Requires the local block height to be even (global H divisible by
    2^levels * n_devices), keeping decimation globally aligned.
    """
    ext = halo_exchange(block, 2, axis_name, pad_mode="reflect")
    v = None
    for k, wk in enumerate(_PYR_K):
        sl = ext[k:k + block.shape[0], :]
        t = wk * sl
        v = t if v is None else v + t
    v = v[::2]
    h = correlate1d(v, _PYR_K, axis=-1, border="reflect101")
    return h[:, ::2]


def _scharr_local(block, axis_name):
    ext = halo_exchange(block, 1, axis_name, pad_mode="edge")
    gx_full = correlate1d(ext, lk_ops._SCHARR_EDGE, axis=-1,
                          border="replicate")
    gx = None
    for k, wk in enumerate(lk_ops._SCHARR_SMOOTH):
        t = wk * gx_full[k:k + block.shape[0], :]
        gx = t if gx is None else gx + t
    gy_s = correlate1d(ext, lk_ops._SCHARR_SMOOTH, axis=-1,
                       border="replicate")
    gy = (gy_s[2:2 + block.shape[0], :] - gy_s[0:block.shape[0], :]) \
        * np.float32(1.0)
    # vertical edge kernel [-1, 0, 1]: (row+1) - (row-1)
    return gx, gy


def _wsum_local(v, w, axis_name):
    """winsize box sums with halo exchange for the vertical pass."""
    r = w // 2
    ext = halo_exchange(v, r, axis_name, pad_mode="edge")
    acc = None
    for k in range(w):
        t = ext[k:k + v.shape[0], :]
        acc = t if acc is None else acc + t
    hp = jnp.pad(acc, ((0, 0), (r, r)), mode="edge")
    out = None
    for k in range(w):
        t = hp[:, k:k + v.shape[1]]
        out = t if out is None else out + t
    return out


def _warp_local(img_block, flow, axis_name, halo: int):
    """Backward warp with vertical displacement clamped to +-halo rows."""
    ext = halo_exchange(img_block, halo, axis_name, pad_mode="edge")
    hb, wb = img_block.shape
    ys = jnp.arange(hb, dtype=jnp.float32)[:, None] + halo
    xs = jnp.arange(wb, dtype=jnp.float32)[None, :]
    fy = jnp.clip(flow[..., 1], -halo, halo) + ys
    fx = jnp.clip(xs + flow[..., 0], 0.0, wb - 1.0)
    fy = jnp.clip(fy, 0.0, hb + 2 * halo - 1.0)
    x0 = jnp.clip(jnp.floor(fx), 0, wb - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(fy), 0, hb + 2 * halo - 2).astype(jnp.int32)
    ax = fx - x0
    ay = fy - y0
    i00 = ext[y0, x0]
    i01 = ext[y0, x0 + 1]
    i10 = ext[y0 + 1, x0]
    i11 = ext[y0 + 1, x0 + 1]
    return (i00 * (1 - ax) * (1 - ay) + i01 * ax * (1 - ay)
            + i10 * (1 - ax) * ay + i11 * ax * ay)


def _lk_dense_block(a_block, b_block, cfg: FlowConfig, axis_name: str,
                    warp_halo: int):
    """Per-device dense LK on a row band (runs under shard_map)."""
    w = cfg.lk_winsize
    pyr_a = [a_block]
    pyr_b = [b_block]
    for _ in range(cfg.levels - 1):
        pyr_a.append(_pyr_down_local(pyr_a[-1], axis_name))
        pyr_b.append(_pyr_down_local(pyr_b[-1], axis_name))

    flow = None
    for lvl in range(cfg.levels - 1, -1, -1):
        ia, ib = pyr_a[lvl], pyr_b[lvl]
        hb, wb = ia.shape
        if flow is None:
            # mark the zero init as varying over the mesh axis so the
            # fori_loop carry type matches the (device-varying) body output
            flow = lax.pcast(jnp.zeros((hb, wb, 2), jnp.float32),
                             (axis_name,), to="varying")
        else:
            # seam-free x2 upsample: 1-row halo so boundary output rows
            # interpolate across the device split exactly like the global op
            hp = flow.shape[0]
            ext = halo_exchange(flow, 1, axis_name, pad_mode="edge")
            up = resize_linear(ext, 2 * (hp + 2), wb)
            flow = up[2:2 + 2 * hp] * 2.0
        gx, gy = _scharr_local(ia, axis_name)
        gxx, gxy, gyy = gx * gx, gx * gy, gy * gy
        g11 = _wsum_local(gxx, w, axis_name)
        g12 = _wsum_local(gxy, w, axis_name)
        g22 = _wsum_local(gyy, w, axis_name)
        det = g11 * g22 - g12 * g12
        min_eig = ((g11 + g22)
                   - jnp.sqrt((g11 - g22) ** 2 + 4.0 * g12 ** 2)) \
            * 0.5 / (w * w)
        ok = (min_eig > cfg.lk_min_eig) & (det > 1e-12)
        inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)

        def body(_i, fl):
            warped = _warp_local(ib, fl, axis_name, warp_halo)
            diff = warped - ia
            ux, uy = fl[..., 0], fl[..., 1]
            h1 = _wsum_local(gxx * ux + gxy * uy - diff * gx, w, axis_name)
            h2 = _wsum_local(gxy * ux + gyy * uy - diff * gy, w, axis_name)
            nx = (g22 * h1 - g12 * h2) * inv_det
            ny = (g11 * h2 - g12 * h1) * inv_det
            new = jnp.stack([nx, ny], axis=-1)
            return jnp.where(ok[..., None], new, fl)

        flow = lax.fori_loop(0, cfg.lk_max_iter, body, flow)
    return flow


def lk_dense_sharded(prev: np.ndarray, nxt: np.ndarray, cfg: FlowConfig,
                     mesh: Optional[Mesh] = None, axis: str = "space",
                     warp_halo: int = 8) -> np.ndarray:
    """Dense pyramidal LK with frame rows sharded across the mesh.

    H must be divisible by n_devices * 2^(levels-1). Returns (H, W, 2).
    """
    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), (axis,))
    n = mesh.size
    h = prev.shape[0]
    div = n * 2 ** (cfg.levels - 1)
    if h % div != 0:
        raise ValueError(f"H={h} must be divisible by {div} "
                         f"(devices * 2^(levels-1))")
    # single-hop halo exchange: every level's local block must hold the
    # widest halo (window radius / warp clamp). Shard fewer devices, fewer
    # levels, or a smaller window otherwise.
    coarsest_local = h // div
    max_halo = max(cfg.lk_winsize // 2, warp_halo, 2)
    if coarsest_local < max_halo:
        raise ValueError(
            f"coarsest local rows {coarsest_local} < max halo {max_halo}; "
            f"reduce devices/levels or winsize (single-hop halo exchange)")

    fn = jax.shard_map(
        functools.partial(_lk_dense_block, cfg=cfg, axis_name=axis,
                          warp_halo=warp_halo),
        mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P(axis))
    a = jax.device_put(jnp.asarray(prev, jnp.float32),
                       NamedSharding(mesh, P(axis)))
    b = jax.device_put(jnp.asarray(nxt, jnp.float32),
                       NamedSharding(mesh, P(axis)))
    return np.asarray(jax.jit(fn)(a, b))


# ------------------------------------------------- sharded Farneback (fine)

def _damp_traced(row_ids, col_ids, hg: int, wg: int):
    """OpenCV border taper with TRACED global indices (sharded bands)."""
    from ..ops.farneback import _BORDER, _BORDER_SCALE

    def axis_scale(ids, limit):
        dist = jnp.minimum(ids, limit - 1 - ids)
        s = jnp.ones_like(ids, dtype=jnp.float32)
        for d in range(_BORDER):
            s = jnp.where(dist == d, jnp.float32(_BORDER_SCALE[d]), s)
        return s

    return axis_scale(row_ids, hg) * axis_scale(col_ids, wg)


def _update_matrices_band(R0s, R1s, flow_s, row0, hg: int, D: int):
    """Planar update_matrices on a row slab with global border damping.

    R0s/R1s: (5, hs, W) slabs; flow_s: (2, hs, W); row0: traced global row
    of slab row 0. Warp displacement clamped to +-D (select-sum)."""
    from ..ops.farneback import _warp_poly_selectsum_p

    hs, wg = R0s.shape[1], R0s.shape[2]
    R1w = _warp_poly_selectsum_p(R1s, flow_s.astype(R1s.dtype), D)
    R0f = R0s.astype(jnp.float32)
    R1w = R1w.astype(jnp.float32)
    dx = flow_s[0]
    dy = flow_s[1]
    a_xx = (R0f[2] + R1w[2]) * 0.5
    a_yy = (R0f[3] + R1w[3]) * 0.5
    axy = (R0f[4] + R1w[4]) * 0.25
    db_x = (R0f[0] - R1w[0]) * 0.5 + a_xx * dx + axy * dy
    db_y = (R0f[1] - R1w[1]) * 0.5 + axy * dx + a_yy * dy

    row_ids = jax.lax.broadcasted_iota(jnp.int32, (hs, wg), 0) + row0
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (hs, wg), 1)
    damp = _damp_traced(jnp.clip(row_ids, 0, hg - 1), col_ids, hg, wg)
    a_xx = a_xx * damp
    a_yy = a_yy * damp
    axy = axy * damp
    db_x = db_x * damp
    db_y = db_y * damp
    return jnp.stack([a_xx * a_xx + axy * axy,
                      (a_xx + a_yy) * axy,
                      a_yy * a_yy + axy * axy,
                      a_xx * db_x + axy * db_y,
                      axy * db_x + a_yy * db_y], axis=0)


def farneback_sharded(prev: np.ndarray, nxt: np.ndarray, cfg: FlowConfig,
                      mesh: Optional[Mesh] = None,
                      axis: str = "space", as_numpy: bool = True):
    """Farneback with the FINEST level row-sharded across the mesh.

    Strategy (see module docstring design note): cv2's cvRound pyramid
    sizes don't divide evenly past level 0, and coarse levels are <25% of
    the pixels — so every device computes the coarse flow replicated
    (identical work on its full-frame copy), and the expensive level-0
    iterations run on row bands. Polyexp slabs are computed locally from
    the replicated frame (halo recompute, zero collectives); the flow
    halo between iterations moves via `lax.ppermute`; the result is
    returned globally assembled by the sharded out_spec.

    Requires H % n_devices == 0 and fast_warp > 0 (the warp's displacement
    clamp bounds the halo). Matches the single-device op to float noise
    away from the warp clamp. `as_numpy=False` returns the row-sharded
    device array instead of a host copy.
    """
    if cfg.fast_warp <= 0:
        raise ValueError("farneback_sharded requires fast_warp > 0 "
                         "(bounded-halo warp)")
    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), (axis,))
    n = mesh.size
    hg, wg = prev.shape[-2], prev.shape[-1]
    if hg % n != 0:
        raise ValueError(f"H={hg} must divide by {n} devices")
    hb = hg // n
    D = cfg.fast_warp
    MPAD = cfg.winsize // 2                 # box-filter halo
    RPAD = MPAD + D + 1                     # + warp reach + bilinear
    EPAD = RPAD + cfg.poly_n                # + polyexp window (recompute)
    if hb < RPAD:
        raise ValueError(f"band rows {hb} < halo {RPAD}; fewer devices")

    from ..ops.farneback import (farneback_from_pyramids, poly_expansion_p,
                                 polyexp_pyramid, update_flow_p)
    from ..ops.pyramid import gaussian_blur_level

    def block_fn(a_full, b_full):
        d = lax.axis_index(axis)
        row0 = d * hb                        # global row of band start

        # ---- replicated coarse pass (levels >= 1) ----
        Rs_a = polyexp_pyramid(a_full, cfg)
        Rs_b = polyexp_pyramid(b_full, cfg)
        if len(Rs_a) > 1:
            coarse = farneback_from_pyramids(Rs_a[:-1], Rs_b[:-1], cfg)
            flow_full = resize_linear(jnp.moveaxis(coarse, -1, 0), hg, wg) \
                * (1.0 / cfg.pyr_scale)
        else:
            flow_full = jnp.zeros((2, hg, wg), jnp.float32)

        # ---- fine level: local polyexp slab from the replicated frame ----
        # level-0 image = small blur of the original (plan k=0)
        img_a0 = gaussian_blur_level(a_full, cfg)
        img_b0 = gaussian_blur_level(b_full, cfg)
        # pad globally so every slab slice is in-bounds with replicate
        # semantics at the true image borders
        pa = jnp.pad(img_a0, ((EPAD, EPAD), (0, 0)), mode="edge")
        pb = jnp.pad(img_b0, ((EPAD, EPAD), (0, 0)), mode="edge")
        sl_a = lax.dynamic_slice(
            pa, (row0, 0), (hb + 2 * EPAD, wg))     # rows row0-EPAD..+EPAD
        sl_b = lax.dynamic_slice(pb, (row0, 0), (hb + 2 * EPAD, wg))
        n_poly = cfg.poly_n
        dt = jnp.bfloat16 if cfg.bf16_poly else jnp.float32
        # valid rows band +- RPAD
        R0s = poly_expansion_p(sl_a, n_poly, cfg.poly_sigma)[
            :, n_poly:-n_poly, :].astype(dt)
        R1s = poly_expansion_p(sl_b, n_poly, cfg.poly_sigma)[
            :, n_poly:-n_poly, :].astype(dt)

        # initial fine flow slab (replicated source -> slice band +- RPAD)
        fp = jnp.pad(flow_full, ((0, 0), (RPAD, RPAD), (0, 0)), mode="edge")
        flow_s = lax.dynamic_slice(fp, (0, row0, 0),
                                   (2, hb + 2 * RPAD, wg))

        for _ in range(cfg.iterations):
            # row0 - RPAD is the global image row of slab row 0
            Mslab = _update_matrices_band(R0s, R1s, flow_s,
                                          row0 - RPAD, hg, D)
            new_slab = update_flow_p(Mslab, cfg.winsize, cfg.gaussian_win)
            band = new_slab[:, RPAD:RPAD + hb, :]
            # refresh the halo from neighbors for the next iteration
            ext = halo_exchange(jnp.moveaxis(band, 0, 1), RPAD, axis,
                                pad_mode="edge")      # (hb+2R, 2, W)
            flow_s = jnp.moveaxis(ext, 1, 0)
        return jnp.moveaxis(flow_s[:, RPAD:RPAD + hb, :], 0, -1)

    fn = jax.shard_map(block_fn, mesh=mesh, in_specs=(P(), P()),
                       out_specs=P(axis))
    a = jnp.asarray(prev, jnp.float32)
    b = jnp.asarray(nxt, jnp.float32)
    out = jax.jit(fn)(a, b)
    return np.asarray(out) if as_numpy else out
