"""The XLA ops against independent references at the shapes and
parameters the accelerator path runs: OpenCV calls, NumPy restatements of
OpenCV's Farneback update (float64), and the NumPy filter oracle
(ref/ekf.py). Odd sizes exercise every border and resize rounding rule.
"""

import numpy as np
import cv2
import jax
import jax.numpy as jnp
import pytest

from kalman_hydra_tpu.config import EkfConfig, FlowConfig
from kalman_hydra_tpu.io.synthetic import translating_pair
from kalman_hydra_tpu.models import dynamics as dyn
from kalman_hydra_tpu.models import ekf as jekf
from kalman_hydra_tpu.ops import farneback as FB
from kalman_hydra_tpu.ops import lk as L
from kalman_hydra_tpu.ops import pyramid as P
from kalman_hydra_tpu.ref import ekf as ref_ekf
from kalman_hydra_tpu.ref import imgproc as ip

_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472])


# ------------------------------------------------------------ NumPy oracle

def np_polyexp(img: np.ndarray, n: int, sigma: float) -> np.ndarray:
    """Weighted least-squares quadratic fit per pixel (float64, replicate
    border): (5, H, W) planes [b_x, b_y, a_xx, a_yy, a_xy(full)]."""
    i = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(i * i) / (2.0 * sigma * sigma))
    g /= g.sum()
    dy, dx = np.meshgrid(i, i, indexing="ij")
    w = np.outer(g, g).ravel()
    B = np.stack([np.ones_like(dx), dx, dy, dx * dx, dy * dy, dx * dy],
                 -1).reshape(-1, 6)
    proj = np.linalg.solve(B.T @ (w[:, None] * B), (B * w[:, None]).T)
    pad = np.pad(img.astype(np.float64), n, mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(pad, (2 * n + 1,) * 2)
    c = win.reshape(img.shape + (-1,)) @ proj.T           # (H, W, 6)
    return np.moveaxis(c[..., 1:], -1, 0)


def np_damp(h: int, w: int) -> np.ndarray:
    def axis(n):
        s = np.ones(n)
        b = min(5, n)
        s[:b] *= _BORDER_SCALE[:b]
        s[n - b:] *= _BORDER_SCALE[:b][::-1]
        return s
    return axis(h)[:, None] * axis(w)[None, :]


def np_warp(R: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Clamped bilinear warp of (C, H, W) planes by (2, H, W) flow."""
    _, h, w = R.shape
    fx = np.clip(np.arange(w)[None, :] + flow[0], 0, w - 1)
    fy = np.clip(np.arange(h)[:, None] + flow[1], 0, h - 1)
    x0 = np.clip(np.floor(fx), 0, w - 2).astype(int)
    y0 = np.clip(np.floor(fy), 0, h - 2).astype(int)
    ax, ay = fx - x0, fy - y0
    return (R[:, y0, x0] * (1 - ax) * (1 - ay) + R[:, y0, x0 + 1] * ax
            * (1 - ay) + R[:, y0 + 1, x0] * (1 - ax) * ay
            + R[:, y0 + 1, x0 + 1] * ax * ay)


def np_iteration(R0, R1, flow, win: int, gaussian: bool) -> np.ndarray:
    """One Farneback update (OpenCV FarnebackUpdateMatrices +
    FarnebackUpdateFlow_Blur/_GaussianBlur) in float64 with an exact
    bilinear warp: (5,H,W) x2 + (2,H,W) -> new absolute flow (2,H,W)."""
    R0 = R0.astype(np.float64)
    R1w = np_warp(R1.astype(np.float64), flow.astype(np.float64))
    dx, dy = flow[0].astype(np.float64), flow[1].astype(np.float64)
    a_xx = (R0[2] + R1w[2]) * 0.5
    a_yy = (R0[3] + R1w[3]) * 0.5
    axy = (R0[4] + R1w[4]) * 0.25
    db_x = (R0[0] - R1w[0]) * 0.5 + a_xx * dx + axy * dy
    db_y = (R0[1] - R1w[1]) * 0.5 + axy * dx + a_yy * dy
    d = np_damp(*R0.shape[1:])
    a_xx, a_yy, axy, db_x, db_y = (v * d for v in (a_xx, a_yy, axy, db_x,
                                                   db_y))
    M = [a_xx * a_xx + axy * axy, (a_xx + a_yy) * axy,
         a_yy * a_yy + axy * axy, a_xx * db_x + axy * db_y,
         axy * db_x + a_yy * db_y]
    if gaussian:
        m = win // 2
        k = cv2.getGaussianKernel(2 * m + 1, m * 0.3, cv2.CV_64F)
        S = [cv2.sepFilter2D(p, cv2.CV_64F, k, k,
                             borderType=cv2.BORDER_REPLICATE) for p in M]
    else:
        S = [cv2.blur(p, (win, win), borderType=cv2.BORDER_REPLICATE)
             for p in M]
    g11, g12, g22, h1, h2 = S
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return np.stack([(g22 * h1 - g12 * h2) * idet,
                     (g11 * h2 - g12 * h1) * idet])


def np_level_images(img: np.ndarray, levels: int, scale: float) -> list:
    """OpenCV's Farneback level images (GaussianBlur of the ORIGINAL +
    INTER_LINEAR resize, min_size 32 clamp), coarsest first."""
    h, w = img.shape
    k, s = 0, 1.0
    while k < levels:
        s *= scale
        if w * s < 32 or h * s < 32:
            break
        k += 1
    out = []
    for kk in range(k, -1, -1):
        s = scale ** kk
        sigma = (1.0 / s - 1.0) * 0.5
        # cvRound rounds half to even, as np.rint does
        ksize = max(int(np.rint(sigma * 5)) | 1, 3)
        blur = cv2.GaussianBlur(img, (ksize, ksize), sigma, sigma,
                                borderType=cv2.BORDER_REFLECT_101)
        size = (int(np.rint(w * s)), int(np.rint(h * s)))
        out.append(cv2.resize(blur, size, interpolation=cv2.INTER_LINEAR))
    return out


def _planes(h, w, seed=0, shift=(1.5, -1.0)):
    """Realistic polyexp planes of a textured frame pair + a smooth flow
    field near the true motion (well-conditioned normal equations)."""
    a, b, _ = translating_pair(height=h, width=w, shift=shift, seed=seed)
    R0 = np_polyexp(a, 5, 1.1).astype(np.float32)
    R1 = np_polyexp(b, 5, 1.1).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    flow = np.stack([shift[0] + 0.5 * np.sin(xx / 9.0),
                     shift[1] + 0.5 * np.cos(yy / 7.0)]).astype(np.float32)
    return R0, R1, flow


def _xla_iteration(R0, R1, flow, win, gaussian, fast_warp=0):
    M = FB.update_matrices_p(jnp.asarray(R0), jnp.asarray(R1),
                             jnp.asarray(flow), fast_warp=fast_warp)
    return np.asarray(FB.update_flow_p(M, win, gaussian), np.float64)


def _rel_err(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)


# ------------------------------------------------------- pyramid / Scharr

@pytest.mark.parametrize("shape", [(64, 96), (37, 53), (257, 129)])
def test_pyr_down_matches_cv2_odd_shapes(shape, rng):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    ref = cv2.pyrDown(img)
    got = np.asarray(P.pyr_down(jnp.asarray(img)))
    assert got.shape == ref.shape
    assert np.abs(ref - got).max() < 1e-3


@pytest.mark.parametrize("shape", [(64, 96), (37, 53), (270, 480)])
def test_scharr_matches_cv2(shape, rng):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    rx = cv2.Scharr(img, cv2.CV_32F, 1, 0,
                    borderType=cv2.BORDER_REPLICATE) / 32.0
    ry = cv2.Scharr(img, cv2.CV_32F, 0, 1,
                    borderType=cv2.BORDER_REPLICATE) / 32.0
    gx, gy = L.scharr_gradients(jnp.asarray(img))
    assert np.abs(np.asarray(gx) - rx).max() < 1e-3
    assert np.abs(np.asarray(gy) - ry).max() < 1e-3


def test_lk_pyramid_matches_cv2(rng):
    """Every level of the LK pyramid (pyrDown chain) and its Scharr
    gradients against OpenCV."""
    img = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    pyr, grads = L.lk_pyramid(jnp.asarray(img), FlowConfig(levels=3))
    ref = ip.build_pyramid(img, 3)
    assert len(pyr) == len(ref) == len(grads)
    for p, r, (gx, gy) in zip(pyr, ref, grads):
        assert np.abs(np.asarray(p) - r).max() < 1e-3
        rx = cv2.Scharr(r, cv2.CV_32F, 1, 0,
                        borderType=cv2.BORDER_REPLICATE) / 32.0
        ry = cv2.Scharr(r, cv2.CV_32F, 0, 1,
                        borderType=cv2.BORDER_REPLICATE) / 32.0
        assert np.abs(np.asarray(gx) - rx).max() < 1e-2
        assert np.abs(np.asarray(gy) - ry).max() < 1e-2


@pytest.mark.parametrize("shape,levels,scale",
                         [((96, 128), 3, 0.5), ((37, 53), 2, 0.5),
                          ((128, 128), 4, 0.5),  # levels_eff clamps to 2
                          ((128, 96), 3, 0.75),   # non-dyadic pyr_scale
                          ((100, 100), 2, 0.6)])
def test_level_images_match_cv2(shape, levels, scale, rng):
    """Farneback level images (blur + cvRound-size resize, from the
    original image) vs OpenCV, every level incl. non-dyadic scales."""
    img = rng.uniform(0, 255, shape).astype(np.float32)
    ref = np_level_images(img, levels, scale)
    got = P.farneback_images(jnp.asarray(img), levels, scale)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        assert np.abs(r - np.asarray(g)).max() < 1e-2


# --------------------------------------------------- polynomial expansion

@pytest.mark.parametrize("pn,ps", [(5, 1.1), (7, 1.5)])
def test_polyexp_matches_lsq_oracle(pn, ps, rng):
    img = rng.uniform(0, 255, (50, 65)).astype(np.float32)
    ref = np_polyexp(img, pn, ps)
    got = np.asarray(FB.poly_expansion_p(jnp.asarray(img), pn, ps))
    assert np.abs(got - ref).max() < 1e-3


def test_polyexp_pyramid_coarse_levels_match_oracle():
    """Every level of polyexp_pyramid = the LSQ oracle on OpenCV's level
    image for that level."""
    a, _, _ = translating_pair(height=150, width=200)
    cfg = FlowConfig(levels=3)
    got = FB.polyexp_pyramid(jnp.asarray(a), cfg)
    imgs = np_level_images(a.astype(np.float32), cfg.levels, cfg.pyr_scale)
    assert len(got) == len(imgs)
    for g, img in zip(got, imgs):
        ref = np_polyexp(img, cfg.poly_n, cfg.poly_sigma)
        assert np.abs(np.asarray(g) - ref).max() < 2e-2


# --------------------------------------------------- Farneback iteration

@pytest.mark.parametrize("gaussian", [False, True])
def test_update_flow_matches_cv2_smoothing(gaussian, rng):
    """Window smoothing of the normal equations (cv2.blur / separable
    Gaussian, replicate border) + the 2x2 solve."""
    M = rng.normal(size=(5, 48, 70)).astype(np.float32)
    M[0] = np.abs(M[0]) + 1.0
    M[2] = np.abs(M[2]) + 1.0
    got = np.asarray(FB.update_flow_p(jnp.asarray(M), 15, gaussian))
    m = 7
    if gaussian:
        k = cv2.getGaussianKernel(2 * m + 1, m * 0.3, cv2.CV_64F)
        S = [cv2.sepFilter2D(p.astype(np.float64), cv2.CV_64F, k, k,
                             borderType=cv2.BORDER_REPLICATE) for p in M]
    else:
        S = [cv2.blur(p.astype(np.float64), (15, 15),
                      borderType=cv2.BORDER_REPLICATE) for p in M]
    g11, g12, g22, h1, h2 = S
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    ref = np.stack([(g22 * h1 - g12 * h2) * idet,
                    (g11 * h2 - g12 * h1) * idet])
    assert _rel_err(got, ref) < 1e-4


@pytest.mark.parametrize("win,gaussian", [(15, False), (13, False),
                                          (15, True)])
def test_iteration_matches_numpy_oracle(win, gaussian):
    """Exact-warp iteration (warp + normal equations + border damping +
    window smoothing + solve) vs the float64 NumPy restatement."""
    R0, R1, flow = _planes(70, 90)
    got = _xla_iteration(R0, R1, flow, win, gaussian)
    ref = np_iteration(R0, R1, flow, win, gaussian)
    assert np.abs(got - ref).max() < 1e-3


@pytest.mark.parametrize("disp", [(3.2, -1.7), (-4.5, 2.25), (0.0, 7.5)])
def test_selectsum_warp_exact_for_uniform_flow(disp):
    """The select-sum warp is exact when every pixel moves alike (its
    horizontal pass reuses neighbours' vertical lerp)."""
    R0, R1, _ = _planes(64, 80)
    flow = np.broadcast_to(np.asarray(disp, np.float32)[:, None, None],
                           (2, 64, 80)).copy()
    got = np.asarray(FB._warp_poly_selectsum_p(jnp.asarray(R1),
                                               jnp.asarray(flow), 8))
    assert np.abs(got - np_warp(R1, flow)).max() < 1e-3


def test_selectsum_warp_clamps_displacement():
    """Displacements beyond +-fast_warp are clamped before warping."""
    _, R1, _ = _planes(64, 80)
    flow = np.broadcast_to(np.asarray([11.3, -9.6], np.float32)[:, None,
                                                                None],
                           (2, 64, 80)).copy()
    got = np.asarray(FB._warp_poly_selectsum_p(jnp.asarray(R1),
                                               jnp.asarray(flow), 4))
    want = np_warp(R1, np.clip(flow, -4, 4))
    assert np.abs(got - want).max() < 1e-3


@pytest.mark.parametrize("iters,gaussian,fast_warp,bf16", [
    (3, False, 0, False),
    (3, False, 8, False),
    (2, True, 0, False),
    (3, False, 8, True),
])
def test_iterations_match_numpy_oracle(iters, gaussian, fast_warp, bf16):
    """Several iterations at one level (the fine-level loop): XLA in f32
    (or bf16 planes) vs the float64 oracle with an exact warp. The
    select-sum warp differs from the exact one only where the flow's
    vertical part varies between neighbouring columns (a smooth field
    here), bf16 storage by its rounding."""
    R0, R1, flow = _planes(72, 96)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    got = jnp.asarray(flow)
    ref = flow.astype(np.float64)
    for _ in range(iters):
        M = FB.update_matrices_p(jnp.asarray(R0).astype(dt),
                                 jnp.asarray(R1).astype(dt), got,
                                 fast_warp=fast_warp)
        got = FB.update_flow_p(M, 15, gaussian)
        ref = np_iteration(R0, R1, ref, 15, gaussian)
    err = np.abs(np.asarray(got) - ref)[:, 8:-8, 8:-8]
    assert err.mean() < (0.02 if bf16 else 2e-3)
    assert err.max() < (0.5 if bf16 else 0.05)


@pytest.mark.parametrize("win,gaussian,iters", [(15, False, 3),
                                                (15, True, 2),
                                                (13, False, 1)])
def test_coarse_level_iterations_odd_shape(win, gaussian, iters):
    """Odd coarse-level shape (67x91): every iteration's border damping
    and replicate smoothing against the oracle."""
    R0, R1, flow = _planes(67, 91, seed=2)
    got, ref = flow, flow.astype(np.float64)
    for _ in range(iters):
        got = _xla_iteration(R0, R1, got.astype(np.float32), win, gaussian)
        ref = np_iteration(R0, R1, ref, win, gaussian)
    assert np.abs(got - ref).max() < 5e-3


def test_bf16_planes_track_f32_oracle():
    """bf16-stored planes: storage-only precision loss against the f32
    oracle on the same inputs."""
    R0, R1, flow = _planes(70, 90)
    M = FB.update_matrices_p(jnp.asarray(R0).astype(jnp.bfloat16),
                             jnp.asarray(R1).astype(jnp.bfloat16),
                             jnp.asarray(flow))
    got = np.asarray(FB.update_flow_p(M, 15, False))
    ref = np_iteration(R0, R1, flow, 15, False)
    err = np.abs(got - ref)[:, 8:-8, 8:-8]
    assert err.mean() < 0.02


def test_bf16_coarse_level_iterations():
    R0, R1, flow = _planes(48, 80, seed=4)
    got = jnp.asarray(flow)
    ref = flow.astype(np.float64)
    for _ in range(2):
        M = FB.update_matrices_p(jnp.asarray(R0).astype(jnp.bfloat16),
                                 jnp.asarray(R1).astype(jnp.bfloat16), got,
                                 fast_warp=8)
        got = FB.update_flow_p(M, 15, False)
        ref = np_iteration(R0, R1, ref, 15, False)
    assert np.abs(np.asarray(got) - ref)[:, 6:-6, 6:-6].mean() < 0.02


def test_band_update_matches_full_image_rows():
    """Row-band normal equations (the sharded fine level) with the band's
    global row offset reproduce the full-image rows."""
    from kalman_hydra_tpu.parallel.spatial import _update_matrices_band
    R0, R1, flow = _planes(96, 90)
    full = np.asarray(FB.update_matrices_p(jnp.asarray(R0), jnp.asarray(R1),
                                           jnp.asarray(flow), fast_warp=8))
    r0, r1 = 20, 70
    band = np.asarray(_update_matrices_band(
        jnp.asarray(R0[:, r0:r1]), jnp.asarray(R1[:, r0:r1]),
        jnp.asarray(flow[:, r0:r1]), r0, 96, 8))
    # rows whose +-8 px warp reach stays inside the band are exact
    assert np.abs(band[:, 9:-9] - full[:, r0 + 9:r1 - 9]).max() < 1e-4


# ------------------------------------------------ whole Farneback vs cv2

@pytest.mark.parametrize("bf16,fast_warp", [(False, 0), (True, 8),
                                            (True, 0)])
def test_farneback_96px_matches_cv2(bf16, fast_warp):
    a, b, _ = translating_pair(height=96, width=96, shift=(2.0, -1.0))
    a8, b8 = np.round(a).astype(np.uint8), np.round(b).astype(np.uint8)
    cfg = FlowConfig(levels=2, bf16_poly=bf16, fast_warp=fast_warp)
    got = np.asarray(jax.jit(lambda x, y: FB.farneback(x, y, cfg))(
        jnp.asarray(a8, jnp.float32), jnp.asarray(b8, jnp.float32)))
    ref = ip.farneback(a8, b8, cfg)
    epe = np.linalg.norm(got - ref, axis=-1)
    assert epe[8:-8, 8:-8].mean() < (0.05 if bf16 else 0.01)
    assert epe.max() < 0.5


# ------------------------------------------------------------ sparse LK

def test_lk_sparse_grid_matches_cv2():
    a, b, _ = translating_pair(height=96, width=96, shift=(2.0, -1.5),
                               seed=0)
    pts = np.stack(np.meshgrid(np.arange(24, 73, 12),
                               np.arange(24, 73, 12)), -1)
    pts = pts.reshape(-1, 2).astype(np.float32)
    cfg = FlowConfig(levels=3)
    rp, rs = ip.lk_sparse(a, b, pts, cfg)
    gp, gs = L.lk_sparse(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts),
                         cfg)
    gp, gs = np.asarray(gp), np.asarray(gs)
    assert (rs.astype(bool) == gs).all()
    m = rs.astype(bool) & gs
    assert np.abs(gp[m] - rp[m]).max() < 0.02


def test_lk_sparse_border_points_match_cv2():
    """Points hugging the image border: status and positions vs cv2."""
    a, b, _ = translating_pair(height=96, width=96, shift=(2.0, -1.5),
                               seed=2)
    pts = np.array([[1.0, 1.0], [94.0, 1.0], [1.0, 94.0], [94.0, 94.0],
                    [0.0, 48.0], [95.0, 48.0], [48.0, 0.3], [47.7, 95.0],
                    [48.0, 48.0]], np.float32)
    cfg = FlowConfig(levels=2)
    rp, rs = ip.lk_sparse(a, b, pts, cfg)
    gp, gs = L.lk_sparse(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts),
                         cfg)
    gp, gs = np.asarray(gp), np.asarray(gs)
    # the interior point tracks exactly as cv2 does; at the border the
    # two clamp their patches differently, so only sanity is required
    assert rs[-1] and gs[-1]
    assert np.abs(gp[-1] - rp[-1]).max() < 0.02
    assert np.isfinite(gp).all()
    assert ((gp[gs] > -2.0) & (gp[gs] < 98.0)).all()


# --------------------------------------------------------------- EKF

def _ekf_case(rng, K, n, per_track_H=False):
    cfg = EkfConfig(state_dim=n)
    F, Q = dyn.transition(cfg), dyn.process_noise(cfg)
    R = (cfg.r * np.eye(2)).astype(np.float32)
    x = rng.normal(size=(K, n)).astype(np.float32)
    P = np.broadcast_to(np.eye(n, dtype=np.float32) * 3, (K, n, n)).copy()
    if per_track_H:
        H = rng.normal(size=(K, 2, n)).astype(np.float32) * 0.3
        H[:, 0, 0] += 1.0
        H[:, 1, 1] += 1.0
    else:
        H = np.broadcast_to(dyn.position_H(cfg), (K, 2, n)).copy()
    z = rng.normal(size=(K, 2)).astype(np.float32) * 3
    xp, Pp = jekf.predict(jnp.asarray(x), jnp.asarray(P), jnp.asarray(F),
                          jnp.asarray(Q))
    y = jnp.einsum("kin,kn->ki", jnp.asarray(H), xp)
    y = jnp.asarray(z) - y
    xg, Pg, ng = jekf.update(xp, Pp, y, jnp.asarray(H), jnp.asarray(R))
    f64 = lambda a: np.asarray(a, np.float64)   # noqa: E731
    for k in range(K):
        xpk, Ppk = ref_ekf.predict(f64(x[k]), f64(P[k]), f64(F), f64(Q))
        xr, Pr, nr = ref_ekf.update(xpk, Ppk, f64(z[k]), f64(H[k]), f64(R))
        assert np.abs(np.asarray(xg[k]) - xr).max() < 1e-3
        assert np.abs(np.asarray(Pg[k]) - Pr).max() < 1e-3
        assert abs(float(ng[k]) - nr) < 1e-3 * (1 + nr)


@pytest.mark.parametrize("state_dim", [4, 6])
def test_ekf_batch_matches_numpy_oracle(state_dim, rng):
    _ekf_case(rng, 200, state_dim)


@pytest.mark.parametrize("K", [600, 700])
def test_ekf_large_batch_matches_numpy_oracle(K, rng):
    """Track counts past 512 that no power of two divides: every track
    of the batch is updated."""
    _ekf_case(rng, K, 4)


def test_ekf_per_track_H_matches_numpy_oracle(rng):
    """Implicit-flow EKF linearizations give every track its own H."""
    _ekf_case(rng, 130, 4, per_track_H=True)
