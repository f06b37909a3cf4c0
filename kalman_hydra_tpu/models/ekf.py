"""Batched (extended) Kalman filter core, pure JAX.

JAX equivalent of the reference's CUDA estimation kernels
(SURVEY.md §2.1 #4): "batched small-matrix ops vmapped over thousands of
tracked points" (BASELINE.json:5). All functions operate on track batches
(K, n) / (K, n, n); einsum contractions with HIGHEST precision keep the
filter float32-stable (no TF32 or bf16 passes; SURVEY.md §7 numerics
policy).

Math contract (SURVEY.md §2.3): predict x=Fx, P=FPF^T+Q; update
y = z - h(x), S = HPH^T + R, K = PH^T S^-1 via closed-form 2x2 Cholesky,
x += Ky, Joseph-form P. Measurement models:

* "position" (linear KF): z = p_prev + flow(p_prev), H = [I2 0].
* "implicit_flow" (EKF/IEKF): the flow field enters the measurement
  function itself. Constraint c(x) = pos(x) - p_prev - flow(pos(x)) = 0,
  linearized at the predicted state: residual y = p_prev + flow(p-) - p-,
  H = (I2 - J_flow(p-)) . [I2 | 0]. The flow Jacobian J makes h nonlinear
  (SURVEY.md §2.3); iekf_iters > 1 re-linearizes at the updated state
  (the reference's IteratedKalmanFilter analog, SURVEY.md §2.1 #2).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import EkfConfig
from ..ops.warp import sample_flow, sample_flow_with_grad
from . import dynamics

_PREC = jax.lax.Precision.HIGHEST


class TrackState(NamedTuple):
    """Filter carry for a fixed-capacity pool of K tracks (static shapes;
    lifecycle is masking, never shape change — SURVEY.md §7)."""

    x: jnp.ndarray         # (K, n) state mean
    P: jnp.ndarray         # (K, n, n) state covariance
    alive: jnp.ndarray     # (K,) bool
    misses: jnp.ndarray    # (K,) int32 consecutive gated frames
    track_id: jnp.ndarray  # (K,) int32 generation id (bumped on re-seed)
    q_scale: jnp.ndarray = None  # (K,) per-track process-noise scale
                                 # (None unless EkfConfig.adaptive_q > 0)


def init_tracks(cfg: EkfConfig, seeds: jnp.ndarray,
                valid: jnp.ndarray = None,
                init_vel: jnp.ndarray = None) -> TrackState:
    """Seed a track pool from (K, 2) positions (+ optional (K, 2) initial
    velocity from a frame-0 flow sample, which removes the dead-reckoning
    convergence transient)."""
    k = seeds.shape[0]
    n = cfg.state_dim
    x = jnp.zeros((k, n), jnp.float32).at[:, 0:2].set(seeds)
    if init_vel is not None:
        x = x.at[:, 2:4].set(init_vel / cfg.dt)
    P0 = jnp.asarray(dynamics.initial_covariance(cfg))
    P = jnp.broadcast_to(P0, (k, n, n))
    alive = jnp.ones(k, bool) if valid is None else valid
    return TrackState(x=x, P=P, alive=alive,
                      misses=jnp.zeros(k, jnp.int32),
                      track_id=jnp.zeros(k, jnp.int32),
                      q_scale=(jnp.ones(k, jnp.float32)
                               if cfg.adaptive_q > 0 else None))


# ----------------------------------------------------------------- predict

def predict(x: jnp.ndarray, P: jnp.ndarray, F: jnp.ndarray, Q: jnp.ndarray,
            q_scale: jnp.ndarray = None):
    """Batched x <- Fx, P <- FPF^T + Q. F, Q are (n, n) constants;
    q_scale optionally scales Q per track (adaptive process noise)."""
    x_p = jnp.einsum("ij,kj->ki", F, x, precision=_PREC)
    FP = jnp.einsum("ij,kjl->kil", F, P, precision=_PREC)
    Qk = Q if q_scale is None else q_scale[:, None, None] * Q
    P_p = jnp.einsum("kil,jl->kij", FP, F, precision=_PREC) + Qk
    return x_p, P_p


def adapt_q(q_scale: jnp.ndarray, nis: jnp.ndarray, mask: jnp.ndarray,
            cfg) -> jnp.ndarray:
    """Mehra-style innovation-based process-noise adaptation, shared by
    every measurement channel (flow EKF, sparse-LK KF, photometric):
    E[NIS] = 2 for a consistent 2-dof filter, so inflate Q when
    innovations run hot and relax when cold, bounded to [0.1, 10] x the
    configured Q. `mask` selects the tracks whose NIS is trustworthy this
    frame (alive, and measurement-valid where the channel has a validity
    gate)."""
    qs = q_scale * (1.0 + cfg.adaptive_q * (nis * 0.5 - 1.0))
    return jnp.where(mask, jnp.clip(qs, 0.1, 10.0), q_scale)


# ------------------------------------------------------------------ update

def _chol2x2(S: jnp.ndarray):
    """Batched 2x2 Cholesky factors (l11, l21, l22) of (K, 2, 2) S."""
    s11 = jnp.maximum(S[:, 0, 0], 1e-12)
    l11 = jnp.sqrt(s11)
    l21 = S[:, 1, 0] / l11
    l22 = jnp.sqrt(jnp.maximum(S[:, 1, 1] - l21 * l21, 1e-12))
    return l11, l21, l22


def _solve2x2_chol(l11, l21, l22, b: jnp.ndarray) -> jnp.ndarray:
    """Solve S z = b for batched 2-vectors given Cholesky of S."""
    # forward: L w = b
    w1 = b[:, 0] / l11
    w2 = (b[:, 1] - l21 * w1) / l22
    # backward: L^T z = w
    z2 = w2 / l22
    z1 = (w1 - l21 * z2) / l11
    return jnp.stack([z1, z2], axis=-1)


def update(x: jnp.ndarray, P: jnp.ndarray, y: jnp.ndarray, H: jnp.ndarray,
           R: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched measurement update from precomputed residual y = z - h(x).

    x (K, n), P (K, n, n), y (K, 2), H (K, 2, n) or (2, n), R (2, 2) or
    per-track (K, 2, 2) (the photometric channel's Gauss-Newton
    covariance). Returns (x_post, P_post, nis).
    """
    if H.ndim == 2:
        H = jnp.broadcast_to(H, (x.shape[0],) + H.shape)
    PHt = jnp.einsum("kij,kmj->kim", P, H, precision=_PREC)       # (K, n, 2)
    S = jnp.einsum("kli,kim->klm", H, PHt, precision=_PREC) + R   # (K, 2, 2)
    l11, l21, l22 = _chol2x2(S)
    alpha = _solve2x2_chol(l11, l21, l22, y)                      # S^-1 y
    nis = jnp.sum(y * alpha, axis=-1)
    Kg = _gain(l11, l21, l22, PHt)                                # (K, n, 2)
    x_post = x + jnp.einsum("kim,km->ki", Kg, y, precision=_PREC)
    n = x.shape[1]
    I = jnp.eye(n, dtype=x.dtype)
    IKH = I - jnp.einsum("kim,kmj->kij", Kg, H, precision=_PREC)
    if R.ndim == 3:
        KRKt = jnp.einsum("kim,kmn,kjn->kij", Kg, R, Kg, precision=_PREC)
    else:
        KRKt = jnp.einsum("kim,mn,kjn->kij", Kg, R, Kg, precision=_PREC)
    P_post = (jnp.einsum("kij,kjl->kil",
                         jnp.einsum("kij,kjl->kil", IKH, P, precision=_PREC),
                         jnp.swapaxes(IKH, 1, 2), precision=_PREC)
              + KRKt)
    return x_post, P_post, nis


def _gain(l11, l21, l22, PHt: jnp.ndarray) -> jnp.ndarray:
    """K = PH^T S^-1 for batched (K, n, 2) PH^T via per-row 2x2 solves."""
    def row_solve(phr):  # (K, 2) one row of PH^T across batch
        return _solve2x2_chol(l11, l21, l22, phr)
    return jnp.stack([row_solve(PHt[:, i, :])
                      for i in range(PHt.shape[1])], axis=1)


# ----------------------------------------------------- measurement models

def measure_position(flow: jnp.ndarray, x_prev: jnp.ndarray,
                     x_pred: jnp.ndarray, cfg: EkfConfig):
    """Linear KF measurement: z = p_prev + flow(p_prev).

    Returns (y, H) with y = z - H x_pred."""
    p_prev = x_prev[:, 0:2]
    disp = sample_flow(flow, p_prev)
    z = p_prev + disp
    H = jnp.asarray(dynamics.position_H(cfg))
    y = z - x_pred[:, 0:2]
    return y, H


def measure_implicit_flow(flow: jnp.ndarray, x_prev: jnp.ndarray,
                          x_lin: jnp.ndarray, cfg: EkfConfig):
    """EKF measurement linearized at x_lin (predicted or IEKF iterate).

    Constraint c(x) = pos(x) - p_prev - flow(pos(x)); residual is
    -c(x_lin) expressed as y = p_prev + flow(p-) - p-; Jacobian
    H = (I2 - J_flow) [I2 | 0] (SURVEY.md §2.3)."""
    p_prev = x_prev[:, 0:2]
    p_lin = x_lin[:, 0:2]
    disp, jac = sample_flow_with_grad(flow, p_lin)
    y = p_prev + disp - p_lin
    I2 = jnp.eye(2, dtype=jnp.float32)
    A = I2 - jac                                   # (K, 2, 2)
    Hpos = jnp.asarray(dynamics.position_H(cfg))   # (2, n)
    H = jnp.einsum("kij,jn->kin", A, Hpos, precision=_PREC)
    return y, H


def ekf_step(state: TrackState, flow: jnp.ndarray, cfg: EkfConfig,
             F: jnp.ndarray, Q: jnp.ndarray, R: jnp.ndarray):
    """One frame: predict + (I)EKF update for all K tracks.

    Dead tracks still predict (freeze handled by caller masks). Returns
    (state', aux) where aux carries (x_pred, P_pred, nis) for smoothing
    and gating.
    """
    x_prev = state.x
    x_pred, P_pred = predict(state.x, state.P, F, Q, q_scale=state.q_scale)

    if cfg.measurement == "position":
        y, H = measure_position(flow, x_prev, x_pred, cfg)
        x_new, P_new, nis = update(x_pred, P_pred, y, H, R)
    elif cfg.filter_type == "ukf":
        from .ukf import ukf_update
        x_new, P_new, nis = ukf_update(x_pred, P_pred, flow,
                                       x_prev[:, 0:2], cfg.r, cfg)
    else:
        x_lin = x_pred
        x_new, P_new, nis = x_pred, P_pred, jnp.zeros(x_pred.shape[0])
        for _ in range(max(cfg.iekf_iters, 1)):
            y, H = measure_implicit_flow(flow, x_prev, x_lin, cfg)
            # IEKF correction: residual relinearized about x_lin includes
            # the (x_pred - x_lin) pushforward
            y_adj = y + jnp.einsum("kin,kn->ki", H, x_lin - x_pred,
                                   precision=_PREC)
            x_new, P_new, nis = update(x_pred, P_pred, y_adj, H, R)
            x_lin = x_new
    return commit_update(state, x_pred, P_pred, x_new, P_new, nis, cfg)


def commit_update(state: TrackState, x_pred, P_pred, x_new, P_new, nis,
                  cfg: EkfConfig, valid=None):
    """Masked commit shared by EVERY measurement channel (flow EKF,
    sparse LK, photometric): live (= alive & valid) tracks take the
    update; everything else keeps the prediction.

    A LIVE track whose measurement is INVALID (LK status false,
    low-texture photometric patch) reports nis = gate_chi2 + 1 so the
    lifecycle gate counts it as a miss — an invalid measurement IS a
    missed measurement. (It used to report nis = 0, which RESET the miss
    counter every frame: a permanently occluded lk_sparse/photometric
    track coasted at the constant-velocity extrapolation forever and
    never freed its pool slot.) Dead slots report nis = 0.
    """
    live = state.alive if valid is None else (state.alive & valid)
    m = live[:, None]
    miss_nis = jnp.float32(cfg.gate_chi2) + 1.0
    nis = jnp.where(live, nis, jnp.where(state.alive, miss_nis, 0.0))
    new_state = state._replace(x=jnp.where(m, x_new, x_pred),
                               P=jnp.where(m[..., None], P_new, P_pred))
    if cfg.adaptive_q > 0 and state.q_scale is not None:
        new_state = new_state._replace(
            q_scale=adapt_q(state.q_scale, nis, live, cfg))
    return new_state, {"x_pred": x_pred, "P_pred": P_pred, "nis": nis}
