"""Unscented Kalman update for the flow measurement channel.

Widened filter zoo next to models/ekf.py (the reference carried KF +
iterated EKF — SURVEY.md §2.1 #2; the UKF is the standard third member):
instead of linearizing the flow-sampling measurement h(x) = pos(x) -
flow(pos(x)) with a central-difference Jacobian, propagate 2n+1 sigma
points through the actual sampler. Per track that is 2n+1 bilinear flow
samples — a tiny (K*(2n+1), 2) gather, vmap/batch friendly.

Selectable via EkfConfig.filter_type = "ukf" (measurement models
"implicit_flow"/"flow_photometric"; "position" is linear so the UKF
reduces to the KF and is not routed here).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import EkfConfig
from ..ops.warp import sample_flow

_PREC = jax.lax.Precision.HIGHEST


def _sigma_points(x: jnp.ndarray, P: jnp.ndarray, lam: float):
    """Batched sigma points: (K, 2n+1, n) and the (2n+1,) weights."""
    K, n = x.shape
    # sqrt((n+lam) P) via batched Cholesky (P is SPD by Joseph updates)
    L = jnp.linalg.cholesky((n + lam) * P)          # (K, n, n), lower
    cols = jnp.swapaxes(L, 1, 2)                    # rows = scaled columns
    chi = jnp.concatenate([x[:, None, :],
                           x[:, None, :] + cols,
                           x[:, None, :] - cols], axis=1)  # (K, 2n+1, n)
    wm = jnp.full(2 * n + 1, 1.0 / (2.0 * (n + lam)))
    wm = wm.at[0].set(lam / (n + lam))
    return chi, wm


def ukf_update(x_pred: jnp.ndarray, P_pred: jnp.ndarray,
               flow: jnp.ndarray, p_prev: jnp.ndarray, r: float,
               cfg: EkfConfig
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Unscented update of (K, n) states against the dense flow field.

    Measurement model: h(x) = pos(x) - flow(pos(x)), observed z = p_prev
    (the implicit-flow constraint of models/ekf.py, un-linearized).
    Returns (x_post, P_post, nis).
    """
    K, n = x_pred.shape
    lam = cfg.ukf_alpha ** 2 * (n + cfg.ukf_kappa) - n
    chi, wm = _sigma_points(x_pred, P_pred, lam)
    wc = wm.at[0].add(1.0 - cfg.ukf_alpha ** 2 + cfg.ukf_beta)

    pos = chi[..., 0:2].reshape(-1, 2)              # (K*(2n+1), 2)
    fl = sample_flow(flow, pos).reshape(K, -1, 2)
    Z = chi[..., 0:2] - fl                          # (K, 2n+1, 2)

    z_mean = jnp.einsum("s,ksm->km", wm, Z, precision=_PREC)
    dZ = Z - z_mean[:, None, :]
    dX = chi - jnp.einsum("s,ksn->kn", wm, chi,
                          precision=_PREC)[:, None, :]
    S = jnp.einsum("s,ksi,ksj->kij", wc, dZ, dZ, precision=_PREC) \
        + r * jnp.eye(2, dtype=jnp.float32)
    C = jnp.einsum("s,ksn,ksm->knm", wc, dX, dZ, precision=_PREC)

    from .ekf import _chol2x2, _solve2x2_chol, _gain
    l11, l21, l22 = _chol2x2(S)
    y = p_prev - z_mean                              # innovation
    alpha = _solve2x2_chol(l11, l21, l22, y)
    nis = jnp.sum(y * alpha, axis=-1)
    Kg = _gain(l11, l21, l22, C)                     # (K, n, 2)
    x_post = x_pred + jnp.einsum("knm,km->kn", Kg, y, precision=_PREC)
    KS = jnp.einsum("knm,kml->knl", Kg, S, precision=_PREC)
    P_post = P_pred - jnp.einsum("knl,kjl->knj", KS, Kg, precision=_PREC)
    P_post = 0.5 * (P_post + jnp.swapaxes(P_post, 1, 2))
    return x_post, P_post, nis
