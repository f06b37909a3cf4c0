"""Debug / sanitizer hooks (SURVEY.md §5 "race detection / sanitizers").

JAX is functional and this package writes no hand-made kernels, so there
are no data races to sanitize. This module adds the numeric sanitizers: a NaN-trapping context and a
checkify'd EKF update that turns non-finite innovations / non-PSD
innovation covariances into reported errors instead of silent garbage.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
from jax.experimental import checkify


@contextlib.contextmanager
def debug_checks():
    """Enable jax_debug_nans for the enclosed region (trap NaNs at the op
    that produced them; reruns the op un-jitted for a precise traceback)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def checked_update(x, P, y, H, R):
    """models.ekf.update wrapped with checkify: errors on non-finite
    residuals and non-PSD innovation covariance (catches the failure modes
    SURVEY.md §5 lists for the EKF). Returns (err, (x, P, nis)); call
    err.throw() to raise."""
    from ..models.ekf import update

    def guarded(x, P, y, H, R):
        checkify.check(jnp.all(jnp.isfinite(y)),
                       "non-finite innovation residual")
        Hb = H if H.ndim == 3 else jnp.broadcast_to(
            H, (x.shape[0],) + H.shape)
        PHt = jnp.einsum("kij,kmj->kim", P, Hb)
        S = jnp.einsum("kli,kim->klm", Hb, PHt) + R
        det = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
        checkify.check(jnp.all(S[:, 0, 0] > 0) & jnp.all(det > 0),
                       "innovation covariance not positive definite")
        return update(x, P, y, H, R)

    return checkify.checkify(guarded)(x, P, y, H, R)
