"""Per-pixel temporal Kalman smoothing of dense flow fields.

BASELINE.json:8 (config 2): "per-pixel EKF smoothing of flow field" —
every pixel runs an independent 2-state-per-component constant-velocity KF
over time, smoothing the (u, v) flow measurement sequence. Because the
per-pixel system is tiny and identical everywhere, the filter is written
in closed scalar form and vectorized over the full (H, W) grid — one
elementwise pass per frame, no matrices materialized (the 2x2 covariance has 3 unique
scalars per pixel per component).

State per flow component: [value, rate]; measurement: that component of
the frame's dense flow. Innovation-gated: pixels whose NIS exceeds the
chi^2 gate (occlusion, flow dropout) coast on prediction.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp


class PixelEkfParams(NamedTuple):
    q: float = 0.01       # process noise spectral density (flow units^2)
    r: float = 0.25       # measurement noise variance
    p0: float = 1.0       # initial value variance
    p0_rate: float = 1.0  # initial rate variance
    gate: float = 6.63    # chi^2(1, 0.99) per-component NIS gate
    dt: float = 1.0


class PixelEkfState(NamedTuple):
    """Each field is (2, H, W) (leading axis = flow component u, v)."""

    x: jnp.ndarray        # value
    v: jnp.ndarray        # rate
    p11: jnp.ndarray      # var(value)
    p12: jnp.ndarray      # cov(value, rate)
    p22: jnp.ndarray      # var(rate)


def init(flow0: jnp.ndarray, params: PixelEkfParams) -> PixelEkfState:
    """flow0: (H, W, 2) first measured flow field."""
    x = jnp.moveaxis(flow0, -1, 0)
    z = jnp.zeros_like(x)
    return PixelEkfState(
        x=x, v=z,
        p11=jnp.full_like(x, params.p0),
        p12=z,
        p22=jnp.full_like(x, params.p0_rate))


def step(state: PixelEkfState, flow: jnp.ndarray,
         params: PixelEkfParams) -> Tuple[PixelEkfState, jnp.ndarray]:
    """One frame: predict + gated update against the measured flow.

    flow: (H, W, 2). Returns (new_state, smoothed (H, W, 2))."""
    dt = params.dt
    q = params.q
    # predict: x += v dt;  P <- F P F^T + Q (2x2 closed form)
    xp = state.x + state.v * dt
    vp = state.v
    p11 = state.p11 + dt * (2.0 * state.p12 + dt * state.p22) \
        + q * dt ** 3 / 3.0
    p12 = state.p12 + dt * state.p22 + q * dt ** 2 / 2.0
    p22 = state.p22 + q * dt

    # update with H = [1 0]
    z = jnp.moveaxis(flow, -1, 0)
    y = z - xp
    s = p11 + params.r
    nis = y * y / s
    ok = nis < params.gate
    k1 = jnp.where(ok, p11 / s, 0.0)
    k2 = jnp.where(ok, p12 / s, 0.0)
    x_new = xp + k1 * y
    v_new = vp + k2 * y
    # Joseph form for the scalar-gain 2x2 case
    r = params.r
    p11_new = (1 - k1) ** 2 * p11 + k1 * k1 * r
    p12_new = (1 - k1) * (p12 - k2 * p11) + k1 * k2 * r
    p22_new = p22 - 2 * k2 * p12 + k2 * k2 * p11 + k2 * k2 * r
    new = PixelEkfState(x=x_new, v=v_new, p11=p11_new, p12=p12_new,
                        p22=p22_new)
    return new, jnp.moveaxis(x_new, 0, -1)


def smooth_flow_sequence(flows: jnp.ndarray,
                         params: PixelEkfParams = PixelEkfParams()
                         ) -> jnp.ndarray:
    """Filter a (T, H, W, 2) flow sequence -> (T, H, W, 2) smoothed.

    `lax.scan` over time; frame 0 initializes the state."""
    st0 = init(flows[0], params)

    def body(st, fl):
        st2, out = step(st, fl, params)
        return st2, out

    _, out = jax.lax.scan(body, st0, flows[1:])
    return jnp.concatenate([flows[:1], out], axis=0)
