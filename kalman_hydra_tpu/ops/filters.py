"""Separable filtering primitives shared by pyramid / LK / Farneback ops.

These reproduce OpenCV's filtering semantics (border modes, kernel
generation, rounding) in pure XLA so that flow fields are comparable to the
oracle at sub-0.5px EPE (BASELINE.json:5). Everything here is shape-static
and jit-safe.

Border naming follows OpenCV: "reflect101" = cv2.BORDER_REFLECT_101
(edge pixel not repeated; numpy mode="reflect"), "replicate" =
cv2.BORDER_REPLICATE (numpy mode="edge").
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

_NP_MODE = {"reflect101": "reflect", "replicate": "edge"}

# OpenCV getGaussianKernel fixed small kernels for sigma <= 0
_SMALL_GAUSSIAN = {
    1: np.array([1.0], np.float64),
    3: np.array([0.25, 0.5, 0.25], np.float64),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float64),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125], np.float64),
}


def cv_round(x: float) -> int:
    """OpenCV cvRound: round half to even."""
    return int(np.rint(x))


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """Replicates cv2.getGaussianKernel (float64 internals, float32 result)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].astype(np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    g = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def pad1d(x: jnp.ndarray, r_lo: int, r_hi: int, axis: int,
          border: str) -> jnp.ndarray:
    pads = [(0, 0)] * x.ndim
    pads[axis] = (r_lo, r_hi)
    return jnp.pad(x, pads, mode=_NP_MODE[border])


def correlate1d(x: jnp.ndarray, kernel, axis: int,
                border: str = "reflect101") -> jnp.ndarray:
    """Same-shape 1-D correlation along `axis` with an odd-length kernel.

    Short kernels unroll into shifted adds (elementwise work XLA fuses);
    long kernels lower to a conv so the HLO stays small at the big
    Farneback-pyramid sigmas (79-tap at the coarsest 1080p level).
    """
    kernel = np.asarray(kernel, dtype=np.float32)
    axis = axis % x.ndim
    k = len(kernel)
    r = k // 2
    xp = pad1d(x, r, r, axis, border)
    # unrolled shifted adds fuse into their consumers; the conv path is
    # kept for pathological sizes to bound HLO growth
    if k <= 99:
        out = None
        n = x.shape[axis]
        for i in range(k):
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(i, i + n)
            term = kernel[i] * xp[tuple(sl)]
            out = term if out is None else out + term
        return out
    return _correlate_conv(xp, kernel, axis)


def _correlate_conv(xp: jnp.ndarray, kernel: np.ndarray, axis: int):
    """VALID conv of pre-padded input along one axis via conv_general_dilated."""
    orig_shape = xp.shape
    # move target axis last, flatten the rest into batch
    perm = [a for a in range(xp.ndim) if a != axis] + [axis]
    xt = jnp.transpose(xp, perm)
    lead = xt.shape[:-1]
    xt = xt.reshape((int(np.prod(lead)) if lead else 1, 1, xt.shape[-1]))
    kern = jnp.asarray(kernel, xp.dtype).reshape(1, 1, len(kernel))
    out = lax.conv_general_dilated(
        xt, kern, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=lax.Precision.HIGHEST)
    out = out.reshape(lead + (out.shape[-1],))
    inv = np.argsort(perm)
    return jnp.transpose(out, inv)


def sep_filter2d(x: jnp.ndarray, kx, ky, border: str = "reflect101"):
    """Separable 2-D correlation over the last two axes (..., H, W)."""
    x = correlate1d(x, ky, axis=x.ndim - 2, border=border)
    return correlate1d(x, kx, axis=x.ndim - 1, border=border)


def gaussian_blur(x: jnp.ndarray, ksize: int, sigma: float,
                  border: str = "reflect101") -> jnp.ndarray:
    """cv2.GaussianBlur twin (separable, same kernel generation)."""
    k = gaussian_kernel(ksize, sigma)
    return sep_filter2d(x, k, k, border=border)


def box_filter(x: jnp.ndarray, size: int, axis: int,
               border: str = "replicate", normalize: bool = True):
    """Odd-size box filter along one axis.

    Windows up to 15 taps unroll into shifted adds (elementwise adds fuse;
    a prefix scan does not). Larger windows use padded cumulative sums
    (O(1) work per pixel regardless of size).
    """
    r = size // 2
    axis = axis % x.ndim
    xp = pad1d(x, r, r, axis, border)
    n = x.shape[axis]
    # factored 3xA box decomposition (identical up to fp regrouping)
    if size >= 9 and size % 3 == 0:
        # factored split: box(3a) = box3 then a strided box_a with step 3
        # (exact regrouping of the sum) — 3 + a shifted reads instead of
        # 3a for the winsize-15 Farneback smoothing sweeps
        summed = _box_split3(xp, size, n, axis, x.ndim)
    elif size <= 15:
        # accumulate in f32 even for bf16 inputs: reads stay half-width,
        # the running sum keeps full precision
        summed = None
        for k in range(size):
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(k, k + n)
            t = xp[tuple(sl)].astype(jnp.float32)
            summed = t if summed is None else summed + t
    else:
        cs = jnp.cumsum(xp, axis=axis, dtype=jnp.float32)
        summed = _box_from_cumsum(cs, size, n, axis, x.ndim)
    return summed / size if normalize else summed


def _box_split3(xp, size, n, axis, ndim):
    """box(size=3a) on pre-padded input as box3 -> stride-3 box_a."""
    a = size // 3
    m = n + size - 3           # box3 output length needed by stage 2
    s3 = None
    for k in range(3):
        sl = [slice(None)] * ndim
        sl[axis] = slice(k, k + m)
        t = xp[tuple(sl)].astype(jnp.float32)
        s3 = t if s3 is None else s3 + t
    out = None
    for j in range(a):
        sl = [slice(None)] * ndim
        sl[axis] = slice(3 * j, 3 * j + n)
        t = s3[tuple(sl)]
        out = t if out is None else out + t
    return out


def _box_from_cumsum(cs, size, n, axis, ndim):
    hi = [slice(None)] * ndim
    hi[axis] = slice(size - 1, size - 1 + n)
    top = cs[tuple(hi)]
    lo = [slice(None)] * ndim
    lo[axis] = slice(0, n - 1)
    first = [slice(None)] * ndim
    first[axis] = slice(0, 1)
    bottom = jnp.concatenate(
        [jnp.zeros_like(cs[tuple(first)]), cs[tuple(lo)]], axis=axis)
    return top - bottom


def box_blur2d(x: jnp.ndarray, size: int, border: str = "replicate",
               normalize: bool = True):
    """size x size box filter over the last two axes."""
    x = box_filter(x, size, axis=x.ndim - 2, border=border,
                   normalize=normalize)
    return box_filter(x, size, axis=x.ndim - 1, border=border,
                      normalize=normalize)
