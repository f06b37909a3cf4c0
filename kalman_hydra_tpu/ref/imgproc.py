"""OpenCV/NumPy oracle: image-processing half.

This is the behavioral contract the device ops are tested against
(BASELINE.json:5: "bit-level-comparable flow fields ... against the
OpenCV/NumPy reference"; SURVEY.md §2.3). It deliberately wraps the same
OpenCV entry points the reference wrapped (`cvtColor`, `pyrDown`,
`calcOpticalFlowFarneback`, `calcOpticalFlowPyrLK`, `goodFeaturesToTrack`)
and nothing else — all compute here is C++ OpenCV or plain NumPy, no JAX.

It is also the CPU baseline whose frames/sec sets the 5x throughput bar
(BASELINE.json:5).
"""

from __future__ import annotations

import numpy as np
import cv2

from ..config import FlowConfig, TrackConfig


def grayscale(frame: np.ndarray) -> np.ndarray:
    """BGR uint8 -> float32 grayscale in [0, 255] (cv2 BT.601 weights)."""
    if frame.ndim == 2:
        return frame.astype(np.float32)
    return cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32)


def pyr_down(img: np.ndarray) -> np.ndarray:
    """One pyramid level: 5-tap binomial blur + 2x decimate (cv2.pyrDown)."""
    return cv2.pyrDown(img)


def build_pyramid(img: np.ndarray, levels: int) -> list:
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def farneback(prev: np.ndarray, nxt: np.ndarray, cfg: FlowConfig,
              flow0: np.ndarray = None) -> np.ndarray:
    """Dense Farneback flow, (H, W, 2) float32, channel 0 = x displacement.

    flow0: optional (H, W, 2) initial flow — wraps
    cv2.OPTFLOW_USE_INITIAL_FLOW (the warm-start surface the device path
    mirrors with farneback(..., flow0=...))."""
    flags = cv2.OPTFLOW_FARNEBACK_GAUSSIAN if cfg.gaussian_win else 0
    flow = None
    if flow0 is not None:
        flags |= cv2.OPTFLOW_USE_INITIAL_FLOW
        flow = np.ascontiguousarray(flow0, np.float32)
    return cv2.calcOpticalFlowFarneback(
        prev.astype(np.uint8) if prev.dtype != np.uint8 else prev,
        nxt.astype(np.uint8) if nxt.dtype != np.uint8 else nxt,
        flow,
        cfg.pyr_scale, cfg.levels, cfg.winsize,
        cfg.iterations, cfg.poly_n, cfg.poly_sigma, flags)


def lk_sparse(prev: np.ndarray, nxt: np.ndarray, pts: np.ndarray,
              cfg: FlowConfig):
    """Pyramidal sparse LK at given (K, 2) float32 points.

    Returns (new_pts (K,2), status (K,) uint8)."""
    p0 = pts.reshape(-1, 1, 2).astype(np.float32)
    p1, st, _err = cv2.calcOpticalFlowPyrLK(
        prev.astype(np.uint8), nxt.astype(np.uint8), p0, None,
        winSize=(cfg.lk_winsize, cfg.lk_winsize),
        maxLevel=cfg.levels - 1,
        criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                  cfg.lk_max_iter, cfg.lk_eps),
        minEigThreshold=cfg.lk_min_eig)
    return p1.reshape(-1, 2), st.reshape(-1)


def lk_dense(prev: np.ndarray, nxt: np.ndarray, cfg: FlowConfig,
             stride: int = 1) -> np.ndarray:
    """Dense flow by running pyramidal LK on a regular pixel grid.

    The reference's LK usage was sparse; this grid version exists so dense-LK
    device flow (BASELINE.json:7) has an oracle with identical math. O(H*W)
    sparse calls — use small images / stride in tests.
    """
    h, w = prev.shape[:2]
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    pts = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float32)
    new_pts, st = lk_sparse(prev, nxt, pts, cfg)
    flow = (new_pts - pts).reshape(ys.shape + (2,))
    st = st.reshape(ys.shape).astype(bool)
    flow[~st] = 0.0
    return flow.astype(np.float32)


def good_features(gray: np.ndarray, cfg: TrackConfig,
                  max_corners: int = 0) -> np.ndarray:
    """Shi-Tomasi corner seeding (cv2.goodFeaturesToTrack), (N, 2) float32."""
    n = max_corners or cfg.num_tracks
    pts = cv2.goodFeaturesToTrack(
        gray.astype(np.uint8), maxCorners=n,
        qualityLevel=cfg.quality_level,
        minDistance=cfg.min_distance,
        blockSize=cfg.corner_block)
    if pts is None:
        return np.zeros((0, 2), dtype=np.float32)
    return pts.reshape(-1, 2).astype(np.float32)


def sample_flow(flow: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Bilinear sample of (H, W, 2) flow at (K, 2) (x, y) points -> (K, 2)."""
    h, w = flow.shape[:2]
    x = np.clip(pts[:, 0], 0.0, w - 1.001)
    y = np.clip(pts[:, 1], 0.0, h - 1.001)
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    f00 = flow[y0, x0]
    f01 = flow[y0, x0 + 1]
    f10 = flow[y0 + 1, x0]
    f11 = flow[y0 + 1, x0 + 1]
    return (f00 * (1 - fx) * (1 - fy) + f01 * fx * (1 - fy)
            + f10 * (1 - fx) * fy + f11 * fx * fy).astype(np.float32)
