"""OpenCV/NumPy oracle: full tracking pipeline (CPU).

Mirrors the reference driver's hot loop (SURVEY.md §3.1): per frame,
grayscale -> dense flow -> sample flow at track positions -> EKF
predict/update -> append trajectory row. This is (a) the parity target for
the device pipeline and (b) the measured CPU baseline that defines the 5x
throughput bar (BASELINE.json:5).
"""

from __future__ import annotations

import time

import numpy as np

from ..config import RunConfig
from ..io.export import Trajectories
from . import ekf as ref_ekf
from . import imgproc as ip


def track_clip(frames: np.ndarray, cfg: RunConfig,
               seeds: np.ndarray = None, timing: dict = None) -> Trajectories:
    """Track one clip ((T, H, W[, 3]) uint8) on CPU with OpenCV + NumPy.

    No gating / re-init here: the oracle keeps the fixed seeded set alive for
    clean parity comparison (lifecycle parity is tested statistically).
    """
    T = len(frames)
    gray0 = ip.grayscale(frames[0])
    if seeds is None:
        seeds = ip.good_features(gray0, cfg.tracks)
    K = len(seeds)

    x, P = ref_ekf.init_state(cfg.ekf, seeds.astype(np.float64))
    F = ref_ekf.transition(cfg.ekf)
    Q = ref_ekf.process_noise(cfg.ekf)
    H = np.zeros((2, cfg.ekf.state_dim))
    H[0, 0] = H[1, 1] = 1.0
    R = cfg.ekf.r * np.eye(2)

    positions = np.zeros((T, K, 2), dtype=np.float32)
    nis_out = np.zeros((T, K), dtype=np.float32)
    positions[0] = seeds
    prev = gray0
    t_flow = t_ekf = 0.0

    for t in range(1, T):
        gray = ip.grayscale(frames[t])
        t0 = time.perf_counter()
        if cfg.flow.method == "lk_sparse":
            flow_at = None
            new_pts, _st = ip.lk_sparse(prev, gray, x[:, 0:2].astype(np.float32),
                                        cfg.flow)
            disp = new_pts - x[:, 0:2].astype(np.float32)
        else:
            flow = ip.farneback(prev, gray, cfg.flow)
            disp = ip.sample_flow(flow, x[:, 0:2].astype(np.float32))
        t1 = time.perf_counter()
        # measurement: previous filtered position + sampled displacement
        z = x[:, 0:2] + disp.astype(np.float64)
        for k in range(K):
            xp, Pp = ref_ekf.predict(x[k], P[k], F, Q)
            x[k], P[k], nis_out[t, k] = ref_ekf.update(xp, Pp, z[k], H, R)
        t2 = time.perf_counter()
        t_flow += t1 - t0
        t_ekf += t2 - t1
        positions[t] = x[:, 0:2].astype(np.float32)
        prev = gray

    if timing is not None:
        timing["flow_s"] = t_flow
        timing["ekf_s"] = t_ekf
    alive = np.ones((T, K), dtype=bool)
    return Trajectories(positions=positions, alive=alive, nis=nis_out)
