"""Oracle self-checks: the OpenCV/NumPy reference must itself be sane
against analytic ground truth before anything is tested against it
(SURVEY.md §4.1)."""

import numpy as np
import pytest

from kalman_hydra_tpu.config import EkfConfig, RunConfig
from kalman_hydra_tpu.ref import ekf as ref_ekf
from kalman_hydra_tpu.ref import imgproc as ip
from kalman_hydra_tpu.ref import pipeline as rp


def test_farneback_oracle_on_translation(trans_pair):
    a, b, flow_true = trans_pair
    flow = ip.farneback(a, b, RunConfig().flow)
    epe = np.linalg.norm(flow - flow_true, axis=-1)[8:-8, 8:-8].mean()
    assert epe < 0.05


def test_lk_sparse_oracle_on_translation(trans_pair):
    a, b, flow_true = trans_pair
    pts = np.stack(np.meshgrid(np.arange(20, 108, 10),
                               np.arange(20, 108, 10)), -1)
    pts = pts.reshape(-1, 2).astype(np.float32)
    new_pts, st = ip.lk_sparse(a, b, pts, RunConfig().flow)
    assert st.all()
    err = np.abs(new_pts - pts - flow_true[0, 0]).mean()
    assert err < 0.05


@pytest.mark.parametrize("state_dim", [4, 6])
def test_kf_oracle_converges_on_constant_velocity(state_dim, rng):
    cfg = EkfConfig(state_dim=state_dim, q=0.05, r=0.25)
    T, K = 40, 3
    v = np.array([1.5, -0.7])
    truth = np.cumsum(np.broadcast_to(v, (T, 2)), axis=0)[:, None, :] \
        + rng.uniform(0, 50, size=(1, K, 2))
    z = truth + rng.normal(0, 0.3, size=(T, K, 2))
    x0, P0 = ref_ekf.init_state(cfg, truth[0, :, :2])
    out = ref_ekf.filter_tracks(cfg, z, x0, P0)
    err = np.linalg.norm(out["x_filt"][-5:, :, :2] - truth[-5:], axis=-1)
    assert err.mean() < 0.5
    vel_err = np.abs(out["x_filt"][-1, :, 2:4] - v).max()
    # CA model has extra freedom (acceleration states soak up noise), so its
    # velocity estimate settles slower than the CV model's.
    assert vel_err < (0.2 if state_dim == 4 else 0.45)


def test_rts_smoother_reduces_error(rng):
    cfg = EkfConfig(state_dim=4, q=0.05, r=1.0)
    T, K = 60, 2
    v = np.array([0.8, 0.4])
    truth = np.broadcast_to(
        np.cumsum(np.broadcast_to(v, (T, 2)), axis=0)[:, None, :]
        + np.array([30.0, 40.0]), (T, K, 2)).copy()
    z = truth + rng.normal(0, 1.0, size=(T, K, 2))
    x0, P0 = ref_ekf.init_state(cfg, truth[0])
    out = ref_ekf.filter_tracks(cfg, z, x0, P0)
    xs, _Ps = ref_ekf.rts_smooth(cfg, out["x_filt"], out["P_filt"],
                                 out["x_pred"], out["P_pred"])
    filt_err = np.linalg.norm(out["x_filt"][:, :, :2] - truth, axis=-1).mean()
    smooth_err = np.linalg.norm(xs[:, :, :2] - truth, axis=-1).mean()
    assert smooth_err < filt_err


def test_joseph_update_keeps_covariance_symmetric_psd(rng):
    cfg = EkfConfig()
    F = ref_ekf.transition(cfg)
    Q = ref_ekf.process_noise(cfg)
    H = np.zeros((2, 4)); H[0, 0] = H[1, 1] = 1.0
    R = cfg.r * np.eye(2)
    x = rng.normal(size=4)
    P = np.eye(4)
    for _ in range(50):
        x, P = ref_ekf.predict(x, P, F, Q)
        x, P, _ = ref_ekf.update(x, P, rng.normal(size=2), H, R)
    assert np.allclose(P, P.T, atol=1e-12)
    assert np.linalg.eigvalsh(P).min() > 0


def test_oracle_pipeline_tracks_blob(blob_clip):
    frames, truth = blob_clip
    cfg = RunConfig()
    tr = rp.track_clip(frames, cfg, seeds=truth.positions[0])
    err = np.linalg.norm(tr.positions[-1] - truth.positions[-1], axis=-1)
    # flow-chained tracking dead-reckons: a small steady-state lag vs truth
    # is inherent; parity between the device path and oracle is tested much tighter.
    assert err.mean() < 3.5


def test_good_features_returns_corners(blob_clip):
    frames, _ = blob_clip
    from kalman_hydra_tpu.config import TrackConfig
    pts = ip.good_features(ip.grayscale(frames[0]), TrackConfig())
    assert len(pts) > 10
    assert pts[:, 0].max() < frames.shape[2]
    assert pts[:, 1].max() < frames.shape[1]
