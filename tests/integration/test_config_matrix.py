"""Config-combination sweep: every representative RunConfig tracks a tiny
clip end-to-end without crashing and with finite outputs.

Motivated by a round-2 regression class: individual features all worked,
but combinations (bf16_poly + exact warp; lag + chunk; adaptive_q
+ lk_sparse) broke or silently degraded. This matrix keeps the
combination space honest."""

import numpy as np
import pytest

from kalman_hydra_tpu import pipeline as pl
from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     SmoothConfig, TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip


@pytest.fixture(scope="module")
def clip48():
    frames, _ = moving_blob_clip(num_frames=5, height=48, width=48,
                                 num_points=4, seed=0)
    return frames


_TRACKS = TrackConfig(num_tracks=8, corner_pool=16)

CONFIGS = [
    ("farneback_kf", RunConfig(flow=FlowConfig(levels=2), tracks=_TRACKS)),
    ("farneback_implicit_iekf", RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="implicit_flow", iekf_iters=2),
        tracks=_TRACKS)),
    ("farneback_ukf", RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="implicit_flow", filter_type="ukf"),
        tracks=_TRACKS)),
    ("farneback_ct_adaptive", RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(dynamics="ct", turn_rate=0.05, adaptive_q=0.3),
        tracks=_TRACKS)),
    ("farneback_fastwarp_bf16", RunConfig(
        flow=FlowConfig(levels=2, fast_warp=4, bf16_poly=True),
        tracks=_TRACKS)),
    ("farneback_gaussian_win", RunConfig(
        flow=FlowConfig(levels=2, gaussian_win=True), tracks=_TRACKS)),
    ("lk_dense_cv4", RunConfig(
        flow=FlowConfig(method="lk_dense", levels=2),
        ekf=EkfConfig(state_dim=4), tracks=_TRACKS)),
    ("lk_sparse_halo_adaptive", RunConfig(
        flow=FlowConfig(method="lk_sparse", levels=2, lk_block_halo=4),
        ekf=EkfConfig(adaptive_q=0.3), tracks=_TRACKS)),
    ("lk_sparse_exact", RunConfig(
        flow=FlowConfig(method="lk_sparse", levels=2, lk_block_halo=0),
        tracks=_TRACKS)),
    ("photometric_only", RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="photometric", photo_win=9),
        tracks=_TRACKS)),
    ("flow_photometric", RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="flow_photometric", photo_win=9),
        tracks=_TRACKS)),
    ("smooth_monolithic", RunConfig(
        flow=FlowConfig(levels=2), tracks=_TRACKS,
        smooth=SmoothConfig(enabled=True))),
    ("smooth_chunked", RunConfig(
        flow=FlowConfig(levels=2), tracks=_TRACKS,
        smooth=SmoothConfig(enabled=True, chunk=2))),
    ("smooth_lag", RunConfig(
        flow=FlowConfig(levels=2), tracks=_TRACKS,
        smooth=SmoothConfig(enabled=True, lag=3))),
    ("no_reinit_seeded", RunConfig(
        flow=FlowConfig(levels=2),
        tracks=TrackConfig(num_tracks=8, corner_pool=16, reinit=False))),
    ("reinit_every_3", RunConfig(
        flow=FlowConfig(levels=2),
        tracks=TrackConfig(num_tracks=8, corner_pool=16, reinit_every=3))),
]


@pytest.mark.parametrize("name,cfg", CONFIGS, ids=[n for n, _ in CONFIGS])
def test_config_combination_tracks(clip48, name, cfg):
    tr = pl.track_clip(clip48, cfg)
    assert tr.positions.shape == (5, 8, 2)
    assert np.isfinite(tr.positions).all()
    assert np.isfinite(tr.nis).all()
    if cfg.smooth.enabled:
        assert tr.smoothed is not None
        assert np.isfinite(tr.smoothed).all()


def test_config_json_roundtrip_all(clip48):
    for name, cfg in CONFIGS:
        assert RunConfig.from_json(cfg.to_json()) == cfg, name


_RENDER_TRACKS = TrackConfig(num_tracks=9, corner_pool=16, reinit=False)

RENDER_CONFIGS = [
    ("render_only", RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="render", q=0.5),
        tracks=_RENDER_TRACKS)),
    ("flow_render", RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="flow_render", q=0.5),
        tracks=_RENDER_TRACKS)),
    ("render_adaptive_q", RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="render", q=0.5, adaptive_q=0.3),
        tracks=_RENDER_TRACKS)),
    ("render_smooth_lag", RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="render", q=0.5),
        tracks=_RENDER_TRACKS, smooth=SmoothConfig(enabled=True, lag=2))),
    ("render_ca6", RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="render", q=0.5, state_dim=6),
        tracks=_RENDER_TRACKS)),
]


@pytest.mark.parametrize("name,cfg", RENDER_CONFIGS,
                         ids=[n for n, _ in RENDER_CONFIGS])
def test_render_config_combination_tracks(clip48, name, cfg):
    # mesh-render channels track a fixed vertex set: 3x3 grid over the
    # clip interior + its rasterized rest template
    from kalman_hydra_tpu.models.mesh import build_mesh
    from kalman_hydra_tpu.models.render import make_template
    from kalman_hydra_tpu.ops.color import grayscale_u8
    import jax.numpy as jnp
    xs = np.linspace(12, 36, 3)
    verts = np.stack(np.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
    mesh = build_mesh(verts.astype(np.float32))
    gray0 = np.asarray(grayscale_u8(jnp.asarray(clip48[0])))
    tmpl = make_template(gray0, mesh)
    tr = pl.track_clip(clip48, cfg, seeds=mesh.vertices, render_tmpl=tmpl)
    assert tr.positions.shape == (5, 9, 2)
    assert np.isfinite(tr.positions).all()
    assert np.isfinite(tr.nis).all()
    if cfg.smooth.enabled:
        assert np.isfinite(tr.smoothed).all()
    assert RunConfig.from_json(cfg.to_json()) == cfg
