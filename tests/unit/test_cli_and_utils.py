"""CLI smoke tests + checkpoint/resume round-trip."""

import numpy as np

from kalman_hydra_tpu.cli import main as cli_main
from kalman_hydra_tpu.io.synthetic import moving_blob_clip


def test_cli_synth_and_track(tmp_path):
    clip = str(tmp_path / "clip.npz")
    out = str(tmp_path / "tracks.npz")
    assert cli_main(["synth", "--out", clip, "--frames", "4",
                     "--height", "64", "--width", "64"]) == 0
    assert cli_main(["track", clip, "--out", out, "--tracks", "8"]) == 0
    from kalman_hydra_tpu.io.export import load
    tr = load(out)
    assert tr.positions.shape[0] == 4
    assert tr.positions.shape[1] == 8


def test_cli_flow(tmp_path):
    a = str(tmp_path / "a.npy")
    b = str(tmp_path / "b.npy")
    out = str(tmp_path / "flow.npz")
    from kalman_hydra_tpu.io.synthetic import translating_pair
    fa, fb, _ = translating_pair(height=64, width=64, shift=(1.0, 0.5))
    np.save(a, np.round(fa).astype(np.uint8))
    np.save(b, np.round(fb).astype(np.uint8))
    assert cli_main(["flow", a, b, "--out", out]) == 0
    with np.load(out) as z:
        assert z["flow"].shape == (64, 64, 2)


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    from kalman_hydra_tpu import pipeline as pl
    from kalman_hydra_tpu.config import FlowConfig, RunConfig, TrackConfig

    frames, _ = moving_blob_clip(num_frames=7, height=64, width=64, seed=3)
    cfg = RunConfig(flow=FlowConfig(levels=2),
                    tracks=TrackConfig(num_tracks=8, corner_pool=16))
    full = pl.track_stream(iter(frames), cfg)

    ck = str(tmp_path / "state.npz")
    # run the first 4 frames (3 steps + init), checkpointing every step
    pl.track_stream(iter(frames[:4]), cfg, checkpoint_path=ck,
                    checkpoint_every=1)
    resumed = pl.track_stream(iter(frames), cfg, checkpoint_path=ck,
                              resume=True)
    # resumed rows cover frames 4..6; compare against the tail of full
    np.testing.assert_allclose(resumed.positions,
                               full.positions[-len(resumed.positions):],
                               atol=1e-4)


def test_checkpoint_resume_preserves_reinit_cadence(tmp_path):
    """Resume must restore frame_idx + the corner-pool cache so
    reinit_every>1 keeps its refresh cadence (regression: resume used to
    silently refresh every frame)."""
    import pytest
    from kalman_hydra_tpu import pipeline as pl
    from kalman_hydra_tpu.config import FlowConfig, RunConfig, TrackConfig

    frames, _ = moving_blob_clip(num_frames=8, height=64, width=64, seed=5)
    cfg = RunConfig(flow=FlowConfig(levels=2),
                    tracks=TrackConfig(num_tracks=8, corner_pool=16,
                                       reinit_every=3))
    full = pl.track_stream(iter(frames), cfg)

    ck = str(tmp_path / "state.npz")
    pl.track_stream(iter(frames[:5]), cfg, checkpoint_path=ck,
                    checkpoint_every=2)  # checkpoint lands at frame_idx=4
    resumed = pl.track_stream(iter(frames), cfg, checkpoint_path=ck,
                              resume=True)
    np.testing.assert_allclose(resumed.positions,
                               full.positions[-len(resumed.positions):],
                               atol=1e-4)
    np.testing.assert_array_equal(resumed.track_id,
                                  full.track_id[-len(resumed.track_id):])

    # a stream shorter than the checkpointed index raises clearly
    with pytest.raises(ValueError, match="resume"):
        pl.track_stream(iter(frames[:3]), cfg, checkpoint_path=ck,
                        resume=True)


def test_runconfig_json_roundtrip():
    from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                         SmoothConfig, TrackConfig)
    cfg = RunConfig(flow=FlowConfig(method="lk_dense", levels=4,
                                    fast_warp=8, bf16_poly=True),
                    ekf=EkfConfig(state_dim=6, measurement="implicit_flow"),
                    tracks=TrackConfig(num_tracks=64, seed_in_body=True,
                                       reinit_every=3),
                    smooth=SmoothConfig(enabled=True, chunk=32))
    cfg2 = RunConfig.from_json(cfg.to_json())
    assert cfg2 == cfg


def test_runconfig_json_ignores_removed_fields():
    """Old run artifacts carrying since-deleted perf-knob fields
    (measurements retire knobs) must load with a warning, not crash."""
    import json
    import warnings
    from kalman_hydra_tpu.config import RunConfig
    raw = json.loads(RunConfig().to_json())
    raw["flow"]["fi_box_stacked"] = True      # deleted round 4
    raw["ekf"]["some_future_knob"] = 1
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cfg = RunConfig.from_json(json.dumps(raw))
    assert cfg == RunConfig()
    assert any("no longer has" in str(w.message) for w in rec)


def test_cli_track_stream_checkpoint(tmp_path):
    clip = str(tmp_path / "clip.npz")
    out = str(tmp_path / "tracks.npz")
    ck = str(tmp_path / "state.npz")
    assert cli_main(["synth", "--out", clip, "--frames", "5",
                     "--height", "64", "--width", "64"]) == 0
    assert cli_main(["track", clip, "--out", out, "--tracks", "8",
                     "--stream", "--checkpoint", ck,
                     "--checkpoint-every", "2"]) == 0
    import os
    assert os.path.exists(ck)
    # resume from the checkpoint
    out2 = str(tmp_path / "tracks2.npz")
    assert cli_main(["track", clip, "--out", out2, "--tracks", "8",
                     "--stream", "--checkpoint", ck, "--resume"]) == 0


def test_smooth_config_rejects_negative_lag():
    import pytest as _pytest
    from kalman_hydra_tpu.config import SmoothConfig
    with _pytest.raises(ValueError):
        SmoothConfig(enabled=True, lag=-5)
    with _pytest.raises(ValueError):
        SmoothConfig(chunk=-1)


def test_runconfig_rejects_flow_measurement_with_sparse_lk():
    import pytest as _pytest
    from kalman_hydra_tpu.config import EkfConfig, FlowConfig, RunConfig
    with _pytest.raises(ValueError):
        RunConfig(flow=FlowConfig(method="lk_sparse"),
                  ekf=EkfConfig(measurement="implicit_flow"))
    with _pytest.raises(ValueError):
        RunConfig(flow=FlowConfig(method="lk_sparse"),
                  ekf=EkfConfig(measurement="flow_photometric"))
    # photometric bypasses flow entirely — allowed
    RunConfig(flow=FlowConfig(method="lk_sparse"),
              ekf=EkfConfig(measurement="photometric"))


def test_cli_temporal_flag(tmp_path):
    """--temporal plumbs FlowConfig.temporal_init through _load_cfg and
    tracks a clip end-to-end (warm-start chain in the scan carry)."""
    clip = str(tmp_path / "clip.npz")
    out = str(tmp_path / "tracks.npz")
    assert cli_main(["synth", "--out", clip, "--frames", "4",
                     "--height", "64", "--width", "64"]) == 0
    assert cli_main(["track", clip, "--out", out, "--tracks", "8",
                     "--temporal"]) == 0
    from kalman_hydra_tpu.io.export import load
    tr = load(out)
    assert tr.positions.shape == (4, 8, 2)
    assert np.isfinite(tr.positions).all()
