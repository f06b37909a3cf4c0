"""Pair-batched pipeline (RunConfig.pair_batch) parity vs the per-frame
scan: the batched front end (polyexp_pyramid_batch,
farneback_pairs_from_pyramids) must reproduce the single-pair path per
pair, and track_arrays_pairflow must reproduce track_arrays
trajectories."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                     SmoothConfig, TrackConfig)
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu import pipeline as pl
from kalman_hydra_tpu.ops import farneback as fb_ops


def _clip(t=6, h=96, w=128):
    frames, _ = moving_blob_clip(num_frames=t, height=h, width=w,
                                 num_points=6, seed=3)
    return frames


def _grays(frames):
    from kalman_hydra_tpu.ops.color import grayscale_u8
    return grayscale_u8(jnp.asarray(frames))


FB = FlowConfig(method="farneback", levels=3, winsize=9, iterations=2,
                poly_n=5, poly_sigma=1.1)

# the two warp formulations of the Farneback iteration: exact bilinear
# gather (fast_warp=0) and the clamped select-sum warp (fast_warp=4)
MODES = {"xla": {}, "xla_fast_warp": {"fast_warp": 4}}


def _flow_cfg(mode):
    return dataclasses.replace(FB, **MODES[mode])


class TestBatchedFrontEnd:
    @pytest.mark.parametrize("bf16", [False, True])
    def test_polyexp_batch_matches_single(self, bf16):
        cfg = dataclasses.replace(FB, bf16_poly=bf16)
        grays = _grays(_clip(t=3))
        bat = fb_ops.polyexp_pyramid_batch(grays, cfg)
        for n in range(grays.shape[0]):
            one = fb_ops.polyexp_pyramid(grays[n], cfg)
            assert len(one) == len(bat)
            for lvl, o in enumerate(one):
                assert bat[lvl][n].dtype == o.dtype
                # identical math; XLA:CPU fuses the two programs' FMAs
                # differently (coefficients are O(1e2), so 1e-3 abs ~
                # 1e-5 relative; bf16 storage rounds at ~4e-3 relative)
                np.testing.assert_allclose(
                    np.asarray(bat[lvl][n], np.float32),
                    np.asarray(o, np.float32),
                    atol=1.0 if bf16 else 1e-3)

    @pytest.mark.parametrize("mode", list(MODES))
    def test_pairs_match_single_pair(self, mode):
        cfg = _flow_cfg(mode)
        grays = _grays(_clip(t=4))
        Rs = fb_ops.polyexp_pyramid_batch(grays, cfg)
        got = fb_ops.farneback_pairs_from_pyramids(Rs, cfg)
        assert got.shape == (3,) + grays.shape[1:] + (2,)
        for b in range(3):
            want = fb_ops.farneback_from_pyramids(
                tuple(R[b] for R in Rs), tuple(R[b + 1] for R in Rs), cfg)
            np.testing.assert_allclose(np.asarray(got[b]),
                                       np.asarray(want), atol=1e-4)

    def test_pairs_multi_clip_chaining(self):
        """clip_len=T chains C clips' frames: pair b must read frames
        (p, p+1) with p = b + b // (T-1) — no pair straddles a clip
        boundary."""
        T, C = 3, 2
        cfg = _flow_cfg("xla_fast_warp")
        grays = jnp.concatenate([_grays(_clip(t=T)),
                                 _grays(_clip(t=T)[::-1].copy())])
        Rs = fb_ops.polyexp_pyramid_batch(grays, cfg)
        got = fb_ops.farneback_pairs_from_pyramids(Rs, cfg, clip_len=T)
        B = C * (T - 1)
        assert got.shape[0] == B
        for b in range(B):
            p = b + b // (T - 1)
            want = fb_ops.farneback_from_pyramids(
                tuple(R[p] for R in Rs), tuple(R[p + 1] for R in Rs), cfg)
            np.testing.assert_allclose(np.asarray(got[b]),
                                       np.asarray(want), atol=1e-4)


class TestPairflowPipeline:
    def _run(self, cfg, frames, seeds=None):
        return jax.device_get(pl.track_arrays(jnp.asarray(frames), cfg,
                                              seeds=seeds))

    def _seeds(self, k=6, h=96, w=128):
        g = np.stack(np.meshgrid(np.linspace(12, w - 12, 3),
                                 np.linspace(12, h - 12, 2)),
                     axis=-1).reshape(-1, 2)[:k]
        return jnp.asarray(g.astype(np.float32))

    @pytest.mark.parametrize("mode", list(MODES))
    def test_matches_scan_farneback(self, mode):
        frames = _clip()
        base = RunConfig(flow=_flow_cfg(mode), ekf=EkfConfig(state_dim=4),
                         tracks=TrackConfig(num_tracks=6))
        seeds = self._seeds()
        ref = self._run(base, frames, seeds)
        got = self._run(base.replace(pair_batch=True), frames, seeds)
        np.testing.assert_allclose(got["pos"], ref["pos"], atol=2e-4)
        np.testing.assert_array_equal(got["track_id"], ref["track_id"])
        np.testing.assert_array_equal(got["alive"], ref["alive"])

    def test_matches_scan_lk_dense(self):
        frames = _clip()
        cfg = RunConfig(flow=FlowConfig(method="lk_dense", levels=3),
                        ekf=EkfConfig(state_dim=4),
                        tracks=TrackConfig(num_tracks=6))
        seeds = self._seeds()
        ref = self._run(cfg, frames, seeds)
        got = self._run(cfg.replace(pair_batch=True), frames, seeds)
        np.testing.assert_allclose(got["pos"], ref["pos"], atol=2e-4)

    def test_matches_scan_with_reinit_cadence_and_lag(self):
        """Corner-pool refresh cadence + online fixed-lag smoothing both
        ride the pair-batched scan identically."""
        frames = _clip(t=8)
        cfg = RunConfig(flow=FB, ekf=EkfConfig(state_dim=4),
                        tracks=TrackConfig(num_tracks=6, reinit=True,
                                           reinit_every=3),
                        smooth=SmoothConfig(enabled=True, lag=2))
        ref = self._run(cfg, frames)
        got = self._run(cfg.replace(pair_batch=True), frames)
        np.testing.assert_allclose(got["pos"], ref["pos"], atol=2e-4)
        np.testing.assert_allclose(got["smoothed"], ref["smoothed"],
                                   atol=2e-4)
        np.testing.assert_array_equal(got["track_id"], ref["track_id"])

    @pytest.mark.parametrize("mode", list(MODES))
    def test_multi_clip_matches_per_clip(self, mode):
        """track_clips_pairflow (BASELINE.json:10 multi-clip batch): all
        clips' pairs form one batch via clip_len chaining; per-clip
        trajectories match the single-clip pair pipeline."""
        clips = np.stack([_clip(), _clip()[::-1].copy()])
        cfg = RunConfig(flow=_flow_cfg(mode), ekf=EkfConfig(state_dim=4),
                        tracks=TrackConfig(num_tracks=6), pair_batch=True)
        seeds = self._seeds()
        got = jax.device_get(pl.track_clips_pairflow(
            jnp.asarray(clips), cfg, seeds=seeds))
        for b in range(2):
            ref = self._run(cfg, clips[b], seeds)
            np.testing.assert_allclose(got["pos"][b], ref["pos"],
                                       atol=2e-4)
            np.testing.assert_array_equal(got["alive"][b], ref["alive"])

    @pytest.mark.parametrize("mode", list(MODES))
    def test_flow_sequence_matches_scan(self, mode):
        """flow_sequence (config 2's contract path, incl. the per-pixel
        EKF smoothing stage) through the pair-batched front end matches
        the per-frame scan."""
        frames = jnp.asarray(_clip())
        base = RunConfig(flow=_flow_cfg(mode))
        for smooth in (False, True):
            ref = np.asarray(pl.flow_sequence(frames, base, smooth=smooth))
            got = np.asarray(pl.flow_sequence(
                frames, base.replace(pair_batch=True), smooth=smooth))
            np.testing.assert_allclose(got, ref, atol=2e-4)

    def test_flow_sequence_lk_dense_matches_scan(self):
        frames = jnp.asarray(_clip())
        cfg = RunConfig(flow=FlowConfig(method="lk_dense", levels=3))
        ref = np.asarray(pl.flow_sequence(frames, cfg))
        got = np.asarray(pl.flow_sequence(frames,
                                          cfg.replace(pair_batch=True)))
        np.testing.assert_allclose(got, ref, atol=2e-4)

    def test_config_validation(self):
        with pytest.raises(ValueError, match="pair_batch"):
            RunConfig(flow=FlowConfig(method="lk_sparse"),
                      pair_batch=True)
        with pytest.raises(ValueError, match="temporal_init"):
            RunConfig(flow=FlowConfig(temporal_init=True),
                      pair_batch=True)
        with pytest.raises(ValueError, match="flow-driven"):
            RunConfig(ekf=EkfConfig(measurement="photometric"),
                      pair_batch=True)
