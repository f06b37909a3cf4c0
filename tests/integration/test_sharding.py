"""Multi-device DP path on the 8-fake-device CPU mesh (SURVEY.md §4.4):
sharded results must equal single-device results."""

import numpy as np
import jax
import pytest

from kalman_hydra_tpu.config import FlowConfig, RunConfig, TrackConfig
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu.parallel import (make_mesh, track_clips_batch,
                                       track_clips_sharded)


@pytest.fixture(scope="module")
def clip_batch():
    clips, seeds = [], []
    for s in range(8):
        frames, truth = moving_blob_clip(num_frames=4, height=64, width=64,
                                         num_points=4, seed=s)
        clips.append(frames)
        seeds.append(truth.positions[0])
    return np.stack(clips), np.stack(seeds).astype(np.float32)


@pytest.fixture(scope="module")
def cfg():
    return RunConfig(flow=FlowConfig(levels=2),
                     tracks=TrackConfig(num_tracks=4, reinit=False))


def test_eight_fake_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_equals_single_device(clip_batch, cfg):
    clips, seeds = clip_batch
    mesh = make_mesh(8)
    single = track_clips_batch(clips, cfg, seeds=seeds)
    sharded = track_clips_sharded(clips, cfg, mesh=mesh, seeds=seeds)
    for a, b in zip(single, sharded):
        assert np.array_equal(a.alive, b.alive)
        np.testing.assert_allclose(a.positions, b.positions, atol=1e-5)


def test_sharded_metric_reduction(clip_batch, cfg):
    clips, seeds = clip_batch
    mesh = make_mesh(8)
    trajs, metrics = track_clips_sharded(clips, cfg, mesh=mesh, seeds=seeds,
                                         reduce_metrics=True)
    assert np.isfinite(metrics["mean_nis"])
    assert metrics["live_fraction"].shape == (4,)
    assert (metrics["live_fraction"] > 0).all()


def test_sharded_on_subset_mesh(clip_batch, cfg):
    clips, seeds = clip_batch
    mesh = make_mesh(4)
    sharded = track_clips_sharded(clips, cfg, mesh=mesh, seeds=seeds)
    single = track_clips_batch(clips, cfg, seeds=seeds)
    np.testing.assert_allclose(single[3].positions, sharded[3].positions,
                               atol=1e-5)


def test_indivisible_batch_raises(clip_batch, cfg):
    clips, seeds = clip_batch
    mesh = make_mesh(8)
    with pytest.raises(ValueError):
        track_clips_sharded(clips[:3], cfg, mesh=mesh, seeds=seeds[:3])


def test_api_track_videos_batch(clip_batch, cfg):
    from kalman_hydra_tpu import api
    clips, seeds = clip_batch
    trajs = api.track_videos(clips[:2], cfg)
    assert len(trajs) == 2
    assert all(np.isfinite(t.positions).all() for t in trajs)


def test_sharded_fast_warp_bf16_equals_single(clip_batch):
    """DP sharding composed with the throughput flow configuration
    (select-sum warp + bf16 polyexp planes): each shard runs the vmapped
    per-clip pipeline and must match the single-device run exactly."""
    clips, seeds = clip_batch
    cfg = RunConfig(flow=FlowConfig(levels=2, fast_warp=4, bf16_poly=True),
                    tracks=TrackConfig(num_tracks=4, reinit=False))
    mesh = make_mesh(4)
    single = track_clips_batch(clips[:4], cfg, seeds=seeds[:4])
    sharded = track_clips_sharded(clips[:4], cfg, mesh=mesh,
                                  seeds=seeds[:4])
    for a, b in zip(single, sharded):
        assert np.array_equal(a.alive, b.alive)
        np.testing.assert_allclose(a.positions, b.positions, atol=1e-5)


def test_sharded_with_smoothing(clip_batch):
    """DP sharding composed with on-device RTS smoothing."""
    from kalman_hydra_tpu.config import SmoothConfig
    clips, seeds = clip_batch
    cfg = RunConfig(flow=FlowConfig(levels=2),
                    tracks=TrackConfig(num_tracks=4, reinit=False),
                    smooth=SmoothConfig(enabled=True))
    mesh = make_mesh(4)
    trajs = track_clips_sharded(clips[:4], cfg, mesh=mesh, seeds=seeds[:4])
    assert all(t.smoothed is not None and np.isfinite(t.smoothed).all()
               for t in trajs)


def test_sharded_render_channel_equals_single(clip_batch):
    """Mesh-render DP: one replicated RenderTemplate, clips sharded over
    the mesh — per-clip render tracking must equal the single-device vmap
    (the template is static data, so the hot loop stays collective-free)."""
    import jax.numpy as jnp
    from kalman_hydra_tpu.config import EkfConfig
    from kalman_hydra_tpu.models.mesh import build_mesh
    from kalman_hydra_tpu.models.render import make_template
    from kalman_hydra_tpu.ops.color import grayscale_u8
    clips, _ = clip_batch
    xs = np.linspace(16, 48, 2)
    verts = np.stack(np.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
    mesh_body = build_mesh(verts.astype(np.float32))
    gray0 = np.asarray(grayscale_u8(jnp.asarray(clips[0, 0])))
    tmpl = make_template(gray0, mesh_body)
    rcfg = RunConfig(
        flow=FlowConfig(levels=2),
        ekf=EkfConfig(measurement="render", q=0.5),
        tracks=TrackConfig(num_tracks=4, reinit=False))
    seeds = np.broadcast_to(mesh_body.vertices, (8, 4, 2)).copy()
    single = track_clips_batch(clips, rcfg, seeds=seeds, render_tmpl=tmpl)
    sharded = track_clips_sharded(clips, rcfg, mesh=make_mesh(8),
                                  seeds=seeds, render_tmpl=tmpl)
    for a, b in zip(single, sharded):
        # segment-sum accumulation order differs under the sharded layout
        # -> float noise at ~1e-6 relative
        np.testing.assert_allclose(a.positions, b.positions, atol=5e-4)
        np.testing.assert_array_equal(a.alive, b.alive)


def test_sharded_pair_batch_equals_single(clip_batch):
    """DP sharding composed with the pair-batched pipeline: the sharded
    path must route through shard_map(track_clips_pairflow) — each device
    chains its local clip shard into one pair batch — and match the
    single-device pairflow run, metrics reduction included."""
    clips, seeds = clip_batch
    cfg = RunConfig(flow=FlowConfig(levels=2, fast_warp=4),
                    tracks=TrackConfig(num_tracks=4, reinit=False),
                    pair_batch=True)
    mesh = make_mesh(4)
    single = track_clips_batch(clips[:4], cfg, seeds=seeds[:4])
    sharded, metrics = track_clips_sharded(clips[:4], cfg, mesh=mesh,
                                           seeds=seeds[:4],
                                           reduce_metrics=True)
    for a, b in zip(single, sharded):
        assert np.array_equal(a.alive, b.alive)
        np.testing.assert_allclose(a.positions, b.positions, atol=1e-5)
    assert np.isfinite(metrics["mean_nis"])
    assert metrics["live_fraction"].shape == (4,)
