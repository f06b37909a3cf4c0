"""Spatially-sharded dense LK (halo exchange over the mesh) vs the
single-device op (SURVEY.md §2.2 TP-analog; §4.4 fake-device testing)."""

import numpy as np
import jax
import pytest

from kalman_hydra_tpu.config import FlowConfig
from kalman_hydra_tpu.io.synthetic import translating_pair
from kalman_hydra_tpu.ops import lk as lk_ops
from kalman_hydra_tpu.parallel.spatial import lk_dense_sharded
from jax.sharding import Mesh


@pytest.fixture(scope="module")
def pair128():
    return translating_pair(height=128, width=128, shift=(2.0, -1.5), seed=0)


# halo constraint: coarsest local rows >= max(win//2, warp_halo) — use a
# 9-px window so 8 devices x 2 levels fit a 128-row frame
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_lk_matches_single_device(pair128, n_dev):
    a, b, _ = pair128
    levels = 3 if n_dev == 2 else 2
    cfg = FlowConfig(levels=levels, lk_max_iter=5, lk_winsize=9)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("space",))
    got = lk_dense_sharded(a, b, cfg, mesh=mesh)
    import jax.numpy as jnp
    ref = np.asarray(jax.jit(
        lambda x, y: lk_ops.lk_dense(x, y, cfg))(jnp.asarray(a),
                                                 jnp.asarray(b)))
    diff = np.abs(got - ref)
    # identical math modulo the warp's vertical clamp; interior must match
    assert diff[8:-8, 8:-8].max() < 1e-3
    assert diff.max() < 0.1


def test_sharded_lk_tracks_truth(pair128):
    a, b, flow_true = pair128
    cfg = FlowConfig(levels=2, lk_max_iter=5, lk_winsize=9)
    mesh = Mesh(np.array(jax.devices()), ("space",))
    got = lk_dense_sharded(a, b, cfg, mesh=mesh)
    epe = np.linalg.norm(got - flow_true, axis=-1)[12:-12, 12:-12]
    assert epe.mean() < 0.05


def test_indivisible_height_raises(pair128):
    a, b, _ = pair128
    cfg = FlowConfig(levels=4)
    mesh = Mesh(np.array(jax.devices()), ("space",))
    with pytest.raises(ValueError):
        lk_dense_sharded(a[:100], b[:100], cfg, mesh=mesh)


def test_halo_too_wide_raises(pair128):
    a, b, _ = pair128
    cfg = FlowConfig(levels=3, lk_winsize=21)   # halo 10 > coarse rows
    mesh = Mesh(np.array(jax.devices()), ("space",))
    with pytest.raises(ValueError):
        lk_dense_sharded(a, b, cfg, mesh=mesh)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_farneback_matches_single_device(pair128, n_dev):
    from kalman_hydra_tpu.ops.farneback import farneback
    from kalman_hydra_tpu.parallel.spatial import farneback_sharded
    import jax.numpy as jnp
    a, b, _ = pair128
    cfg = FlowConfig(levels=3, fast_warp=8)
    ref = np.asarray(jax.jit(lambda x, y: farneback(x, y, cfg))(
        jnp.asarray(a), jnp.asarray(b)))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("space",))
    got = farneback_sharded(a, b, cfg, mesh=mesh)
    d = np.abs(got - ref)
    assert d[8:-8, 8:-8].max() < 5e-3
    assert d.max() < 0.1


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_farneback_winsize13_matches_single(pair128, n_dev):
    """A 13-px window on the band path (halo sizes follow winsize): each
    band's global row offset reaches the border damping, so interior
    parity vs the single-device run is float noise; the global border
    rows carry the band-vs-single semantics difference (<0.1 px)."""
    from kalman_hydra_tpu.ops.farneback import farneback
    from kalman_hydra_tpu.parallel.spatial import farneback_sharded
    import jax.numpy as jnp
    a, b, _ = pair128
    cfg = FlowConfig(levels=3, fast_warp=8, winsize=13)
    ref = np.asarray(jax.jit(lambda x, y: farneback(x, y, cfg))(
        jnp.asarray(a), jnp.asarray(b)))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("space",))
    got = farneback_sharded(a, b, cfg, mesh=mesh)
    d = np.abs(got - ref)
    assert d[8:-8, 8:-8].max() < 5e-3
    assert d.max() < 0.1


def test_sharded_farneback_bf16(pair128):
    """bf16 plane storage (the throughput configuration) composes with
    the sharded band path."""
    from kalman_hydra_tpu.ops.farneback import farneback
    from kalman_hydra_tpu.parallel.spatial import farneback_sharded
    import jax.numpy as jnp
    a, b, _ = pair128
    cfg = FlowConfig(levels=2, fast_warp=8, bf16_poly=True)
    ref = np.asarray(jax.jit(lambda x, y: farneback(x, y, cfg))(
        jnp.asarray(a), jnp.asarray(b)))
    mesh = Mesh(np.array(jax.devices()[:2]), ("space",))
    got = farneback_sharded(a, b, cfg, mesh=mesh)
    d = np.abs(got - ref)
    assert d[8:-8, 8:-8].max() < 0.05      # bf16 storage noise
    assert d.max() < 0.15


def test_sharded_farneback_requires_fast_warp(pair128):
    from kalman_hydra_tpu.parallel.spatial import farneback_sharded
    a, b, _ = pair128
    with pytest.raises(ValueError):
        farneback_sharded(a, b, FlowConfig(levels=3), mesh=Mesh(
            np.array(jax.devices()), ("space",)))


def test_api_flow_sharded(pair128):
    from kalman_hydra_tpu import api
    a, b, flow_true = pair128
    got = api.flow_sharded(a, b, FlowConfig(levels=3, fast_warp=8))
    epe = np.linalg.norm(got - flow_true, axis=-1)[12:-12, 12:-12]
    assert epe.mean() < 0.05
