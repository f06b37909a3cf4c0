"""Device mesh + data-parallel clip sharding (SURVEY.md §2.2).

The reference is single-process/single-GPU; this build's first-class
parallelism is clip-batch data parallelism over the devices of one host
(BASELINE.json:11): clips are independent, so DP = `NamedSharding` of the
batch axis over a 1-D `Mesh(("data",))` — XLA emits no collectives in the
hot loop, only at the optional metric reduction (psum via `jnp.mean` over
the sharded axis). Spatial (halo-exchange) frame sharding is the TP
analog (parallel/spatial.py) — not needed at 1080p on one device.

The GPUs of one host are joined all to all by NVLink, so the mesh is a
plain 1-D device list with no topology to follow. Tested on a CPU host
faked to 8 devices (tests/conftest.py, SURVEY.md §4.4) with the same
axis names and layouts.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RunConfig
from ..io.export import Trajectories
from .. import pipeline as _pipeline


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """1-D data mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


@functools.partial(jax.jit, static_argnames=("cfg", "with_history"))
def _track_batch_jit(clips, cfg: RunConfig, with_history: bool = False,
                     seeds: Optional[jnp.ndarray] = None, render_tmpl=None):
    """vmapped multi-clip pipeline (single device, BASELINE.json:10).

    render_tmpl (RenderTemplate) is shared by every clip — vmap closes
    over it unmapped (broadcast), matching the replicated sharding the DP
    path uses."""
    if cfg.pair_batch:
        # the multi-clip pair-batched twin chains every clip's pairs into
        # one batch (clip_len) instead of vmapping per clip
        if render_tmpl is not None:
            raise ValueError(
                "pair_batch does not support the render channel "
                "(render_tmpl must be None)")
        return _pipeline.track_clips_pairflow(clips, cfg, with_history,
                                              seeds)
    fn = lambda f, s: _pipeline.track_arrays(f, cfg, with_history, s,
                                             render_tmpl)
    if seeds is None:
        return jax.vmap(lambda f: _pipeline.track_arrays(
            f, cfg, with_history, None, render_tmpl))(clips)
    return jax.vmap(fn)(clips, seeds)


def track_clips_batch(clips: np.ndarray, cfg: RunConfig,
                      seeds: Optional[np.ndarray] = None, render_tmpl=None):
    """Track a (B, T, H, W[, 3]) uint8 batch with vmap on one device.

    Returns a list of B Trajectories."""
    outs = jax.device_get(_track_batch_jit(
        jnp.asarray(clips), cfg, False,
        None if seeds is None else jnp.asarray(seeds), render_tmpl))
    return _to_trajectories(outs)


def track_clips_sharded(clips: np.ndarray, cfg: RunConfig,
                        mesh: Optional[Mesh] = None,
                        seeds: Optional[np.ndarray] = None,
                        reduce_metrics: bool = False, render_tmpl=None):
    """Data-parallel tracking: clip batch sharded over the mesh axis.

    B must be divisible by the mesh size. With `reduce_metrics`, also
    returns globally reduced filter-health metrics (mean NIS, live-track
    fraction per frame) — the only cross-device communication
    (SURVEY.md §5 "Distributed communication backend"). `render_tmpl`
    (one RenderTemplate shared by all clips — e.g. chunks of one long
    recording of the same meshed body) is REPLICATED over the mesh; the
    per-clip render channel then runs collective-free like the rest of
    the DP hot loop.
    """
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    B = clips.shape[0]
    if B % mesh.size != 0:
        raise ValueError(f"batch {B} not divisible by mesh size {mesh.size}")

    data_sharding = NamedSharding(mesh, P(axis))
    clips_d = jax.device_put(jnp.asarray(clips), data_sharding)
    seeds_d = (None if seeds is None
               else jax.device_put(jnp.asarray(seeds), data_sharding))
    tmpl_d = (None if render_tmpl is None
              else jax.device_put(render_tmpl, NamedSharding(mesh, P())))

    if cfg.pair_batch:
        # the DP path shard_maps the multi-clip pairflow pipeline: each
        # device chains its LOCAL clip shard into one pair batch
        # (track_clips_pairflow's clip_len chaining). RunConfig
        # validation only constrains ekf.measurement, not the template
        # arg itself — reject a stray template loudly rather than
        # silently ignoring it.
        if render_tmpl is not None:
            raise ValueError(
                "pair_batch does not support the render channel "
                "(render_tmpl must be None)")
        outs, metrics = _track_sharded_pairflow(
            clips_d, cfg, mesh, axis, seeds_d, reduce_metrics)
    else:
        outs, metrics = _track_sharded_jit(clips_d, cfg, reduce_metrics,
                                           seeds_d, tmpl_d)
    trajs = _to_trajectories(jax.device_get(outs))
    if reduce_metrics:
        return trajs, jax.device_get(metrics)
    return trajs


@functools.lru_cache(maxsize=32)
def _pairflow_sharded_fn(cfg: RunConfig, mesh: Mesh, axis: str,
                         has_seeds: bool, reduce_metrics: bool):
    """Build (and cache) the jitted shard_map'd pairflow pipeline.

    Module-level cache keyed on the static configuration so repeated
    calls hit the jit trace/executable cache instead of retracing —
    mirrors _track_batch_jit / _track_sharded_jit, which get this for
    free from jax.jit's own cache.
    """
    def local(clips, seeds=None):
        outs = _pipeline.track_clips_pairflow(clips, cfg, False, seeds)
        if not reduce_metrics:
            # collective-free hot loop when metrics are not requested
            return outs, None
        metrics = {
            "mean_nis": jax.lax.pmean(jnp.mean(outs["nis"]), axis),
            "live_fraction": jax.lax.pmean(
                jnp.mean(outs["alive"].astype(jnp.float32), axis=(0, 2)),
                axis),
        }
        return outs, metrics

    metrics_spec = P() if reduce_metrics else None
    # check_vma=False: the EKF scan's initial carry (seeded from frame 0's
    # corner pool) is built from constants the varying-mesh-axes check
    # types as replicated, while the scan body's output varies over the
    # data axis, so the checked scan refuses equal carries. Every value
    # here is per-device by construction (P(axis) in, P(axis) out).
    if not has_seeds:
        return jax.jit(jax.shard_map(
            lambda c: local(c), mesh=mesh, in_specs=(P(axis),),
            out_specs=(P(axis), metrics_spec), check_vma=False))
    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), metrics_spec), check_vma=False))


def _track_sharded_pairflow(clips_d, cfg: RunConfig, mesh: Mesh, axis: str,
                            seeds_d=None, reduce_metrics: bool = False):
    """DP-sharded pair-batched pipeline: shard_map of the multi-clip
    pairflow path over the data mesh (one pair batch per device, clips
    chained via clip_len). Metrics (when requested) are pmean-reduced
    over the mesh axis — the DP path's only collective."""
    fn = _pairflow_sharded_fn(cfg, mesh, axis, seeds_d is not None,
                              reduce_metrics)
    if seeds_d is None:
        return fn(clips_d)
    return fn(clips_d, seeds_d)


@functools.partial(jax.jit, static_argnames=("cfg", "reduce_metrics"))
def _track_sharded_jit(clips_in, cfg: RunConfig, reduce_metrics: bool,
                       seeds_in=None, render_tmpl=None):
    if seeds_in is None:
        outs = jax.vmap(lambda f: _pipeline.track_arrays(
            f, cfg, False, None, render_tmpl))(clips_in)
    else:
        outs = jax.vmap(lambda f, s: _pipeline.track_arrays(
            f, cfg, False, s, render_tmpl))(clips_in, seeds_in)
    if reduce_metrics:
        # the only cross-device reduction in the DP path: XLA inserts the
        # psum/all-reduce over the sharded batch axis here
        metrics = {
            "mean_nis": jnp.mean(outs["nis"]),
            "live_fraction": jnp.mean(
                outs["alive"].astype(jnp.float32), axis=(0, 2)),
        }
        return outs, metrics
    return outs, None


def _to_trajectories(outs) -> list:
    B = outs["pos"].shape[0]
    return [Trajectories(positions=np.asarray(outs["pos"][b]),
                         alive=np.asarray(outs["alive"][b]),
                         nis=np.asarray(outs["nis"][b]),
                         track_id=np.asarray(outs["track_id"][b]),
                         smoothed=(np.asarray(outs["smoothed"][b])
                                   if "smoothed" in outs else None))
            for b in range(B)]
