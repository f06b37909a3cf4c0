"""Public API — mirrors the reference driver scripts (BASELINE.json:5:
"load video -> flow -> EKF tracks -> trajectory export")."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import jax
import jax.numpy as jnp

from .config import FlowConfig, RunConfig
from .io.export import Trajectories, save as save_tracks
from .io.video import FrameStream, PrefetchStream
from . import pipeline as _pipeline


def flow(a: np.ndarray, b: np.ndarray,
         cfg: Optional[FlowConfig] = None,
         initial: Optional[np.ndarray] = None) -> np.ndarray:
    """Dense optical flow between two grayscale frames, (H, W, 2) float32.

    Oracle-equivalent of cv2.calcOpticalFlowFarneback / dense pyramidal LK
    depending on cfg.method (SURVEY.md §3.2). Accepts uint8 or float
    frames, gray or color; [0, 1]-normalized float frames are rescaled to
    the 0..255 intensity range the solver constants assume (cv2 itself
    rejects float input outright). `initial`: optional (H, W, 2) warm
    start — cv2's OPTFLOW_USE_INITIAL_FLOW (Farneback only; it seeds the
    coarsest pyramid level, parity-tested vs the flag in
    test_farneback.py).
    """
    cfg = cfg or FlowConfig()
    from .ops.color import grayscale_u8
    a_np, b_np = np.asarray(a), np.asarray(b)
    if (a_np.dtype.kind == "f" and b_np.dtype.kind == "f"
            and max(float(a_np.max()), float(b_np.max())) <= 1.0):
        # normalized floats would otherwise hit the det + 1e-3 solve
        # regularizer ~1e8x too hard and return silently-zero flow
        a_np, b_np = a_np * 255.0, b_np * 255.0
    a_j = grayscale_u8(jnp.asarray(a_np))
    b_j = grayscale_u8(jnp.asarray(b_np))
    if cfg.method == "farneback":
        from .ops.farneback import farneback as _fb
        if initial is not None:
            out = jax.jit(_fb, static_argnames="cfg")(
                a_j, b_j, cfg, flow0=jnp.asarray(initial, jnp.float32))
        else:
            out = jax.jit(_fb, static_argnames="cfg")(a_j, b_j, cfg)
    elif cfg.method == "lk_dense":
        if initial is not None:
            raise ValueError("initial flow is a Farneback feature "
                             "(cv2.OPTFLOW_USE_INITIAL_FLOW)")
        from .ops.lk import lk_dense as _lkd
        out = jax.jit(_lkd, static_argnames="cfg")(a_j, b_j, cfg)
    else:
        raise ValueError("flow() needs a dense method")
    return np.asarray(out)


def track_video(source: Union[str, np.ndarray],
                cfg: Optional[RunConfig] = None,
                out_path: Optional[str] = None,
                streaming: bool = False,
                max_frames: Optional[int] = None) -> Trajectories:
    """Track a video file / (T, H, W[, 3]) uint8 array; optionally export.

    The reference driver's entry point (SURVEY.md §3.1)."""
    cfg = cfg or RunConfig()
    if isinstance(source, str):
        stream = FrameStream(source)
        if streaming:
            tracks = _pipeline.track_stream(
                PrefetchStream(stream, depth=4), cfg)
        else:
            frames = stream.read_all(limit=max_frames)
            tracks = _pipeline.track_clip(frames, cfg)
    else:
        frames = source if max_frames is None else source[:max_frames]
        if streaming:
            tracks = _pipeline.track_stream(iter(frames), cfg)
        else:
            tracks = _pipeline.track_clip(frames, cfg)
    if out_path:
        save_tracks(tracks, out_path)
    return tracks


def track_mesh(frames: np.ndarray, cfg: Optional[RunConfig] = None,
               mesh=None, n_vertices: int = 64, seed: int = 0,
               streaming: bool = False):
    """Track a deformable body MESH through a clip with the render channel.

    The reference's core use-case (SURVEY.md §0 orientation): segment the
    body in frame 0, mesh it (models/mesh.py), then track every vertex with
    the deformed-mesh appearance observation (models/render.py — the
    OpenGL-render analog). Pass `mesh` (BodyMesh) to skip segmentation.
    Returns (mesh, Trajectories); feed positions to
    models.mesh.mesh_strain_sequence for strain.

    cfg.ekf.measurement defaults to "render" here; "flow_render" combines
    dense flow (primary) with the render refinement. tracks.num_tracks and
    reinit are overridden to match the mesh (vertex identity is fixed).
    """
    import dataclasses
    from .config import EkfConfig
    from .models.render import make_template
    from .ops.color import grayscale_u8
    if cfg is None:
        # deformation-sized process noise: a deforming body accelerates
        # its vertices (the CV default q=0.05 is sized for rigid tracks;
        # an underpowered Q makes the NIS gate reject exactly the render
        # measurements that would correct the filter — vertices then
        # coast, lag the deformation, and die of accumulated misses)
        from .config import TrackConfig
        cfg = RunConfig(ekf=EkfConfig(measurement="render", q=0.5),
                        tracks=TrackConfig(reinit=False))
    frames = np.asarray(frames)
    gray0 = np.asarray(grayscale_u8(jnp.asarray(frames[0])))
    if mesh is None:
        from .models.mesh import mesh_from_mask
        from .ops.segment import segment_body
        mask = np.asarray(segment_body(jnp.asarray(gray0)))
        mesh = mesh_from_mask(mask, n_points=n_vertices, seed=seed)
    tmpl = make_template(gray0, mesh)
    v = mesh.vertices.shape[0]
    meas = (cfg.ekf.measurement
            if cfg.ekf.measurement in ("render", "flow_render")
            else "render")
    # one replace: ekf + tracks together, so the measurement/reinit
    # cross-field validation never sees a half-updated config
    cfg = cfg.replace(
        ekf=dataclasses.replace(cfg.ekf, measurement=meas),
        tracks=dataclasses.replace(cfg.tracks, num_tracks=v, reinit=False))
    if streaming:
        tracks = _pipeline.track_stream(iter(frames[1:]), cfg,
                                        frame0=frames[0],
                                        render_tmpl=tmpl,
                                        seeds=mesh.vertices)
    else:
        tracks = _pipeline.track_clip(frames, cfg, seeds=mesh.vertices,
                                      render_tmpl=tmpl)
    return mesh, tracks


def flow_sequence(frames, cfg: Optional[RunConfig] = None,
                  smooth: bool = False) -> np.ndarray:
    """Dense flow for each consecutive pair of a (T, H, W[, 3]) uint8 clip,
    optionally per-pixel-KF smoothed (BASELINE.json:8)."""
    cfg = cfg or RunConfig()
    from . import pipeline as pl
    return np.asarray(pl.flow_sequence(jnp.asarray(frames), cfg, smooth))


def smooth(frames_or_tracks, cfg: Optional[RunConfig] = None) -> Trajectories:
    """Run the pipeline with the RTS smoother enabled (BASELINE.json:11)."""
    cfg = (cfg or RunConfig())
    if not cfg.smooth.enabled:
        cfg = cfg.replace(smooth=cfg.smooth.__class__(enabled=True))
    return track_video(frames_or_tracks, cfg)


def flow_sharded(a: np.ndarray, b: np.ndarray,
                 cfg: Optional[FlowConfig] = None,
                 method: str = "farneback") -> np.ndarray:
    """Dense flow with frame rows sharded across the device mesh
    (SURVEY.md §2.2 spatial sharding; halo exchange by `ppermute`).

    method="farneback" requires cfg.fast_warp > 0 (bounded-halo warp).
    """
    cfg = cfg or FlowConfig(fast_warp=8)
    from .parallel.spatial import farneback_sharded, lk_dense_sharded
    if method == "farneback":
        return farneback_sharded(a, b, cfg)
    if method == "lk_dense":
        return lk_dense_sharded(a, b, cfg)
    raise ValueError(f"unknown sharded method {method!r}")


def track_videos(clips: np.ndarray, cfg: Optional[RunConfig] = None,
                 sharded: bool = False):
    """Track a (B, T, H, W[, 3]) uint8 clip batch (BASELINE.json:10).

    `sharded=True` distributes clips over the device mesh
    (data-parallel, BASELINE.json:11); otherwise a single-device vmap.
    Returns a list of Trajectories.
    """
    cfg = cfg or RunConfig()
    from .parallel import track_clips_batch, track_clips_sharded
    if sharded:
        return track_clips_sharded(clips, cfg)
    return track_clips_batch(clips, cfg)


def export(tracks: Trajectories, path: str) -> None:
    save_tracks(tracks, path)
