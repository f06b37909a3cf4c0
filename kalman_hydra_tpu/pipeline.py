"""Jitted tracking pipeline: the device-resident hot loop.

Target stack of SURVEY.md §3.1: one XLA program per frame step —
grayscale -> dense flow -> sample at tracks -> batched EKF update -> gate ->
re-seed — scanned over the clip with `lax.scan`. Frame data never returns
to host between decode and trajectory output (BASELINE.json:5); only the
per-frame track rows (K x state) leave the device.

Two drivers:
  * `track_clip`: whole clip in HBM, single `jit(scan)` — the benchmark
    path (max throughput, BASELINE.json:10).
  * `track_stream`: python loop over a host frame iterator with one
    `device_put` per frame — the long-video / bounded-memory path
    (SURVEY.md §5 long-context: O(1) device memory in clip length).
"""

from __future__ import annotations

import functools
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .config import RunConfig
from .io.export import Trajectories
from .models import dynamics, lifecycle
from .models.ekf import TrackState, ekf_step, init_tracks
from .models.rts import rts_smooth
from .ops import lk as lk_ops
from .ops.color import grayscale_u8
from .ops.farneback import farneback
from .ops.features import corner_pool


class Carry(NamedTuple):
    tracks: TrackState
    prev_gray: jnp.ndarray  # (H, W) float32
    prev_rpyr: Tuple = ()   # cached Farneback polyexp pyramid (per level)
    corner_cache: Tuple = ()  # (pts, score) pool reused between refreshes
    frame_idx: jnp.ndarray = None  # int32 step counter (reinit_every)
    lag_buf: Tuple = ()     # (xf, Pf, xp, Pp, tid, alive) windows, oldest
    #                         first — only when SmoothConfig.lag > 0
    prev_flow: jnp.ndarray = None  # (H, W, 2) previous pair's flow — only
    #                                when FlowConfig.temporal_init


def _lag_buf_init(state: TrackState, lag: int) -> Tuple:
    """Prime the fixed-lag window with the seed state replicated: same
    track ids + alive mask everywhere => no artificial segment breaks."""
    rep = lambda a: jnp.broadcast_to(a[None], (lag + 1,) + a.shape)
    return (rep(state.x), rep(state.P), rep(state.x), rep(state.P),
            rep(state.track_id), rep(state.alive))


def _lag_buf_push(buf: Tuple, state: TrackState, x_pred, P_pred) -> Tuple:
    new = (state.x, state.P, x_pred, P_pred, state.track_id, state.alive)
    return tuple(jnp.concatenate([b[1:], n[None]], axis=0)
                 for b, n in zip(buf, new))


def _flow_field(prev_gray, gray, cfg: RunConfig):
    if cfg.flow.method == "farneback":
        return farneback(prev_gray, gray, cfg.flow)
    if cfg.flow.method == "lk_dense":
        return lk_ops.lk_dense(prev_gray, gray, cfg.flow)
    raise ValueError(f"dense flow required, got {cfg.flow.method!r}")


def _prime_init_velocity(carry0: "Carry", frame1, cfg: RunConfig) -> "Carry":
    """Prime track velocities with the frame0->frame1 flow at the seeds:
    the filter starts converged instead of dead-reckoning from v=0
    (TrackConfig.init_velocity). Shared by track_arrays and
    track_stream's fresh start so the two drivers stay trajectory-
    identical. Reuses frame 0's cached polyexp pyramid when the flow
    method carries one (the photometric channel doesn't -> dense
    fallback)."""
    from .ops.warp import sample_flow
    gray1 = grayscale_u8(frame1)
    if cfg.flow.method == "farneback" and carry0.prev_rpyr:
        from .ops.farneback import farneback_from_pyramids, polyexp_pyramid
        rpyr1 = polyexp_pyramid(gray1, cfg.flow)
        flow01 = farneback_from_pyramids(carry0.prev_rpyr, rpyr1, cfg.flow)
    else:
        flow01 = _flow_field(carry0.prev_gray, gray1, cfg)
    v0 = sample_flow(flow01, carry0.tracks.x[:, 0:2]) / cfg.ekf.dt
    x0 = carry0.tracks.x.at[:, 2:4].set(v0)
    return carry0._replace(tracks=carry0.tracks._replace(x=x0))


def _fresh_corner_pool(gray, cfg: RunConfig):
    """Corner pool exactly as the per-frame step refreshes it
    (seed_in_body mask included) — shared by the step, init_from_frame's
    reinit cache, and resume's cache fallback, so early-frame and
    post-resume reseeds can't silently come from off-body corners."""
    mask = None
    if cfg.tracks.seed_in_body:
        from .ops.segment import segment_body
        mask = segment_body(gray)
    return corner_pool(gray, cfg.tracks, mask=mask)


def _needs_render_tmpl(cfg: RunConfig) -> bool:
    return cfg.ekf.measurement in ("render", "flow_render")


def make_step(cfg: RunConfig, render_tmpl=None):
    """Build the per-frame step function (closed over static config).

    `render_tmpl`: RenderTemplate for the mesh-render measurement channels
    (models/render.py); required iff cfg.ekf.measurement is "render" /
    "flow_render"."""
    F = jnp.asarray(dynamics.transition(cfg.ekf))
    Q = jnp.asarray(dynamics.process_noise(cfg.ekf))
    R = jnp.asarray(cfg.ekf.r * np.eye(2, dtype=np.float32))
    if _needs_render_tmpl(cfg) and render_tmpl is None:
        raise ValueError(
            f"ekf.measurement={cfg.ekf.measurement!r} needs a "
            "RenderTemplate (models.render.make_template) passed as "
            "render_tmpl — see api.track_mesh")
    if (render_tmpl is not None
            and render_tmpl.rest.shape[0] != cfg.tracks.num_tracks):
        raise ValueError(
            f"render template has {render_tmpl.rest.shape[0]} vertices but "
            f"tracks.num_tracks={cfg.tracks.num_tracks}; the track pool IS "
            "the vertex set (seed with mesh.vertices)")

    def step(carry: Carry, frame):
        gray = grayscale_u8(frame)
        h, w = gray.shape

        if cfg.ekf.measurement == "render":
            # deformed-mesh appearance channel (the reference's OpenGL
            # render observation): reads the frame directly, no dense flow
            from .models.render import render_step
            state, aux = render_step(carry.tracks, gray, cfg.ekf, F, Q,
                                     render_tmpl)
        elif cfg.ekf.measurement == "photometric":
            # appearance-only channel (render-residual analog): reads the
            # frames directly, no dense flow — survives flow dropout
            from .models.photometric import photometric_step
            state, aux = photometric_step(carry.tracks, carry.prev_gray,
                                          gray, cfg.ekf, F, Q)
        elif cfg.flow.method == "lk_sparse":
            pos = carry.tracks.x[:, 0:2]
            lk_cache = lk_ops.lk_pyramid(gray, cfg.flow)
            prev_cache = carry.prev_rpyr or None
            new_pts, ok = lk_ops.lk_sparse(
                carry.prev_gray, gray, pos, cfg.flow,
                prev_pyr=prev_cache, next_pyr=lk_cache)
            state = carry.tracks
            x_pred, P_pred = _predict_only(state, F, Q)
            z = pos + (new_pts - pos)  # = new_pts; kept explicit for clarity
            y = z - x_pred[:, 0:2]
            from .models.ekf import commit_update, update as kf_update
            Hm = jnp.asarray(dynamics.position_H(cfg.ekf))
            x_new, P_new, nis = kf_update(x_pred, P_pred, y, Hm, R)
            # ok=False (LK lost the point) counts as a MISS via the
            # shared commit so the lifecycle gate can recycle the slot
            state, aux = commit_update(state, x_pred, P_pred, x_new,
                                       P_new, nis, cfg.ekf, valid=ok)
        elif cfg.flow.method == "farneback":
            # reuse the cached polyexp pyramid of the previous frame
            # (each frame's polyexp is computed once, not twice)
            from .ops.farneback import (farneback_from_pyramids,
                                        polyexp_pyramid)
            rpyr = polyexp_pyramid(gray, cfg.flow)
            flow = farneback_from_pyramids(carry.prev_rpyr, rpyr, cfg.flow,
                                           flow0=carry.prev_flow)
            with jax.named_scope("ekf"):
                state, aux = ekf_step(carry.tracks, flow, cfg.ekf, F, Q, R)
        else:
            flow = _flow_field(carry.prev_gray, gray, cfg)
            with jax.named_scope("ekf"):
                state, aux = ekf_step(carry.tracks, flow, cfg.ekf, F, Q, R)
        if cfg.ekf.measurement == "flow_photometric":
            # (lk_sparse + flow_photometric is rejected at config time)
            # second sequential measurement: photometric refinement of the
            # flow-updated state (SURVEY.md §2.1 #3 "flow as an additional
            # measurement channel" — here flow is primary, appearance second)
            from .models.photometric import photometric_refine
            state, aux = photometric_refine(state, aux, carry.prev_gray,
                                            gray, carry.tracks.x[:, 0:2],
                                            cfg.ekf)
        elif cfg.ekf.measurement == "flow_render":
            # flow primary + mesh-render refinement (SURVEY.md §2.1 #3:
            # "flow as an additional measurement channel" — the render
            # model is the reference's primary observation)
            from .models.render import render_refine
            state, aux = render_refine(state, aux, gray, cfg.ekf,
                                       render_tmpl)

        state = lifecycle.gate(state, aux["x_pred"], aux["P_pred"],
                               aux["nis"], cfg.ekf)
        state = lifecycle.kill_lost(state, cfg.ekf, h, w)
        corner_cache = carry.corner_cache
        frame_idx = (carry.frame_idx + 1
                     if carry.frame_idx is not None else None)
        if cfg.tracks.reinit:
            def fresh_pool(g):
                with jax.named_scope("corner_pool"):
                    return _fresh_corner_pool(g, cfg)

            if cfg.tracks.reinit_every <= 1 or not corner_cache:
                cpts, cscore = fresh_pool(gray)
            else:
                refresh = (frame_idx % cfg.tracks.reinit_every) == 0
                cpts, cscore = lax.cond(
                    refresh, lambda g: fresh_pool(g),
                    lambda g: corner_cache, gray)
                # keep the carry pytree structure stable: only the caching
                # mode stores the pool in the carry
                corner_cache = (cpts, cscore)
            state = lifecycle.reseed(state, cpts, cscore, cfg.ekf, cfg.tracks)

        out = {
            "pos": state.x[:, 0:2],
            "alive": state.alive,
            "nis": aux["nis"],
            "track_id": state.track_id,
            "x_filt": state.x,
            "P_filt": state.P,
            "x_pred": aux["x_pred"],
            "P_pred": aux["P_pred"],
        }
        lag_buf = carry.lag_buf
        if cfg.smooth.enabled and cfg.smooth.lag > 0:
            # online fixed-lag smoothing: push this frame into the window,
            # emit the smoothed state of the frame leaving it (frame
            # t - lag). Only (K, 2) crosses to host per frame.
            from .models.rts import fixed_lag_smooth
            lag_buf = _lag_buf_push(lag_buf, state, aux["x_pred"],
                                    aux["P_pred"])
            xs0, _Ps0 = fixed_lag_smooth(F, *lag_buf)
            out["smoothed_lag"] = xs0[:, 0:2]
        if cfg.ekf.measurement in ("photometric", "render"):
            new_rpyr = carry.prev_rpyr      # no flow pyramids in this mode
        elif cfg.flow.method == "farneback":
            new_rpyr = rpyr
        elif cfg.flow.method == "lk_sparse":
            new_rpyr = lk_cache
        else:
            new_rpyr = carry.prev_rpyr
        prev_flow = carry.prev_flow
        if prev_flow is not None:
            # temporal warm start: this pair's flow seeds the next pair's
            # coarsest level (only set when the farneback branch ran —
            # init_from_frame gates on method + measurement)
            prev_flow = flow
        return Carry(tracks=state, prev_gray=gray, prev_rpyr=new_rpyr,
                     corner_cache=corner_cache, frame_idx=frame_idx,
                     lag_buf=lag_buf, prev_flow=prev_flow), out

    return step


def _predict_only(state: TrackState, F, Q):
    from .models.ekf import predict
    return predict(state.x, state.P, F, Q, q_scale=state.q_scale)


def init_from_frame(frame0, cfg: RunConfig) -> Carry:
    """Seed the track pool from frame 0's corner pool (optionally
    restricted to the segmented body)."""
    gray0 = grayscale_u8(frame0)
    mask = None
    if cfg.tracks.seed_in_body:
        from .ops.segment import segment_body
        mask = segment_body(gray0)
    pts, score = corner_pool(gray0, cfg.tracks,
                             pool_size=cfg.tracks.num_tracks, mask=mask)
    state = init_tracks(cfg.ekf, pts, valid=score > 0)
    rpyr = ()
    if cfg.ekf.measurement in ("photometric", "render"):
        pass                                 # no flow pyramids in this mode
    elif cfg.flow.method == "farneback":
        from .ops.farneback import polyexp_pyramid
        rpyr = polyexp_pyramid(gray0, cfg.flow)
    elif cfg.flow.method == "lk_sparse":
        rpyr = lk_ops.lk_pyramid(gray0, cfg.flow)
    corner_cache = ()
    if cfg.tracks.reinit and cfg.tracks.reinit_every > 1:
        corner_cache = _fresh_corner_pool(gray0, cfg)
    lag_buf = (_lag_buf_init(state, cfg.smooth.lag)
               if cfg.smooth.enabled and cfg.smooth.lag > 0 else ())
    prev_flow = None
    if (cfg.flow.temporal_init and cfg.flow.method == "farneback"
            and cfg.ekf.measurement not in ("photometric", "render")):
        # pair 0->1 is a cold start (zeros == cv2 USE_INITIAL_FLOW with a
        # zero field)
        prev_flow = jnp.zeros(gray0.shape + (2,), jnp.float32)
    return Carry(tracks=state, prev_gray=gray0, prev_rpyr=rpyr,
                 corner_cache=corner_cache,
                 frame_idx=jnp.int32(0), lag_buf=lag_buf,
                 prev_flow=prev_flow)


def track_arrays(frames, cfg: RunConfig, with_history: bool = False,
                 seeds: Optional[jnp.ndarray] = None, render_tmpl=None):
    """Pure traced pipeline on a (T, H, W[, 3]) frame array -> output dict.

    The functional core shared by the jitted single-clip driver, the
    multi-clip vmap batch (BASELINE.json:10), and the sharded data-parallel
    path (BASELINE.json:11, parallel/mesh.py).
    """
    if cfg.pair_batch:
        return track_arrays_pairflow(frames, cfg, with_history, seeds)
    carry0 = init_from_frame(frames[0], cfg)
    if seeds is not None:
        # _replace keeps corner_cache/frame_idx so reinit_every>1 caching
        # stays active with explicit seeds
        carry0 = carry0._replace(tracks=init_tracks(cfg.ekf, seeds))
    if cfg.tracks.init_velocity:
        carry0 = _prime_init_velocity(carry0, frames[1], cfg)
    if carry0.lag_buf and (seeds is not None or cfg.tracks.init_velocity):
        # the fixed-lag window was primed from the corner-pool state in
        # init_from_frame; re-prime it from the (replaced) seed state so
        # the first emissions don't smooth through stale entries
        carry0 = carry0._replace(
            lag_buf=_lag_buf_init(carry0.tracks, cfg.smooth.lag))
    step = make_step(cfg, render_tmpl=render_tmpl)
    carry, outs = lax.scan(step, carry0, frames[1:])
    return _finalize_track_outputs(carry0.tracks, carry.lag_buf, outs,
                                   cfg, with_history)


def _finalize_track_outputs(state0: TrackState, final_lag_buf, outs,
                            cfg: RunConfig, with_history: bool):
    """Prepend the frame-0 row and run the configured smoother — the
    output tail shared by the per-frame scan and the pair-batched
    pipeline (their scans emit identical per-step dicts)."""
    # prepend the frame-0 row
    first = {
        "pos": state0.x[:, 0:2],
        "alive": state0.alive,
        "nis": jnp.zeros_like(outs["nis"][0]),
        "track_id": state0.track_id,
        "x_filt": state0.x,
        "P_filt": state0.P,
        "x_pred": state0.x,
        "P_pred": state0.P,
        "smoothed_lag": state0.x[:, 0:2],
    }
    first = {k: first[k] for k in outs}
    outs = {k: jnp.concatenate([first[k][None], v], axis=0)
            for k, v in outs.items()}
    if cfg.smooth.enabled and cfg.smooth.lag > 0:
        # fixed-lag mode: the scan already smoothed each frame as it left
        # the window — assemble instead of running a second full RTS.
        # Frames T-1-lag..T-1 come from one RTS over the final window.
        L = cfg.smooth.lag
        T = outs["pos"].shape[0]
        F = jnp.asarray(dynamics.transition(cfg.ekf))
        xf, Pf, xp, Pp, tid_b, alive_b = final_lag_buf
        brk = (tid_b[1:] != tid_b[:-1]) | ~alive_b[1:] | ~alive_b[:-1]
        xs_tail, _ = rts_smooth(F, xf, Pf, xp, Pp, breaks=brk)
        # window entry i <-> frame (T-1-L+i): frames 0..T-1-L come from
        # the per-step emissions (step t smoothed frame t-L), the last L
        # frames from the final window's tail
        if T > L:
            sm = jnp.concatenate([outs["smoothed_lag"][L:],
                                  xs_tail[1:, :, 0:2]], axis=0)
        else:
            sm = xs_tail[L + 1 - T:, :, 0:2]
        outs["smoothed"] = sm
    elif cfg.smooth.enabled:
        # RTS on device (the P history never leaves device memory) with
        # segment breaks at re-seeds / dead frames
        tid = outs["track_id"]
        alive = outs["alive"]
        breaks = (tid[1:] != tid[:-1]) | ~alive[1:] | ~alive[:-1]
        F = jnp.asarray(dynamics.transition(cfg.ekf))
        xs, _Ps = rts_smooth(F, outs["x_filt"], outs["P_filt"],
                             outs["x_pred"], outs["P_pred"], breaks=breaks)
        outs["smoothed"] = xs[..., 0:2]
    if not with_history:
        outs = {k: v for k, v in outs.items()
                if k in ("pos", "alive", "nis", "track_id", "smoothed")}
    return outs


class FlowCarry(NamedTuple):
    """Scan carry of the pair-batched pipeline: flow is precomputed, so
    no frame/pyramid state rides along — just the filter pool and the
    optional fixed-lag smoother window."""
    tracks: TrackState
    lag_buf: Tuple = ()


def make_flow_scan_step(cfg: RunConfig):
    """Per-frame EKF/lifecycle step over a PRECOMPUTED dense flow field
    (+ the corner pool that frame would refresh/reuse): the pair-batched
    pipeline's scan body. Same math and update order as make_step's
    farneback branch — only the flow computation moved out of the scan."""
    F = jnp.asarray(dynamics.transition(cfg.ekf))
    Q = jnp.asarray(dynamics.process_noise(cfg.ekf))
    R = jnp.asarray(cfg.ekf.r * np.eye(2, dtype=np.float32))

    def step(carry: FlowCarry, inp):
        if cfg.tracks.reinit:
            flow, cpts, cscore = inp
        else:
            (flow,) = inp
        h, w = flow.shape[0], flow.shape[1]
        state, aux = ekf_step(carry.tracks, flow, cfg.ekf, F, Q, R)
        state = lifecycle.gate(state, aux["x_pred"], aux["P_pred"],
                               aux["nis"], cfg.ekf)
        state = lifecycle.kill_lost(state, cfg.ekf, h, w)
        if cfg.tracks.reinit:
            state = lifecycle.reseed(state, cpts, cscore, cfg.ekf,
                                     cfg.tracks)
        out = {
            "pos": state.x[:, 0:2],
            "alive": state.alive,
            "nis": aux["nis"],
            "track_id": state.track_id,
            "x_filt": state.x,
            "P_filt": state.P,
            "x_pred": aux["x_pred"],
            "P_pred": aux["P_pred"],
        }
        lag_buf = carry.lag_buf
        if cfg.smooth.enabled and cfg.smooth.lag > 0:
            from .models.rts import fixed_lag_smooth
            lag_buf = _lag_buf_push(lag_buf, state, aux["x_pred"],
                                    aux["P_pred"])
            xs0, _Ps0 = fixed_lag_smooth(F, *lag_buf)
            out["smoothed_lag"] = xs0[:, 0:2]
        return FlowCarry(tracks=state, lag_buf=lag_buf), out

    return step


def _corner_pool_sequence(grays, cfg: RunConfig):
    """Corner pools for scan steps t = 1..T-1 of the pair-batched
    pipeline: exactly the pool make_step would hold at each step
    (refreshed when t % reinit_every == 0, otherwise the most recent
    refresh — frame 0's pool is init_from_frame's cache). The distinct
    refresh frames are computed batched (vmapped Shi-Tomasi), then
    gathered per step."""
    T = grays.shape[0]
    re = max(cfg.tracks.reinit_every, 1)
    refresh = sorted({(t // re) * re for t in range(1, T)})
    pools = jax.vmap(lambda g: _fresh_corner_pool(g, cfg))(
        grays[np.asarray(refresh)])
    pos = {f: i for i, f in enumerate(refresh)}
    sel = np.asarray([pos[(t // re) * re] for t in range(1, T)])
    return tuple(p[sel] for p in pools)          # each (T-1, ...)


def track_arrays_pairflow(frames, cfg: RunConfig,
                          with_history: bool = False,
                          seeds: Optional[jnp.ndarray] = None):
    """Pair-batched twin of track_arrays (RunConfig.pair_batch):

      1. dense flow for EVERY consecutive frame pair, batched over pairs
         (ops.farneback.farneback_pairs_from_pyramids);
      2. corner pools for the refresh frames, batched;
      3. one EKF/lifecycle scan over the precomputed fields.

    Trajectory semantics match track_arrays for cold dense-flow configs
    (enforced by RunConfig validation; tested in
    tests/integration/test_pairflow.py)."""
    grays = grayscale_u8(frames)
    if cfg.flow.method == "farneback":
        from .ops.farneback import (farneback_pairs_from_pyramids,
                                    polyexp_pyramid_batch)
        Rs = polyexp_pyramid_batch(grays, cfg.flow)
        flows = farneback_pairs_from_pyramids(Rs, cfg.flow)
    else:                                         # lk_dense
        flows = jax.vmap(lambda a, b: lk_ops.lk_dense(a, b, cfg.flow))(
            grays[:-1], grays[1:])
    return _track_from_pair_flows(grays, flows, cfg, with_history, seeds)


def track_clips_pairflow(frames_b, cfg: RunConfig,
                         with_history: bool = False,
                         seeds: Optional[jnp.ndarray] = None):
    """Multi-clip pair-batched pipeline (BASELINE.json:10 "multi-clip
    batch"): a (B, T, H, W[, 3]) clip stack runs dense flow for ALL
    B*(T-1) frame pairs as one batch — the frames chain as one (B*T)
    stack with `clip_len=T` so no pair straddles a clip boundary — then
    the per-clip EKF/lifecycle scans run under vmap.

    Per-clip trajectories match track_arrays on each clip
    (tests/integration/test_pairflow.py)."""
    B, T = frames_b.shape[0], frames_b.shape[1]
    grays_b = grayscale_u8(frames_b)
    if cfg.flow.method == "farneback":
        from .ops.farneback import (farneback_pairs_from_pyramids,
                                    polyexp_pyramid_batch)
        flat = grays_b.reshape((B * T,) + grays_b.shape[2:])
        Rs = polyexp_pyramid_batch(flat, cfg.flow)
        flows = farneback_pairs_from_pyramids(Rs, cfg.flow, clip_len=T)
        flows_b = flows.reshape((B, T - 1) + flows.shape[1:])
    else:                                         # lk_dense
        flows_b = jax.vmap(jax.vmap(
            lambda a, b: lk_ops.lk_dense(a, b, cfg.flow)))(
            grays_b[:, :-1], grays_b[:, 1:])
    fn = functools.partial(_track_from_pair_flows, cfg=cfg,
                           with_history=with_history)
    if seeds is not None and seeds.ndim == 2:
        seeds = jnp.broadcast_to(seeds, (B,) + seeds.shape)
    if seeds is not None:
        return jax.vmap(lambda g, f, s: fn(g, f, seeds=s))(
            grays_b, flows_b, seeds)
    return jax.vmap(lambda g, f: fn(g, f))(grays_b, flows_b)


def _track_from_pair_flows(grays, flows, cfg: RunConfig,
                           with_history: bool = False,
                           seeds: Optional[jnp.ndarray] = None):
    """Shared tail of the pair-batched pipelines: corner pools at the
    refresh cadence + one EKF/lifecycle scan over precomputed flows."""
    # ---- init (mirrors init_from_frame minus the flow pyramids) ----
    gray0 = grays[0]
    mask = None
    if cfg.tracks.seed_in_body:
        from .ops.segment import segment_body
        mask = segment_body(gray0)
    pts, score = corner_pool(gray0, cfg.tracks,
                             pool_size=cfg.tracks.num_tracks, mask=mask)
    state0 = init_tracks(cfg.ekf, pts, valid=score > 0)
    if seeds is not None:
        state0 = init_tracks(cfg.ekf, seeds)
    if cfg.tracks.init_velocity:
        from .ops.warp import sample_flow
        v0 = sample_flow(flows[0], state0.x[:, 0:2]) / cfg.ekf.dt
        state0 = state0._replace(x=state0.x.at[:, 2:4].set(v0))
    lag_buf = (_lag_buf_init(state0, cfg.smooth.lag)
               if cfg.smooth.enabled and cfg.smooth.lag > 0 else ())
    carry0 = FlowCarry(tracks=state0, lag_buf=lag_buf)

    if cfg.tracks.reinit:
        cpts, cscore = _corner_pool_sequence(grays, cfg)
        xs = (flows, cpts, cscore)
    else:
        xs = (flows,)
    step = make_flow_scan_step(cfg)
    carry, outs = lax.scan(step, carry0, xs)
    return _finalize_track_outputs(carry0.tracks, carry.lag_buf, outs,
                                   cfg, with_history)


@functools.partial(jax.jit, static_argnames=("cfg", "with_history"))
def _track_clip_jit(frames, cfg: RunConfig, with_history: bool,
                    seeds: Optional[jnp.ndarray] = None, render_tmpl=None):
    # (uint8 frames can't alias any float output, so donation would be a
    # no-op with a warning — XLA frees the buffer after grayscale anyway)
    return track_arrays(frames, cfg, with_history, seeds, render_tmpl)


@functools.partial(jax.jit, static_argnames=("cfg", "smooth"))
def flow_sequence(frames, cfg: RunConfig, smooth: bool = False):
    """Dense flow for every consecutive frame pair of a (T, H, W[, 3])
    clip -> (T-1, H, W, 2), optionally per-pixel-KF smoothed
    (BASELINE.json:8 config 2). One jitted scan; frames stay in HBM.
    """
    grays = grayscale_u8(frames)

    if cfg.pair_batch and cfg.flow.method == "farneback":
        # pair-batched front end (RunConfig.pair_batch): all T-1 pairs
        # computed as one batch, as in track_arrays_pairflow; per-pair
        # math identical to the scan below (cold per-pair mode only —
        # RunConfig validation already rejects temporal_init with
        # pair_batch)
        from .ops.farneback import (farneback_pairs_from_pyramids,
                                    polyexp_pyramid_batch)
        Rs = polyexp_pyramid_batch(grays, cfg.flow)
        flows = farneback_pairs_from_pyramids(Rs, cfg.flow)
    elif cfg.pair_batch:                          # lk_dense
        flows = jax.vmap(lambda a, b: lk_ops.lk_dense(a, b, cfg.flow))(
            grays[:-1], grays[1:])
    elif cfg.flow.method == "farneback":
        # carry the cached polyexp pyramid so each interior frame is
        # expanded ONCE, not twice (same caching contract as make_step;
        # a per-pair farneback() call recomputed frame t's polyexp as
        # 'prev' at step t+1)
        from .ops.farneback import farneback_from_pyramids, polyexp_pyramid

        def body(c, gray):
            rpyr_prev, fl_prev = c
            rpyr = polyexp_pyramid(gray, cfg.flow)
            fl = farneback_from_pyramids(rpyr_prev, rpyr, cfg.flow,
                                         flow0=fl_prev)
            return (rpyr, fl if fl_prev is not None else None), fl

        rpyr0 = polyexp_pyramid(grays[0], cfg.flow)
        # temporal_init: chain each pair's flow into the next pair's
        # coarsest-level init (pair 0 cold-starts from zeros)
        fl0 = (jnp.zeros(grays[0].shape + (2,), jnp.float32)
               if cfg.flow.temporal_init else None)
        _, flows = lax.scan(body, (rpyr0, fl0), grays[1:])
    else:
        def body(prev_gray, gray):
            fl = _flow_field(prev_gray, gray, cfg)
            return gray, fl

        _, flows = lax.scan(body, grays[0], grays[1:])
    if smooth:
        from .models.pixel_ekf import PixelEkfParams, smooth_flow_sequence
        flows = smooth_flow_sequence(flows, PixelEkfParams())
    return flows


@functools.partial(jax.jit, static_argnames=("cfg",))
def _track_flows_jit(flows, seeds, cfg: RunConfig):
    F = jnp.asarray(dynamics.transition(cfg.ekf))
    Q = jnp.asarray(dynamics.process_noise(cfg.ekf))
    R = jnp.asarray(cfg.ekf.r * np.eye(2, dtype=np.float32))
    state0 = init_tracks(cfg.ekf, seeds)

    def step(state, flow):
        state, aux = ekf_step(state, flow, cfg.ekf, F, Q, R)
        state = lifecycle.gate(state, aux["x_pred"], aux["P_pred"],
                               aux["nis"], cfg.ekf)
        state = lifecycle.kill_lost(state, cfg.ekf,
                                    flow.shape[0], flow.shape[1])
        return state, {"pos": state.x[:, 0:2], "alive": state.alive,
                       "nis": aux["nis"], "track_id": state.track_id}

    _, outs = lax.scan(step, state0, flows)
    first = {"pos": state0.x[:, 0:2], "alive": state0.alive,
             "nis": jnp.zeros_like(outs["nis"][0]),
             "track_id": state0.track_id}
    return {k: jnp.concatenate([first[k][None], v]) for k, v in outs.items()}


def track_precomputed_flow(flows: np.ndarray, seeds: np.ndarray,
                           cfg: RunConfig) -> Trajectories:
    """Track from a PRECOMPUTED (T-1, H, W, 2) flow sequence — the
    reference's precomputed-flow-reader path (SURVEY.md §2.1 #8): no flow
    computation, just the EKF stack over supplied fields. Re-seeding is
    unavailable (no frames for the corner pool); gating/kill still apply.
    """
    outs = jax.device_get(_track_flows_jit(
        jnp.asarray(flows), jnp.asarray(seeds), cfg))
    return Trajectories(positions=np.asarray(outs["pos"]),
                        alive=np.asarray(outs["alive"]),
                        nis=np.asarray(outs["nis"]),
                        track_id=np.asarray(outs["track_id"]))


def track_clip(frames: np.ndarray, cfg: RunConfig,
               seeds: Optional[np.ndarray] = None,
               with_history: bool = False, render_tmpl=None) -> Trajectories:
    """Track a whole (T, H, W[, 3]) uint8 clip on device.

    `seeds`: optional (num_tracks, 2) positions overriding corner seeding
    (used by parity tests to pin both pipelines to the same tracks).
    `render_tmpl`: RenderTemplate for the mesh-render measurement channels.
    `with_history` is accepted for backward compatibility but has no
    effect: Trajectories never carries filter history (use
    `track_arrays(..., with_history=True)` for raw x/P histories).
    """
    frames_d = jnp.asarray(frames)
    seeds_d = None if seeds is None else jnp.asarray(seeds)
    if (cfg.smooth.enabled and cfg.smooth.chunk > 0
            and cfg.smooth.lag == 0):
        # host-chunked smoothing (SmoothConfig.chunk > 0, and lag takes
        # precedence when both are set — same rule as track_stream): run
        # the filter
        # with history, offload it, smooth O(chunk) on device — the
        # long-horizon memory plan (SURVEY.md §3.4). Monolithic on-device
        # RTS (chunk == 0) stays the throughput path.
        import dataclasses
        filt_cfg = cfg.replace(
            smooth=dataclasses.replace(cfg.smooth, enabled=False))
        outs = jax.device_get(
            _track_clip_jit(frames_d, filt_cfg, True, seeds_d, render_tmpl))
        outs["smoothed"] = _smooth_history_chunked(outs, cfg)[..., 0:2]
        if not with_history:
            outs = {k: v for k, v in outs.items()
                    if k in ("pos", "alive", "nis", "track_id", "smoothed")}
    else:
        # Trajectories never carries filter history, so always prune it
        # INSIDE the jit — with_history=True used to materialize the full
        # (T, K, n, n) P histories in HBM only for the host keep-filter
        # below to discard them unfetched
        outs = _track_clip_jit(frames_d, cfg, False, seeds_d, render_tmpl)
        # fetch only the trajectory-sized outputs (D2H is the expensive
        # path; smoothing already ran on device)
        keep = ("pos", "alive", "nis", "track_id", "smoothed")
        outs = jax.device_get({k: v for k, v in outs.items() if k in keep})
    traj = Trajectories(
        positions=np.asarray(outs["pos"]),
        alive=np.asarray(outs["alive"]),
        nis=np.asarray(outs["nis"]),
        track_id=np.asarray(outs["track_id"]),
        smoothed=(np.asarray(outs["smoothed"])
                  if "smoothed" in outs else None))
    return traj


def _smooth_history_chunked(outs, cfg: RunConfig) -> np.ndarray:
    """Chunked RTS over host-resident filter history: segment breaks at
    re-seeds/dead frames, O(chunk) device memory (models/rts.py)."""
    from .models.rts import rts_smooth_chunked
    tid = np.asarray(outs["track_id"])
    alive = np.asarray(outs["alive"])
    breaks = (tid[1:] != tid[:-1]) | ~alive[1:] | ~alive[:-1]
    F = np.asarray(dynamics.transition(cfg.ekf))
    chunk = cfg.smooth.chunk if cfg.smooth.chunk > 0 else 64
    xs, _Ps = rts_smooth_chunked(
        F, np.asarray(outs["x_filt"]), np.asarray(outs["P_filt"]),
        np.asarray(outs["x_pred"]), np.asarray(outs["P_pred"]),
        chunk=chunk, breaks=breaks)
    return xs


def track_stream(frame_iter: Iterator[np.ndarray], cfg: RunConfig,
                 frame0: np.ndarray = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 resume: bool = False, render_tmpl=None,
                 seeds: Optional[np.ndarray] = None) -> Trajectories:
    """Track a host frame stream with O(1) device memory.

    One jitted step per frame; `device_put` overlaps with the previous
    step's compute thanks to JAX async dispatch. With `checkpoint_path` +
    `checkpoint_every`, the (tiny) filter-state pytree is serialized every
    N frames; `resume=True` reloads it and fast-forwards the stream
    (SURVEY.md §5 checkpoint/resume). `seeds` overrides corner seeding
    with explicit (num_tracks, 2) positions (mesh vertices for the render
    channel) — same semantics as track_arrays; ignored on resume (the
    checkpointed state already carries the tracks).
    """
    import os
    from .utils import checkpoint as ckpt

    # with smoothing on: lag > 0 = online fixed-lag (only the smoothed
    # (K, 2) row crosses to host per frame); otherwise the filter history
    # is offloaded to host RAM and smoothed chunk-at-a-time afterwards —
    # O(chunk) device memory in clip length (SURVEY.md §5 long-context)
    fetch_keys = ("pos", "alive", "nis", "track_id")
    use_lag = cfg.smooth.enabled and cfg.smooth.lag > 0
    if use_lag:
        fetch_keys += ("smoothed_lag",)
    elif cfg.smooth.enabled:
        fetch_keys += ("x_filt", "P_filt", "x_pred", "P_pred")

    rows = []
    it = iter(frame_iter)
    start_idx = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, prev_gray, start_idx, ccache, lbuf, pflow = ckpt.load_state(
            checkpoint_path)
        prev_gray_d = jnp.asarray(prev_gray)
        rpyr = ()
        if cfg.ekf.measurement in ("photometric", "render"):
            pass                             # no flow pyramids in this mode
        elif cfg.flow.method == "farneback":
            from .ops.farneback import polyexp_pyramid
            rpyr = jax.jit(polyexp_pyramid, static_argnames="cfg")(
                prev_gray_d, cfg.flow)
        elif cfg.flow.method == "lk_sparse":
            rpyr = lk_ops.lk_pyramid(prev_gray_d, cfg.flow)
        corner_cache = ()
        if cfg.tracks.reinit and cfg.tracks.reinit_every > 1:
            # restore the pool verbatim (old checkpoints without it fall
            # back to recomputing from the checkpointed frame)
            if ccache is not None:
                corner_cache = tuple(jnp.asarray(a) for a in ccache)
            else:
                corner_cache = _fresh_corner_pool(prev_gray_d, cfg)
        tracks_d = jax.tree.map(jnp.asarray, state)
        if cfg.smooth.enabled and cfg.smooth.lag > 0:
            # the checkpointed smoother window makes resume BIT-IDENTICAL
            # to an uninterrupted stream; old checkpoints without one fall
            # back to a flat re-prime from the restored state (the first
            # `lag` smoothed rows then lean on that flat prefix)
            if lbuf is not None and lbuf[0].shape[0] == cfg.smooth.lag + 1:
                lag_buf = tuple(jnp.asarray(a) for a in lbuf)
            else:
                lag_buf = _lag_buf_init(tracks_d, cfg.smooth.lag)
        else:
            lag_buf = ()
        prev_flow = None
        if (cfg.flow.temporal_init and cfg.flow.method == "farneback"
                and cfg.ekf.measurement not in ("photometric", "render")):
            # restore the warm-start field for bit-identical resume; old
            # checkpoints without it re-prime cold (zeros)
            prev_flow = (jnp.asarray(pflow) if pflow is not None
                         else jnp.zeros(prev_gray_d.shape + (2,),
                                        jnp.float32))
        carry = Carry(tracks=tracks_d,
                      prev_gray=prev_gray_d, prev_rpyr=rpyr,
                      corner_cache=corner_cache,
                      frame_idx=jnp.int32(start_idx),
                      lag_buf=lag_buf, prev_flow=prev_flow)
        # frame_idx counts filter steps: state at frame_idx=k has consumed
        # frames 0..k (frame 0 seeded the filter), so skip k+1 frames
        import itertools
        skipped = sum(1 for _ in itertools.islice(it, start_idx + 1))
        if skipped < start_idx + 1:
            raise ValueError(
                f"resume: stream ended after {skipped} frames but the "
                f"checkpoint was written at frame {start_idx} — the stream "
                f"must replay at least the first {start_idx + 1} frames")
    else:
        if frame0 is None:
            frame0 = next(it)
        carry = jax.jit(init_from_frame, static_argnames="cfg")(
            jnp.asarray(frame0), cfg)
        if seeds is not None:
            carry = carry._replace(
                tracks=init_tracks(cfg.ekf, jnp.asarray(seeds)))
            if carry.lag_buf:
                carry = carry._replace(
                    lag_buf=_lag_buf_init(carry.tracks, cfg.smooth.lag))
        if cfg.tracks.init_velocity:
            # peek frame 1 to prime velocities exactly as track_arrays
            # does (streaming and clip runs of the same config used to
            # silently diverge), then replay it through the main loop
            import itertools
            frame1 = next(it, None)
            if frame1 is not None:
                carry = jax.jit(_prime_init_velocity,
                                static_argnames="cfg")(
                    carry, jnp.asarray(frame1), cfg)
                if carry.lag_buf:
                    # re-prime the smoother window from the seeded state
                    carry = carry._replace(lag_buf=_lag_buf_init(
                        carry.tracks, cfg.smooth.lag))
                it = itertools.chain([frame1], it)
        rows.append(_state_row(carry, cfg, fetch_keys))

    raw_step = make_step(cfg, render_tmpl=render_tmpl)
    step_fn = jax.jit(lambda c, f: raw_step(c, f))
    pending = None
    frame_idx = start_idx
    # double-buffered H2D: a background thread decodes + device_puts the
    # next frames while this loop's step computes, so the transfer of
    # frame t+1 overlaps the compute of frame t (io.video.device_prefetch)
    from .io.video import device_prefetch
    for frame in device_prefetch(it, depth=2):
        carry, out = step_fn(carry, frame)
        frame_idx += 1
        if pending is not None:
            rows.append(jax.device_get(
                {k: pending[k] for k in fetch_keys}))
        pending = out
        if (checkpoint_path and checkpoint_every
                and frame_idx % checkpoint_every == 0):
            ckpt.save_state(checkpoint_path, jax.device_get(carry.tracks),
                            np.asarray(carry.prev_gray), frame_idx,
                            corner_cache=carry.corner_cache,
                            lag_buf=jax.device_get(carry.lag_buf),
                            prev_flow=(None if carry.prev_flow is None
                                       else np.asarray(carry.prev_flow)))
    if pending is not None:
        rows.append(jax.device_get(
            {k: pending[k] for k in fetch_keys}))
    if not rows:
        # resumed at (or past) the end of the stream: report the restored
        # state as a single row rather than failing
        rows.append(_state_row(carry, cfg, fetch_keys))
    smoothed = None
    if use_lag and len(rows) > 1:
        smoothed = _assemble_lag_smoothed(rows, carry, cfg)
    elif cfg.smooth.enabled and len(rows) > 1:
        hist = {k: np.stack([np.asarray(r[k]) for r in rows])
                for k in ("x_filt", "P_filt", "x_pred", "P_pred",
                          "track_id", "alive")}
        smoothed = _smooth_history_chunked(hist, cfg)[..., 0:2]
    return Trajectories(
        positions=np.stack([np.asarray(r["pos"]) for r in rows]),
        alive=np.stack([np.asarray(r["alive"]) for r in rows]),
        nis=np.stack([np.asarray(r["nis"]) for r in rows]),
        track_id=np.stack([np.asarray(r["track_id"]) for r in rows]),
        smoothed=smoothed)


def _state_row(carry: Carry, cfg: RunConfig, fetch_keys) -> dict:
    """Host row for a bare filter state (frame 0 / resume-at-end)."""
    x = np.asarray(carry.tracks.x)
    P = np.asarray(carry.tracks.P)
    row = {"pos": x[:, 0:2],
           "alive": np.asarray(carry.tracks.alive),
           "nis": np.zeros(cfg.tracks.num_tracks, np.float32),
           "track_id": np.asarray(carry.tracks.track_id)}
    if "x_filt" in fetch_keys:
        row.update({"x_filt": x, "P_filt": P, "x_pred": x, "P_pred": P})
    if "smoothed_lag" in fetch_keys:
        row["smoothed_lag"] = x[:, 0:2]
    return row


def _assemble_lag_smoothed(rows, carry: Carry, cfg: RunConfig) -> np.ndarray:
    """Align the per-step fixed-lag emissions into a (T, K, 2) smoothed
    trajectory: step t's `smoothed_lag` is frame t - lag; the trailing
    `lag` frames come from one full RTS over the final carry window (the
    same window the step smoother held), so every frame ends up smoothed
    with all the future the window ever saw."""
    from .models.rts import rts_smooth
    L = cfg.smooth.lag
    T = len(rows)
    K = rows[0]["pos"].shape[0]
    smoothed = np.stack([np.asarray(r["pos"]) for r in rows]).astype(
        np.float32)                              # fallback: filtered pos
    for t in range(L, T):
        smoothed[t - L] = np.asarray(rows[t]["smoothed_lag"])
    # flush the final window: entry i <-> frame (T-1-L+i)
    xf, Pf, xp, Pp, tid, alive = carry.lag_buf
    breaks = (tid[1:] != tid[:-1]) | ~alive[1:] | ~alive[:-1]
    F = jnp.asarray(dynamics.transition(cfg.ekf))
    xs, _Ps = jax.jit(rts_smooth)(F, xf, Pf, xp, Pp, breaks=breaks)
    xs_np = np.asarray(xs[..., 0:2])
    for i in range(L + 1):
        f = T - 1 - L + i
        if 0 <= f < T:
            smoothed[f] = xs_np[i]
    return smoothed
