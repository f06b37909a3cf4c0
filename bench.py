"""Benchmark harness — prints ONE JSON line on stdout.

Headline: frames/s of the fused flow+EKF pipeline on a 1080p synthetic
clip (BASELINE.json:2), with the device it ran on.

Usage:
  python bench.py                 # headline: 1080p fused pipeline
  python bench.py --config N      # one of the 5 BASELINE.json configs
  python bench.py --sparse        # sparse pyrLK pipeline at 1080p
  python bench.py --render        # mesh-render channel at 480p
  python bench.py --quick         # small shapes

Timing: the jitted pipeline is compiled and run once before the clock
starts; each timed run ends in `block_until_ready`, and the median of
`repeats` runs is reported with its min-max spread. The harness refuses
to measure anywhere but on a GPU backend (a CPU number is not a device
number). Diagnostics go to stderr; stdout carries exactly one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_info() -> dict:
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


def make_clip(t, h, w, seed=0):
    from kalman_hydra_tpu.io.synthetic import moving_blob_clip
    frames, truth = moving_blob_clip(
        num_frames=t, height=h, width=w, num_points=16,
        blob_sigma=max(h, w) / 18.0, velocity=(2.1, -1.4), seed=seed)
    return frames, truth


def seed_grid(num_tracks, h, w):
    """Regular (num_tracks, 2) seed grid over the frame interior."""
    g = int(np.ceil(np.sqrt(num_tracks)))
    gy, gx = np.mgrid[0:g, 0:g]
    return np.stack([8 + gx.ravel() * (w - 16) / max(g - 1, 1),
                     8 + gy.ravel() * (h - 16) / max(g - 1, 1)],
                    axis=-1)[:num_tracks].astype(np.float32)


def time_fn(fn, args, repeats):
    """Compile + warm `fn(*args)`, then time `repeats` runs.

    Returns (median seconds, extra fields)."""
    import jax
    t0 = time.time()
    jax.block_until_ready(fn(*args))
    compile_s = time.time() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    spread = (max(times) - min(times)) / med if med > 0 else 0.0
    return med, {"fps_median_of": repeats,
                 "fps_spread_pct": round(spread * 100.0, 1),
                 "first_call_s": round(compile_s, 2)}


def pipeline_config(flow_method="farneback", num_tracks=1024, state_dim=6,
                    fast_warp=8, bf16_poly=True, iterations=3,
                    temporal_init=False, reinit_every=4, lk_halo=8,
                    lk_solver="corr_conv"):
    """The throughput graph: cv2-default Farneback geometry with the
    select-sum warp and bf16 polyexp planes, a 4-frame corner-pool
    refresh cadence; sparse LK runs the batched block-halo solver."""
    from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                         TrackConfig)
    sparse = flow_method == "lk_sparse"
    return RunConfig(
        flow=FlowConfig(method=flow_method, fast_warp=fast_warp,
                        bf16_poly=bf16_poly and flow_method == "farneback",
                        iterations=iterations,
                        temporal_init=temporal_init,
                        lk_block_halo=lk_halo if sparse else 0,
                        lk_solver=lk_solver if sparse else "blockhalo"),
        ekf=EkfConfig(state_dim=state_dim),
        tracks=TrackConfig(num_tracks=num_tracks,
                           corner_pool=max(256, num_tracks),
                           reinit_every=reinit_every))


def bench_fused_pipeline(h, w, t, num_tracks, state_dim=6,
                         flow_method="farneback", repeats=None,
                         iterations=3, temporal_init=False, fast_warp=8):
    """Fused flow+EKF frames/s on device-resident frames (one jitted
    clip scan per run). Returns (fps, extra)."""
    import jax
    import jax.numpy as jnp
    from kalman_hydra_tpu import pipeline as pl

    cfg = pipeline_config(flow_method, num_tracks, state_dim,
                          fast_warp=fast_warp, iterations=iterations,
                          temporal_init=(temporal_init
                                         and flow_method == "farneback"))
    frames, _ = make_clip(t, h, w)
    frames_d = jnp.asarray(frames)
    seeds = jnp.asarray(seed_grid(num_tracks, h, w))
    fn = jax.jit(lambda f, s: pl.track_arrays(f, cfg, seeds=s)["pos"])
    if repeats is None:
        repeats = 5
    med, extra = time_fn(fn, (frames_d, seeds), repeats)
    fps = (t - 1) / med
    log(f"{h}x{w} T={t} K={num_tracks} {flow_method}: median "
        f"{med*1e3:.2f} ms/clip over {repeats} runs "
        f"(spread {extra['fps_spread_pct']}%) => {fps:.2f} frames/s")
    return fps, extra


def bench_epe(h=256, w=256, fast_warp=8, bf16_poly=True):
    """Mean endpoint error of device Farneback against the analytic flow
    of a rigidly translated frame pair (interior, 16 px border off)."""
    import jax
    import jax.numpy as jnp
    from kalman_hydra_tpu.config import FlowConfig
    from kalman_hydra_tpu.io.synthetic import translating_pair
    from kalman_hydra_tpu.ops.farneback import farneback

    a, b, truth = translating_pair(height=h, width=w, shift=(3.0, -2.0))
    cfg = FlowConfig(fast_warp=fast_warp, bf16_poly=bf16_poly)
    fl = np.asarray(jax.jit(lambda x, y: farneback(x, y, cfg))(
        jnp.asarray(np.round(a), jnp.float32),
        jnp.asarray(np.round(b), jnp.float32)))
    epe = float(np.linalg.norm(fl - truth, axis=-1)[16:-16, 16:-16].mean())
    log(f"EPE vs analytic flow @{h}x{w}: {epe:.5f} px")
    return epe


def bench_render_channel(h=480, w=640, n_vertices=64, repeats=5):
    """Mesh-render observation channel: one full render_step (predict +
    lumped-GN vertex measurement + EKF update) per frame with a
    segmentation-derived mesh (models/render.py)."""
    import jax
    import jax.numpy as jnp
    from kalman_hydra_tpu.config import EkfConfig
    from kalman_hydra_tpu.io.synthetic import deforming_body_clip
    from kalman_hydra_tpu.models import dynamics
    from kalman_hydra_tpu.models.ekf import init_tracks
    from kalman_hydra_tpu.models.mesh import mesh_from_mask
    from kalman_hydra_tpu.models.render import make_template, render_step
    from kalman_hydra_tpu.ops.color import grayscale_u8
    from kalman_hydra_tpu.ops.segment import segment_body

    frames, _truth, _strain = deforming_body_clip(num_frames=3, height=h,
                                                  width=w, seed=0)
    gray0 = np.asarray(grayscale_u8(jnp.asarray(frames[0])))
    mask = np.asarray(segment_body(jnp.asarray(gray0)))
    mesh = mesh_from_mask(mask, n_points=n_vertices, seed=0)
    tmpl = make_template(gray0, mesh)
    cfg = EkfConfig(measurement="render", q=0.5)
    F = jnp.asarray(dynamics.transition(cfg))
    Q = jnp.asarray(dynamics.process_noise(cfg))
    state0 = init_tracks(cfg, jnp.asarray(mesh.vertices))
    gray1 = grayscale_u8(jnp.asarray(frames[1]))
    fn = jax.jit(lambda g: render_step(state0, g, cfg, F, Q, tmpl)[0].x)
    med, extra = time_fn(fn, (gray1,), repeats)
    log(f"render channel {h}x{w} V={n_vertices}: {med*1e3:.3f} ms/frame")
    return 1.0 / med, extra


def bench_flow_pixel_ekf(h=480, w=854, t=33, repeats=5):
    """Config 2 (BASELINE.json:8): dense Farneback over a 480p clip +
    per-pixel KF smoothing of the flow fields, one jitted scan."""
    import jax.numpy as jnp
    from kalman_hydra_tpu import pipeline as pl
    from kalman_hydra_tpu.config import FlowConfig, RunConfig
    cfg = RunConfig(flow=FlowConfig(fast_warp=8, bf16_poly=True))
    frames, _ = make_clip(t, h, w)
    med, extra = time_fn(lambda f: pl.flow_sequence(f, cfg, smooth=True),
                         (jnp.asarray(frames),), repeats)
    return (t - 1) / med, extra


def bench_rts(h=480, w=854, t=33, repeats=5):
    """Config 5 (BASELINE.json:11): 3-level Farneback + 256 tracks with
    re-init and on-device RTS smoothing over a 33-frame clip."""
    import jax
    import jax.numpy as jnp
    from kalman_hydra_tpu import pipeline as pl
    from kalman_hydra_tpu.config import (FlowConfig, RunConfig,
                                         SmoothConfig, TrackConfig)
    cfg = RunConfig(flow=FlowConfig(levels=3, fast_warp=8, bf16_poly=True),
                    tracks=TrackConfig(num_tracks=256),
                    smooth=SmoothConfig(enabled=True))
    frames, _ = make_clip(t, h, w)
    fn = jax.jit(lambda f: pl.track_arrays(f, cfg)["smoothed"])
    med, extra = time_fn(fn, (jnp.asarray(frames),), repeats)
    return (t - 1) / med, extra


CONFIGS = {
    # n: (metric, runner) — BASELINE.json configs 1-5
    1: ("fps_cfg1_256p_lk_dense", lambda: bench_fused_pipeline(
        256, 256, t=33, num_tracks=256, state_dim=4,
        flow_method="lk_dense")),
    2: ("fps_cfg2_480p_flow_pixel_ekf", bench_flow_pixel_ekf),
    3: ("fps_cfg3_720p_1ktracks", lambda: bench_fused_pipeline(
        720, 1280, t=17, num_tracks=1024)),
    4: ("fps_cfg4_1080p", lambda: bench_fused_pipeline(
        1080, 1920, t=9, num_tracks=1024)),
    5: ("fps_cfg5_480p_rts", bench_rts),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0,
                    help="BASELINE config 1-5; 0 = headline 1080p")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sparse", action="store_true",
                    help="sparse pyrLK pipeline at 1080p (1024 tracks)")
    ap.add_argument("--render", action="store_true",
                    help="mesh-render channel at 480p (V=64 mesh)")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        log(f"bench: JAX backend is {jax.default_backend()!r}; it measures "
            "only on a GPU")
        return 2
    from kalman_hydra_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache(ROOT)

    epe = None
    if args.render:
        metric = "fps_render_480p_v64"
        fps, extra = bench_render_channel()
    elif args.sparse:
        metric = "fps_1080p_sparse_lk"
        fps, extra = bench_fused_pipeline(1080, 1920, t=9, num_tracks=1024,
                                          flow_method="lk_sparse")
    elif args.quick:
        metric = "fps_quick_128p"
        fps, extra = bench_fused_pipeline(128, 128, t=5, num_tracks=64)
        epe = bench_epe(128, 128)
    elif args.config:
        if args.config not in CONFIGS:
            raise SystemExit(f"unknown config {args.config}")
        metric, run = CONFIGS[args.config]
        fps, extra = run()
    else:
        metric = "fps_1080p_fused_flow_ekf"
        fps, extra = bench_fused_pipeline(1080, 1920, t=9, num_tracks=1024)
        epe = bench_epe(1080, 1920)
    out = {"metric": metric, "value": round(fps, 3), "unit": "frames/s",
           "epe_px": None if epe is None else round(epe, 5)}
    out.update(extra)
    out.update(device_info())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
