"""Bring-up check of the flow + EKF tracking pipeline on an NVIDIA GPU.

    python chip_smoke.py           # one card: main path, parity, EPE
    python chip_smoke.py --four    # only the multi-card paths (4 cards)

One JAX process drives the card(s). The first line is the card's name and
power limit as `nvidia-smi` reports them; each phase then prints one line
with its wall time and its numbers. The last line of standard output is a
JSON object `{"ok": true, "device": {...}}`, printed only when every
phase passed. With no GPU backend, or outside a checkout of this
repository, the script exits non-zero and prints no such line.

Phases (one card):
  main    1080p synthetic clip, 9 frames, 1024 tracks, 6-state EKF through
          the user entry points: `api.smooth` with RunConfig defaults
          (cv2-default Farneback, exact warp, f32 planes, re-init, RTS),
          `api.track_video` with the throughput graph (select-sum warp,
          bf16 planes, 4-frame corner-pool cadence), `cli.main(["track",
          ...])` in-process, and `track_stream` with a checkpoint and a
          resume. frames/s and peak device memory are information only.
  parity  the same runs on this process's CPU backend: flow and track
          differences within the tolerances below (equal alive masks for
          the default f32 graph), and the GPU flow's endpoint error
          against the clip's analytic flow.
Phase (--four):
  four    clip-batch data parallelism (`track_clips_sharded`, 4 clips of
          the default graph without RTS on 4 cards) against each clip
          tracked on one card, and row-band
          Farneback (`farneback_sharded`, 2048x2048, 5 levels) against the
          unsharded flow; both outputs must span all 4 devices.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# ---------------------------------------------------------------- tolerances
# GPU vs CPU backend of the same program. Every contraction asks for
# Precision.HIGHEST, so TF32 plays no part; what remains is summation order
# (XLA fuses and reassociates the shifted-add filters differently per
# backend) in float32, ~1e-6 relative on polyexp coefficients of O(1e2).
# Through 5 pyramid levels x 3 Farneback iterations that stays well under
# a thousandth of a pixel on average; single pixels in low-texture regions
# (near-singular 2x2 solves) amplify it, hence the looser max.
# bf16 planes round each coefficient to 8 bits of mantissa; two backends
# that compute the f32 value a few ulps apart can round it to neighbouring
# bf16 values, so the bf16 graph is held to 10x looser bounds.
# Tracks: a slot whose NIS sits within float noise of the chi-square
# gate, or whose position is that close to the kill border, can be gated
# on one backend and not on the other, and is then re-seeded from another
# corner (hundreds of px away). With f32 planes the noise is ~1e-5 px and
# the default graph's lifecycle agrees exactly: equal alive masks. bf16
# planes widen it to ~1e-3 px, so a handful of slots may take a different
# lifecycle path: at most 0.5% of the track-frames, and every slot whose
# alive/track-id history agrees on both backends is held to TRACK_MAX_TOL.
FLOW_MEAN_TOL = {"f32": 1e-3, "bf16": 1e-2}     # px, interior mean |d|
FLOW_MAX_TOL = {"f32": 0.05, "bf16": 0.5}        # px, interior max |d|
TRACK_MAX_TOL = {"f32": 0.01, "bf16": 0.1}       # px, agreeing slots
ALIVE_MISMATCH_TOL = {"f32": 0.0, "bf16": 0.005}  # share of track-frames
# endpoint error vs the analytic flow of the clip (blob plateau +
# static background, rim excluded): the project's accuracy bar
EPE_TOL = 0.5                                    # px, mean
# --four: sharded vs one-card results. A DP shard runs the per-clip
# program under vmap, which XLA may fuse differently from the one-clip
# program: float32 summation-order noise (GPU vs CPU measured ~1e-4 px
# on the tracks), so the default f32 graph is used and alive masks must
# agree exactly. Row bands are exact in the interior; the replicated-
# coarse / band border handling differs from the single-device op near
# the global image border (__graft_entry__.py band-parity tolerances).
DP_TRACK_TOL = 1e-3
BAND_INTERIOR_TOL = 5e-3
BAND_OVERALL_TOL = 0.1

H, W, T, K = 1080, 1920, 9, 1024


def gpu_line() -> str:
    """`name, power.limit` of the first card (nvidia-smi, no JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        lines = out.stdout.strip().splitlines()
        if out.returncode == 0 and lines:
            return lines[0].strip()
        return f"nvidia-smi failed (rc={out.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def report(phase: str, t0: float, **nums) -> None:
    body = " ".join(f"{k}={v}" for k, v in nums.items())
    print(f"[{phase}] wall={time.time() - t0:.2f}s {body}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def make_clip(height: int, width: int, frames: int, seed: int = 0):
    from kalman_hydra_tpu.io.synthetic import moving_blob_clip
    geom = dict(height=height, width=width,
                blob_sigma=max(height, width) / 18.0, velocity=(2.1, -1.4))
    clip, _truth = moving_blob_clip(num_frames=frames, num_points=16,
                                    seed=seed, **geom)
    return clip, geom


def configs(num_tracks: int):
    """(main, throughput) RunConfigs of the smoke run."""
    from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                         SmoothConfig, TrackConfig)
    main = RunConfig(ekf=EkfConfig(state_dim=6),
                     tracks=TrackConfig(num_tracks=num_tracks),
                     smooth=SmoothConfig(enabled=True))
    fast = RunConfig(flow=FlowConfig(fast_warp=8, bf16_poly=True),
                     ekf=EkfConfig(state_dim=6),
                     tracks=TrackConfig(num_tracks=num_tracks,
                                        corner_pool=max(256, num_tracks),
                                        reinit_every=4))
    return main, fast


def _timed(fn, *args, **kw):
    t0 = time.time()
    out = fn(*args, **kw)
    return out, time.time() - t0


def phase_main(clip, main_cfg, fast_cfg, workdir: str) -> dict:
    """Drive the user entry points once each; returns their results."""
    import jax
    from kalman_hydra_tpu import api, cli, pipeline
    from kalman_hydra_tpu.io.export import load

    t0 = time.time()
    T_, K_ = clip.shape[0], main_cfg.tracks.num_tracks
    dev = jax.devices()[0]

    # 1. RunConfig defaults + RTS through api.smooth (compile, then warm)
    res_main, cold = _timed(api.smooth, clip, main_cfg)
    res_main, warm = _timed(api.smooth, clip, main_cfg)
    check(res_main.positions.shape == (T_, K_, 2), "main: positions shape")
    check(res_main.smoothed is not None
          and res_main.smoothed.shape == (T_, K_, 2), "main: smoothed")
    check(np.isfinite(res_main.positions).all()
          and np.isfinite(res_main.smoothed).all(), "main: non-finite")
    live = float(res_main.alive[-1].mean())
    check(live > 0.5, f"main: only {live:.2f} of the tracks alive")

    # 2. throughput graph through api.track_video
    res_fast, cold_f = _timed(api.track_video, clip, fast_cfg)
    res_fast, warm_f = _timed(api.track_video, clip, fast_cfg)
    check(np.isfinite(res_fast.positions).all(), "fast: non-finite")
    check(float(res_fast.alive[-1].mean()) > 0.5, "fast: tracks lost")

    # 3. the CLI, in this process, on the same clip and configuration
    clip_path = os.path.join(workdir, "clip.npz")
    np.savez(clip_path, frames=clip)
    cfg_path = os.path.join(workdir, "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(main_cfg.to_json())
    out_path = os.path.join(workdir, "tracks.npz")
    rc = cli.main(["track", clip_path, "--out", out_path,
                   "--config", cfg_path])
    check(rc == 0, f"cli: exit code {rc}")
    res_cli = load(out_path)
    check(os.path.exists(out_path.rsplit(".", 1)[0] + ".report.json"),
          "cli: no run report")
    cli_diff = float(np.abs(res_cli.positions - res_main.positions).max())
    check(cli_diff < 1e-4, f"cli vs api.smooth: {cli_diff:.2e} px")

    # 4. streaming with a checkpoint, then a resume from it
    stream_cfg = main_cfg.replace(smooth=main_cfg.smooth.__class__())
    ck = os.path.join(workdir, "state.npz")
    every = max(1, (T_ - 1) // 2 + 1)
    full, t_stream = _timed(pipeline.track_stream, iter(clip), stream_cfg,
                            checkpoint_path=ck, checkpoint_every=every)
    check(full.positions.shape == (T_, K_, 2), "stream: shape")
    resumed = pipeline.track_stream(iter(clip), stream_cfg,
                                    checkpoint_path=ck, resume=True)
    tail = full.positions[every + 1:]
    check(resumed.positions.shape == tail.shape, "resume: shape")
    resume_diff = float(np.abs(resumed.positions - tail).max())
    check(resume_diff < 1e-5, f"resume vs uninterrupted: {resume_diff:.2e}")

    report("main", t0, frames=T_, size=f"{clip.shape[2]}x{clip.shape[1]}",
           tracks=K_,
           fps_main_rts=f"{(T_ - 1) / warm:.2f}",
           fps_throughput=f"{(T_ - 1) / warm_f:.2f}",
           first_call_s=f"{cold:.1f}/{cold_f:.1f}",
           stream_s=f"{t_stream:.1f}", live=f"{live:.3f}",
           cli_max_diff=f"{cli_diff:.1e}",
           resume_max_diff=f"{resume_diff:.1e}",
           peak_bytes=peak_bytes(dev))
    return {"main": res_main, "fast": res_fast}


def _interior(a, border=16):
    return a[border:-border, border:-border]


def phase_parity(clip, geom, main_cfg, fast_cfg, results) -> dict:
    """GPU results of phase_main against the CPU backend of this process,
    and the GPU flow's EPE against the clip's analytic flow."""
    import jax
    from kalman_hydra_tpu import api
    from kalman_hydra_tpu.io.synthetic import moving_blob_flow

    t0 = time.time()
    dev = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    truth, valid = moving_blob_flow(0, **geom)
    nums, failures = {}, []
    for mode, cfg in (("f32", main_cfg), ("bf16", fast_cfg)):
        with jax.default_device(dev):
            fl_dev = api.flow(clip[0], clip[1], cfg.flow)
        with jax.default_device(cpu):
            fl_cpu = api.flow(clip[0], clip[1], cfg.flow)
            run = api.smooth if mode == "f32" else api.track_video
            tr_cpu = run(clip, cfg)
        tr_dev = results["main" if mode == "f32" else "fast"]
        d = np.abs(_interior(fl_dev) - _interior(fl_cpu))
        flow_mean, flow_max = float(d.mean()), float(d.max())
        alive_diff = int((tr_dev.alive != tr_cpu.alive).sum())
        same = ((tr_dev.alive == tr_cpu.alive)
                & (tr_dev.track_id == tr_cpu.track_id)).all(axis=0)
        track_max = float(np.abs(tr_dev.positions - tr_cpu.positions)[
            :, same].max(initial=0.0))
        alive_share = alive_diff / tr_dev.alive.size
        epe = float(np.linalg.norm(fl_dev - truth, axis=-1)[valid].mean())
        nums.update({f"{mode}_flow_mean": f"{flow_mean:.2e}",
                     f"{mode}_flow_max": f"{flow_max:.2e}",
                     f"{mode}_track_max": f"{track_max:.2e}",
                     f"{mode}_alive_mismatch": alive_diff,
                     f"{mode}_slots_compared": int(same.sum()),
                     f"{mode}_epe": f"{epe:.4f}"})
        failures += [
            msg for ok, msg in (
                (flow_mean <= FLOW_MEAN_TOL[mode],
                 f"{mode}: flow mean |d| {flow_mean:.2e} > "
                 f"{FLOW_MEAN_TOL[mode]}"),
                (flow_max <= FLOW_MAX_TOL[mode],
                 f"{mode}: flow max |d| {flow_max:.2e} > "
                 f"{FLOW_MAX_TOL[mode]}"),
                (alive_share <= ALIVE_MISMATCH_TOL[mode],
                 f"{mode}: alive masks differ in {alive_diff} entries"),
                (track_max <= TRACK_MAX_TOL[mode],
                 f"{mode}: track max |d| {track_max:.2e} > "
                 f"{TRACK_MAX_TOL[mode]}"),
                (epe <= EPE_TOL, f"{mode}: EPE {epe:.3f} > {EPE_TOL}"))
            if not ok]
    report("parity", t0, reference=cpu.platform, **nums)
    check(not failures, "; ".join(failures))
    return nums


def phase_four(n: int, clip_hw=(H, W), frames: int = T,
               num_tracks: int = K, band_hw=(2048, 2048),
               band_levels: int = 5) -> dict:
    """Multi-card paths on the first n devices (see module docstring)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kalman_hydra_tpu import pipeline
    from kalman_hydra_tpu.config import FlowConfig
    from kalman_hydra_tpu.io.synthetic import moving_blob_clip
    from kalman_hydra_tpu.ops.color import grayscale_u8
    from kalman_hydra_tpu.ops.farneback import farneback
    from kalman_hydra_tpu.parallel import make_mesh, track_clips_sharded
    from kalman_hydra_tpu.parallel import mesh as mesh_mod
    from kalman_hydra_tpu.parallel.spatial import farneback_sharded

    t0 = time.time()
    devs = jax.devices()
    check(len(devs) >= n, f"four: need {n} devices, have {len(devs)}")
    main_cfg, _fast = configs(num_tracks)
    cfg = main_cfg.replace(smooth=main_cfg.smooth.__class__())

    # clip-batch data parallelism over a 1-D mesh
    mesh = make_mesh(n)
    clips = np.stack([make_clip(*clip_hw, frames, seed=s)[0]
                      for s in range(n)])
    sharded = track_clips_sharded(clips, cfg, mesh=mesh)
    single = [pipeline.track_clip(c, cfg) for c in clips]
    dp_diff = max(float(np.abs(a.positions - b.positions).max())
                  for a, b in zip(sharded, single))
    dp_alive = all(np.array_equal(a.alive, b.alive)
                   for a, b in zip(sharded, single))
    clips_d = jax.device_put(clips, NamedSharding(mesh, P("data")))
    outs, _ = mesh_mod._track_sharded_jit(clips_d, cfg, False)
    dp_devs = {s.device for s in outs["pos"].addressable_shards}
    check(len(dp_devs) == n, f"dp: output on {len(dp_devs)} devices")
    check(dp_alive, "dp: alive masks differ from one-card runs")
    check(dp_diff <= DP_TRACK_TOL, f"dp: positions differ by {dp_diff:.2e}")

    # row-band spatial sharding of the Farneback fine level
    bh, bw = band_hw
    fr, _ = moving_blob_clip(num_frames=2, height=bh, width=bw,
                             blob_sigma=max(bh, bw) / 18.0,
                             velocity=(2.1, -1.4), seed=7)
    g = np.asarray(grayscale_u8(fr), np.float32)
    fcfg = FlowConfig(levels=band_levels, fast_warp=8)
    band = farneback_sharded(g[0], g[1], fcfg,
                             mesh=make_mesh(n, axis="space"),
                             as_numpy=False)
    band_devs = {s.device for s in band.addressable_shards}
    check(len(band_devs) == n, f"band: output on {len(band_devs)} devices")
    ref = np.asarray(jax.jit(lambda a, b: farneback(a, b, fcfg))(g[0], g[1]))
    d = np.abs(np.asarray(band) - ref).max(axis=-1)
    interior, overall = float(d[8:-8, 8:-8].max()), float(d.max())
    check(interior < BAND_INTERIOR_TOL, f"band: interior {interior:.2e}")
    check(overall < BAND_OVERALL_TOL, f"band: overall {overall:.2e}")
    nums = {"dp_clips": n, "dp_max_diff": f"{dp_diff:.2e}",
            "dp_alive_equal": dp_alive, "dp_devices": len(dp_devs),
            "band_shape": f"{bw}x{bh}", "band_levels": band_levels,
            "band_interior_max": f"{interior:.2e}",
            "band_overall_max": f"{overall:.2e}",
            "band_devices": len(band_devs)}
    report("four", t0, **nums)
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card DP and row-band phases")
    args = ap.parse_args(argv)

    print(gpu_line(), flush=True)
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX backend is {backend!r}, not 'gpu'; "
              "nothing to check", file=sys.stderr)
        return 2
    from kalman_hydra_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache(ROOT)

    if args.four:
        phase_four(4)
    else:
        clip, geom = make_clip(H, W, T)
        main_cfg, fast_cfg = configs(K)
        with tempfile.TemporaryDirectory() as work:
            results = phase_main(clip, main_cfg, fast_cfg, work)
        phase_parity(clip, geom, main_cfg, fast_cfg, results)

    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
