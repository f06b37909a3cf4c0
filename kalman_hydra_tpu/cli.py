"""Command-line interface — mirrors the reference's run_*.py driver scripts
(SURVEY.md §2.1 #1: parse args, open video, init filter, loop, export).

  python -m kalman_hydra_tpu track clip.mp4 --out tracks.npz [--smooth]
  python -m kalman_hydra_tpu flow a.npy b.npy --out flow.npz
  python -m kalman_hydra_tpu synth --out clip.npz --frames 32
  python -m kalman_hydra_tpu bench --quick
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

import numpy as np

logger = logging.getLogger("kalman_hydra_tpu")


def _load_cfg(args):
    from .config import RunConfig, SmoothConfig
    if args.config:
        cfg = RunConfig.from_json(open(args.config).read())
    else:
        cfg = RunConfig()
    over = {}
    if getattr(args, "method", None) or getattr(args, "temporal", False):
        fover = {}
        if getattr(args, "method", None):
            fover["method"] = args.method
        if getattr(args, "temporal", False):
            # warm-start chaining (cv2 OPTFLOW_USE_INITIAL_FLOW over
            # time) is Farneback-only; config validation enforces it
            fover["temporal_init"] = True
        over["flow"] = dataclasses.replace(cfg.flow, **fover)
    if getattr(args, "tracks", None):
        over["tracks"] = dataclasses.replace(cfg.tracks,
                                             num_tracks=args.tracks)
    if (getattr(args, "smooth", False) or getattr(args, "smooth_chunk", 0)
            or getattr(args, "smooth_lag", 0)):
        over["smooth"] = SmoothConfig(
            enabled=True, chunk=getattr(args, "smooth_chunk", 0) or 0,
            lag=getattr(args, "smooth_lag", 0) or 0)
    return cfg.replace(**over) if over else cfg


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kalman_hydra_tpu")
    ap.add_argument("-v", "--v", action="count", default=0, dest="v",
                    help="verbosity (-v info, -vv debug)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("track", help="track a video -> trajectories")
    t.add_argument("video")
    t.add_argument("--out", default="tracks.npz")
    t.add_argument("--config", help="RunConfig JSON file")
    t.add_argument("--method", choices=["farneback", "lk_dense", "lk_sparse"])
    t.add_argument("--tracks", type=int)
    t.add_argument("--smooth", action="store_true")
    t.add_argument("--smooth-chunk", type=int, default=0,
                   help="host-chunked RTS chunk length (0 = on-device "
                        "monolithic; implies --smooth when > 0)")
    t.add_argument("--smooth-lag", type=int, default=0,
                   help="online fixed-lag smoother window (streaming-"
                        "friendly: O(lag) device memory, no P-history "
                        "D2H; implies --smooth when > 0)")
    t.add_argument("--stream", action="store_true",
                   help="O(1)-memory streaming mode")
    t.add_argument("--checkpoint", help="state checkpoint path")
    t.add_argument("--checkpoint-every", type=int, default=0)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--max-frames", type=int)
    t.add_argument("--temporal", action="store_true",
                   help="warm-start each pair's flow from the previous "
                        "pair (Farneback; pairs well with fewer "
                        "iterations)")
    t.add_argument("--profile", help="write a jax.profiler trace here")

    f = sub.add_parser("flow", help="dense flow between two frames")
    f.add_argument("a")
    f.add_argument("b")
    f.add_argument("--out", default="flow.npz")
    f.add_argument("--config")
    f.add_argument("--method", choices=["farneback", "lk_dense"])

    s = sub.add_parser("synth", help="generate a synthetic test clip")
    s.add_argument("--out", default="clip.npz")
    s.add_argument("--frames", type=int, default=16)
    s.add_argument("--height", type=int, default=256)
    s.add_argument("--width", type=int, default=256)
    s.add_argument("--seed", type=int, default=0)

    b = sub.add_parser("bench", help="run the benchmark harness")
    b.add_argument("--config", type=int, default=0)
    b.add_argument("--quick", action="store_true")

    m = sub.add_parser(
        "mesh", help="segment -> mesh -> track vertices (render channel) "
        "-> per-triangle strain")
    m.add_argument("video")
    m.add_argument("--out", default="mesh_tracks.npz")
    m.add_argument("--config", help="RunConfig JSON (ekf.measurement "
                   "render/flow_render; defaults supplied otherwise)")
    m.add_argument("--vertices", type=int, default=64,
                   help="mesh vertex count (Lloyd-sampled in the body)")
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--measurement", choices=["render", "flow_render"],
                   help="override the observation channel")
    m.add_argument("--max-frames", type=int)
    m.add_argument("--stream", action="store_true",
                   help="O(1)-memory streaming driver")

    args = ap.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    logging.basicConfig(
        level=(logging.WARNING if args.v == 0
               else logging.INFO if args.v == 1 else logging.DEBUG),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    if args.cmd == "track":
        from . import api
        from .io.video import FrameStream, PrefetchStream
        from . import pipeline as pl
        cfg = _load_cfg(args)

        if (args.checkpoint or args.resume) and not args.stream:
            ap.error("--checkpoint/--resume require --stream "
                     "(clip mode has no incremental state to save)")

        def run():
            if args.stream:
                src = FrameStream(args.video)
                if args.max_frames:
                    # bound the stream (used to be silently ignored here)
                    import itertools
                    src = itertools.islice(iter(src), args.max_frames)
                stream = PrefetchStream(src, depth=4)
                tracks = pl.track_stream(
                    stream, cfg, checkpoint_path=args.checkpoint,
                    checkpoint_every=args.checkpoint_every,
                    resume=args.resume)
                from .io.export import save
                save(tracks, args.out)
                return tracks
            return api.track_video(args.video, cfg, out_path=args.out,
                                   max_frames=args.max_frames)

        if args.profile:
            from .utils.profiling import trace
            with trace(args.profile):
                tracks = run()
        else:
            tracks = run()
        live = tracks.alive.mean()
        from .utils.report import run_report
        rep = run_report(tracks, gate_chi2=cfg.ekf.gate_chi2)
        logger.info("run report: %s", json.dumps(rep, sort_keys=True))
        report_path = args.out.rsplit(".", 1)[0] + ".report.json"
        with open(report_path, "w") as f:
            json.dump(rep, f, indent=2, sort_keys=True)
        print(f"tracked {tracks.num_frames} frames x "
              f"{tracks.num_tracks} slots (live {live:.0%}) -> {args.out} "
              f"(+ {report_path})")
        return 0

    if args.cmd == "flow":
        from . import api
        from .config import FlowConfig, RunConfig
        a = _load_frame(args.a)
        b_ = _load_frame(args.b)
        if args.config:
            # --config takes a RunConfig JSON (same format as `track`);
            # the flow section drives this command (it used to be
            # accepted and silently ignored)
            cfg = RunConfig.from_json(open(args.config).read()).flow
        else:
            cfg = FlowConfig()
        if args.method:
            cfg = dataclasses.replace(cfg, method=args.method)
        fl = api.flow(a, b_, cfg)
        np.savez_compressed(args.out, flow=fl)
        mag = np.linalg.norm(fl, axis=-1)
        print(f"flow {fl.shape}: |u| mean {mag.mean():.3f} max {mag.max():.3f}"
              f" -> {args.out}")
        return 0

    if args.cmd == "synth":
        from .io.synthetic import moving_blob_clip
        frames, truth = moving_blob_clip(
            num_frames=args.frames, height=args.height, width=args.width,
            seed=args.seed)
        np.savez_compressed(args.out, frames=frames,
                            truth_positions=truth.positions)
        print(f"wrote {frames.shape} clip -> {args.out}")
        return 0

    if args.cmd == "mesh":
        from . import api
        from .config import RunConfig
        from .io.video import FrameStream
        from .models.mesh import mesh_strain_sequence, triangle_quality
        cfg = None
        if args.config:
            cfg = RunConfig.from_json(open(args.config).read())
        if args.measurement:
            base = cfg or RunConfig(
                ekf=dataclasses.replace(RunConfig().ekf, q=0.5),
                tracks=dataclasses.replace(RunConfig().tracks,
                                           reinit=False))
            cfg = base.replace(ekf=dataclasses.replace(
                base.ekf, measurement=args.measurement))
        frames = FrameStream(args.video).read_all(limit=args.max_frames)
        mesh, tracks = api.track_mesh(frames, cfg=cfg,
                                      n_vertices=args.vertices,
                                      seed=args.seed,
                                      streaming=args.stream)
        strain = mesh_strain_sequence(mesh, tracks.positions)
        exx = strain["F"][:, :, 0, 0] - 1.0
        eyy = strain["F"][:, :, 1, 1] - 1.0
        np.savez_compressed(
            args.out, vertices=mesh.vertices, triangles=mesh.triangles,
            positions=tracks.positions, alive=tracks.alive,
            nis=tracks.nis, track_id=tracks.track_id,
            exx=exx, eyy=eyy, max_shear=strain["max_shear"],
            area_ratio=strain["area_ratio"])
        q = triangle_quality(tracks.positions[-1], mesh.triangles)
        print(f"meshed {len(mesh.vertices)} vertices / "
              f"{len(mesh.triangles)} triangles; tracked "
              f"{tracks.num_frames} frames (live "
              f"{tracks.alive[-1].mean():.0%}); final strain exx "
              f"{np.median(exx[-1]):+.4f} eyy {np.median(eyy[-1]):+.4f}, "
              f"quality floor {q.min():.2f} -> {args.out}")
        return 0

    if args.cmd == "bench":
        import subprocess
        # bench.py lives at the repo root (one level above the package),
        # so the subcommand works from any cwd / installed package
        bench_path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "bench.py")
        if not os.path.exists(bench_path):
            print(f"bench harness not found at {bench_path}; run "
                  f"`python bench.py` from a repo checkout", file=sys.stderr)
            return 1
        cmd = [sys.executable, bench_path]
        if args.quick:
            cmd.append("--quick")
        elif args.config:
            cmd += ["--config", str(args.config)]
        return subprocess.call(cmd)

    return 1


def _load_frame(path: str) -> np.ndarray:
    if path.endswith((".npy", ".npz")):
        if path.endswith(".npz"):
            with np.load(path) as z:
                return z[list(z.keys())[0]]
        return np.load(path)
    import cv2
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise IOError(f"cannot read {path}")
    return img


if __name__ == "__main__":
    sys.exit(main())
