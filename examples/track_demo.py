"""End-to-end demo: synthesize a clip, track it, smooth it, report, render.

    python examples/track_demo.py [--out-dir /tmp/kh_demo]

Mirrors the reference's driver-script user journey (SURVEY.md §3.1).
Everything runs on whatever jax.devices()[0] is (JAX_PLATFORMS=cpu pins
the CPU backend).
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="/tmp/kh_demo")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--size", type=int, default=256)
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    from kalman_hydra_tpu import api
    from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                         SmoothConfig, TrackConfig)
    from kalman_hydra_tpu.io.overlay import write_overlay
    from kalman_hydra_tpu.io.synthetic import moving_blob_clip
    from kalman_hydra_tpu.utils.report import write_report

    print("generating synthetic clip...")
    frames, truth = moving_blob_clip(
        num_frames=args.frames, height=args.size, width=args.size,
        num_points=16, seed=0)

    cfg = RunConfig(
        flow=FlowConfig(levels=3, fast_warp=8),
        ekf=EkfConfig(state_dim=4),
        tracks=TrackConfig(num_tracks=32, corner_pool=128,
                           seed_in_body=True),
        smooth=SmoothConfig(enabled=True))

    print("tracking (first call compiles)...")
    tracks = api.track_video(frames, cfg,
                             out_path=os.path.join(args.out_dir,
                                                   "tracks.npz"))
    rep = write_report(tracks, os.path.join(args.out_dir, "report.json"))
    print("report:", json.dumps(rep, indent=2, sort_keys=True)[:400], "...")

    print("dense flow + per-pixel smoothing...")
    flows = api.flow_sequence(frames[:8], cfg, smooth=True)
    print("flow field:", flows.shape,
          f"mean |u| {np.linalg.norm(flows, axis=-1).mean():.2f} px")

    print("rendering overlay...")
    write_overlay(os.path.join(args.out_dir, "overlay.npz"), frames, tracks)
    print("done ->", args.out_dir)


if __name__ == "__main__":
    main()
