"""Deformable-body demo: segment, mesh, track vertices, report strain.

    python examples/mesh_strain_demo.py [--out-dir /tmp/kh_mesh_demo]

The Hydra-behavior workflow the reference was built for (SURVEY.md §0):
find the animal, put a mesh on it, track the mesh through the clip, and
quantify deformation per triangle — here on a synthetic deforming body
whose affine stretch is known analytically, so the demo ends by scoring
its own strain estimate against ground truth.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="/tmp/kh_mesh_demo")
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    import jax.numpy as jnp
    from kalman_hydra_tpu import pipeline as pl
    from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                         SmoothConfig, TrackConfig)
    from kalman_hydra_tpu.io.synthetic import deforming_body_clip
    from kalman_hydra_tpu.models import mesh as M
    from kalman_hydra_tpu.ops import segment as seg
    from kalman_hydra_tpu.ops.color import grayscale_u8

    print("synthesizing a deforming-body clip (affine stretch, known truth)...")
    frames, _truth, strain_true = deforming_body_clip(
        num_frames=12, stretch=(0.15, -0.10), omega=0.5)

    print("segmenting the body...")
    gray0 = grayscale_u8(jnp.asarray(frames[0]))
    mask = np.asarray(seg.segment_body(gray0))
    interior = np.asarray(seg._pool(jnp.asarray(mask), 13, "min"))
    print(f"  body covers {mask.mean():.0%} of the frame")

    print("building the mesh...")
    mesh = M.mesh_from_mask(interior, n_points=24, seed=0)
    print(f"  {len(mesh.vertices)} vertices, {len(mesh.triangles)} triangles")

    print("tracking mesh vertices (first call compiles)...")
    cfg = RunConfig(flow=FlowConfig(levels=3),
                    ekf=EkfConfig(state_dim=4, measurement="implicit_flow",
                                  q=8.0),
                    tracks=TrackConfig(num_tracks=len(mesh.vertices),
                                       reinit=False, init_velocity=True),
                    smooth=SmoothConfig(enabled=True))
    tr = pl.track_clip(frames, cfg, seeds=mesh.vertices)
    print(f"  live vertices at end: {tr.alive[-1].mean():.0%}")

    print("computing per-triangle strain vs analytic deformation...")
    strain = M.mesh_strain_sequence(mesh, tr.smoothed)
    F = strain["F"]
    exx = F[:, :, 0, 0].mean(axis=1) - 1.0
    eyy = F[:, :, 1, 1].mean(axis=1) - 1.0
    err_x = np.abs(exx - strain_true[:, 0]).max()
    err_y = np.abs(eyy - strain_true[:, 1]).max()
    print("   t   exx_est  exx_true  eyy_est  eyy_true")
    for t in range(len(exx)):
        print(f"  {t:2d}  {exx[t]:+.4f}  {strain_true[t, 0]:+.4f}"
              f"  {eyy[t]:+.4f}  {strain_true[t, 1]:+.4f}")
    print(f"  max strain error: exx {err_x:.4f}, eyy {err_y:.4f} "
          f"(peak deformation 0.15)")

    print("re-tracking with the mesh-RENDER observation channel "
          "(the reference's textured-render measurement)...")
    from kalman_hydra_tpu import api
    rcfg = RunConfig(ekf=EkfConfig(measurement="render", q=0.5),
                     tracks=TrackConfig(reinit=False),
                     smooth=SmoothConfig(enabled=True))
    _mesh_r, tr_r = api.track_mesh(frames, cfg=rcfg, mesh=mesh)
    # strain from the RTS-smoothed vertices, same as the flow section
    # (raw per-frame positions put ~0.05 px noise through the sliver
    # triangles' high leverage)
    strain_r = M.mesh_strain_sequence(mesh, tr_r.smoothed)
    exx_r = strain_r["F"][:, :, 0, 0].mean(axis=1) - 1.0
    eyy_r = strain_r["F"][:, :, 1, 1].mean(axis=1) - 1.0
    err_xr = np.abs(exx_r - strain_true[:, 0]).max()
    err_yr = np.abs(eyy_r - strain_true[:, 1]).max()
    print(f"  render-channel max strain error: exx {err_xr:.4f}, "
          f"eyy {err_yr:.4f} (flow channel: {err_x:.4f}/{err_y:.4f})")

    print("strain-triggered dynamic remeshing on the tracked deformation...")
    dyn = M.mesh_strain_sequence_dynamic(mesh, tr.positions,
                                         shear_threshold=1.08,
                                         min_quality=0.15)
    print(f"  remesh events at frames {dyn['events']}; "
          f"shear p95 max {dyn['max_shear_p95'].max():.2f} "
          f"(bounded by the 1.08 trigger), "
          f"quality floor {dyn['quality_min'].min():.2f}")

    np.savez_compressed(
        os.path.join(args.out_dir, "mesh_tracks.npz"),
        vertices=mesh.vertices, triangles=mesh.triangles,
        positions=tr.positions, smoothed=tr.smoothed,
        positions_render=tr_r.positions,
        exx=exx, eyy=eyy, exx_render=exx_r, eyy_render=eyy_r,
        strain_true=strain_true,
        max_shear=strain["max_shear"],
        dyn_shear_p95=dyn["max_shear_p95"],
        dyn_quality_min=dyn["quality_min"],
        dyn_events=np.asarray(dyn["events"], np.int32))
    ok = (err_x < 0.06 and err_y < 0.05 and len(dyn["events"]) >= 1
          and err_xr < 0.03 and err_yr < 0.03)
    print(("OK" if ok else "DEGRADED"), "->", args.out_dir)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
