"""Per-fusion device time of the 1080p pipeline and of one Farneback
fine-level iteration, from a `jax.profiler` trace, with each fusion's
bytes estimated from the optimized HLO.

    python tools/fusion_report.py [--out chiprun_out/fusions]

For each workload (the RunConfig-default graph and the throughput graph:
whole 9-frame clip, and one fine-level iteration at 1080p) it compiles,
warms, traces `--runs` runs, and sums the device time of every XLA op
(the trace's "XLA Ops" line) per run. Bytes per fusion = its output
bytes + its operand bytes as the HLO declares them (an upper bound on
what the kernel must move: re-reads served by L2 are not subtracted,
gathers are counted at their operands' full size). The achieved rate is
bytes / time and its share is against the H100 SXM's 3.35 TB/s of HBM.
Each op is attributed to the named scope in its HLO metadata (polyexp,
fb_levelN/matrices, fb_levelN/smooth_solve, ekf, corner_pool, ...).

Writes `<out>/<workload>.json` with every op and prints the top ops.
Needs a GPU backend. CUDA-graph replay is turned off for the run
(`--xla_gpu_enable_command_buffer=`) so that every kernel appears in the
trace; wall times here therefore include per-kernel launch costs that
the graph-replayed pipeline does not pay.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
_DT_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "pred": 1,
             "u8": 1, "s8": 1, "s64": 8, "u64": 8, "f64": 8, "s16": 2,
             "u16": 2}
_SHAPE = re.compile(r"\b(f32|bf16|f16|s32|u32|pred|u8|s8|s64|u64|f64|s16|"
                    r"u16)\[([0-9,]*)\]")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DT_BYTES[dt]
    return total


def hlo_fusion_table(hlo_text: str) -> dict:
    """name -> {opcode, bytes, scope} for every kernel-launching op
    (fusion, custom-call, copy, ...) outside the fused computations of an
    optimized HLO module."""
    fused = set(re.findall(r"calls=%?([\w.\-]+)", hlo_text))
    out_bytes = {}
    rows = {}
    comp = None
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            head = line.split("(")[0].split()
            comp = head[-1].lstrip("%") if head else None
            continue
        m = _INSTR.match(line)
        if not m or comp is None:
            continue
        name, rest = m.group(1), m.group(2)
        # result shape is everything before the opcode's '('
        opcode_at = re.search(r"\s([a-z][\w\-]*)\(", rest)
        res = rest[:opcode_at.start()] if opcode_at else rest
        out_bytes[name] = _shape_bytes(res)
        if comp in fused or not opcode_at:
            continue
        opcode = opcode_at.group(1)
        if opcode in ("parameter", "constant", "get-tuple-element", "tuple",
                      "bitcast", "while", "conditional", "call",
                      "after-all", "partition-id", "replica-id"):
            continue
        args = rest[opcode_at.end():]
        depth, end = 1, len(args)
        for i, ch in enumerate(args):
            depth += ch == "("
            depth -= ch == ")"
            if depth == 0:
                end = i
                break
        operands = re.findall(r"%([\w.\-]+)", args[:end])
        scope = ""
        mm = re.search(r'op_name="([^"]*)"', rest)
        if mm:
            parts = [p for p in mm.group(1).split("/")
                     if not p.startswith(("jit(", "pjit(", "while",
                                          "body", "cond", "closed_call",
                                          "checkpoint", "remat", "vmap(",
                                          "branch_"))]
            scope = "/".join(parts[:-1])
        rows[name] = {"opcode": opcode, "out": out_bytes[name],
                      "operands": operands, "scope": scope}
    for r in rows.values():
        r["bytes"] = r["out"] + sum(out_bytes.get(o, 0)
                                    for o in r.pop("operands"))
        r.pop("out")
    return rows


def _stats(ev) -> dict:
    try:
        return dict(ev.stats)
    except (TypeError, ValueError):
        return {}


def trace_ops(fn, args, runs: int, trace_dir: str) -> dict:
    """Device time per XLA op, summed over `runs` runs / runs.

    Reads the GPU planes of the trace: the events of the "XLA Ops" line
    when the trace has one, else every kernel on the "Stream" lines,
    named by its `hlo_op` stat (the HLO instruction it implements) or,
    failing that, by the kernel name. `layout` lists the planes and lines
    seen, for checking the reduction against a new trace format."""
    import jax
    from jax.profiler import ProfileData
    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(trace_dir):
        for _ in range(runs):
            jax.block_until_ready(fn(*args))
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = ProfileData.from_file(path)
    per_op = defaultdict(float)
    busy = []
    layout = {}
    for plane in pd.planes:
        lines = list(plane.lines)
        layout[plane.name] = {
            ln.name: [e.name for e in list(ln.events)[:3]] for ln in lines}
        if "GPU" not in plane.name:
            continue
        names = [ln.name for ln in lines]
        use = ([ln for ln in lines if ln.name == "XLA Ops"]
               if "XLA Ops" in names else
               [ln for ln in lines if ln.name.startswith("Stream")])
        for line in use:
            for ev in line.events:
                st = _stats(ev)
                op = st.get("hlo_op") or ev.name
                per_op[str(op)] += ev.duration_ns / runs
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy.sort()
    union, cur_s, cur_e = 0.0, None, None
    for s, e in busy:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        union += cur_e - cur_s
    span = (busy[-1][1] - busy[0][0]) / runs if busy else 0.0
    return {"ops_ns": dict(per_op), "busy_ns": union / runs,
            "span_ns": span, "layout": layout}


def _lookup(table: dict, op: str) -> dict:
    """HLO row of a trace op name (kernel names replace '.' by '_')."""
    if op in table:
        return table[op]
    head, _, tail = op.rpartition("_")
    if tail.isdigit() and f"{head}.{tail}" in table:
        return table[f"{head}.{tail}"]
    return {"bytes": 0, "scope": "?", "opcode": "?"}


def report(name, fn, args, runs, out_dir):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    wall_first = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    table = hlo_fusion_table(fn.lower(*args).compile().as_text())
    with tempfile.TemporaryDirectory() as td:
        tr = trace_ops(fn, args, runs, td)
    rows = []
    for op, ns in tr["ops_ns"].items():
        info = _lookup(table, op)
        rate = info["bytes"] / (ns * 1e-9) if ns > 0 else 0.0
        rows.append({"op": op, "us": ns / 1e3, "opcode": info["opcode"],
                     "scope": info["scope"], "bytes": info["bytes"],
                     "gbps": rate / 1e9,
                     "hbm_share": rate / HBM_BYTES_PER_S})
    rows.sort(key=lambda r: -r["us"])
    by_scope = defaultdict(float)
    for r in rows:
        key = r["scope"].split("/")[0] or "(none)"
        if key.startswith("fb_level"):
            key = r["scope"].split("/")[0] + "/" + (
                r["scope"].split("/")[1] if "/" in r["scope"] else "")
        by_scope[key] += r["us"]
    summary = {"workload": name, "wall_ms_median": float(np.median(times))
               * 1e3, "first_call_s": wall_first,
               "device_busy_ms": tr["busy_ns"] / 1e6,
               "device_span_ms": tr["span_ns"] / 1e6,
               "trace_layout": tr["layout"],
               "op_sum_ms": sum(r["us"] for r in rows) / 1e3,
               "scope_ms": {k: v / 1e3 for k, v in sorted(
                   by_scope.items(), key=lambda kv: -kv[1])},
               "ops": rows}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"== {name}: wall {summary['wall_ms_median']:.3f} ms, device "
          f"busy {summary['device_busy_ms']:.3f} ms, op sum "
          f"{summary['op_sum_ms']:.3f} ms", flush=True)
    print("   by scope (ms): " + ", ".join(
        f"{k}={v:.3f}" for k, v in list(summary["scope_ms"].items())[:12]))
    for r in rows[:14]:
        print(f"   {r['us']:9.1f} us {r['opcode']:11s} "
              f"{r['bytes'] / 1e6:8.1f} MB {r['gbps']:7.0f} GB/s "
              f"({100 * r['hbm_share']:5.1f}%) {r['scope'][:40]:40s} "
              f"{r['op'][:40]}", flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "fusions"))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    # XLA replays each jitted program as one CUDA graph ("command_buffer"
    # in the trace), which hides the kernels inside it; off for this run
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_enable_command_buffer" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_gpu_enable_command_buffer=").strip()
    import jax
    import jax.numpy as jnp
    if jax.default_backend() != "gpu":
        print("fusion_report: needs a GPU backend", file=sys.stderr)
        return 2
    from kalman_hydra_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache(ROOT)
    import bench
    from kalman_hydra_tpu import pipeline as pl
    from kalman_hydra_tpu.config import (EkfConfig, FlowConfig, RunConfig,
                                         TrackConfig)
    from kalman_hydra_tpu.ops import farneback as fb
    from kalman_hydra_tpu.ops.color import grayscale_u8

    h, w, t, k = 1080, 1920, 9, 1024
    frames, _ = bench.make_clip(t, h, w)
    frames_d = jnp.asarray(frames)
    seeds = jnp.asarray(bench.seed_grid(k, h, w))
    default = RunConfig(ekf=EkfConfig(state_dim=6),
                        tracks=TrackConfig(num_tracks=k))
    fast = bench.pipeline_config(num_tracks=k)
    for name, cfg in (("pipeline_default", default),
                      ("pipeline_throughput", fast)):
        fn = jax.jit(lambda f, s, cfg=cfg: pl.track_arrays(
            f, cfg, seeds=s)["pos"])
        report(name, fn, (frames_d, seeds), args.runs, args.out)
    # one fine-level iteration with a realistic flow field
    g = grayscale_u8(frames_d[:2])
    for name, flow_cfg in (("iter_exact_f32", FlowConfig()),
                           ("iter_fastwarp_bf16",
                            FlowConfig(fast_warp=8, bf16_poly=True))):
        R0 = fb.polyexp_pyramid(g[0], flow_cfg)[-1]
        R1 = fb.polyexp_pyramid(g[1], flow_cfg)[-1]
        flow = jnp.moveaxis(fb.farneback(g[0], g[1], flow_cfg), -1, 0)

        def it(a, b, f, c=flow_cfg):
            M = fb.update_matrices_p(a, b, f, fast_warp=c.fast_warp)
            return fb.update_flow_p(M, c.winsize, c.gaussian_win)
        report(name, jax.jit(it), (R0, R1, flow), args.runs * 3, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
