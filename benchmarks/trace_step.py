#!/usr/bin/env python3
"""Profile one 16x1080p q=50 encode step on the GPU and list its top ops.

    python benchmarks/trace_step.py [--steps 3] [--top 25] [--out DIR]

Runs the jitted correct-mode pipeline (models/mpeg1._jitted_correct_pipeline,
RGB intake, integer AAN DCT) on device-resident frames: compile, warm up,
time 10 steps with block_until_ready, then trace `--steps` steps with
jax.profiler and reduce the trace (reduce_trace below) to

  * the wall time of one step (median of the timed steps),
  * device busy time and idle share over the traced window,
  * the top device ops by summed duration.

Prints one JSON object.  Fails when JAX finds no GPU: a CPU run is not a
device measurement.
"""

from __future__ import annotations

import os

os.environ["JAX_PLATFORMS"] = "cuda"

import argparse
import glob
import json
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# lines of a device plane that are summaries, not kernel executions
_SUMMARY_LINES = ("XLA Modules", "XLA Ops", "Steps", "Source", "Framework")


def reduce_trace(xplane_path: str, top: int) -> dict:
    """Device time per op from a jax.profiler xplane file.

    Kernel events are read from every line of each GPU plane that is not
    a summary line (the CUDA stream lines).  Busy time is the union of
    their intervals; the window runs from the first kernel start to the
    last kernel end.  Ops are keyed by the "XLA Ops" line's names when it
    exists (an XLA fusion can launch several kernels), else by kernel."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    out = {"planes": []}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {ln.name: list(ln.events) for ln in plane.lines}
        out["planes"].append({n: len(e) for n, e in lines.items()})
        kernels = [ev for n, evs in lines.items()
                   if not n.startswith(_SUMMARY_LINES) for ev in evs]
        if not kernels:
            continue
        spans = sorted((ev.start_ns, ev.start_ns + ev.duration_ns)
                       for ev in kernels)
        busy, cur_s, cur_e = 0.0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
        per_op = defaultdict(lambda: [0.0, 0])
        for ev in lines.get("XLA Ops") or kernels:
            per_op[ev.name][0] += ev.duration_ns
            per_op[ev.name][1] += 1
        total = sum(v[0] for v in per_op.values())
        ranked = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
        out[plane.name] = {
            "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1 - busy / window if window else None,
            "ops_source": "XLA Ops" if lines.get("XLA Ops") else "kernels",
            "ops_total_ms": total / 1e6,
            "top_ops": [
                {"name": name, "ms": ns / 1e6, "count": cnt,
                 "share": ns / total}
                for name, (ns, cnt) in ranked
            ],
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None,
                    help="keep the trace here (default: a temporary dir)")
    args = ap.parse_args(argv)

    import jax

    from chip_smoke import BATCH, card_line, texture_frames
    from ec504_imageencoder_tpu.models.mpeg1 import (
        MPEG1IntraEncoder,
        _jitted_correct_pipeline,
        pad_to_macroblocks,
    )
    from ec504_imageencoder_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: {dev}")
    enable_compile_cache()
    card = card_line()

    enc = MPEG1IntraEncoder(quality=50)
    frames = pad_to_macroblocks(texture_frames(BATCH, 1))
    msb = enc.resolve_slice_bytes(frames.shape[2] // 16)
    fn = _jitted_correct_pipeline(enc.qscale, msb, enc.dct_impl,
                                  enc.color_range)
    x, q = jax.device_put(frames), jax.device_put(enc.intra_q)
    t0 = time.perf_counter()
    compiled = fn.lower(x, q).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    jax.block_until_ready(compiled(x, q))
    steps = []
    for _ in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(x, q))
        steps.append(time.perf_counter() - t0)

    trace_dir = args.out or tempfile.mkdtemp(prefix="trace_step_")
    with jax.profiler.trace(trace_dir):
        for i in range(args.steps):
            with jax.profiler.StepTraceAnnotation("encode_step", step_num=i):
                jax.block_until_ready(compiled(x, q))
    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    reduced = reduce_trace(max(paths, key=os.path.getmtime), args.top)
    print(json.dumps({
        "card": card,
        "device_kind": dev.device_kind,
        "shape": list(frames.shape),
        "quality": 50,
        "slice_bytes": msb,
        "compile_s": compile_s,
        "step_ms_median": float(np.median(steps)) * 1e3,
        "step_ms_all": [s * 1e3 for s in steps],
        "traced_steps": args.steps,
        "memory_analysis": {
            k: getattr(mem, k) for k in dir(mem)
            if k.endswith("size_in_bytes")
        } if mem is not None else None,
        "trace": reduced,
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
