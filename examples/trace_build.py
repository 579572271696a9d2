#!/usr/bin/env python3
"""Device busy and idle share of the headline build, from a profiler trace.

Builds the headline problem (``betacores_tpu/headline.py``: N=1M
contaminated logistic-regression rows, d=10, S=100, opt_itrs=500,
n_subsample_select=1000, n_subsample_opt=200, beta=0.1), compiles and warms
the build, then traces two build iterations with ``jax.profiler`` and
reduces the trace of the first GPU's stream lines to:

  * the device window (first device event's start to the last one's end;
    the host clock's window of the traced call is printed beside it) and
    the device's busy time (the union of the intervals in which an
    operation runs on the device), so idle share = 1 - busy / window;
  * device events per Adam step, and the top operations by total time;
  * device-to-host copies: a ``lax.while_loop`` whose trip count is not
    known at compile time copies its predicate to the host every turn.

Run it on a GPU: python examples/trace_build.py [--out summary.json]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ITRS = 2                  # traced build iterations (1,000 Adam steps)
PLANE = "/device:GPU:0"   # trace plane of the device
LINE = "Stream"           # prefix of that plane's lines that hold device work


def union_ns(intervals):
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(path: str, plane_prefix: str, line_prefix: str,
                 host_ns: float, n_steps: int):
    """Summary of the lines starting with ``line_prefix`` (the GPU's stream
    lines; its "XLA Modules" and "XLA Ops" lines restate the same time) of
    the planes starting with ``plane_prefix`` in the xplane file at
    ``path``."""
    import jax

    pd = jax.profiler.ProfileData.from_file(path)
    spans, per_name, per_count, copies = [], collections.Counter(), collections.Counter(), 0
    planes = [p for p in pd.planes if p.name.startswith(plane_prefix)]
    lines = collections.Counter()
    for plane in planes:
        for line in plane.lines:
            lines[line.name] += sum(1 for _ in line.events)
            if not line.name.startswith(line_prefix):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.end_ns))
                per_name[ev.name] += ev.duration_ns
                per_count[ev.name] += 1
                low = ev.name.lower()
                if "memcpy" in low and ("dtoh" in low or "d2h" in low):
                    copies += 1
    busy = union_ns(spans)
    window_ns = (max(e for _, e in spans) - min(s for s, _ in spans)) if spans else 0
    return {
        "planes": [p.name for p in planes],
        "lines": dict(lines),
        "host_window_ms": host_ns / 1e6,
        "window_ms": window_ns / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window_ns if window_ns else None,
        "device_events": len(spans),
        "events_per_adam_step": len(spans) / n_steps,
        "device_to_host_copies": copies,
        "top_by_time": [(n, per_name[n] / 1e6, per_count[n])
                        for n, _ in per_name.most_common(15)],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the summary here (JSON)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from betacores_tpu import headline as H
    from betacores_tpu.coresets import init_state, make_incremental_builder
    from betacores_tpu.inference import logreg_laplace_sampler
    from betacores_tpu.models import logreg

    dev = jax.devices()[0]
    k_data, k2 = jax.random.split(jax.random.key(0))
    Z = H.data(k_data)
    build = make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(),
                                     H.config()).build
    st0 = init_state(H.M_BUF, H.D, beta=H.BETA, dtype=jnp.float32)
    jax.block_until_ready(build(k2, st0, ITRS))            # compile + warm
    logdir = tempfile.mkdtemp(prefix="trace_build_")
    with jax.profiler.trace(logdir):
        t0 = time.perf_counter_ns()
        jax.block_until_ready(build(k2, st0, ITRS))
        window = time.perf_counter_ns() - t0
    (path,) = glob.glob(os.path.join(logdir, "plugins", "profile", "*", "*.xplane.pb"))
    summary = reduce_trace(path, PLANE, LINE, window, ITRS * H.OPT_ITRS)
    summary.update(device=dev.device_kind, itrs=ITRS)
    for k, v in summary.items():
        if k != "top_by_time":
            print(f"{k}: {v}")
    for name, ms, n in summary["top_by_time"]:
        print(f"  {ms:10.3f} ms  {n:7d}x  {name[:100]}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
