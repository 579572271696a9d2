#!/usr/bin/env python3
"""Measure the native C++ loader against numpy text parsing (a speedup
claim must be a measured number).

Generates webspam-shaped synthetic files (the reference's largest published
config: d=127 features + label, N=126,185 — data_tabulate.py:3-7) as CSV and
svmlight, parses each with native/loader.cpp and with the numpy/pure-Python
fallbacks, cross-checks values, and reports MB/s + speedups. A --scale-rows
GB-class CSV is additionally parsed native-only (the numpy baseline at that
size is minutes-class; its rate is size-independent, so the small-file rate
is the honest baseline).

Run: python3 examples/bench_native_loader.py [--rows 126185] [--scale-rows 1000000]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from betacores_tpu.data import native_loader as nl


def gen_csv(path, rows, cols, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            vals = rng.standard_normal(cols)
            f.write(",".join(f"{v:.6f}" for v in vals) + "\n")
    return os.path.getsize(path)


def gen_svmlight(path, rows, n_features, nnz_per_row, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            y = rng.choice([-1, 1])
            idx = np.sort(rng.choice(n_features, nnz_per_row, replace=False)) + 1
            vals = rng.standard_normal(nnz_per_row)
            f.write(f"{y} " + " ".join(
                f"{i}:{v:.6f}" for i, v in zip(idx, vals)) + "\n")
    return os.path.getsize(path)


def timed(fn, reps=2):
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=126_185)
    ap.add_argument("--cols", type=int, default=128,
                    help="webspam: 127 features + label")
    ap.add_argument("--scale-rows", type=int, default=1_000_000,
                    help="rows for the GB-class native-only CSV parse "
                         "(0 = skip)")
    ap.add_argument("--nnz", type=int, default=32,
                    help="nonzeros per svmlight row")
    ap.add_argument("--workdir", default="/tmp/bcloader_bench")
    args = ap.parse_args()

    if not nl.native_available():
        print(json.dumps({"error": "native loader unavailable (no toolchain)"}))
        return 1
    os.makedirs(args.workdir, exist_ok=True)
    rec = {"host_cores": os.cpu_count()}

    # --- CSV, webspam shape ---
    csv_path = os.path.join(args.workdir, "webspam_shape.csv")
    if not os.path.exists(csv_path):
        gen_csv(csv_path, args.rows, args.cols)
    sz = os.path.getsize(csv_path)
    t_nat, X_nat = timed(lambda: nl.load_csv(csv_path))
    t_np, X_np = timed(
        lambda: np.atleast_2d(np.genfromtxt(csv_path, delimiter=",")
                              .astype(np.float32)), reps=1)
    t_lt, X_lt = timed(
        lambda: np.loadtxt(csv_path, delimiter=",").astype(np.float32), reps=1)
    assert X_nat.shape == X_np.shape == (args.rows, args.cols)
    err = float(np.max(np.abs(X_nat - X_np)))
    rel = err / float(np.max(np.abs(X_np)))
    assert rel < 1e-6, f"native CSV values diverge from numpy: rel={rel}"
    rec["csv"] = {
        "rows": args.rows, "cols": args.cols, "mb": round(sz / 1e6, 1),
        "native_s": round(t_nat, 3), "native_mb_s": round(sz / 1e6 / t_nat, 1),
        "genfromtxt_s": round(t_np, 2), "loadtxt_s": round(t_lt, 2),
        "speedup_vs_genfromtxt": round(t_np / t_nat, 1),
        "speedup_vs_loadtxt": round(t_lt / t_nat, 1),
        "max_rel_err_vs_numpy": rel,
    }
    print(f"CSV {sz/1e6:.0f} MB: native {t_nat:.2f}s "
          f"({sz/1e6/t_nat:.0f} MB/s), genfromtxt {t_np:.1f}s, "
          f"loadtxt {t_lt:.1f}s -> {t_np/t_nat:.1f}x / {t_lt/t_nat:.1f}x",
          file=sys.stderr)

    # --- svmlight, webspam shape (webspam ships as svmlight) ---
    svm_path = os.path.join(args.workdir, "webspam_shape.svm")
    if not os.path.exists(svm_path):
        gen_svmlight(svm_path, args.rows, args.cols - 1, args.nnz)
    ssz = os.path.getsize(svm_path)
    t_snat, (Xs, ys) = timed(lambda: nl.load_svmlight(svm_path, args.cols - 1))
    t_spy, (Xp, yp) = timed(
        lambda: nl._svmlight_numpy(svm_path, args.cols - 1), reps=1)
    assert Xs.shape == Xp.shape
    srel = float(np.max(np.abs(Xs - Xp))) / max(float(np.max(np.abs(Xp))), 1e-9)
    assert srel < 1e-6 and np.array_equal(ys, yp)
    rec["svmlight"] = {
        "rows": args.rows, "mb": round(ssz / 1e6, 1),
        "native_s": round(t_snat, 3),
        "native_mb_s": round(ssz / 1e6 / t_snat, 1),
        "python_s": round(t_spy, 2),
        "speedup_vs_python": round(t_spy / t_snat, 1),
        "max_rel_err": srel,
    }
    print(f"svmlight {ssz/1e6:.0f} MB: native {t_snat:.2f}s "
          f"({ssz/1e6/t_snat:.0f} MB/s), pure-python {t_spy:.1f}s "
          f"-> {t_spy/t_snat:.1f}x", file=sys.stderr)

    # --- GB-class CSV, native only ---
    if args.scale_rows:
        big_path = os.path.join(args.workdir, "scale.csv")
        if not os.path.exists(big_path):
            print(f"generating {args.scale_rows}-row CSV...", file=sys.stderr)
            gen_csv(big_path, args.scale_rows, args.cols, seed=1)
        bsz = os.path.getsize(big_path)
        t_big, Xb = timed(lambda: nl.load_csv(big_path), reps=1)
        assert Xb.shape == (args.scale_rows, args.cols)
        rec["csv_scale"] = {"rows": args.scale_rows,
                           "gb": round(bsz / 1e9, 2),
                           "native_s": round(t_big, 2),
                           "native_mb_s": round(bsz / 1e6 / t_big, 1)}
        print(f"CSV {bsz/1e9:.2f} GB: native {t_big:.1f}s "
              f"({bsz/1e6/t_big:.0f} MB/s)", file=sys.stderr)

    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
