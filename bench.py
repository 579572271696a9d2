"""Headline benchmark: build an M=100 beta-coreset over N=1M contaminated
logistic-regression points with the reference hyperparameters (S=100, 500
Adam iterations per selection, n_subsample_select=1000,
n_subsample_opt=200; reference zellner_logreg/main.py:115-127), on a GPU.
The whole build (100 selections x 500 MC-gradient steps, each with a fresh
warm-started Newton-Laplace posterior re-fit, posterior sampling and
beta-projection) runs as ONE compiled XLA program.

Prints exactly one JSON line:
  {"metric": ..., "value": seconds, "unit": "s", "device": {...}, ...}
On any failure, including a process without a GPU, a parsable failure
record (value=-1) is printed instead and the exit code is 1.
"""

import json
import sys
import time
import traceback

from betacores_tpu import headline as H
from betacores_tpu.utils.device import peaks, require_gpu

N, D_FEAT, M, S, M_BUF = H.N, H.D, H.M, H.S, H.M_BUF
N_SUB_SEL, N_SUB_OPT, OPT_ITRS = H.N_SEL, H.N_OPT, H.OPT_ITRS
METRIC = "bcores_build_n1m_m100_logreg_seconds"

# --full-data: the reference's DEFAULT select semantics (score ALL N
# candidates every selection — reference sparsevi.py:14-15, n_subsample=None)
# instead of the n_subsample_select=1000 headline. Same JSON contract, its
# own metric name.
FULL_DATA = "--full-data" in sys.argv
if FULL_DATA:
    N_SUB_SEL = None
    METRIC = "bcores_build_n1m_m100_logreg_fullselect_seconds"

# --dedup: mask already-selected indices out of the candidate argmax so
# every selection adds a distinct point (IncrementalConfig.dedup_select).
# The default (reference-parity, bcores.py:84) silently drops duplicate
# argmaxes; this mode fills the budget. The JSON line reports the fill
# either way.
DEDUP = "--dedup" in sys.argv
if DEDUP:
    METRIC += "_dedup"


def _roofline(t_build: float, device_kind: str) -> None:
    """Analytic bytes/FLOP budget for the dominant per-step ops and the
    achieved share of the card's published peaks (utils/device.py).
    Estimates only — stderr, never part of the JSON contract."""
    pk = peaks(device_kind)
    d = D_FEAT
    if FULL_DATA:
        per_sel = (N * d + 3 * N * S) * 4          # data read + dot-boundary
        frac = 100 * M * per_sel / (t_build * pk["hbm_bytes_per_s"])
        print(f"roofline (full-candidate select): ~{M * per_sel / 1e9:.1f} GB "
              f"moved in the select passes; {frac:.1f}% of {device_kind} HBM "
              f"bandwidth over the whole build.", file=sys.stderr)
        return
    n_rows = N_SUB_OPT + M_BUF  # data subsample + coreset buffer, projected jointly
    # per Adam step: projection matmul (n,d)@(d,S), beta-lik elementwise
    # (~12 flops/entry), Newton-Laplace refit (~6 iters of n*d^2), resid/corr
    # matvecs over (n,S)
    proj = 2 * n_rows * d * S
    blik = 12 * n_rows * S
    lap = 6 * (N_SUB_OPT * d * d * 2 + d ** 3)
    mv = 4 * n_rows * S
    per_step = proj + blik + lap + mv
    per_sel = 2 * N_SUB_SEL * d * S + OPT_ITRS * per_step
    flops = M * per_sel
    # bytes per Adam step: ~6 materialized (n,S)/(n,d) f32 arrays, plus the
    # random-row gathers from the 40 MB dataset
    bytes_step = 6 * n_rows * S * 4
    gather = M * (OPT_ITRS * N_SUB_OPT + N_SUB_SEL) * d * 4
    bytes_tot = M * OPT_ITRS * bytes_step + gather
    print(
        f"roofline: ~{flops / 1e9:.1f} GFLOP, ~{bytes_tot / 1e9:.2f} GB moved; "
        f"compute floor {flops / pk['f32_flops'] * 1e3:.2f} ms (f32), "
        f"memory floor {bytes_tot / pk['hbm_bytes_per_s'] * 1e3:.1f} ms; "
        f"achieved {100 * flops / (t_build * pk['f32_flops']):.3f}% of f32 peak / "
        f"{100 * bytes_tot / (t_build * pk['hbm_bytes_per_s']):.2f}% of HBM "
        f"bandwidth. The M x opt_itrs = {M * OPT_ITRS} dependent steps make "
        f"the build latency-bound, not roofline-bound.",
        file=sys.stderr,
    )


def run():
    import jax
    import jax.numpy as jnp

    from betacores_tpu.coresets import init_state, make_incremental_builder
    from betacores_tpu.inference import logreg_laplace_sampler
    from betacores_tpu.models import logreg

    print(f"devices: {jax.devices()}", file=sys.stderr)

    k_data, k2 = jax.random.split(jax.random.key(0))
    Z = jax.block_until_ready(H.data(k_data))

    # n_subsample_select is None under --full-data
    cfg = H.config(n_subsample_select=N_SUB_SEL, dedup_select=DEDUP)
    model = logreg.bundle()
    sampler = logreg_laplace_sampler()
    n_dev = jax.device_count()
    if n_dev > 1:
        # several cards: row-shard N over the mesh's data axis; state
        # replicated, distributed argmax.
        from betacores_tpu.parallel import (auto_mesh_shape, make_mesh,
                                            make_sharded_incremental_builder,
                                            shard_data)

        mesh = make_mesh(*auto_mesh_shape(n_dev))
        Zs, n_true = shard_data(Z, mesh)
        build = make_sharded_incremental_builder(Zs, n_true, model, sampler,
                                                 cfg, mesh)
        print(f"sharded build over mesh {dict(mesh.shape)}", file=sys.stderr)
    else:
        build = make_incremental_builder(Z, model, sampler, cfg).build
    st0 = init_state(M_BUF, D_FEAT, beta=H.BETA, dtype=jnp.float32)

    t0 = time.perf_counter()
    st = jax.block_until_ready(build(k2, st0, M))
    t_first = time.perf_counter() - t0

    t0 = time.perf_counter()
    st = jax.block_until_ready(build(k2, st0, M))
    t_build = time.perf_counter() - t0

    n_sel = int(st.m)
    w = jnp.asarray(st.wts)
    print(
        f"first-call (incl compile): {t_first:.2f}s; build: {t_build:.3f}s; "
        f"selected {n_sel}/{M} points, sum(w)={float(w.sum()):.1f}",
        file=sys.stderr,
    )
    assert n_sel >= M // 2, f"degenerate build: only {n_sel} selections"
    if DEDUP:
        assert n_sel == M, f"dedup build under-filled: {n_sel}/{M}"
    _roofline(t_build, jax.devices()[0].device_kind)
    return t_build, n_sel


def main():
    try:
        dev = require_gpu()
        device = {"platform": dev.platform, "kind": dev.device_kind}
        t_build, n_sel = run()
    except Exception as e:  # noqa: BLE001 — the JSON contract must hold
        traceback.print_exc(file=sys.stderr)
        print(json.dumps({
            "metric": METRIC,
            "value": -1.0,
            "unit": "s",
            "error": f"{type(e).__name__}: {e}",
        }))
        return 1
    print(json.dumps({
        "metric": METRIC,
        "value": t_build,
        "unit": "s",
        "device": device,
        "selected": n_sel,
        "budget": M,
        "fill": n_sel / M,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
