"""Full-candidate (n_subsample=None) builds at headline scale, with roofline
accounting against the card's published peaks.

The reference's DEFAULT semantics score ALL N candidates every selection
(reference bayesiancoresets/coreset/sparsevi.py:14-15: ``n_subsample=None``
unless the caller subsamples), and its exact-gradient mode sums over all N
every optimization step. Unlike the subsampled headline config (a
latency-bound chain of 50k small dependent steps), these are
bandwidth/throughput-bound (N, S) passes.

Configs (N=1M contaminated logreg rows, d=10, M=100 selections, S=100):

  headline  n_sel=1000, n_opt=200, 500 Adam itrs   (control; bench.py config)
  fullsel   n_sel=None, n_opt=200, 500 Adam itrs   (reference default select)
  fullopt   n_sel=None, n_opt=None, 50 Adam itrs   (exact Sigma-over-N gradient)

For each config this prints wall clock plus an analytic roofline: the
mandatory device-memory bytes and FLOPs of the (N, S) passes, and the
achieved share of the card's published peaks (betacores_tpu/utils/
device.py, keyed by device kind; an unknown card is an error). Two memory
floors are reported for the select pass: the MATERIALIZING floor (write +
re-read the (N, S) projection — what a two-pass XLA program must move, the
residual needs the full column sum before candidates can be scored) and
the STREAMING floor (read the 40 MB dataset twice, recompute the
projection in the second pass — what a fused kernel could reach if the
transform were free).

Timing: end-to-end build ended by a host fetch of the final state. Run it
on a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

N, D_FEAT, M, S = 1_000_000, 10, 100, 100   # defaults; --n/--d override
M_BUF = 128

PEAK_FLOPS = PEAK_BW = None   # set from the card in main()

def _roofline(name, t, n_full_sel, n_full_opt, opt_itrs):
    # reads module globals N/D_FEAT, which main() may override via --n/--d
    """Floors of the byte model: XLA keeps the (N, S) margin DOT's output as
    a materialization boundary — the dot itself is cheap (k = d = 10), but
    its result is written to device memory once and read once per consumer
    pass. The select pass has two consumer reads (column sums, then row
    scores once the residual exists); the optimize pass one. The
    'streaming' floor is what a kernel that never materializes (N, S) would
    move (examples/bench_select_pass.py measures the components)."""
    d = D_FEAT  # Z = y * X is exactly (N, d) (data/synthetic.py:27)
    row_bytes = N * d * 4
    ns_bytes = N * S * 4
    sel_flops = 2 * N * d * S + 4 * N * S          # proj matmul + score matvecs
    opt_flops = 2 * N * d * S + 2 * N * S          # proj matmul + column sum

    n_steps = M * opt_itrs
    flops = n_full_sel * sel_flops + (opt_flops * n_steps if n_full_opt else 0)
    bytes_mat = (n_full_sel * (row_bytes + 3 * ns_bytes)
                 + ((row_bytes + 2 * ns_bytes) * n_steps if n_full_opt else 0))
    bytes_stream = (n_full_sel * 2 * row_bytes
                    + (row_bytes * n_steps if n_full_opt else 0))
    floors = {
        "flop_s": flops / PEAK_FLOPS,
        "hbm_mat_s": bytes_mat / PEAK_BW,
        "hbm_stream_s": bytes_stream / PEAK_BW,
    }
    print(
        f"[{name}] wall {t:.3f}s | analytic floors: "
        f"f32 {floors['flop_s']*1e3:.0f} ms, "
        f"HBM(dot-boundary) {floors['hbm_mat_s']*1e3:.0f} ms, "
        f"HBM(streaming) {floors['hbm_stream_s']*1e3:.0f} ms | achieved "
        f"{100*flops/(t*PEAK_FLOPS):.2f}% f32 peak, "
        f"{100*bytes_mat/(t*PEAK_BW):.1f}% HBM(dot-boundary), "
        f"{100*bytes_stream/(t*PEAK_BW):.1f}% HBM(stream)",
        file=sys.stderr,
    )
    return floors


def main():
    global N, D_FEAT, PEAK_FLOPS, PEAK_BW
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="*",
                    default=["headline", "fullsel", "fullopt"])
    ap.add_argument("--fullopt-itrs", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--d", type=int, default=D_FEAT)
    ap.add_argument("--quality", action="store_true",
                    help="also score each config's FINAL coreset downstream: "
                         "Laplace posterior on the coreset -> held-out "
                         "accuracy / predictive log-likelihood on 20k clean "
                         "rows, plus the shared-key tangent error")
    args = ap.parse_args()
    N, D_FEAT = args.n, args.d

    import jax
    import jax.numpy as jnp

    from betacores_tpu.coresets import (IncrementalConfig, init_state,
                                        make_incremental_builder)
    from betacores_tpu.data import gen_synthetic_logreg, perturb_logreg
    from betacores_tpu.inference import logreg_laplace_sampler
    from betacores_tpu.models import logreg
    from betacores_tpu.utils.device import peaks, require_gpu

    pk = peaks(require_gpu().device_kind)
    PEAK_FLOPS, PEAK_BW = pk["f32_flops"], pk["hbm_bytes_per_s"]
    print(f"devices: {jax.devices()}", file=sys.stderr)
    k0, k1, k2 = jax.random.split(jax.random.key(0), 3)
    X, y, Z = gen_synthetic_logreg(k0, N, d=D_FEAT, dtype=jnp.float32)
    X, y, Z, _ = perturb_logreg(k1, X, y, f_rate=0.1)
    Z = jax.block_until_ready(Z)
    if args.quality:
        # clean held-out rows from the same generator (no corruption)
        Xt, yt, Zt = gen_synthetic_logreg(jax.random.key(7), 20_000, d=D_FEAT,
                                          dtype=jnp.float32)
        # ONE shared FULL-DATA tangent-error estimator for every config —
        # each builder's own error() uses its config's n_subsample_opt, and
        # a subsampled estimate is inflated by estimator variance, so
        # cross-config comparisons need the exact residual
        from betacores_tpu.coresets.incremental import make_tangent_error

        shared_err = None  # built below once model/sampler exist

        @jax.jit
        def _quality(wts, pts, slot_mask):
            from betacores_tpu.inference.laplace import (newton_laplace,
                                                         sample_laplace)

            wm = wts * slot_mask
            lap = newton_laplace(
                lambda th: logreg.log_joint(pts, th, wm),
                lambda th: logreg.grad_th_log_joint(pts, th, wm),
                lambda th: logreg.hess_th_log_joint(pts, th, wm),
                jnp.zeros(pts.shape[1], dtype=jnp.float32), n_iters=25)
            ths = sample_laplace(jax.random.key(9), lap, 256)
            return (logreg.compute_accuracy(Xt, yt, ths),
                    logreg.predictive_loglik(Zt, ths))

    cfg_by_name = {
        "headline": IncrementalConfig(projection_dim=S, n_subsample_select=1000,
                                      n_subsample_opt=200, opt_itrs=500, i0=1.0,
                                      use_beta=True),
        "fullsel": IncrementalConfig(projection_dim=S, n_subsample_select=None,
                                     n_subsample_opt=200, opt_itrs=500, i0=1.0,
                                     use_beta=True),
        "fullopt": IncrementalConfig(projection_dim=S, n_subsample_select=None,
                                     n_subsample_opt=None,
                                     opt_itrs=args.fullopt_itrs, i0=1.0,
                                     use_beta=True),
    }
    model = logreg.bundle()
    sampler = logreg_laplace_sampler()
    st0 = init_state(M_BUF, D_FEAT, beta=0.1, dtype=jnp.float32)

    out = {}
    for name in args.configs:
        cfg = cfg_by_name[name]
        builder = make_incremental_builder(Z, model, sampler, cfg)
        t0 = time.perf_counter()
        st = builder.build(k2, st0, M)
        m_sel = int(st.m)  # host fetch forces sync
        t_first = time.perf_counter() - t0
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            st = builder.build(k2, st0, M)
            m_sel = int(st.m)
            times.append(time.perf_counter() - t0)
        t = min(times)
        wsum = float(jnp.asarray(st.wts).sum())
        print(f"[{name}] first(incl compile) {t_first:.1f}s; runs "
              f"{['%.3f' % x for x in times]}; m={m_sel} sum(w)={wsum:.1f}",
              file=sys.stderr)
        floors = _roofline(name, t,
                           n_full_sel=(M if cfg.n_subsample_select is None else 0),
                           n_full_opt=cfg.n_subsample_opt is None,
                           opt_itrs=cfg.opt_itrs)
        out[name] = {"wall_s": round(t, 3), "m": m_sel,
                     "sum_w": round(wsum, 1), "opt_itrs": cfg.opt_itrs,
                     **{k: round(v, 4) for k, v in floors.items()}}
        if args.quality:
            if shared_err is None:
                shared_err = make_tangent_error(
                    Z, model, sampler,
                    IncrementalConfig(projection_dim=S, n_subsample_opt=None,
                                      use_beta=True))
            err = float(shared_err(jax.random.key(123), st))
            acc, pll = _quality(st.wts, st.pts,
                                st.slot_mask.astype(jnp.float32))
            acc, pll = float(acc), float(pll)
            print(f"[{name}] quality: tangent err {err:.1f} (shared key), "
                  f"held-out acc {acc:.4f}, pll {pll:.4f}", file=sys.stderr)
            out[name].update(tangent_err=round(err, 2), acc=round(acc, 4),
                             pll=round(pll, 4))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
