"""Headline config on the VIRTUAL 8-device mesh: N=1M, M=100 sharded build.

Executes the full headline configuration (bench.py: N=1M contaminated
logreg rows, M=100 selections x 500 Adam steps, S=100,
n_subsample_select=1000, n_subsample_opt=200) through
``make_sharded_incremental_builder`` on an 8-device virtual CPU mesh end to
end — a rehearsal of shard-local memory behavior, the pre-drawn fast path
and collective correctness at real shapes without several GPUs. The wall
clock here is NOT a device number (virtual devices timeshare host cores);
the point is execution and quality. On four GPUs, `python chip_smoke.py
--four-gpus` runs the same builder.

Run:  python examples/virtual_mesh_headline.py [--mesh 4x2] [--itrs 100]
"""

import argparse
import os
import sys
import time

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# FORCE the CPU backend: this rehearsal never opens a GPU.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="4x2", help="data x samp mesh shape")
    ap.add_argument("--itrs", type=int, default=100, help="selections (M)")
    ap.add_argument("--n", type=int, default=1_000_000)
    # headline values by default; the smoke test shrinks them
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=500)
    ap.add_argument("--n-subsample-select", type=int, default=1000)
    ap.add_argument("--n-subsample-opt", type=int, default=200)
    # the FULL-DATA select config (reference default semantics,
    # n_subsample_select=None) — every shard scores all its local rows, the
    # exact Sigma-over-N meets in one psum('data'), and the distributed
    # argmax runs over every valid row.
    ap.add_argument("--full-data", action="store_true",
                    help="n_subsample_select=None (score ALL N per selection)")
    # the FULL-GRADIENT config — the reference's default semantics on BOTH
    # phases (sparsevi.py:14-15: n_subsample=None everywhere): score ALL N
    # candidates per selection AND optimize with the EXACT Sigma-over-N
    # gradient every Adam step.
    ap.add_argument("--full-gradient", action="store_true",
                    help="n_subsample_select=None AND n_subsample_opt=None "
                         "(exact gradient; pair with --opt-itrs 50)")
    ap.add_argument("--census", action="store_true",
                    help="also AOT-lower ONE build iteration of this config "
                         "for CUDA at reduced shapes and print "
                         "its per-step collective mix (shape-independent)")
    args = ap.parse_args()
    if args.full_gradient:
        args.full_data = True
        args.n_subsample_opt = None
    if args.full_data:
        args.n_subsample_select = None
    n_data, n_samp = (int(t) for t in args.mesh.split("x"))

    import jax
    import jax.numpy as jnp
    import numpy as np

    from betacores_tpu.coresets import IncrementalConfig, init_state
    from betacores_tpu.data import gen_synthetic_logreg, perturb_logreg
    from betacores_tpu.inference import logreg_laplace_sampler
    from betacores_tpu.models import logreg
    from betacores_tpu.parallel import (make_mesh,
                                        make_sharded_incremental_builder,
                                        shard_data)

    assert jax.device_count() >= n_data * n_samp, jax.devices()
    N, D_FEAT, S = args.n, 10, args.proj_dim
    k0, k1, k2 = jax.random.split(jax.random.key(0), 3)
    X, y, Z = gen_synthetic_logreg(k0, N, d=D_FEAT, dtype=jnp.float32)
    X, y, Z, _ = perturb_logreg(k1, X, y, f_rate=0.1)
    Z = jax.block_until_ready(Z)

    cfg = IncrementalConfig(projection_dim=S,
                            n_subsample_select=args.n_subsample_select,
                            n_subsample_opt=args.n_subsample_opt,
                            opt_itrs=args.opt_itrs, i0=1.0,
                            use_beta=True)
    model, sampler = logreg.bundle(), logreg_laplace_sampler()
    mesh = make_mesh(n_data, n_samp)
    Zs, n_true = shard_data(Z, mesh)
    build = make_sharded_incremental_builder(Zs, n_true, model, sampler,
                                             cfg, mesh)
    st0 = init_state(128, D_FEAT, beta=0.1, dtype=jnp.float32)

    t0 = time.perf_counter()
    st = jax.block_until_ready(build(k2, st0, args.itrs))
    t_total = time.perf_counter() - t0
    w = np.asarray(st.wts)
    idcs = np.asarray(st.idcs)[: int(st.m)]
    ok = (int(st.m) > 0 and np.isfinite(w).all() and (w >= 0).all()
          and (idcs >= 0).all() and (idcs < N).all()
          and len(set(idcs.tolist())) == len(idcs))
    mode = ("full-gradient" if args.full_gradient
            else "full-select" if args.full_data else "headline")
    print(f"[{mode}] mesh={dict(mesh.shape)} N={N} M={args.itrs} S={S} "
          f"opt_itrs={args.opt_itrs}: "
          f"selected m={int(st.m)}, nnz(w)={(w > 0).sum()}, "
          f"sum(w)={w.sum():.1f} (N={N}), "
          f"wall={t_total:.1f}s (compile included; virtual CPU devices — "
          f"not a device number), ok={ok}")

    if args.census:
        # Per-step collective mix of THIS config, from the CUDA StableHLO
        # (jax.export cross-platform lowering — no GPU needed).
        # Collective COUNT per step is shape-independent, so lower at tiny
        # shapes: the full-size export would embed the closed-over N=1M
        # shard constants into the module.
        N_c = 16 * n_data + 3
        Zc = Z[:N_c]
        cfg_c = IncrementalConfig(
            projection_dim=n_samp * 4,
            n_subsample_select=None if args.n_subsample_select is None else 8 * n_data,
            n_subsample_opt=None if args.n_subsample_opt is None else 4 * n_data,
            opt_itrs=3, i0=1.0, use_beta=True)
        Zcs, nc_true = shard_data(Zc, mesh)
        build_c = make_sharded_incremental_builder(Zcs, nc_true, model,
                                                   sampler, cfg_c, mesh)
        st_c = init_state(8, D_FEAT, beta=0.1, dtype=jnp.float32)
        exp = jax.export.export(
            jax.jit(lambda k, s: build_c(k, s, 1)), platforms=["cuda"]
        )(k2, st_c)
        txt = exp.mlir_module()
        counts = {k: txt.count(f"stablehlo.{k}") for k in
                  ("all_reduce", "all_gather", "collective_permute",
                   "reduce_scatter")}
        # normalize to per-Adam-step: subtract the select pass's share by
        # lowering a 0-opt variant is overkill — report the raw per-build-
        # iteration mix (select + opt_itrs Adam steps) plus opt_itrs so the
        # reader can divide
        print(f"[{mode}] collective census (1 select + {cfg_c.opt_itrs} Adam "
              f"steps, CUDA StableHLO): {counts}; no host callbacks: "
              f"{'stablehlo.custom_call @xla_python_cpu_callback' not in txt}")

    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
