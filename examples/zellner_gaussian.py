#!/usr/bin/env python3
"""Synthetic contaminated-Gaussian coreset experiment.

Reproduces reference examples/zellner_gaussian/main.py: N Gaussian points
plus three outlier clusters; build {BCORES, BPSVI, SVI, GIGAO, GIGAR, RAND,
PRIOR} coresets for sizes m = 1..M; score each size by closed-form
reverse/forward KL against the clean-data posterior; pickle the results.

Usage:  python3 examples/zellner_gaussian.py --alg BCORES --trial 1
"""

import argparse
import os
import pickle
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import betacores_tpu as bc
from betacores_tpu import snnls as snnls_mod
from betacores_tpu.data import gen_synthetic_gaussian
from betacores_tpu.evaluation import reverse_forward_kl
from betacores_tpu.inference import gaussian_conjugate_sampler, prior_gaussian_sampler
from betacores_tpu.models import gaussian as gmod

ALGS = ["BCORES", "BPSVI", "SVI", "GIGAO", "GIGAR", "IHTO", "IHTR", "RAND", "PRIOR"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", choices=ALGS, default="BCORES")
    ap.add_argument("--trial", type=int, default=1)
    ap.add_argument("--M", type=int, default=200)
    ap.add_argument("--N", type=int, default=5000)
    ap.add_argument("--d", type=int, default=100)
    ap.add_argument("--proj-dim", type=int, default=200)
    ap.add_argument("--opt-itrs", type=int, default=1000)
    ap.add_argument("--n-subsample-opt", type=int, default=200)
    ap.add_argument("--n-subsample-select", type=int, default=1000)
    ap.add_argument("--i0", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--learn-beta", action="store_true",
                    help="jointly optimize beta by gradient (the reference's "
                         "dead learn_beta path, working here)")
    ap.add_argument("--pihat-noise", type=float, default=0.75)
    ap.add_argument("--select-beta", action="store_true",
                    help="BCORES only: pick beta by the trimmed held-out "
                         "predictive criterion (coresets/select_beta.py) over "
                         "--beta-grid before the main trajectory, overriding "
                         "--beta. The robust alternative to --learn-beta (the "
                         "in-build tangent objective cannot identify beta; "
                         "see select_beta.py docstring)")
    ap.add_argument("--beta-grid", default="0.01,0.05,0.1,0.2,0.3,0.5,0.7,1.0")
    ap.add_argument("--select-trim", type=float, default=0.2,
                    help="fraction of lowest held-out scores to drop; choose "
                         ">= the suspected contamination rate")
    ap.add_argument("--select-M", type=int, default=0,
                    help="coreset size for the selection builds (0 = --M)")
    ap.add_argument("--results-dir", default="results")
    args = ap.parse_args()

    key = jax.random.key(args.trial)
    kd, kh = jax.random.split(key)
    X, Xc, Sig = gen_synthetic_gaussian(kd, N=args.N, d=args.d, dtype=jnp.float32)
    d = args.d
    mu0, Sig0 = jnp.zeros(d), jnp.eye(d)
    Sig0inv = jnp.eye(d)
    Siginv = jnp.asarray(np.linalg.inv(np.asarray(Sig)), dtype=jnp.float32)
    logdetSig = float(np.linalg.slogdet(np.asarray(Sig))[1])

    model = gmod.bundle(Siginv, logdetSig)
    sampler_w = gaussian_conjugate_sampler(mu0, Sig0inv, Siginv)
    # true posterior of the clean data
    post_full = gmod.weighted_post(mu0, Sig0inv, Siginv, X, jnp.ones(X.shape[0]))

    sched = lambda i: args.i0 / (1.0 + i)
    S = args.proj_dim
    prj_w = bc.BlackBoxProjector(sampler_w, S, model=model)
    prj_bw = bc.BetaBlackBoxProjector(sampler_w, S, model=model)

    # mis-tuned projector for GIGAR (reference main.py:76-84)
    U = float(jax.random.uniform(jax.random.fold_in(kh, 0)))
    muhat = U * post_full.mu  # + (1-U)*0
    Sighat = U * post_full.cov + (1.0 - U) * Sig0
    muhat = muhat + args.pihat_noise * jnp.linalg.norm(muhat) * jax.random.normal(
        jax.random.fold_in(kh, 1), (d,), dtype=jnp.float32)
    Sighat = Sighat * jnp.exp(-2 * args.pihat_noise * jnp.abs(
        jax.random.normal(jax.random.fold_in(kh, 2), (), dtype=jnp.float32)))
    sampler_opt = prior_gaussian_sampler(post_full.mu, jnp.linalg.cholesky(post_full.cov))
    sampler_real = prior_gaussian_sampler(muhat, jnp.linalg.cholesky(Sighat))
    prj_opt = bc.BlackBoxProjector(sampler_opt, S, model=model)
    prj_real = bc.BlackBoxProjector(sampler_real, S, model=model)

    common = dict(opt_itrs=args.opt_itrs, n_subsample_opt=args.n_subsample_opt,
                  n_subsample_select=args.n_subsample_select, step_sched=sched,
                  seed=args.trial, max_size=args.M)
    algs = {
        "BCORES": lambda: bc.BetaCoreset(Xc, prj_bw, beta=args.beta,
                                         learn_beta=args.learn_beta, **common),
        "SVI": lambda: bc.SparseVICoreset(Xc, prj_w, **common),
        "BPSVI": lambda: bc.BatchPSVICoreset(Xc, prj_w, opt_itrs=args.opt_itrs,
                                             n_subsample_opt=args.n_subsample_opt,
                                             step_sched=lambda m: sched,
                                             seed=args.trial, max_size=args.M),
        "GIGAO": lambda: bc.HilbertCoreset(Xc, prj_opt, seed=args.trial),
        "GIGAR": lambda: bc.HilbertCoreset(Xc, prj_real, seed=args.trial),
        # beyond reference: accelerated-IHT Hilbert solves (GIGA-seeded
        # hybrid, never worse than GIGA at equal sparsity — snnls/iht.py)
        "IHTO": lambda: bc.HilbertCoreset(Xc, prj_opt, seed=args.trial,
                                          snnls=snnls_mod.AccIHT),
        "IHTR": lambda: bc.HilbertCoreset(Xc, prj_real, seed=args.trial,
                                          snnls=snnls_mod.AccIHT),
        "RAND": lambda: bc.UniformSamplingCoreset(Xc, seed=args.trial),
        "PRIOR": lambda: None,
    }

    select_record = None
    if args.select_beta:
        if args.alg != "BCORES":
            raise SystemExit("--select-beta only applies to BCORES")
        from betacores_tpu.coresets.select_beta import (driver_select_beta,
                                                        padded_scorer)

        # fresh held-out CONTAMINATED draw from the same generator — the
        # trimmed criterion is contamination-robust by construction, so the
        # held-out split needs no oracle clean/dirty labels
        _, Xho, _ = gen_synthetic_gaussian(jax.random.fold_in(kd, 777),
                                           N=2000, d=d, dtype=jnp.float32)
        M_sel = args.select_M or args.M
        alg_sel = bc.BetaCoreset(Xc, prj_bw, beta=args.beta, **common)

        @jax.jit
        def _pred_ll(wm, pm, xho):
            # held-out predictive: x | mu ~ N(mu, Sig), mu ~ N(mu_w, Sig_w)
            # => x ~ N(mu_w, Sig + Sig_w); per-point log pdf. xho is a jit
            # ARGUMENT (CLAUDE.md: never close a jitted fn over a dataset)
            post = gmod.weighted_post(mu0, Sig0inv, Siginv, pm, wm)
            L = jnp.linalg.cholesky(jnp.asarray(Sig) + post.cov)
            r = jax.scipy.linalg.solve_triangular(L, (xho - post.mu).T, lower=True)
            return (-0.5 * jnp.sum(r * r, axis=0) - jnp.log(jnp.diag(L)).sum()
                    - 0.5 * d * jnp.log(2.0 * jnp.pi))

        score_fn = padded_scorer(args.M, d,
                                 lambda w, p: _pred_ll(w, p, jnp.asarray(Xho)))
        grid = [float(b) for b in args.beta_grid.split(",")]
        best_beta, select_record, cache = driver_select_beta(
            alg_sel, grid, score_fn, args.select_trim, M_sel)
        # closed-form rKL of each candidate build vs the clean posterior —
        # the oracle answer the criterion is supposed to recover (reporting
        # only; the selection above never saw clean/dirty labels)
        grid_rkl = {}
        for b, (wb, pb) in cache.items():
            post_b = gmod.weighted_post(mu0, Sig0inv, Siginv,
                                        jnp.asarray(np.atleast_2d(pb)),
                                        jnp.asarray(np.atleast_1d(wb)))
            grid_rkl[b] = float(reverse_forward_kl(post_b, post_full)[0])
        print("select-beta grid (beta: trimmed-pll | oracle rKL):")
        for b, s in zip(grid, select_record["scores"]):
            mark = " <- selected" if b == best_beta else ""
            print(f"  {b:g}: {s:.4f} | {grid_rkl[b]:.4g}{mark}")
        rkl_argmin = min(grid, key=lambda b: grid_rkl[b])
        print(f"selected beta = {best_beta:g} (oracle rKL argmin = {rkl_argmin:g}) "
              f"[{select_record['select_time_s']:.1f}s for {len(grid)} builds]")
        args.beta = best_beta
        select_record.update({"rkl": grid_rkl, "rkl_argmin": rkl_argmin})

    t0 = time.perf_counter()
    w = [np.zeros(1)]
    p = [np.zeros((1, d))]
    betas = [args.beta]
    alg = algs[args.alg]()
    if args.alg == "PRIOR":
        for m in range(1, args.M + 1):
            w.append(np.zeros(1))
            p.append(np.zeros((1, d)))
    elif args.alg == "BPSVI":
        # vmapped across sizes (replaces the reference's Pool(10))
        from betacores_tpu.coresets import bpsvi_build_batch

        builder = alg._builder_for(args.M)
        wts_b, pts_b, _ = bpsvi_build_batch(builder, jax.random.key(args.trial + 1000),
                                            list(range(1, args.M + 1)), args.M,
                                            jnp.zeros(d, dtype=jnp.float32))
        for m in range(1, args.M + 1):
            wm = np.asarray(wts_b[m - 1])
            keep = wm > 0
            w.append(wm[keep])
            p.append(np.asarray(pts_b[m - 1])[keep])
    elif args.alg in ("GIGAO", "GIGAR", "IHTO", "IHTR"):
        # one on-device program records the weights after EVERY greedy
        # iteration; a per-m build(1, m)/get() loop pays hundreds of device
        # round trips instead
        Wtr = np.asarray(alg.snnls.build_trace(args.M))
        data_np = np.asarray(alg.data)
        for m in range(1, args.M + 1):
            wm = Wtr[m - 1]
            keep = wm > 0
            w.append(wm[keep])
            p.append(data_np[alg._row_map[keep]])
        alg._sync_state()
    elif args.alg == "RAND":
        for wm, pm, im in alg.build_trace(args.M):
            w.append(wm)
            p.append(pm)
    else:
        # one device program records every size's coreset (build_trace);
        # a per-m build(1, m)/get() loop pays per-size device round trips
        for wm, pm, im, bm in alg.build_trace(args.M):
            w.append(wm)
            p.append(pm)
            if args.alg == "BCORES":
                betas.append(bm)
    build_time = time.perf_counter() - t0

    # KL evaluation per coreset size (reference main.py:157-167).
    # Zero-weight pad every coreset to one static shape so a single compiled
    # (weighted_post + KL) program serves all M+1 sizes, then vmap over m.
    cap = max(len(np.atleast_1d(wm)) for wm in w)
    Wpad = np.zeros((args.M + 1, cap), dtype=np.float32)
    Ppad = np.zeros((args.M + 1, cap, d), dtype=np.float32)
    for m in range(args.M + 1):
        wm, pm = np.atleast_1d(w[m]), np.atleast_2d(p[m])
        Wpad[m, : len(wm)] = wm
        Ppad[m, : len(wm)] = pm

    @jax.jit
    def eval_m(wm, pm):
        post_w = gmod.weighted_post(mu0, Sig0inv, Siginv, pm, wm)
        return reverse_forward_kl(post_w, post_full)

    rklw, fklw = jax.vmap(eval_m)(jnp.asarray(Wpad), jnp.asarray(Ppad))
    rklw, fklw = np.asarray(rklw), np.asarray(fklw)

    os.makedirs(args.results_dir, exist_ok=True)
    tag = f"{args.alg}_{args.trial}"
    if args.alg == "BCORES":
        tag += f"_b{args.beta}" + ("_learned" if args.learn_beta else "") \
            + ("_selected" if args.select_beta else "")
    out = os.path.join(args.results_dir, f"results_{tag}.pk")
    with open(out, "wb") as fh:
        pickle.dump({"alg": args.alg, "trial": args.trial, "w": w, "p": p,
                     "rklw": rklw, "fklw": fklw, "betas": betas,
                     "build_time_s": build_time, "select_beta": select_record,
                     "mup": np.asarray(post_full.mu), "Sigp": np.asarray(post_full.cov)}, fh)
    print(f"{args.alg} trial {args.trial}: build {build_time:.1f}s, "
          f"rKL[1]={rklw[1]:.3f} rKL[M]={rklw[args.M]:.3f} -> {out}")


if __name__ == "__main__":
    main()
