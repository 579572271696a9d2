#!/usr/bin/env python3
"""Bayesian-logistic-regression coreset experiment on UCI-scale data.

Reproduces reference examples/zellner_logreg/main.py: load an npz dataset
(or generate a synthetic one), whiten covariates, inject f_rate corruption,
build {BCORES, SVI, BPSVI, RAND, PRIOR} coresets up to size M with a
Laplace-approximation posterior sampler, then evaluate each coreset size by
sampling the weighted posterior with the on-device HMC sampler (replacing
the reference's weighted-Stan NUTS) and computing test accuracy and
predictive log-likelihood. (The reference's evaluation loop dies at an
``exit()`` debug artifact after the first MCMC, main.py:223 — completed
here.)

Usage: python3 examples/zellner_logreg.py --alg BCORES --dataset synth_lr \
          --trial 1 --f-rate 0.1
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
from betacores_tpu.data import gen_synthetic_logreg, perturb_logreg
from betacores_tpu.data.loaders import load_npz, reference_dataset_path, std_cov
from betacores_tpu.evaluation import compute_accuracy, predictive_loglik
from betacores_tpu.inference import HMCConfig, hmc, logreg_laplace_sampler
from betacores_tpu.models import logreg

ALGS = ["BCORES", "SVI", "BPSVI", "RAND", "PRIOR"]


def load_dataset(name: str, trial: int, synth_n: int = 12000, synth_d: int = 10):
    path = reference_dataset_path(name)
    if path is not None:
        X, Y, Xt, Yt = load_npz(path)
        X, Y, Z, mean_, cov_ = std_cov(X, Y)
        Xt, Yt, Zt, _, _ = std_cov(Xt, Yt, mean_, cov_)
        return (np.asarray(a, dtype=np.float32) for a in (X, Y, Z, Xt, Yt, Zt))
    # synthetic fallback (zero-egress environments). --synth-N/--synth-d pin
    # shapes of datasets whose raw blobs are stripped from the mirror, e.g.
    # webspam/covtype at d=127 / N=126,185 (reference
    # zellner_logreg/data_tabulate.py:3-7)
    k = jax.random.key(trial + 7)
    k1, k2 = jax.random.split(k)
    X, Y, Z = gen_synthetic_logreg(k1, synth_n, d=synth_d)
    Xt, Yt, Zt = gen_synthetic_logreg(k2, max(2000, synth_n // 6), d=synth_d)
    return X, Y, Z, Xt, Yt, Zt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", choices=ALGS, default="BCORES")
    ap.add_argument("--dataset", default="synth_lr")
    ap.add_argument("--synth-N", type=int, default=12000,
                    help="rows for the synthetic generator (used when "
                         "--dataset resolves to no npz)")
    ap.add_argument("--synth-d", type=int, default=10,
                    help="feature dim for the synthetic generator (127 = "
                         "webspam/covtype shape, reference "
                         "data_tabulate.py:3-7)")
    ap.add_argument("--trial", type=int, default=1)
    ap.add_argument("--graddiag", action="store_true")
    ap.add_argument("--i0", type=float, default=1.0)
    ap.add_argument("--f-rate", type=float, default=0.1)
    ap.add_argument("--structured", action="store_true",
                    help="structured boundary attack instead of unstructured "
                         "noise+flips (reference model_lr.py:44-60 gen_synthetic "
                         "adversary)")
    ap.add_argument("--M", type=int, default=100)
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=500)
    ap.add_argument("--n-subsample-opt", type=int, default=200)
    ap.add_argument("--n-subsample-select", type=int, default=1000)
    ap.add_argument("--refit-every", type=int, default=1,
                    help="lagged Laplace refits in the Adam loop (1 = "
                         "reference every-step parity; ~4 keeps the "
                         "downstream accuracy, tests/test_coresets.py)")
    ap.add_argument("--dedup-select", action="store_true",
                    help="mask already-selected indices out of the candidate "
                         "argmax so every selection adds a distinct point "
                         "(default: reference-parity duplicate drop, which "
                         "under-fills under subsampled select — RESULTS.md "
                         "'Dedup-masked select')")
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--select-beta", action="store_true",
                    help="BCORES only: pick beta by the trimmed held-out "
                         "predictive criterion (coresets/select_beta.py) over "
                         "--beta-grid before the main trajectory, overriding "
                         "--beta (the in-build tangent objective cannot "
                         "identify beta — see select_beta.py docstring)")
    ap.add_argument("--beta-grid", default="0.01,0.05,0.1,0.2,0.3,0.5,0.7,1.0")
    ap.add_argument("--select-trim", type=float, default=0.2,
                    help="fraction of lowest held-out scores to drop; choose "
                         ">= the suspected contamination rate")
    ap.add_argument("--select-M", type=int, default=0,
                    help="coreset size for the selection builds (0 = --M)")
    ap.add_argument("--eval-every", type=int, default=10,
                    help="evaluate accuracy/pll every k-th coreset size")
    ap.add_argument("--mcmc-samples", type=int, default=1000)
    ap.add_argument("--mcmc-warmup", type=int, default=1000)
    ap.add_argument("--mcmc-chains", type=int, default=2,
                    help="HMC chains per evaluated size; >=2 enables "
                         "split-R-hat/ESS convergence checks (the reference "
                         "samples a single unchecked Stan chain)")
    ap.add_argument("--eval-sampler", choices=["hmc", "nuts"], default="hmc",
                    help="evaluation sampler: jittered multinomial HMC "
                         "(default; cheap, static shapes) or dynamic-"
                         "trajectory NUTS (inference/nuts.py — the "
                         "reference's Stan sampler family, adapt_delta=0.9 "
                         "-> target_accept=0.9, max_treedepth=10)")
    ap.add_argument("--eval-full-data", action="store_true",
                    help="also evaluate a FULL-DATA posterior baseline, "
                         "subsampled to --full-data-cap rows (the reference's "
                         "mcmc_noXt.py:29-31 pattern: full-data NUTS on a 5k "
                         "subsample when N is large)")
    ap.add_argument("--full-data-cap", type=int, default=5000)
    ap.add_argument("--results-dir", default="results")
    args = ap.parse_args()

    X, Y, Z, Xt, Yt, Zt = (jnp.asarray(a) for a in load_dataset(
        args.dataset, args.trial, args.synth_N, args.synth_d))
    kp = jax.random.key(args.trial)
    X, Y, Z, out_idx = perturb_logreg(kp, X, Y, f_rate=args.f_rate,
                                      structured=args.structured)
    D = X.shape[1]
    print(f"dataset {args.dataset}: N={X.shape[0]} d={D}, corrupted {len(out_idx)}")

    model = logreg.bundle()
    sampler_w = logreg_laplace_sampler(diag=args.graddiag)
    sched = lambda i: args.i0 / (1.0 + i)
    S = args.proj_dim
    # full bundles (model=), not loose callbacks: routes the refinement-step
    # kernel through the eager API on a GPU
    prj_w = bc.BlackBoxProjector(sampler_w, S, model=model)
    prj_bw = bc.BetaBlackBoxProjector(sampler_w, S, model=model)

    common = dict(opt_itrs=args.opt_itrs, n_subsample_opt=args.n_subsample_opt,
                  n_subsample_select=args.n_subsample_select, step_sched=sched,
                  seed=args.trial, max_size=args.M, refit_every=args.refit_every, dedup_select=args.dedup_select)
    algs = {
        "BCORES": lambda: bc.BetaCoreset(Z, prj_bw, beta=args.beta, learn_beta=False, **common),
        "SVI": lambda: bc.SparseVICoreset(Z, prj_w, **common),
        "BPSVI": lambda: bc.BatchPSVICoreset(Z, prj_w, opt_itrs=args.opt_itrs,
                                             n_subsample_opt=args.n_subsample_opt,
                                             step_sched=lambda m: sched,
                                             seed=args.trial, max_size=args.M),
        "RAND": lambda: bc.UniformSamplingCoreset(Z, seed=args.trial),
        "PRIOR": lambda: None,
    }
    select_record = None
    if args.select_beta:
        if args.alg != "BCORES":
            raise SystemExit("--select-beta only applies to BCORES")
        from betacores_tpu.coresets.select_beta import (driver_select_beta,
                                                        padded_scorer)
        from betacores_tpu.models.logreg import log_likelihood as lr_ll

        # hold out a slice of the CORRUPTED training rows — the trimmed
        # criterion needs no clean/dirty labels; builds use the rest
        n_ho = min(2000, max(1, Z.shape[0] // 6))
        Zho, Zbuild = Z[-n_ho:], Z[: Z.shape[0] - n_ho]
        M_sel = args.select_M or args.M
        alg_sel = bc.BetaCoreset(Zbuild, prj_bw, beta=args.beta,
                                 learn_beta=False, **common)
        k_score = jax.random.key(args.trial * 31 + 5)
        S_score = 256

        @jax.jit
        def _pred_ll(wm, pm, zho):
            # per-point held-out predictive log-lik under the coreset's
            # Laplace posterior: log mean_s p(z | th_s). zho is a jit
            # ARGUMENT (CLAUDE.md: never close a jitted fn over a dataset)
            samples, _ = sampler_w(k_score, S_score, wm, pm,
                                   jnp.zeros(D, dtype=jnp.float32))
            ll = lr_ll(zho, samples)
            return (jax.scipy.special.logsumexp(ll, axis=1)
                    - jnp.log(float(S_score)))

        score_fn = padded_scorer(args.M, D,
                                 lambda w, p: _pred_ll(w, p, jnp.asarray(Zho)))
        grid = [float(b) for b in args.beta_grid.split(",")]
        best_beta, select_record, _ = driver_select_beta(
            alg_sel, grid, score_fn, args.select_trim, M_sel)
        print("select-beta grid: " + "  ".join(
            f"{b:g}:{s:.4f}" for b, s in zip(grid, select_record["scores"])))
        print(f"selected beta = {best_beta:g} "
              f"[{select_record['select_time_s']:.1f}s for {len(grid)} builds]")
        args.beta = best_beta

    alg = algs[args.alg]()

    t0 = time.perf_counter()
    w = [np.zeros(1)]
    p = [np.zeros((1, D), dtype=np.float32)]
    if args.alg == "PRIOR":
        for m in range(1, args.M + 1):
            w.append(np.zeros(1))
            p.append(np.zeros((1, D), dtype=np.float32))
    elif args.alg == "BPSVI":
        from betacores_tpu.coresets import bpsvi_build_batch

        builder = alg._builder_for(args.M)
        wts_b, pts_b, _ = bpsvi_build_batch(builder, jax.random.key(args.trial + 1000),
                                            list(range(1, args.M + 1)), args.M,
                                            jnp.zeros(D, dtype=jnp.float32))
        for m in range(1, args.M + 1):
            wm = np.asarray(wts_b[m - 1])
            keep = wm > 0
            w.append(wm[keep])
            p.append(np.asarray(pts_b[m - 1])[keep])
    elif args.alg == "RAND":
        for wm, pm, im in alg.build_trace(args.M):
            w.append(wm)
            p.append(pm)
    else:
        # one device program records every size (see zellner_gaussian.py)
        for wm, pm, im, bm in alg.build_trace(args.M):
            w.append(wm)
            p.append(pm)
    build_time = time.perf_counter() - t0
    print(f"build: {build_time:.1f}s")

    # evaluation: HMC on the weighted coreset posterior per size
    from betacores_tpu.inference import summarize_chains

    # always evaluate the final size; never skip it when eval_every does
    # not divide M (round-3 review; multiclass.py carried this fix already)
    eval_ms = sorted(set(range(0, args.M + 1, args.eval_every)) | {args.M})
    accs, plls, mcmc_times, diags = {}, {}, {}, {}
    # diagnostic-gated escalation (escalation.py): the primary sampler runs
    # first; failed split-R-hat/ESS/divergence diagnostics re-run that size
    # with NUTS — the reference's evaluator IS adaptive NUTS (mcmc.py:21-59)
    # and its user never has to pick a sampler, so neither should ours
    from betacores_tpu.inference import default_nuts_config, run_with_escalation
    from betacores_tpu.inference.nuts import run_chains_weighted_logreg_nuts

    nuts_cfg = default_nuts_config(args.mcmc_samples, args.mcmc_warmup)
    if args.eval_sampler == "nuts":
        cfg = nuts_cfg
        run_eval_chains = run_chains_weighted_logreg_nuts
    else:
        cfg = HMCConfig(n_samples=args.mcmc_samples,
                        n_warmup=args.mcmc_warmup, L_max=32)
        run_eval_chains = hmc.run_chains_weighted_logreg
    # zero-weight pad every coreset to one static shape: zero-weight rows
    # are inert in the weighted log-density, and per-size shapes would
    # recompile the HMC program for every evaluated m
    eval_cap = max(len(np.atleast_1d(w[m])) for m in eval_ms)
    for m in eval_ms:
        wm_c = np.atleast_1d(w[m]).astype(np.float32)
        pm_c = np.atleast_2d(p[m]).astype(np.float32)
        wm = jnp.asarray(np.pad(wm_c, (0, eval_cap - len(wm_c))))
        pm = jnp.asarray(np.pad(pm_c, ((0, eval_cap - len(wm_c)), (0, 0))))
        t1 = time.perf_counter()
        run = run_with_escalation(
            jax.random.key(args.trial * 100 + m), run_eval_chains, cfg,
            run_chains_weighted_logreg_nuts, nuts_cfg,
            pm, wm, jnp.zeros(D, dtype=jnp.float32), args.mcmc_chains,
            primary_name=args.eval_sampler)
        chains = jax.block_until_ready(run.chains)
        mcmc_times[m] = time.perf_counter() - t1
        diags[m] = {k: np.asarray(v) for k, v in run.summary.items()}
        diags[m]["sampler_used"] = run.sampler_used
        diags[m]["escalated"] = run.escalated
        samples = chains.reshape(-1, D)
        accs[m] = float(compute_accuracy(Xt, Yt, samples))
        plls[m] = float(predictive_loglik(Zt, samples))
        rhat, ess = float(diags[m]["rhat"].max()), float(diags[m]["ess"].min())
        flag = ("" if not run.escalated else
                f"  ** {args.eval_sampler} failed ({run.failure_reason}); "
                "recorded NUTS re-run")
        print(f"m={m:4d} acc={accs[m]:.4f} pll={plls[m]:.4f} "
              f"accept={float(np.mean(run.stats['accept_stat'])):.2f} "
              f"rhat={rhat:.3f} ess={ess:.0f} [{run.sampler_used}] "
              f"({mcmc_times[m]:.1f}s){flag}")

    full = None
    if args.eval_full_data:
        # reference mcmc_noXt.py:29-31: the full-data MCMC baseline runs on a
        # <= full_data_cap uniform subsample with weights N/n (same posterior
        # target in expectation, bounded sampler cost at N >= 100k)
        N = Z.shape[0]
        n_fd = min(args.full_data_cap, N)
        sub = (np.random.default_rng(args.trial).choice(N, n_fd, replace=False)
               if n_fd < N else np.arange(N))
        w_fd = jnp.full((n_fd,), N / n_fd, dtype=jnp.float32)
        t1 = time.perf_counter()
        # the baseline always runs the HMC runner, so it needs an HMCConfig
        # even when --eval-sampler nuts set cfg to a NUTSConfig (round-5
        # review: passing the NUTSConfig here crashed on cfg.L_max AFTER
        # the whole per-size eval loop had completed)
        fd_cfg = (cfg if isinstance(cfg, HMCConfig) else
                  HMCConfig(n_samples=args.mcmc_samples,
                            n_warmup=args.mcmc_warmup, L_max=32))
        chains, stats = hmc.run_chains_weighted_logreg(
            jax.random.key(args.trial * 100 + 999), Z[jnp.asarray(sub)], w_fd,
            jnp.zeros(D, dtype=jnp.float32), args.mcmc_chains, fd_cfg)
        chains = jax.block_until_ready(chains)
        t_fd = time.perf_counter() - t1
        samples = chains.reshape(-1, D)
        full = {"n_subsample": int(n_fd),
                "acc": float(compute_accuracy(Xt, Yt, samples)),
                "pll": float(predictive_loglik(Zt, samples)),
                "mcmc_time_s": t_fd,
                "diag": {k: np.asarray(v) for k, v in summarize_chains(chains).items()}}
        print(f"full-data baseline (n={n_fd}): acc={full['acc']:.4f} "
              f"pll={full['pll']:.4f} ({t_fd:.1f}s)")

    os.makedirs(args.results_dir, exist_ok=True)
    # config-encoding filename (reference pattern, main.py:235): include
    # every swept hyperparameter or sweep points overwrite each other
    tag = f"{args.dataset}_{args.alg}_{args.trial}_{args.f_rate}_b{args.beta}_i{args.i0}"
    if args.dedup_select:
        tag += "_dedup"
    if args.graddiag:
        # config-encoding filename: the graddiag axis is swept by
        # run_sweep.py's logreg protocol grid (reference run.sh:7-12)
        tag += "_gd"
    if args.select_beta:
        tag += "_selected"
    if args.structured:
        tag += "_struct"
    out = os.path.join(args.results_dir, f"results_{tag}.pk")
    with open(out, "wb") as fh:
        pickle.dump({"args": vars(args), "w": w, "p": p, "accs": accs, "plls": plls,
                     "build_time_s": build_time, "mcmc_times": mcmc_times,
                     "mcmc_diagnostics": diags, "full_data": full,
                     "select_beta": select_record}, fh)
    print(f"saved -> {out}")


if __name__ == "__main__":
    main()
