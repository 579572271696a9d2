#!/usr/bin/env python3
"""Neural-linear batch active-learning experiment.

Reproduces reference examples/zellner_neural_linear/main.py: an MLP
feature extractor with an exact Bayesian last layer; data batched into
groups; group-corruption injected; {BCORES, SVI, RAND} group-mode coresets
warm-started from an initial batch, interleaving coreset iterations with
encoder re-training on the current weighted coreset; per-iteration test
RMSE / predictive NLL. (The reference's script dies at an ``exit()`` after
preprocessing, main.py:80 — completed here.)

Usage: python3 examples/zellner_neural_linear.py --alg BCORES --trial 1
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
from betacores_tpu.data import gen_synthetic_linreg, perturb_groups
from betacores_tpu.data.loaders import make_random_groups, standardize
from betacores_tpu.models.neural_linear import (
    NeuralLinear,
    neural_linear_model_factory,
    neural_linear_sampler_factory,
)

ALGS = ["BCORES", "SVI", "RAND", "PRIOR"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", choices=ALGS, default="BCORES")
    ap.add_argument("--dataset", default="synth",
                    help="synth (generator, reference "
                         "model_neurlinr.py:80-88), or a real regression npz "
                         "resolvable by reference_dataset_path: biketrips / "
                         "biketrips_large / airportdelays (reference "
                         "examples/data), movielens5 (in-repo star ratings "
                         "1-5 as regression), or a reference UCI name "
                         "boston / news / year / prices2018 "
                         "(model_neurlinr.py:6-35 loader semantics via "
                         "data.loaders.load_uci_regression; needs the raw "
                         "file dropped locally — zero egress here).")
    ap.add_argument("--trial", type=int, default=1)
    ap.add_argument("--N", type=int, default=2000,
                    help="train rows (real datasets: subsampled without "
                         "replacement if smaller than the file; 0 = all)")
    ap.add_argument("--D", type=int, default=12)
    ap.add_argument("--M", type=int, default=20, help="coreset iterations (batches)")
    ap.add_argument("--batch-size", type=int, default=20, help="group size")
    ap.add_argument("--init-size", type=int, default=20)
    ap.add_argument("--out-features", type=int, default=30)
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=500)
    ap.add_argument("--n-subsample-opt", type=int, default=1000)
    ap.add_argument("--i0", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=0.5)
    ap.add_argument("--select-beta", action="store_true",
                    help="pick beta by the contamination-robust trimmed "
                         "held-out predictive criterion "
                         "(coresets/select_beta.py): per candidate, a fresh "
                         "encoder + SHORT acquisition loop (--select-M "
                         "rounds), scored by trimmed per-point Gaussian "
                         "predictive log-density on a held-out slice of the "
                         "CORRUPTED train rows (BCORES only)")
    ap.add_argument("--beta-grid", default="0.01,0.1,0.3,0.5,0.7,1.0")
    ap.add_argument("--select-trim", type=float, default=0.2)
    ap.add_argument("--select-M", type=int, default=0,
                    help="acquisition rounds per candidate (0 = max(3, M/4))")
    ap.add_argument("--f-rate", type=float, default=0.1)
    ap.add_argument("--nn-epochs", type=int, default=200)
    ap.add_argument("--initial-lr", type=float, default=1e-2)
    ap.add_argument("--weight-decay", type=float, default=1e-1)
    ap.add_argument("--train-nn-freq", type=int, default=1)
    ap.add_argument("--results-dir", default="results")
    args = ap.parse_args()

    rng = np.random.default_rng(args.trial)
    key = jax.random.key(args.trial)

    if args.dataset == "synth":
        X, Y, _ = gen_synthetic_linreg(key, N=args.N + 1500, D=args.D)
        X, Y = np.asarray(X), np.asarray(Y)
        X, Xt = X[: args.N], X[args.N :]
        Y, Yt = Y[: args.N], Y[args.N :]
    elif args.dataset in ("boston", "news", "year", "prices2018"):
        # the reference's own UCI loaders (model_neurlinr.py:6-35), local
        # files only; 80/20 split like its driver (main.py uses sklearn
        # train_test_split on the loaded arrays)
        from betacores_tpu.data.loaders import load_uci_regression

        X, Y = load_uci_regression(args.dataset)
        perm = rng.permutation(X.shape[0])
        n_te = max(1, int(0.2 * X.shape[0]))
        X, Y = X[perm].astype(np.float64), Y[perm].astype(np.float64)
        Xt, Yt = X[:n_te], Y[:n_te]
        X, Y = X[n_te:], Y[n_te:]
        if args.N and args.N < X.shape[0]:
            X, Y = X[: args.N], Y[: args.N]
        print(f"dataset {args.dataset}: N={X.shape[0]} d={X.shape[1]} "
              f"test={Xt.shape[0]} (y in [{Y.min():.3g}, {Y.max():.3g}])")
    else:
        # real regression npz: same (X, y, Xt, yt)
        # format as the logreg sets; ratings-as-regression for movielens5
        from betacores_tpu.data.loaders import load_npz, reference_dataset_path

        path = reference_dataset_path(args.dataset)
        if path is None:
            raise SystemExit(f"dataset {args.dataset!r} not found (searched "
                             f"$BETACORES_DATA, repo data/, reference mirror)")
        X, Y, Xt, Yt = load_npz(path)
        if args.dataset.startswith("movielens"):
            Y, Yt = Y + 1.0, Yt + 1.0  # star buckets 0..4 -> 1..5 stars
        if args.N and args.N < X.shape[0]:
            sel = rng.choice(X.shape[0], args.N, replace=False)
            X, Y = X[sel], Y[sel]
        Y, Yt = Y[:, None], Yt[:, None]
        print(f"dataset {args.dataset}: N={X.shape[0]} d={X.shape[1]} "
              f"test={Xt.shape[0]} (y in [{Y.min():.3g}, {Y.max():.3g}])")
    Xi, Yi = X[: args.init_size].copy(), Y[: args.init_size].copy()
    X, Y, Xi, Yi, Xt, Yt, in_m, in_s, out_m, out_s = standardize(X, Y, Xi, Yi, Xt, Yt)

    groups = make_random_groups(rng, X.shape[0], args.batch_size)
    X, Y = perturb_groups(jax.random.fold_in(key, 1), X, Y, groups, f_rate=args.f_rate)
    X, Y = np.asarray(X), np.asarray(Y)
    Z = np.hstack([X, Y]).astype(np.float32)
    Z_init = np.hstack([Xi, Yi]).astype(np.float32)
    Z_test = np.hstack([Xt, Yt]).astype(np.float32)[:1000]

    datamn, datastd = float(np.mean(Y)), float(np.std(Y))
    sigsq = max(datastd**2, 1e-3)
    F = args.out_features
    mu0 = datamn * jnp.ones(F, dtype=jnp.float32)
    Sig0inv = jnp.linalg.inv((datastd**2 + datamn**2) * jnp.eye(F, dtype=jnp.float32))

    nl = NeuralLinear(Z_init, out_features=F, output_mean=out_m, output_std=out_s,
                      sigmasq=sigsq, seed=args.trial)
    model_factory = neural_linear_model_factory(nl.module, sigsq)
    sampler_factory = neural_linear_sampler_factory(nl.module, mu0, Sig0inv, sigsq)
    prj = bc.coresets.ContextualProjector(sampler_factory, args.proj_dim, model_factory)

    sched = lambda i: args.i0 / (1.0 + i)
    init_kw = dict(wts=np.ones(args.init_size), idcs=10_000_000 + np.arange(args.init_size),
                   pts=Z_init, groups=groups, initialized=True)
    N = Z.shape[0]

    select_record = None
    if args.select_beta:
        if args.alg != "BCORES":
            raise SystemExit("--select-beta only applies to BCORES")
        from betacores_tpu.coresets.select_beta import select_beta
        from betacores_tpu.models.neural_linear import gaussian_log_density

        # score on a random slice of the CORRUPTED train rows (the trimmed
        # mean drops the contaminated tail — no clean labels needed). The
        # slice stays inside its groups for the candidate builds (group
        # structure must not change); with select-M batches of
        # --batch-size points the overlap with selected rows is minimal.
        rng_sel = np.random.default_rng(args.trial * 7 + 1)
        ho = rng_sel.choice(Z.shape[0], max(1, Z.shape[0] // 6), replace=False)
        Zho = jnp.asarray(Z[ho])
        M_sel = args.select_M or max(3, args.M // 4)
        sel_epochs = max(20, args.nn_epochs // 4)
        holder = {}

        def build_fn(b):
            nl_b = NeuralLinear(Z_init, out_features=F, output_mean=out_m,
                                output_std=out_s, sigmasq=sigsq,
                                seed=args.trial)
            alg_b = bc.BetaCoreset(
                jnp.asarray(Z), prj, beta=b, learn_beta=False,
                opt_itrs=args.opt_itrs, n_subsample_opt=args.n_subsample_opt,
                step_sched=sched, seed=args.trial, **init_kw)
            wts = pts = None
            for _ in range(M_sel):
                alg_b.ctx = nl_b.variables
                alg_b.build(1, N + args.init_size)
                wts, pts = alg_b.get()[:2]
                nl_b.update_batch(pts.astype(np.float32))
                nl_b.optimize(wts.astype(np.float32), pts.astype(np.float32),
                              num_epochs=sel_epochs,
                              initial_lr=args.initial_lr,
                              weight_decay=args.weight_decay)
            holder["nl"] = nl_b
            return wts, pts

        def score_fn(wts, pts):
            # per-point predictive log-density under the candidate's
            # coreset posterior (its encoder + exact Bayes last layer)
            mean, var = holder["nl"].forward(Zho[:, :-1])
            return np.asarray(
                gaussian_log_density(Zho[:, -1:], mean, var)).ravel()

        grid = [float(b) for b in args.beta_grid.split(",")]
        t_sel0 = time.perf_counter()
        best_beta, scores = select_beta(build_fn, grid, score_fn,
                                        trim=args.select_trim)
        t_sel = time.perf_counter() - t_sel0
        select_record = {"grid": grid, "scores": [float(s) for s in scores],
                         "beta": best_beta, "trim": args.select_trim,
                         "select_time_s": t_sel}
        print("select-beta grid: " + "  ".join(
            f"{b:g}:{s:.4f}" for b, s in zip(grid, scores)))
        print(f"selected beta = {best_beta:g} [{t_sel:.1f}s, "
              f"{M_sel} rounds per candidate]")
        args.beta = best_beta

    if args.alg == "BCORES":
        alg = bc.BetaCoreset(jnp.asarray(Z), prj, beta=args.beta, learn_beta=False,
                             opt_itrs=args.opt_itrs, n_subsample_opt=args.n_subsample_opt,
                             step_sched=sched, seed=args.trial, **init_kw)
    elif args.alg == "SVI":
        alg = bc.SparseVICoreset(jnp.asarray(Z), prj, opt_itrs=args.opt_itrs,
                                 n_subsample_opt=args.n_subsample_opt,
                                 step_sched=sched, seed=args.trial, **init_kw)
    elif args.alg == "RAND":
        alg = bc.UniformSamplingCoreset(jnp.asarray(Z), seed=args.trial, groups=groups,
                                        wts=np.ones(args.init_size),
                                        idcs=10_000_000 + np.arange(args.init_size),
                                        pts=Z_init)
    else:
        alg = None

    nlls, rmses = np.zeros(args.M + 1), np.zeros(args.M + 1)
    nlls[0], rmses[0] = nl.test(Z_test)
    print(f"m=0 nll={nlls[0]:.4f} rmse={rmses[0]:.4f}")

    t0 = time.perf_counter()
    for m in range(1, args.M + 1):
        if alg is None:
            nlls[m], rmses[m] = nlls[0], rmses[0]
            continue
        if hasattr(alg, "ctx"):
            alg.ctx = nl.variables
        alg.build(1, N + args.init_size)
        got = alg.get()
        wts, pts = got[0], got[1]
        nl.update_batch(pts.astype(np.float32))
        if m % args.train_nn_freq == 0:
            nl.optimize(wts.astype(np.float32), pts.astype(np.float32),
                        num_epochs=args.nn_epochs, initial_lr=args.initial_lr,
                        weight_decay=args.weight_decay)
        nlls[m], rmses[m] = nl.test(Z_test)
        print(f"m={m} coreset_pts={len(wts)} nll={nlls[m]:.4f} rmse={rmses[m]:.4f}")
    total = time.perf_counter() - t0

    os.makedirs(args.results_dir, exist_ok=True)
    tag = f"{args.dataset}_{args.alg}_frate_{args.f_rate}_beta_{args.beta}_i0_{args.i0}_{args.trial}"
    with open(os.path.join(args.results_dir, f"results_{tag}.pk"), "wb") as fh:
        pickle.dump({"args": vars(args), "rmses": rmses, "nlls": nlls,
                     "time_s": total, "select_beta": select_record}, fh)
    print(f"done in {total:.1f}s; rmse {rmses[0]:.3f} -> {rmses[args.M]:.3f}")


if __name__ == "__main__":
    main()
