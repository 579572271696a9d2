#!/usr/bin/env python3
"""Out-of-core merge-reduce coreset build beyond device memory.

Demonstrates the capability leap past the reference's only N-axis answer
(subsampling, reference bayesiancoresets/coreset/hilbert.py:12-15): the
dataset can be LARGER THAN DEVICE MEMORY (N x d x 4 bytes past the card's
memory), where no single-shot build can run at all.
``merge_reduce_build`` (coresets/streaming.py) streams host chunks through
ONE compiled leaf-build program (peak device memory: one chunk + the leaf
coresets), then summarizes the union of weighted leaf points with one final
weighted build.

Quality evidence: the conjugate-Gaussian posterior over ALL N rows is
closed-form from running sums accumulated during generation, so the
streamed coreset's reverse KL against its EXACT full-data posterior is
computable even though the data never fits on device. A same-generator
single-shot build at --n-single (default 50M, fits on the card) provides the
quality-parity reference point.

Usage: python3 examples/streaming_outofcore.py            # full 500M demo
       python3 examples/streaming_outofcore.py --n 20_000_000 --chunk 5_000_000
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=500_000_000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=25_000_000)
    ap.add_argument("--n-single", type=int, default=50_000_000,
                    help="single-shot comparison build size (0 = skip)")
    ap.add_argument("--m-leaf", type=int, default=100)
    ap.add_argument("--m-final", type=int, default=100)
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=300)
    ap.add_argument("--i0", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--checkpoint", default="",
                    help="npz path: leaf-pass fault tolerance — crash and "
                         "rerun with the same args to resume bit-identically")
    ap.add_argument("--max-union-rows", type=int, default=0,
                    help=">0: hierarchical merge-reduce tree, capping every "
                         "level's working set at this many weighted rows")
    ap.add_argument("--mesh", default="",
                    help="e.g. 4x1: run the MESH-STREAMED leaf pass — rounds "
                         "of n_lanes simultaneous leaf builds over the "
                         "running platform's devices (GPUs, or a virtual "
                         "mesh on the CPU platform). Incompatible with "
                         "--checkpoint (per-leaf checkpoints need the "
                         "sequential stream).")
    args = ap.parse_args()

    mesh_shape = None
    if args.mesh:
        if args.checkpoint:
            raise SystemExit("--mesh is incompatible with --checkpoint")
        try:
            mesh_shape = tuple(int(t) for t in args.mesh.split("x"))
        except ValueError:
            mesh_shape = ()
        if len(mesh_shape) != 2 or min(mesh_shape) < 1:
            raise SystemExit(f"--mesh must be DATAxSAMP (e.g. 8x1), got "
                             f"{args.mesh!r}")
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                f"{mesh_shape[0] * mesh_shape[1]}").strip()

    import jax

    if mesh_shape is not None and jax.device_count() < mesh_shape[0] * mesh_shape[1]:
        raise SystemExit(f"--mesh {args.mesh} needs {mesh_shape[0] * mesh_shape[1]} "
                         f"devices; {jax.devices()[0].platform} has "
                         f"{jax.device_count()}")
    import jax.numpy as jnp

    from betacores_tpu.coresets import (IncrementalConfig, init_state,
                                        make_incremental_builder,
                                        merge_reduce_build)
    from betacores_tpu.evaluation import reverse_forward_kl
    from betacores_tpu.inference import gaussian_conjugate_sampler
    from betacores_tpu.models import gaussian as gmod

    N, d, C = args.n, args.d, args.chunk
    gb = N * d * 4 / 2**30
    print(f"N={N:,} d={d} f32 = {gb:.1f} GiB host data, chunks of {C:,}")

    # ---- generate in host RAM, chunk by chunk, tracking the exact
    # full-data sufficient statistic (conjugate gaussian: only sum_n x_n
    # and N are needed for the posterior) ----
    rng = np.random.default_rng(args.seed)
    sig = 2.0
    t0 = time.perf_counter()
    data = np.empty((N, d), dtype=np.float32)
    xsum = np.zeros(d, dtype=np.float64)
    gen_chunk = 10_000_000
    for i in range(0, N, gen_chunk):
        j = min(i + gen_chunk, N)
        blk = rng.standard_normal((j - i, d), dtype=np.float32) * np.sqrt(sig)
        blk += 1.0  # common mean offset so the posterior moves off the prior
        data[i:j] = blk
        xsum += blk.sum(axis=0, dtype=np.float64)
    t_gen = time.perf_counter() - t0
    print(f"generated in {t_gen:.0f}s")

    Sig = sig * np.eye(d)
    Siginv = jnp.asarray(np.linalg.inv(Sig), dtype=jnp.float32)
    logdetSig = float(np.linalg.slogdet(Sig)[1])
    mu0, Sig0inv = jnp.zeros(d), jnp.eye(d)
    model = gmod.bundle(Siginv, logdetSig)
    sampler = gaussian_conjugate_sampler(mu0, Sig0inv, Siginv)

    def exact_post(n_rows, xs):
        """Conjugate posterior from the sufficient statistic only."""
        prec = np.eye(d) + n_rows * np.asarray(Siginv, dtype=np.float64)
        mu = np.linalg.solve(prec, np.asarray(Siginv, dtype=np.float64) @ xs)
        return gmod.GaussianPosterior(
            mu=jnp.asarray(mu, jnp.float32),
            prec_chol=jnp.asarray(np.linalg.cholesky(prec), jnp.float32))

    post_full = exact_post(N, xsum)

    cfg = IncrementalConfig(projection_dim=args.proj_dim,
                            n_subsample_select=1000, n_subsample_opt=200,
                            opt_itrs=args.opt_itrs, i0=args.i0)

    # ---- streamed merge-reduce build (out-of-core: one chunk on device
    # at a time) ----
    mesh = None
    if mesh_shape is not None:
        from betacores_tpu.parallel import make_mesh

        mesh = make_mesh(*mesh_shape)
        print(f"mesh-streamed leaf pass over {dict(mesh.shape)} "
              f"({-(-N // C)} leaves in rounds of {mesh_shape[0]})")
    t0 = time.perf_counter()
    st_leaf = init_state(args.m_leaf, d, dtype=jnp.float32)
    final_state, leaf_pts, leaf_wts = merge_reduce_build(
        jax.random.key(args.seed), data, model, sampler,
        leaf_config=cfg, final_config=cfg, chunk_size=C,
        m_leaf=args.m_leaf, m_final=args.m_final, st_leaf=st_leaf,
        mesh=mesh,
        checkpoint_path=args.checkpoint or None,
        max_union_rows=args.max_union_rows or None)
    w = np.asarray(jax.block_until_ready(final_state.wts))
    p = np.asarray(final_state.pts)
    t_stream = time.perf_counter() - t0

    post_stream = gmod.weighted_post(mu0, Sig0inv, Siginv,
                                     jnp.asarray(p), jnp.asarray(w))
    rkl_stream = float(reverse_forward_kl(post_stream, post_full)[0])
    rkl_prior = float(reverse_forward_kl(
        gmod.GaussianPosterior(mu=mu0, prec_chol=jnp.eye(d)), post_full)[0])
    nnz = int((w > 0).sum())
    print(f"streamed build ({N:,} rows, {-(-N // C)} leaves): {t_stream:.0f}s, "
          f"{nnz} points, rKL={rkl_stream:.4g} (prior rKL={rkl_prior:.4g})")

    # ---- single-shot comparison at a size that fits device memory ----
    result = {"n": N, "d": d, "chunk": C, "gib": round(gb, 1),
              "t_generate_s": round(t_gen, 1),
              "t_stream_s": round(t_stream, 1),
              "rkl_stream": rkl_stream, "rkl_prior": rkl_prior,
              "nnz_stream": nnz}
    if args.n_single:
        Ns = args.n_single
        post_s = exact_post(Ns, data[:Ns].sum(axis=0, dtype=np.float64))
        t0 = time.perf_counter()
        b = make_incremental_builder(jnp.asarray(data[:Ns]), model, sampler, cfg)
        st = b.build(jax.random.key(args.seed + 1),
                     init_state(args.m_final, d, dtype=jnp.float32),
                     args.m_final)
        ws = np.asarray(jax.block_until_ready(st.wts))
        ps = np.asarray(st.pts)
        t_single = time.perf_counter() - t0
        post_1 = gmod.weighted_post(mu0, Sig0inv, Siginv,
                                    jnp.asarray(ps), jnp.asarray(ws))
        rkl_single = float(reverse_forward_kl(post_1, post_s)[0])
        print(f"single-shot at N={Ns:,}: {t_single:.0f}s, "
              f"{int((ws > 0).sum())} points, rKL={rkl_single:.4g} "
              f"(vs its own exact posterior)")
        result.update({"n_single": Ns, "t_single_s": round(t_single, 1),
                       "rkl_single": rkl_single})

    print(json.dumps(result))


if __name__ == "__main__":
    main()
