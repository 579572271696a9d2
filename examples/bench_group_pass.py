"""Group-mode build microbenchmarks.

The group build's per-step cost is one full (N, S) projection followed by a
(G, S) group reduction (select) or a total over groups (optimize). XLA
lowers ``segment_sum`` to a scatter-add; the alternative is a one-hot
matmul (coresets/groups.py ONEHOT_MAX_BYTES chooses between them). This
script measures, at movielens-groups scale and a larger webspam-like shape:

  proj      projection + plain column sum (the streaming floor)
  segsum    projection + segment_sum group reduction        (old select path)
  onehot    projection + one-hot matmul group reduction     (new select path)
  opt_old   segment_sum group reduction summed over groups  (old optimize)
  opt_new   masked weighted column sum                      (new optimize)

Same in-device lax.scan timing recipe as bench_select_pass.py; run it on
a GPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def run_shape(N, G, S, d, reps):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from betacores_tpu.data import gen_synthetic_logreg, perturb_logreg
    from betacores_tpu.models import logreg

    k0, k1, k2, k3 = jax.random.split(jax.random.key(0), 4)
    X, y, Z = gen_synthetic_logreg(k0, N, d=d, dtype=jnp.float32)
    X, y, Z, _ = perturb_logreg(k1, X, y, f_rate=0.1)
    D = Z.shape[1]
    beta = jnp.float32(0.1)
    ths = jax.random.normal(k2, (reps, S, D), dtype=jnp.float32) * 0.1
    # contiguous equal groups + a tail of ungrouped rows (id G)
    per = N // (G + 1)
    gid = jnp.minimum(jnp.arange(N, dtype=jnp.int32) // max(per, 1), G)
    Z = jax.block_until_ready(Z)

    def blik(pts, th):
        v = logreg.beta_likelihood(pts, th, beta)
        return v - v.mean(axis=1, keepdims=True)

    def v_proj(Z, th, gid):
        return blik(Z, th).sum(axis=0) @ jnp.ones((S,), jnp.float32)

    def v_segsum(Z, th, gid):
        g = jax.ops.segment_sum(blik(Z, th), gid, num_segments=G + 1)[:G]
        return g.sum()

    def v_onehot(Z, th, gid):
        onehot = (gid[:, None] == jnp.arange(G, dtype=gid.dtype))
        vecs = blik(Z, th)
        g = jax.lax.dot_general(onehot.astype(vecs.dtype), vecs,
                                (((0,), (0,)), ((), ())))
        return g.sum()

    def v_opt_old(Z, th, gid):
        g = jax.ops.segment_sum(blik(Z, th), gid, num_segments=G + 1)[:G]
        return g.sum(axis=0) @ jnp.ones((S,), jnp.float32)

    def v_opt_new(Z, th, gid):
        w_eff = (gid < G).astype(jnp.float32)
        return (w_eff @ blik(Z, th)) @ jnp.ones((S,), jnp.float32)

    out = {}
    for name, body in [("proj", v_proj), ("segsum", v_segsum),
                       ("onehot", v_onehot), ("opt_old", v_opt_old),
                       ("opt_new", v_opt_new)]:
        @jax.jit
        def f(Z, ths, gid, body=body):
            def step(acc, th):
                return acc + body(Z, th, gid), None
            return lax.scan(step, jnp.float32(0.0), ths)[0]

        jax.block_until_ready(f(Z, ths, gid))  # compile + warm
        t0 = time.perf_counter()
        r = float(jax.block_until_ready(f(Z, ths, gid)))
        t = time.perf_counter() - t0
        per_ms = t / reps * 1e3
        out[name] = per_ms
        print(f"  {name:8s} {per_ms:8.3f} ms/pass  (acc={r:.4g})")
    return out


def run_end_to_end(N, G, S, d, M_groups, opt_itrs):
    """The REAL group builder (make_group_incremental_builder) at scale,
    reference group semantics (n_subsample_select=None — score every group;
    n_subsample_opt=None — exact gradient), end to end on the device."""
    import time

    import jax
    import jax.numpy as jnp

    from betacores_tpu.coresets import IncrementalConfig, init_state
    from betacores_tpu.coresets.groups import (init_group_state,
                                               make_group_incremental_builder)
    from betacores_tpu.data import gen_synthetic_logreg, perturb_logreg
    from betacores_tpu.inference import logreg_laplace_sampler
    from betacores_tpu.models import logreg
    from betacores_tpu.ops.projection import Groups

    k0, k1, k2 = jax.random.split(jax.random.key(0), 3)
    X, y, Z = gen_synthetic_logreg(k0, N, d=d, dtype=jnp.float32)
    X, y, Z, _ = perturb_logreg(k1, X, y, f_rate=0.1)
    per = N // G
    gl = [list(range(g * per, min((g + 1) * per, N))) for g in range(G)]
    gp = Groups.from_lists(gl)
    cfg = IncrementalConfig(projection_dim=S, n_subsample_select=None,
                            n_subsample_opt=None, opt_itrs=opt_itrs, i0=1.0,
                            use_beta=True)
    build = make_group_incremental_builder(
        Z, gp, logreg.bundle(), logreg_laplace_sampler(), cfg)
    M_buf = (M_groups + 1) * per
    gst0 = init_group_state(
        init_state(M_buf, Z.shape[1], beta=0.1, dtype=jnp.float32), G)
    t0 = time.perf_counter()
    gst = build(k2, gst0, M_groups)
    n_sel = int(gst.selected.sum())
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    gst = build(k2, gst0, M_groups)
    n_sel = int(gst.selected.sum())
    t = time.perf_counter() - t0
    per_iter = t / M_groups * 1e3
    print(f"  end-to-end: {t:.3f}s for {M_groups} group selections x "
          f"{opt_itrs} exact-gradient steps (first incl compile "
          f"{t_first:.1f}s); {n_sel} groups selected, m={int(gst.core.m)} "
          f"points; {per_iter:.1f} ms/iteration "
          f"~ {per_iter / (1 + opt_itrs):.3f} ms per (N, S) pass")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--shapes", nargs="*",
                    default=["10000x100", "126185x500", "1000000x100"])
    ap.add_argument("--S", type=int, default=100)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--end-to-end", action="store_true",
                    help="run the real group builder (reference group "
                         "semantics: full group select + exact gradient) "
                         "instead of the per-pass microbenches")
    ap.add_argument("--M-groups", type=int, default=20)
    ap.add_argument("--opt-itrs", type=int, default=100)
    args = ap.parse_args()

    import jax
    print(f"devices: {jax.devices()}", file=sys.stderr)
    for shp in args.shapes:
        N, G = (int(v) for v in shp.split("x"))
        print(f"N={N} G={G} S={args.S}:")
        if args.end_to_end:
            run_end_to_end(N, G, args.S, args.d, args.M_groups, args.opt_itrs)
        else:
            run_shape(N, G, args.S, args.d, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
