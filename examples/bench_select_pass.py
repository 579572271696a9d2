"""Component microbenchmarks of the full-candidate select pass: where does
the time of a full (N, S) select go, and does a streaming two-pass
reformulation beat the materializing XLA composition?

Timing recipe: each candidate is wrapped in an in-device ``lax.scan`` of
``--reps`` repetitions with per-iteration distinct operands (fresh theta
block each rep), accumulating one scalar; wall time of the second call,
ended by ``jax.block_until_ready``, divided by reps. Run it on a GPU: a
time from the CPU backend says nothing about the card.

Variants:
  matmul    margins-only pass: sum(Z @ th.T)            (transform-free floor)
  proj      materialized centered beta-projection, consumed by a col-sum
  colsum    beta-projection column sum (fusable reduction — does XLA stream it?)
  select    the EXACT _select score chain (centered materialize + 2nd read)
  stream    two-pass streaming select: pass 1 raw column sums, pass 2
            recomputed raw + row reductions, scores from uncentered identities
            (no (N, S) materialization; optimization_barrier defeats CSE)
"""

from __future__ import annotations

import argparse
import sys
import time

N, D_FEAT, S, M_BUF = 1_000_000, 10, 100, 128


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", nargs="*",
                    default=["matmul", "proj", "colsum", "select", "stream"])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax

    from betacores_tpu.data import gen_synthetic_logreg, perturb_logreg
    from betacores_tpu.models import logreg

    from betacores_tpu.utils.device import require_gpu

    require_gpu()
    print(f"devices: {jax.devices()}", file=sys.stderr)
    k0, k1, k2 = jax.random.split(jax.random.key(0), 3)
    X, y, Z = gen_synthetic_logreg(k0, N, d=D_FEAT, dtype=jnp.float32)
    X, y, Z, _ = perturb_logreg(k1, X, y, f_rate=0.1)
    d = Z.shape[1]
    beta = jnp.float32(0.1)
    reps = args.reps
    ths = jax.random.normal(k2, (reps, S, d), dtype=jnp.float32) * 0.1
    corepts = Z[:M_BUF]
    w = jnp.abs(jax.random.normal(jax.random.key(5), (M_BUF,))) * 10.0
    Z = jax.block_until_ready(Z)

    def blik(pts, th):
        return logreg.beta_likelihood(pts, th, beta)

    def blik3(pts, th):
        # reduced-transcendental form: 3 exp + 1 log1p + 1 div (vs the
        # 2-softplus form's 2 exp + 2 log1p + 3 exp). p^{b+1} = p^b * p with
        # p = sigmoid(-m) computed from t = exp(-|m|) directly.
        m = -(pts @ th.T)
        t = jnp.exp(-jnp.abs(m))
        sp = jnp.maximum(m, 0.0) + jnp.log1p(t)     # softplus(m) = -log p
        sn = sp - m                                 # softplus(-m) = -log(1-p)
        a = jnp.exp(-beta * sp)                     # p^beta
        p = jnp.where(m >= 0, t, 1.0) / (1.0 + t)   # sigmoid(-m)
        c = jnp.exp(-(beta + 1.0) * sn)             # (1-p)^{beta+1}
        return (beta + 1.0) / beta * a - a * p - c

    def center(v):
        return v - v.mean(axis=1, keepdims=True)

    def scan_over(body):
        @jax.jit
        def f(Z, ths, w, corepts):
            def step(acc, th):
                return acc + body(Z, th, w, corepts), None
            return lax.scan(step, jnp.float32(0.0), ths)[0]
        return f

    def v_matmul(Z, th, w, corepts):
        return (Z @ th.T).sum()

    def v_proj(Z, th, w, corepts):
        vecs = center(blik(Z, th))
        # force materialization: the consumer indexes rows via a
        # data-dependent permutation XLA cannot fuse into the producer
        i = (jnp.abs(vecs[0, 0]) * 12345.6).astype(jnp.int32) % N
        return vecs[i].sum() + vecs.sum()

    def v_colsum(Z, th, w, corepts):
        return center(blik(Z, th)).sum(axis=0) @ jnp.ones((S,), jnp.float32)

    def v_select(Z, th, w, corepts):
        # the exact incremental._select chain at n_sel=None
        vecs = center(blik(Z, th))
        corevecs = center(blik(corepts, th))
        resid = vecs.sum(axis=0) - w @ corevecs
        vn = jnp.sqrt(jnp.sum(vecs * vecs, axis=1))
        vn = jnp.where(vn > 0, vn, jnp.inf)
        corrs = (vecs @ resid) / vn / S
        f = jnp.argmax(corrs)
        return corrs[f] + 1e-9 * f.astype(jnp.float32)

    def v_stream(Z, th, w, corepts):
        # pass 1: raw column sums -> centered target sum
        raw = blik(Z, th)
        csum = raw.sum(axis=0)                      # (S,)
        T = csum - csum.sum() / S                   # centered colsum
        corevecs = center(blik(corepts, th))
        resid = T - w @ corevecs
        rsum = resid.sum()
        # pass 2: recompute raw (barrier defeats CSE), row reductions only
        th2 = lax.optimization_barrier(th)
        raw2 = blik(Z, th2)
        a = raw2 @ resid                            # (N,)
        s = raw2.sum(axis=1)                        # (N,)
        q = jnp.sum(raw2 * raw2, axis=1)            # (N,)
        mean = s / S
        vdotr = a - mean * rsum
        vn2 = q - S * mean * mean
        vn = jnp.sqrt(jnp.maximum(vn2, 0.0))
        vn = jnp.where(vn > 0, vn, jnp.inf)
        corrs = vdotr / vn / S
        f = jnp.argmax(corrs)
        return corrs[f] + 1e-9 * f.astype(jnp.float32)

    def v_colsum_ll(Z, th, w, corepts):
        v = logreg.log_likelihood(Z, th)
        return center(v).sum(axis=0) @ jnp.ones((S,), jnp.float32)

    def v_colsum_b3(Z, th, w, corepts):
        return center(blik3(Z, th)).sum(axis=0) @ jnp.ones((S,), jnp.float32)

    def v_select_b3(Z, th, w, corepts):
        vecs = center(blik3(Z, th))
        corevecs = center(blik3(corepts, th))
        resid = vecs.sum(axis=0) - w @ corevecs
        vn = jnp.sqrt(jnp.sum(vecs * vecs, axis=1))
        vn = jnp.where(vn > 0, vn, jnp.inf)
        corrs = (vecs @ resid) / vn / S
        f = jnp.argmax(corrs)
        return corrs[f] + 1e-9 * f.astype(jnp.float32)

    # --- broadcast-FMA margin variants: no dot, so no (N, S) dot-output
    # materialization; the whole margins+transform+reduction chain is one
    # XLA loop fusion over the 44 MB data read ---
    Zt = jnp.asarray(Z.T)  # (d, N): contiguous per-coordinate rows

    def bcast_margins(Z, th):
        acc = Z[:, 0:1] * th.T[0][None, :]
        for j in range(1, d):
            acc = acc + Z[:, j:j + 1] * th.T[j][None, :]
        return -acc

    def bcast_margins_t(Zt, th):
        acc = Zt[0][:, None] * th.T[0][None, :]
        for j in range(1, d):
            acc = acc + Zt[j][:, None] * th.T[j][None, :]
        return -acc

    def blik_m(m):
        sp_pos = jax.nn.softplus(m)
        sp_neg = jax.nn.softplus(-m)
        return ((beta + 1.0) / beta * jnp.exp(-beta * sp_pos)
                - jnp.exp(-(beta + 1.0) * sp_pos)
                - jnp.exp(-(beta + 1.0) * sp_neg))

    def v_colsum_bc(Z, th, w, corepts):
        v = center(blik_m(bcast_margins(Z, th)))
        return v.sum(axis=0) @ jnp.ones((S,), jnp.float32)

    def v_colsum_bct(Z, th, w, corepts):
        v = center(blik_m(bcast_margins_t(Zt, th)))
        return v.sum(axis=0) @ jnp.ones((S,), jnp.float32)

    def v_select_bc(Z, th, w, corepts):
        # two-pass streaming select, broadcast margins, recompute in pass 2
        raw = blik_m(bcast_margins(Z, th))
        csum = raw.sum(axis=0)
        T = csum - csum.sum() / S
        corevecs = center(blik(corepts, th))
        resid = T - w @ corevecs
        rsum = resid.sum()
        th2 = lax.optimization_barrier(th)
        raw2 = blik_m(bcast_margins(Z, th2))
        a = raw2 @ resid
        s = raw2.sum(axis=1)
        q = jnp.sum(raw2 * raw2, axis=1)
        mean = s / S
        vdotr = a - mean * rsum
        vn2 = q - S * mean * mean
        vn = jnp.sqrt(jnp.maximum(vn2, 0.0))
        vn = jnp.where(vn > 0, vn, jnp.inf)
        corrs = vdotr / vn / S
        f = jnp.argmax(corrs)
        return corrs[f] + 1e-9 * f.astype(jnp.float32)

    def v_dotsq(Z, th, w, corepts):
        # non-collapsible dot consumer: measures the skinny-k dot itself
        m = Z @ th.T
        return jnp.sum(m * m)

    def v_dotsq_bf16(Z, th, w, corepts):
        m = jnp.dot(Z.astype(jnp.bfloat16), th.T.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32)
        return jnp.sum(m * m)

    def blik_mb(pts, th):
        # bf16 margin matrix (halves the dot-boundary HBM traffic; f32
        # transform). Margin relative error ~0.4% -> ~1% score noise.
        m = -jnp.dot(pts.astype(jnp.bfloat16), th.T.astype(jnp.bfloat16),
                     preferred_element_type=jnp.bfloat16).astype(jnp.float32)
        sp_pos = jax.nn.softplus(m)
        sp_neg = jax.nn.softplus(-m)
        return ((beta + 1.0) / beta * jnp.exp(-beta * sp_pos)
                - jnp.exp(-(beta + 1.0) * sp_pos)
                - jnp.exp(-(beta + 1.0) * sp_neg))

    def v_colsum_mb(Z, th, w, corepts):
        v = center(blik_mb(Z, th))
        return v.sum(axis=0) @ jnp.ones((S,), jnp.float32)

    def v_select_mb(Z, th, w, corepts):
        vecs = center(blik_mb(Z, th))
        corevecs = center(blik(corepts, th))
        resid = vecs.sum(axis=0) - w @ corevecs
        vn = jnp.sqrt(jnp.sum(vecs * vecs, axis=1))
        vn = jnp.where(vn > 0, vn, jnp.inf)
        corrs = (vecs @ resid) / vn / S
        f = jnp.argmax(corrs)
        return corrs[f] + 1e-9 * f.astype(jnp.float32)

    def v_selloop(Z, th, w, corepts):
        # the select chain inside a sequential fori_loop with threaded state
        # (mimics the build's fori body — does loop context break the fusion
        # the standalone chain gets?)
        def body(i, w):
            thi = th + 1e-6 * i
            vecs = center(blik(Z, thi))
            corevecs = center(blik(corepts, thi))
            resid = vecs.sum(axis=0) - w @ corevecs
            vn = jnp.sqrt(jnp.sum(vecs * vecs, axis=1))
            vn = jnp.where(vn > 0, vn, jnp.inf)
            corrs = (vecs @ resid) / vn / S
            f = jnp.argmax(corrs)
            return w.at[f % M_BUF].add(1e-7 * corrs[f])
        return lax.fori_loop(0, 1, lambda i, w: body(i, w), w).sum()

    fns = {"matmul": v_matmul, "proj": v_proj, "colsum": v_colsum,
           "selloop": v_selloop, "colsum_mb": v_colsum_mb,
           "select_mb": v_select_mb,
           "select": v_select, "stream": v_stream,
           "colsum_ll": v_colsum_ll, "colsum_b3": v_colsum_b3,
           "select_b3": v_select_b3, "colsum_bc": v_colsum_bc,
           "colsum_bct": v_colsum_bct, "select_bc": v_select_bc,
           "dotsq": v_dotsq, "dotsq_bf16": v_dotsq_bf16}
    for name in args.variants:
        f = scan_over(fns[name])
        jax.block_until_ready(f(Z, ths, w, corepts))  # compile + warm
        t0 = time.perf_counter()
        r = float(jax.block_until_ready(f(Z, ths, w, corepts)))
        t = time.perf_counter() - t0
        per = t / reps
        print(f"{name:8s} {per*1e3:8.3f} ms/pass   (total {t:.3f}s, acc={r:.4g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
