"""Sharded multi-device coreset builds.

Mesh replacement for the reference's only parallelism
(multiprocessing.Pool, SURVEY.md section 2.5): the dataset's N axis is
sharded over the mesh's ``data`` axis and the projection's posterior-sample
S axis over the ``samp`` axis. Per build iteration:

  * posterior sampling + weight refinement are REPLICATED (the coreset
    state is M x d — tiny); every device computes identical values from
    identical keys, so no parameter broadcasts are needed;
  * candidate scoring is LOCAL: each data-shard draws a stratified local
    subsample, projects it, and scores it against the residual;
  * the Sigma-over-N residual term is one psum('data') of an S-slice, and
    every inner product over S is a psum('samp') — the only collectives,
    both tiny;
  * greedy selection is a DISTRIBUTED ARGMAX: per-shard top-1 then an
    all_gather('data') of (score, global index, point) triples and a
    replicated argmax. Ties break toward the lower shard index, which
    matches the single-device first-argmax rule under the same candidate
    ordering (SURVEY.md hard part 5; across different mesh shapes the
    subsample streams differ, so equivalence is statistical, not bitwise).

The same mesh program compiles on a virtual CPU mesh
(``--xla_force_host_platform_device_count``), which is how tests and
``dryrun_multichip`` rehearse it without several GPUs.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..coresets.incremental import IncrementalConfig
from ..coresets.state import CoresetState
from ..utils.opt import nn_adam, step_schedule
from .mesh import DATA_AXIS, SAMP_AXIS, require_axes


def make_sharded_incremental_builder(
    data_sharded: jnp.ndarray,
    n_true: int,
    model,
    sampler: Callable,
    config: IncrementalConfig,
    mesh,
    step_sizes: Optional[jnp.ndarray] = None,
    data_weights: Optional[jnp.ndarray] = None,
) -> Callable:
    """Returns jitted ``build(key, state, itrs) -> state`` where
    ``data_sharded`` is row-sharded over the mesh's data axis (zero-padded
    to divisibility; ``n_true`` is the unpadded row count) and the state is
    replicated.

    ``n_subsample_select/opt = None`` is FULL-DATA mode (reference
    sparsevi.py:14-15: score ALL N candidates / exact Sigma-over-N in the
    refinement gradient): every shard projects all of its local rows, the
    column sums meet in one psum('data'), and the distributed argmax runs
    over every valid row — the mode that makes "N sharded because it does
    not fit one chip" EXACT rather than stratified. With the same key it
    computes the single-device full-data builder's quantities up to float
    summation order (tested); the two modes mix freely per phase
    (e.g. full-data select + subsampled optimize).

    ``data_weights`` (optional, the output of ``mesh.shard_weights`` — an
    (N_pad,) vector sharded like the data rows, zero-padded) makes row n
    count ``u_n`` times in the residual target, exactly like the
    single-device weighted builder (incremental.py): the stratified local
    estimate becomes ``shard_scale * sum_j u_j v_j`` and zero-weight rows
    (padding / dead merge-reduce leaf slots) are masked out of the
    distributed candidate argmax. ``None`` keeps the unweighted program
    bit-identical."""
    if config.learn_beta and getattr(model, "beta_gradient", None) is None:
        raise ValueError("learn_beta requires a model with beta_gradient")
    weighted = data_weights is not None
    if weighted:
        if data_weights.shape != (data_sharded.shape[0],):
            raise ValueError(
                f"data_weights must be ({data_sharded.shape[0]},) (padded like "
                f"the sharded rows — use shard_weights), got {data_weights.shape}")
        # cast like every other weighted entry point: f64 weights would
        # silently promote the tangent computation and break the documented
        # u=ones == unweighted bit-identity
        data_weights = jnp.asarray(data_weights, dtype=data_sharded.dtype)

    n_data, n_samp = require_axes(mesh)
    S = config.projection_dim
    if S % n_samp:
        raise ValueError(f"projection_dim {S} must divide over samp axis {n_samp}")
    S_loc = S // n_samp
    n_sel_loc = (None if config.n_subsample_select is None
                 else max(1, config.n_subsample_select // n_data))
    n_opt_loc = (None if config.n_subsample_opt is None
                 else max(1, config.n_subsample_opt // n_data))
    dtype = data_sharded.dtype
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=dtype)
    step_sizes = jnp.asarray(step_sizes, dtype=dtype)

    def _center_S(lls):
        """Center an (n, S_loc) block over the FULL S axis via psum('samp')."""
        mean = jax.lax.psum(lls.sum(axis=1), SAMP_AXIS) / S
        return lls - mean[:, None]

    def _proj(pts, samples_loc, beta):
        if config.use_beta:
            return _center_S(model.beta_likelihood(pts, samples_loc, beta))
        return _center_S(model.log_likelihood(pts, samples_loc))

    def _dot_S(a, b):
        """Inner product over the sharded S axis."""
        return jax.lax.psum(a @ b, SAMP_AXIS)

    def _tangent_core(samples, st, beta, n_loc, k_sub, data_local, u_local,
                      ax_d, ax_s, local_valid, with_beta_grad: bool = False):
        """Subsample + project against ALREADY-DRAWN (replicated) samples.
        ``n_loc=None`` is full-data mode: every valid local row, exact
        psum'd Sigma-over-N, no stratified rescale."""
        samples_loc = jax.lax.dynamic_slice_in_dim(samples, ax_s * S_loc, S_loc, axis=0)
        if n_loc is None:
            # FULL-DATA: project all local rows; zero-padding rows (indices
            # >= local_valid) are masked out of the target and, in select,
            # out of the candidate argmax
            sub = None
            row_valid = (jnp.arange(data_local.shape[0]) < local_valid)
            vecs = _proj(data_local, samples_loc, beta)
            vecs = vecs * row_valid[:, None].astype(dtype)
            usub = u_local
            rowsum = vecs.sum(axis=0) if usub is None else usub @ vecs
            total = jax.lax.psum(rowsum, DATA_AXIS)             # (S_loc,)
        else:
            # stratified local subsample of this shard's valid rows
            sub = jax.random.randint(jax.random.fold_in(k_sub, ax_d), (n_loc,), 0,
                                     jnp.maximum(local_valid, 1))
            vecs = _proj(data_local[sub], samples_loc, beta)
            has_rows = (local_valid > 0).astype(dtype)
            vecs = vecs * has_rows
            # unbiased stratified Sigma-over-N (weighted: Sigma u_n v_n):
            # per-shard rescale, then psum
            usub = None if u_local is None else u_local[sub]
            rowsum = vecs.sum(axis=0) if usub is None else usub @ vecs
            shard_scale = local_valid.astype(dtype) / n_loc
            total = jax.lax.psum(shard_scale * rowsum, DATA_AXIS)  # (S_loc,)
        mask = st.slot_mask[:, None].astype(dtype)
        corevecs = _proj(st.pts, samples_loc, beta) * mask
        betagrads = None
        if with_beta_grad:
            # d/d(beta) of the coreset projections for learn-beta, centered
            # over the full S axis like the scalar projection
            betagrads = _center_S(model.beta_gradient(st.pts, samples_loc, beta)) * mask
        return vecs, corevecs, total, sub, usub, betagrads

    def _tangent(key, w, st, beta, n_loc, aux, data_local, u_local, ax_d, ax_s,
                 local_valid, with_beta_grad: bool = False):
        k_samp, k_sub = jax.random.split(key)
        # replicated sampler: same key on every device -> identical samples
        samples, aux = sampler(k_samp, S, w, st.pts, aux)
        vecs, corevecs, total, sub, usub, betagrads = _tangent_core(
            samples, st, beta, n_loc, k_sub, data_local, u_local,
            ax_d, ax_s, local_valid, with_beta_grad)
        return vecs, corevecs, total, sub, usub, aux, betagrads

    def _step(data_local, u_local, key, st: CoresetState) -> CoresetState:
        ax_d = jax.lax.axis_index(DATA_AXIS)
        ax_s = jax.lax.axis_index(SAMP_AXIS)
        rows_loc = data_local.shape[0]
        local_valid = jnp.clip(n_true - ax_d * rows_loc, 0, rows_loc)
        k_sel, k_opt = jax.random.split(key)

        # ---- select (distributed argmax) ----
        vecs, corevecs, total, sub, usub, aux, _ = _tangent(
            k_sel, st.wts, st, st.beta, n_sel_loc, st.sampler_aux,
            data_local, u_local, ax_d, ax_s, local_valid,
        )
        resid_loc = total - st.wts @ corevecs  # (S_loc,), sharded over samp
        corr_num = _dot_S(vecs, resid_loc)     # (n_loc,), replicated over samp
        vn = jnp.sqrt(jax.lax.psum(jnp.sum(vecs * vecs, axis=1), SAMP_AXIS))
        vn = jnp.where(vn > 0, vn, jnp.inf)
        corrs = corr_num / vn / S
        if sub is None:
            # full-data: per-row padding mask (row i valid iff i < local_valid)
            corrs = jnp.where(jnp.arange(rows_loc) < local_valid, corrs, -jnp.inf)
        else:
            # shards with no valid rows (padding-only) never win the argmax
            corrs = jnp.where(local_valid > 0, corrs, -jnp.inf)
        if usub is not None:
            # zero-base-weight rows contribute nothing to the target, so
            # they must never be selectable (incremental.py weighted select)
            corrs = jnp.where(usub > 0, corrs, -jnp.inf)

        M_max = st.wts.shape[0]
        if config.dedup_select:
            # mask already-selected GLOBAL indices out of this shard's
            # candidates before the local top-1 (the replicated st.idcs
            # makes the membership test local — no extra collective), then
            # always install the distributed-argmax winner. Mirrors the
            # single-device dedup branch (coresets/incremental.py).
            cand_g = (ax_d * rows_loc
                      + (jnp.arange(rows_loc) if sub is None else sub)
                      ).astype(jnp.int32)
            cand_sel = jnp.any(
                jnp.logical_and(cand_g[:, None] == st.idcs[None, :],
                                st.slot_mask[None, :]), axis=1)
            corrs = jnp.where(cand_sel, -jnp.inf, corrs)

        best_loc = jnp.argmax(corrs)
        best_score = corrs[best_loc]
        sel_row = best_loc if sub is None else sub[best_loc]
        best_gidx = (ax_d * rows_loc + sel_row).astype(jnp.int32)
        best_pt = data_local[sel_row]
        scores_g = jax.lax.all_gather(best_score, DATA_AXIS)   # (n_data,)
        gidx_g = jax.lax.all_gather(best_gidx, DATA_AXIS)
        pts_g = jax.lax.all_gather(best_pt, DATA_AXIS)
        win = jnp.argmax(scores_g)
        f, f_pt, f_score = gidx_g[win], pts_g[win], scores_g[win]

        if config.dedup_select:
            add = jnp.logical_and(st.m < M_max, jnp.isfinite(f_score))
        else:
            cn = jnp.sqrt(jax.lax.psum(jnp.sum(corevecs * corevecs, axis=1), SAMP_AXIS))
            cn = jnp.where(cn > 0, cn, jnp.inf)
            corecorrs = jnp.where(st.slot_mask, jnp.abs(_dot_S(corevecs, resid_loc)) / cn / S, -jnp.inf)
            take_new = jnp.logical_or(st.m == 0, f_score > jnp.max(corecorrs))
            already = jnp.any(jnp.logical_and(st.idcs == f, st.slot_mask))
            add = jnp.logical_and(take_new, jnp.logical_and(jnp.logical_not(already), st.m < M_max))
            if u_local is not None:
                # the m==0 arm of take_new bypasses the -inf masks: an
                # all-masked candidate round must never install a u==0 row
                # (same guard as the single-device weighted select)
                add = jnp.logical_and(add, jnp.isfinite(f_score))
        slot = jnp.minimum(st.m, M_max - 1)
        st = st._replace(
            idcs=jnp.where(add, st.idcs.at[slot].set(f), st.idcs),
            pts=jnp.where(add, st.pts.at[slot].set(f_pt), st.pts),
            m=jnp.where(add, st.m + 1, st.m),
            sampler_aux=aux,
        )

        # ---- optimize (replicated Adam over the M-dim weights; shared
        # projected-Adam from utils/opt, same update as the single-device
        # and group builders) ----
        if not config.learn_beta:
            fit = getattr(sampler, "fit", None)
            from_fit = getattr(sampler, "from_fit", None)
            fit_aux = getattr(sampler, "fit_aux", None)
            draw_noise = getattr(sampler, "draw_noise", None)
            from_noise = getattr(sampler, "from_noise", None)
            laplace_family = (fit is not None and from_fit is not None
                              and fit_aux is not None)
            if (draw_noise is not None and from_noise is not None
                    and n_opt_loc is not None):
                # Single-device fast-path parity (coresets/incremental.py
                # pre-drawn branch, ported shard-local): pre-draw the
                # WHOLE refinement loop's posterior noise and per-shard
                # subsample indices in batched kernels and pre-gather the
                # local rows in one pass, instead of one
                # randn+randint+gather chain per Adam step. The draws replay
                # nn_adam's exact key stream (split(key, T), then
                # split(k) -> (k_samp, k_sub), then fold_in(k_sub, ax_d))
                # through the SAME functions the per-step path used, so
                # every value is bit-identical by construction. Noise and
                # the posterior refit are REPLICATED (same keys everywhere);
                # only the subsample rows are shard-local.
                T = step_sizes.shape[0]
                aux0 = st.sampler_aux
                keys = jax.random.split(k_opt, T)
                pair = jax.vmap(jax.random.split)(keys)        # (T, 2)
                k_samp_all, k_sub_all = pair[:, 0], pair[:, 1]
                z_all = jax.vmap(
                    lambda k: draw_noise(k, S, st.wts, st.pts, aux0))(k_samp_all)
                sub_all = jax.vmap(lambda k: jax.random.randint(
                    jax.random.fold_in(k, ax_d), (n_opt_loc,), 0,
                    jnp.maximum(local_valid, 1)))(k_sub_all)
                rows_all = data_local[sub_all]                 # (T, n_opt_loc, D)
                has_rows = (local_valid > 0).astype(dtype)
                shard_scale = local_valid.astype(dtype) / n_opt_loc
                mask = st.slot_mask[:, None].astype(dtype)
                M_buf = st.pts.shape[0]
                lagged = config.refit_every > 1 and laplace_family
                k_refit = config.refit_every

                # Pre-append the coreset buffer (constant across this
                # refinement pass) to every step's subsample rows: joint
                # projection is bit-identical to two separate calls
                # (centering is per-row), one kernel chain instead of two.
                rows_all = jnp.concatenate(
                    [rows_all,
                     jnp.broadcast_to(st.pts, (T, M_buf) + st.pts.shape[1:])],
                    axis=1)                                    # (T, n_opt_loc+M, D)
                u_all = None if u_local is None else u_local[sub_all]

                if lagged:
                    def mk_samples(w, lap, z, i):
                        lap = jax.lax.cond(
                            jnp.logical_and(i % k_refit == 0, i > 0),
                            lambda: fit(w, st.pts, fit_aux(lap)),
                            lambda: lap)
                        return from_fit(lap, z), lap

                    carry0 = fit(st.wts, st.pts, aux0)
                    steps = jnp.arange(T)
                else:
                    def mk_samples(w, aux, z, i):
                        return from_noise(z, w, st.pts, aux)

                    carry0 = aux0
                    steps = None

                def unpack(xsl):
                    if steps is None:
                        return (None,) + tuple(xsl) + ((None,) if u_all is None else ())
                    return tuple(xsl) + ((None,) if u_all is None else ())

                xs = (z_all, rows_all) if u_all is None else (z_all, rows_all, u_all)
                if steps is not None:
                    xs = (steps,) + xs

                def grad_fn(w, carry, k, xsl):
                    i, z, rows, usub = unpack(xsl)
                    samples, carry = mk_samples(w, carry, z, i)
                    samples_loc = jax.lax.dynamic_slice_in_dim(
                        samples, ax_s * S_loc, S_loc, axis=0)
                    allvecs = _proj(rows, samples_loc, st.beta)
                    vecs_o = allvecs[:n_opt_loc] * has_rows
                    corevecs_o = allvecs[n_opt_loc:] * mask
                    rowsum = (vecs_o.sum(axis=0) if usub is None
                              else usub @ vecs_o)
                    total_o = jax.lax.psum(shard_scale * rowsum, DATA_AXIS)
                    resid = total_o - w @ corevecs_o
                    return -_dot_S(corevecs_o, resid) / S, carry

                w_new, carry = nn_adam(st.wts, grad_fn, carry0, k_opt,
                                       step_sizes, xs=xs)
                aux = fit_aux(carry) if lagged else carry
                return st._replace(wts=w_new, sampler_aux=aux)

            def grad_fn(w, aux, k):
                vecs_o, corevecs_o, total_o, _, _, aux, _ = _tangent(
                    k, w, st, st.beta, n_opt_loc, aux, data_local, u_local,
                    ax_d, ax_s, local_valid
                )
                resid = total_o - w @ corevecs_o
                return -_dot_S(corevecs_o, resid) / S, aux

            w_new, aux = nn_adam(st.wts, grad_fn, st.sampler_aux, k_opt, step_sizes)
            return st._replace(wts=w_new, sampler_aux=aux)

        # learn_beta: joint (w, beta) refinement, replicated like the weight
        # Adam (same update as coresets/incremental.py's learn_beta branch:
        # reference bcores.py:127-140 with the working autodiff beta-gradient;
        # beta clamped to (floor, beta_cap] exactly like
        # coresets/incremental.py — see the degenerate beta->inf minimum
        # note there). The extra collective is one psum('samp') for the
        # betagrads inner product.
        beta_floor = jnp.asarray(1e-3, dtype=dtype)
        beta_cap = jnp.asarray(config.beta_cap, dtype=dtype)
        clamp_b = lambda b: jnp.clip(b, beta_floor, beta_cap)

        def grad_fn_b(x, aux, k):
            w, beta = x[:-1], clamp_b(x[-1])
            vecs_o, corevecs_o, total_o, _, _, aux, betagrads = _tangent(
                k, w, st, beta, n_opt_loc, aux, data_local, u_local,
                ax_d, ax_s, local_valid, with_beta_grad=True,
            )
            resid = total_o - w @ corevecs_o
            wgrad = -_dot_S(corevecs_o, resid) / S
            betagrad = -config.beta_grad_scale * jnp.sum(w * _dot_S(betagrads, resid)) / S
            return jnp.concatenate([wgrad, betagrad[None]]), aux

        x0 = jnp.concatenate([st.wts, st.beta[None]])
        xf, aux = nn_adam(x0, grad_fn_b, st.sampler_aux, k_opt, step_sizes)
        return st._replace(wts=xf[:-1], beta=clamp_b(xf[-1]), sampler_aux=aux)

    def _build_local(data_local, u_local, key, itrs, st):
        # itrs is traced (fori_loop -> while_loop): one compiled program for
        # every build size, like the single-device builders (CLAUDE.md)
        def body(i, st):
            return _step(data_local, u_local, jax.random.fold_in(key, i), st)

        return jax.lax.fori_loop(0, itrs, body, st)

    def _trace_local(data_local, u_local, key, itrs, st):
        def body(st, i):
            st = _step(data_local, u_local, jax.random.fold_in(key, i), st)
            return st, (st.wts, st.idcs, st.beta)

        return jax.lax.scan(body, st, jnp.arange(itrs))

    state_spec = CoresetState(wts=P(), idcs=P(), pts=P(), m=P(), beta=P(), sampler_aux=P())

    if weighted:
        # the weights ride through shard_map as a row-sharded argument; the
        # unweighted branch keeps the original program bit-identical
        @jax.jit
        def _build_w(data, u, key, st: CoresetState, itrs) -> CoresetState:
            return jax.shard_map(
                lambda d, uu, k, i, s: _build_local(d, uu, k, i, s),
                mesh=mesh,
                in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(), P(), state_spec),
                out_specs=state_spec,
                check_vma=False,
            )(data, u, key, itrs, st)

        @partial(jax.jit, static_argnums=4)
        def _trace_w(data, u, key, st: CoresetState, itrs: int):
            return jax.shard_map(
                lambda d, uu, k, s: _trace_local(d, uu, k, itrs, s),
                mesh=mesh,
                in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(), state_spec),
                out_specs=(state_spec, (P(), P(), P())),
                check_vma=False,
            )(data, u, key, st)

        build = lambda key, st, itrs: _build_w(
            data_sharded, data_weights, key, st, jnp.asarray(itrs, dtype=jnp.int32))
        build.trace = lambda key, st, itrs: _trace_w(
            data_sharded, data_weights, key, st, int(itrs))
        return build

    @jax.jit
    def _build_d(data, key, st: CoresetState, itrs) -> CoresetState:
        # data is a jit ARGUMENT: a closed-over dataset embeds into the HLO
        # (see coresets/incremental.py _bind)
        return jax.shard_map(
            lambda d, k, i, s: _build_local(d, None, k, i, s),
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None), P(), P(), state_spec),
            out_specs=state_spec,
            check_vma=False,
        )(data, key, itrs, st)

    @partial(jax.jit, static_argnums=3)
    def _trace_d(data, key, st: CoresetState, itrs: int):
        # static itrs (output shape); per-iteration (wts, idcs, beta) are
        # replicated, so the trace transfers once at the end
        return jax.shard_map(
            lambda d, k, s: _trace_local(d, None, k, itrs, s),
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None), P(), state_spec),
            out_specs=(state_spec, (P(), P(), P())),
            check_vma=False,
        )(data, key, st)

    build = lambda key, st, itrs: _build_d(data_sharded, key, st, jnp.asarray(itrs, dtype=jnp.int32))
    # per-size trace entry point (same key stream as build)
    build.trace = lambda key, st, itrs: _trace_d(data_sharded, key, st, int(itrs))
    return build
