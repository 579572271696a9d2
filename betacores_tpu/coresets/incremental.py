"""Incremental greedy coreset builder (SparseVI and beta-Cores).

Spec: reference coreset/sparsevi.py:26-139 and coreset/bcores.py:27-156 —
both share one skeleton per iteration:

  select:   draw S posterior samples from the current coreset posterior,
            project a data subsample and the coreset into the tangent space,
            score candidates by correlation with the residual
            resid = scaling * sum_n vecs_n - w . corevecs, and append the
            argmax unless an existing coreset point scores higher;
  optimize: refine all weights by ``opt_itrs`` projected-Adam steps of the
            Monte-Carlo KL gradient -corevecs . resid / S, re-sampling the
            posterior and the data subsample EVERY step (call stack
            SURVEY.md 3.2).

beta-Cores is the same skeleton with beta-likelihood projections
(``use_beta``); ``learn_beta`` additionally optimizes beta by gradient —
working here via the models' autodiff beta_gradient (the reference's
learn_beta path crashes on a missing method, bcores.py:131).

The entire ``build(key, state, itrs)`` — itrs x (select + opt_itrs Adam
steps), every posterior re-fit included — is ONE compiled XLA program: a
``lax.scan`` over iterations wrapping a ``lax.scan`` over Adam steps. The
posterior sampler warm-starts through ``state.sampler_aux``, replacing the
reference's cold scipy-BFGS-per-gradient-step (its dominant cost).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.projection import (
    draw_subsample,
    project_beta,
    project_beta_with_grad,
    project_ll,
)
from ..utils.opt import nn_adam, step_schedule
from .state import CoresetState


@dataclasses.dataclass(frozen=True)
class IncrementalConfig:
    """Static build configuration (reference constructor kwargs at
    bcores.py:9-11 / sparsevi.py:9-11)."""

    projection_dim: int = 100          # S
    n_subsample_select: Optional[int] = None
    n_subsample_opt: Optional[int] = None
    opt_itrs: int = 100
    i0: float = 0.1                    # lr schedule i0 / (1 + i)
    use_beta: bool = False             # project with the beta-likelihood
    learn_beta: bool = False
    # dedup_select=True masks already-selected data indices OUT of the
    # candidate argmax and always installs the best remaining candidate, so
    # every select step grows the coreset by one until the budget is full.
    # Default False = reference parity: the reference drops a duplicate
    # argmax on the floor (`f not in self.idcs`, bcores.py:84) and also
    # skips the add when an existing coreset point out-scores every
    # candidate — under subsampled select that silently under-fills the
    # budget (the round-4 headline bench delivered 94 of M=100 points).
    dedup_select: bool = False
    beta_grad_scale: float = 1e-5      # reference bcores.py:134 damping
    beta_cap: float = 1.0              # learn_beta clamp ceiling (see below)
    # refit_every=k > 1 re-fits the sampler's posterior (the Newton-Laplace
    # chain — the longest dependent-kernel run in each Adam step) only every
    # k-th refinement step, reusing the last fit's (mu, chol) to transform
    # that step's fresh noise. Beyond reference (which refits every step,
    # bcores.py:142-146): an opt-in latency/accuracy trade for the
    # latency-bound build (PERF.md). The refinement
    # objective is nonstationary in w through the posterior, so a lagged fit
    # is a slightly stale tangent space that vanishes as w converges;
    # measured quality at k<=5 matches k=1 (tests/test_coresets.py). The
    # pre-drawn fast path and the sharded builder (parallel/sharded.py)
    # honor it for samplers exposing fit/from_fit/fit_aux (the Laplace
    # families); elsewhere it is ignored.
    refit_every: int = 1

    def __post_init__(self):
        if self.learn_beta and not self.use_beta:
            # otherwise the data projects under the plain log-likelihood
            # while corevecs/betagrads use the beta-likelihood — silently
            # inconsistent tangent spaces
            raise ValueError("learn_beta requires use_beta=True")
        if self.refit_every < 1:
            raise ValueError("refit_every must be >= 1")


class IncrementalBuilder:
    """Compiled entry points: ``build(key, state, itrs[, ctx])`` runs itrs x
    (select + optimize); ``optimize(key, state[, ctx])`` runs one refinement
    pass alone (the reference's post-build ``Coreset.optimize()``). ``ctx``
    is an arbitrary traced pytree handed to model/sampler factories — e.g.
    the neural-linear encoder parameters, which change between builds
    without retracing (reference zellner_neural_linear/main.py:191-205
    interleaves NN training with coreset iterations)."""

    def __init__(self, build_fn, optimize_fn, build_trace_fn=None):
        self.build = build_fn
        self.optimize = optimize_fn
        # build_trace(key, state, itrs, ctx=None) -> (state, (wts, idcs,
        # beta) per iteration): the whole incremental loop as ONE device
        # program, recording each size's coreset — replaces per-m
        # ``build(1, m); get()`` driver loops and their per-size host round
        # trips. itrs is static (output
        # shape); the key stream matches ``build(key, st, itrs)``.
        self.build_trace = build_trace_fn

    def __call__(self, key, state, itrs, ctx=None):
        return self.build(key, state, itrs, ctx)


def make_incremental_builder(
    data: jnp.ndarray,
    model,
    sampler: Callable,
    config: IncrementalConfig,
    step_sizes: Optional[jnp.ndarray] = None,
    contextual: bool = False,
    data_weights: Optional[jnp.ndarray] = None,
) -> IncrementalBuilder:
    """Returns compiled ``IncrementalBuilder`` closed over the dataset,
    model bundle and sampler. ``step_sizes`` overrides the default
    i0/(1+i) schedule (shape (opt_itrs,)). With ``contextual=True``,
    ``model`` and ``sampler`` are factories ``ctx -> ModelFns`` /
    ``ctx -> sampler_fn`` resolved at trace time from the traced ``ctx``
    pytree passed to ``build`` (e.g. neural-linear encoder params).

    ``data_weights`` (optional (N,) array, a jit argument like ``data``)
    makes row n count ``u_n`` times in the residual target
    ``resid = scaling * sum_n u_n v_n - w . corevecs`` — the full-data
    target becomes the WEIGHTED posterior's tangent vector. Selection
    scoring stays per-row (the reference normalizes candidate scores by
    ||v_n||, so a base weight cancels there anyway). This is what a
    merge-reduce streaming build needs: leaf coresets carry weights, and
    the final build summarizes the union of weighted leaf points
    (coresets/streaming.py). ``None`` (default) is bit-identical to the
    unweighted path. Integer weights are exactly equivalent to duplicating
    rows on the full-data (no-subsample) path; under subsampling the
    estimator stays unbiased: E[N/n * sum_sub u v] = sum u v."""
    N = data.shape[0]
    S = config.projection_dim
    if (config.learn_beta and not contextual
            and getattr(model, "beta_gradient", None) is None):
        raise ValueError("learn_beta requires a model with beta_gradient")
    n_sel = None if config.n_subsample_select is None else min(N, config.n_subsample_select)
    n_opt = None if config.n_subsample_opt is None else min(N, config.n_subsample_opt)
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data.dtype)
    step_sizes = jnp.asarray(step_sizes, dtype=data.dtype)

    weighted = data_weights is not None
    if weighted:
        data_weights = jnp.asarray(data_weights, dtype=data.dtype)
        if data_weights.shape != (N,):
            raise ValueError(f"data_weights must be ({N},), got {data_weights.shape}")

    def _resolve(ctx):
        if contextual:
            return model(ctx), sampler(ctx)
        return model, sampler

    def _project(mdl, pts, samples, beta):
        if config.use_beta:
            return project_beta(mdl, pts, samples, beta)
        return project_ll(mdl, pts, samples)

    def _bind(data, u):
        # ``data`` (and ``u``, the optional (N,) base weights) are jit
        # arguments of the entry points below, NOT closure constants: a
        # closed-over dataset is embedded into the compiled program (an
        # N x D constant -> multi-hundred-MB HLO, minutes of compile, and a
        # cache entry per dataset); as parameters the program is
        # dataset-independent.

        def _sum_rows(vecs, usub):
            # sum_n u_n v_n over already-gathered rows; u=None keeps the
            # plain sum so the unweighted program is bit-identical. The ONE
            # implementation of the weighted target — the pre-gathered fast
            # path delegates here too, so the paths cannot diverge.
            return vecs.sum(axis=0) if u is None else usub @ vecs

        def _target_sum(vecs, sub_idcs):
            usub = None if u is None else (u if sub_idcs is None else u[sub_idcs])
            return _sum_rows(vecs, usub)
        def _tangent(key, w, st: CoresetState, beta, n_sub, aux, ctx,
                     with_beta_grad: bool = False):
            """Posterior samples + centered projections of a data (sub)sample and
            of the coreset buffer (padding rows zeroed). ``with_beta_grad``
            additionally returns d/d(beta) of the coreset projections
            (learn-beta path); None otherwise."""
            mdl, smp = _resolve(ctx)
            _project_ = lambda pts, samples, beta: _project(mdl, pts, samples, beta)
            k_samp, k_sub = jax.random.split(key)
            samples, aux = smp(k_samp, S, w, st.pts, aux)
            mask = st.slot_mask[:, None].astype(data.dtype)
            if n_sub is None:
                vecs = _project_(data, samples, beta)
                scaling = jnp.asarray(1.0, dtype=data.dtype)
                sub_idcs = None
            elif not with_beta_grad:
                # one projection pass over [subsample; coreset buffer]: the
                # centering is per-row, so splitting afterwards is identical
                # to two separate calls but costs one matmul+transform
                # kernel chain instead of two (the build is latency-bound:
                # 50k dependent steps in the headline config).
                sub_idcs, scaling = draw_subsample(k_sub, N, n_sub)
                allvecs = _project_(
                    jnp.concatenate([data[sub_idcs], st.pts], axis=0), samples, beta)
                vecs = allvecs[:n_sub]
                corevecs, betagrads = allvecs[n_sub:] * mask, None
                return vecs, corevecs, scaling, sub_idcs, samples, aux, betagrads
            else:
                sub_idcs, scaling = draw_subsample(k_sub, N, n_sub)
                vecs = _project_(data[sub_idcs], samples, beta)
            if with_beta_grad:
                corevecs, betagrads = project_beta_with_grad(mdl, st.pts, samples, beta)
                corevecs, betagrads = corevecs * mask, betagrads * mask
            else:
                corevecs, betagrads = _project_(st.pts, samples, beta) * mask, None
            return vecs, corevecs, scaling, sub_idcs, samples, aux, betagrads

        def _select(key, st: CoresetState, ctx) -> CoresetState:
            """Reference bcores.py:74-90 / sparsevi.py:74-96."""
            vecs, corevecs, scaling, sub_idcs, _, aux, _ = _tangent(
                key, st.wts, st, st.beta, n_sel, st.sampler_aux, ctx
            )
            resid = scaling * _target_sum(vecs, sub_idcs) - st.wts @ corevecs
            vn = jnp.sqrt(jnp.sum(vecs * vecs, axis=1))
            vn = jnp.where(vn > 0, vn, jnp.inf)  # zero projections score 0 (reference NaNs)
            corrs = (vecs @ resid) / vn / S
            if u is not None:
                # zero-base-weight rows are non-data (merge-reduce padding /
                # dead leaf slots): they contribute nothing to the target,
                # so they must never be selectable either
                usub = u if sub_idcs is None else u[sub_idcs]
                corrs = jnp.where(usub > 0, corrs, -jnp.inf)
            M_max = st.wts.shape[0]
            if config.dedup_select:
                # mask already-selected rows out of the candidate argmax:
                # scatter the live slots' indices into an (N,) hit-count
                # (scatter-add so a stale padding slot can never erase a
                # live slot's mark), gather at the candidates, and always
                # install the best remaining candidate. No corecorrs
                # comparison: in this mode re-selection pressure on an
                # existing point is refinement's job, never a skipped add.
                hits = jnp.zeros((N,), jnp.int32).at[st.idcs].add(
                    st.slot_mask.astype(jnp.int32), mode="drop")
                cand_sel = (hits if sub_idcs is None else hits[sub_idcs]) > 0
                corrs = jnp.where(cand_sel, -jnp.inf, corrs)
                fcand = jnp.argmax(corrs)
                f = (fcand if sub_idcs is None else sub_idcs[fcand]).astype(jnp.int32)
                # -inf guard covers u==0 rows, padding shards AND the
                # (pathological) all-candidates-already-selected subsample
                add = jnp.logical_and(st.m < M_max, jnp.isfinite(corrs[fcand]))
            else:
                cn = jnp.sqrt(jnp.sum(corevecs * corevecs, axis=1))
                cn = jnp.where(cn > 0, cn, jnp.inf)
                corecorrs = jnp.where(st.slot_mask, jnp.abs(corevecs @ resid) / cn / S, -jnp.inf)

                fcand = jnp.argmax(corrs)
                f = (fcand if sub_idcs is None else sub_idcs[fcand]).astype(jnp.int32)
                take_new = jnp.logical_or(st.m == 0, corrs[fcand] > jnp.max(corecorrs))
                already = jnp.any(jnp.logical_and(st.idcs == f, st.slot_mask))
                add = jnp.logical_and(take_new, jnp.logical_and(jnp.logical_not(already), st.m < M_max))
                if u is not None:
                    # the m==0 arm of take_new bypasses the -inf mask above: an
                    # all-padding subsample at iteration 0 would install a u==0
                    # row as the first coreset point (and Adam would then grow
                    # its weight). Never add a masked candidate.
                    add = jnp.logical_and(add, jnp.isfinite(corrs[fcand]))

            slot = jnp.minimum(st.m, M_max - 1)
            idcs_new = jnp.where(add, st.idcs.at[slot].set(f), st.idcs)
            pts_new = jnp.where(add, st.pts.at[slot].set(data[f]), st.pts)
            m_new = jnp.where(add, st.m + 1, st.m)
            return st._replace(idcs=idcs_new, pts=pts_new, m=m_new, sampler_aux=aux)

        def _optimize(key, st: CoresetState, ctx) -> CoresetState:
            """Reference bcores.py:126-150 / sparsevi.py:128-136."""
            if not config.learn_beta:
                mdl, smp = _resolve(ctx)
                from_noise = getattr(smp, "from_noise", None)
                draw_noise = getattr(smp, "draw_noise", None)
                if from_noise is not None and draw_noise is not None and n_opt is not None:
                    # Pre-draw the WHOLE refinement loop's posterior noise and
                    # subsample indices in batched kernels, and pre-gather the
                    # subsample rows in one pass, instead of one
                    # randn+randint+gather kernel chain per Adam step — the
                    # build is latency-bound (50k dependent steps in the
                    # headline config), so each removed per-step kernel is
                    # wall-clock. The draws replay nn_adam's exact key stream
                    # (split(key, T) then split(k) -> (k_samp, k_sub)) through
                    # the SAME functions the per-step path uses — the
                    # sampler's own draw_noise and ops.projection's
                    # draw_subsample — so every value is bit-identical by
                    # construction, not by keeping inline copies in sync.
                    # number of Adam steps = len(step_sizes), NOT
                    # config.opt_itrs: a caller-supplied step_sizes of a
                    # different length must keep working (nn_adam runs
                    # len(step_sizes) steps; the pre-drawn xs must match)
                    T = step_sizes.shape[0]
                    aux0 = st.sampler_aux
                    keys = jax.random.split(key, T)
                    pair = jax.vmap(jax.random.split)(keys)        # (T, 2)
                    k_samp, k_sub = pair[:, 0], pair[:, 1]
                    z_all = jax.vmap(
                        lambda k: draw_noise(k, S, st.wts, st.pts, aux0))(k_samp)
                    idx_all, _ = jax.vmap(
                        lambda k: draw_subsample(k, N, n_opt))(k_sub)
                    rows_all = data[idx_all]                       # (T, n_opt, D)
                    scaling = jnp.asarray(N / n_opt, dtype=data.dtype)
                    mask = st.slot_mask[:, None].astype(data.dtype)
                    M_buf = st.pts.shape[0]
                    sum_sub = _sum_rows

                    fit = getattr(smp, "fit", None)
                    from_fit = getattr(smp, "from_fit", None)
                    fit_aux = getattr(smp, "fit_aux", None)
                    lagged = (config.refit_every > 1 and fit is not None
                              and from_fit is not None and fit_aux is not None)

                    if lagged:
                        # lagged posterior refits (config.refit_every): the
                        # Adam carry holds the FIT STATE (mu, chol); the
                        # Newton chain runs only on every k-th step inside a
                        # lax.cond, other steps just transform fresh noise
                        k_refit = config.refit_every

                        def mk_samples(w, lap, z, i):
                            lap = jax.lax.cond(
                                jnp.logical_and(i % k_refit == 0, i > 0),
                                lambda: fit(w, st.pts, fit_aux(lap)),
                                lambda: lap)
                            return from_fit(lap, z), lap

                        carry0 = fit(st.wts, st.pts, aux0)
                        steps = jnp.arange(T)
                        unpack = ((lambda xsl: (xsl[0], xsl[1], xsl[2], None))
                                  if u is None else (lambda xsl: xsl))
                    else:
                        def mk_samples(w, aux, z, i):
                            return from_noise(z, w, st.pts, aux)

                        carry0 = aux0
                        steps = None
                        unpack = ((lambda xsl: (None, xsl[0], xsl[1], None))
                                  if u is None
                                  else (lambda xsl: (None,) + tuple(xsl)))

                    # pre-append the coreset buffer (constant across this
                    # refinement pass) to every step's subsample rows: ONE
                    # batched concat here instead of a concat kernel inside
                    # each of the T dependent steps
                    rows_all = jnp.concatenate(
                        [rows_all,
                         jnp.broadcast_to(st.pts, (T, M_buf) + st.pts.shape[1:])],
                        axis=1)                                    # (T, n_opt+M, D)
                    xs = ((z_all, rows_all) if u is None
                          else (z_all, rows_all, u[idx_all]))      # pre-gathered
                    if steps is not None:
                        xs = (steps,) + xs

                    def grad_fn(w, carry, k, xsl):
                        i, z, rows, usub = unpack(xsl)
                        samples, carry = mk_samples(w, carry, z, i)
                        allvecs = _project(mdl, rows, samples, st.beta)
                        vecs, corevecs = allvecs[:n_opt], allvecs[n_opt:] * mask
                        resid = scaling * sum_sub(vecs, usub) - w @ corevecs
                        return -(corevecs @ resid) / S, carry

                    w_new, carry = nn_adam(st.wts, grad_fn, carry0, key,
                                           step_sizes, xs=xs)
                    aux = fit_aux(carry) if lagged else carry
                    return st._replace(wts=w_new, sampler_aux=aux)

                def grad_fn(w, aux, k):
                    vecs, corevecs, scaling, sub_idcs, _, aux, _ = _tangent(
                        k, w, st, st.beta, n_opt, aux, ctx)
                    resid = scaling * _target_sum(vecs, sub_idcs) - w @ corevecs
                    return -(corevecs @ resid) / S, aux

                w_new, aux = nn_adam(st.wts, grad_fn, st.sampler_aux, key, step_sizes)
                return st._replace(wts=w_new, sampler_aux=aux)

            # learn_beta: joint (w, beta) refinement, all coordinates projected
            # to >= 0 (reference partial_nn_opt over arange, bcores.py:136-139).
            # beta is additionally clamped to (beta_floor, beta_cap]:
            # - floor: the beta-likelihood has a 1/beta pole at 0, and Adam's
            #   sign-normalized steps would otherwise walk beta onto it (the
            #   reference's >= 0 projection alone would NaN the same way);
            # - cap (default 1.0): the raw tangent residual has a DEGENERATE
            #   minimum at beta -> inf (every projection scales like
            #   exp(beta*ll) -> 0, so the residual vanishes identically and
            #   Adam walks beta off to ~30, measured). The density-power
            #   divergence is the KL<->L2 interpolation only on (0, 1]
            #   (Basu et al. 1998), so the clamp is the statistically
            #   meaningful range, not just a numerical guard.
            beta_floor = jnp.asarray(1e-3, dtype=data.dtype)
            beta_cap = jnp.asarray(config.beta_cap, dtype=data.dtype)
            clamp_b = lambda b: jnp.clip(b, beta_floor, beta_cap)

            def grad_fn(x, aux, k):
                w, beta = x[:-1], clamp_b(x[-1])
                vecs, corevecs, scaling, sub_idcs, _, aux, betagrads = _tangent(
                    k, w, st, beta, n_opt, aux, ctx, with_beta_grad=True)
                resid = scaling * _target_sum(vecs, sub_idcs) - w @ corevecs
                wgrad = -(corevecs @ resid) / S
                betagrad = -config.beta_grad_scale * (w @ (betagrads @ resid)) / S
                return jnp.concatenate([wgrad, betagrad[None]]), aux

            x0 = jnp.concatenate([st.wts, st.beta[None]])
            xf, aux = nn_adam(x0, grad_fn, st.sampler_aux, key, step_sizes)
            return st._replace(wts=xf[:-1], beta=clamp_b(xf[-1]), sampler_aux=aux)

        return _select, _optimize

    @jax.jit
    def _build_d(data, u, key, st: CoresetState, itrs, ctx=None) -> CoresetState:
        # itrs is a traced operand (fori_loop -> while_loop): one compiled
        # program serves build(1, m) loops and one-shot build(M, M) alike —
        # each compilation costs tens of seconds at the headline shapes.
        # Per-iteration keys fold the loop counter into ``key``, so REPEATED
        # calls must pass FRESH keys (the eager wrappers do) or the same
        # subsample stream repeats.
        _select, _optimize = _bind(data, u)

        def body(i, st):
            k1, k2 = jax.random.split(jax.random.fold_in(key, i))
            st = _select(k1, st, ctx)
            st = _optimize(k2, st, ctx)
            return st

        return jax.lax.fori_loop(0, itrs, body, st)

    @partial(jax.jit, static_argnums=4)
    def _build_trace_d(data, u, key, st: CoresetState, itrs: int, ctx=None):
        _select, _optimize = _bind(data, u)

        def body(st, i):
            k1, k2 = jax.random.split(jax.random.fold_in(key, i))
            st = _select(k1, st, ctx)
            st = _optimize(k2, st, ctx)
            return st, (st.wts, st.idcs, st.beta)

        st, per_itr = jax.lax.scan(body, st, jnp.arange(itrs))
        return st, per_itr

    @jax.jit
    def _optimize_d(data, u, key, st: CoresetState, ctx=None) -> CoresetState:
        return _bind(data, u)[1](key, st, ctx)

    uw = data_weights if weighted else None
    build = lambda key, st, itrs, ctx=None: _build_d(data, uw, key, st, itrs, ctx)
    build._cache_size = _build_d._cache_size  # test/introspection passthrough
    builder = IncrementalBuilder(
        build,
        lambda key, st, ctx=None: _optimize_d(data, uw, key, st, ctx),
        lambda key, st, itrs, ctx=None: _build_trace_d(data, uw, key, st, int(itrs), ctx),
    )
    # same compiled program, caller-supplied (data, weights): data is a jit
    # ARGUMENT by design, so same-shape chunks reuse the compile — the
    # merge-reduce streaming driver (coresets/streaming.py) runs one leaf
    # build per chunk through this without K recompiles. The shapes MUST
    # match the make-time dataset: N is baked into draw_subsample ranges and
    # sum_scaling, and a shorter array would silently clamp-gather (review
    # finding) — so mismatches raise here instead.
    def _build_with_data(d2, u2, key, st, itrs, ctx=None):
        if d2.shape != data.shape:
            raise ValueError(
                f"build_with_data: data shape {d2.shape} != the compiled "
                f"program's {data.shape} (N and D are baked into the "
                f"subsample ranges and scaling)")
        if u2 is not None and u2.shape != (N,):
            raise ValueError(f"build_with_data: weights must be ({N},), got {u2.shape}")
        return _build_d(d2, u2, key, st, itrs, ctx)

    builder.build_with_data = _build_with_data
    builder.data_weights = uw  # introspection (e.g. utils/export.py defaults)
    builder.error = make_tangent_error(data, model, sampler, config,
                                       contextual=contextual, data_weights=uw)
    return builder


def make_tangent_error(
    data: jnp.ndarray,
    model,
    sampler: Callable,
    config: IncrementalConfig,
    contextual: bool = False,
    data_weights: Optional[jnp.ndarray] = None,
) -> Callable:
    """Tangent-space residual norm ``||scaling * sum_n u_n v_n - w . corevecs|| / S``
    under a fresh posterior draw keyed by ``key`` (u_n = 1 without
    ``data_weights``).

    The reference's incremental coresets hard-code ``error() -> 0``
    (bcores.py:152-153 / sparsevi.py:138-139), which makes the
    ``Coreset.optimize()`` rollback guard (coreset.py:48-65) vacuous — a
    documented deviation (PARITY.md): this is one matvec on quantities the
    build already computes, and with a shared ``key`` the before/after
    comparison in ``optimize()`` evaluates both states under the SAME
    posterior samples and data subsample (an apples-to-apples monotonicity
    check; independent draws would make the guard fire on sampling noise)."""
    N = data.shape[0]
    S = config.projection_dim
    n_opt = None if config.n_subsample_opt is None else min(N, config.n_subsample_opt)
    if data_weights is not None:
        data_weights = jnp.asarray(data_weights, dtype=data.dtype)

    @jax.jit
    def _error_d(data, u, key, st: CoresetState, ctx=None):
        mdl = model(ctx) if contextual else model
        smp = sampler(ctx) if contextual else sampler
        if config.use_beta:
            proj = lambda pts, samples: project_beta(mdl, pts, samples, st.beta)
        else:
            proj = lambda pts, samples: project_ll(mdl, pts, samples)
        k_samp, k_sub = jax.random.split(key)
        samples, _ = smp(k_samp, S, st.wts, st.pts, st.sampler_aux)
        if n_opt is None:
            vecs = proj(data, samples)
            scaling = jnp.asarray(1.0, dtype=data.dtype)
            tsum = vecs.sum(axis=0) if u is None else u @ vecs
        else:
            sub_idcs, scaling = draw_subsample(k_sub, N, n_opt)
            vecs = proj(data[sub_idcs], samples)
            tsum = vecs.sum(axis=0) if u is None else u[sub_idcs] @ vecs
        corevecs = proj(st.pts, samples) * st.slot_mask[:, None].astype(data.dtype)
        resid = scaling * tsum - st.wts @ corevecs
        return jnp.sqrt(jnp.sum(resid * resid)) / S

    return lambda key, st, ctx=None: _error_d(data, data_weights, key, st, ctx)
