"""Group-mode (batch) incremental coreset builds.

Spec: reference coreset/bcores.py:91-123 and coreset/sparsevi.py:97-126
(group branches), used for demographic-group data valuation
(zellner_logreg/group_selection.py) and batch acquisition in the
neural-linear experiment. Selection scores whole groups — a group's tangent
vector is the SUM of its members' projections (bcores.py:50,60) — and
appends every member of the winning group with zero initial weight; weight
refinement then runs at the individual-point level.

Design: group vectors come from one full (N, S) projection followed by a
one-hot matmul over the per-point group-id vector (or segment_sum's
scatter-add — see ONEHOT_MAX_BYTES below), instead of
the reference's Python loop of per-group projections; the refinement
target needs no per-group split at all and reduces in the projection pass. Appending a variable-size group under static shapes scatters a
padded (L_max,) member block with out-of-range drop.

Reference behaviors preserved: the first ``initialized`` warm-start slots
are excluded from the existing-point score comparison (bcores.py:105-109);
with ``n_subsample_opt`` set, refinement subsamples individual POINTS, not
groups (the reference's branch at bcores.py:51 applies because
``select=False``); selected groups are never re-selected.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.projection import Groups, draw_subsample, project_beta, project_ll
from ..utils.opt import nn_adam, step_schedule
from .incremental import IncrementalConfig
from .state import CoresetState


# The (G, S) group reduction has two plain-XLA forms: segment_sum, which
# XLA lowers to a scatter-add, and onehot.T @ vecs, one (G, N) x (N, S)
# dot. The onehot is an (N, G) f32 materialization, so the dot is used only
# while its footprint (N*G*4 bytes) stays under this gate, and the scatter
# takes huge G*N (module-level so tests can patch the gate and pin the two
# paths against each other). Which form is faster on a GPU, and so where
# the gate belongs, is not measured yet (ROADMAP.md).
ONEHOT_MAX_BYTES = 256 * 1024 * 1024


class GroupCoresetState(NamedTuple):
    core: CoresetState
    selected: jnp.ndarray      # (G,) bool: group already in the coreset
    initialized: jnp.ndarray   # scalar int32: warm-start slots locked out of
                               # the corecorr comparison


def group_ids_from_groups(groups: Groups, n_data: int) -> jnp.ndarray:
    """(N,) int32 group id per point; points in no group get id G (an extra
    dropped segment)."""
    members = np.asarray(groups.members)
    G = members.shape[0]
    gid = np.full(n_data, G, dtype=np.int32)
    for g in range(G):
        mem = members[g]
        gid[mem[mem >= 0]] = g
    return jnp.asarray(gid)


def init_group_state(core: CoresetState, n_groups: int,
                     selected=None, initialized: int = 0) -> GroupCoresetState:
    sel = jnp.zeros(n_groups, dtype=bool) if selected is None else jnp.asarray(selected)
    return GroupCoresetState(core=core, selected=sel,
                             initialized=jnp.asarray(initialized, dtype=jnp.int32))


def make_group_incremental_builder(
    data: jnp.ndarray,
    groups: Groups,
    model,
    sampler: Callable,
    config: IncrementalConfig,
    step_sizes: Optional[jnp.ndarray] = None,
    contextual: bool = False,
    data_weights: Optional[jnp.ndarray] = None,
):
    """Returns jitted ``build(key, gstate, itrs[, ctx]) -> gstate``. With
    ``contextual=True``, ``model``/``sampler`` are ctx factories (see
    incremental.IncrementalBuilder).

    ``data_weights`` (optional (N,) array, a jit argument like ``data``)
    makes point n count ``u_n`` times: a group's tangent vector becomes
    ``sum_{n in g} u_n v_n`` (weighted segment_sum), groups whose total mass
    is zero are masked out of the candidate argmax, and u==0 members (non-
    data: merge-reduce padding / dead leaf slots) are DROPPED at append time
    so they can never receive coreset weight. ``None`` keeps the unweighted
    program bit-identical."""
    if getattr(config, "learn_beta", False):
        raise NotImplementedError(
            "group-mode builders do not implement learn_beta (the joint "
            "(w, beta) refinement exists on the point builders only; the "
            "reference's group mode never learns beta either) — silently "
            "keeping beta fixed while the caller asked to learn it would "
            "be a wrong-result trap. Use learn_beta=False (and "
            "coresets/select_beta.py to choose beta robustly).")
    N = data.shape[0]
    weighted = data_weights is not None
    if weighted:
        data_weights = jnp.asarray(data_weights, dtype=data.dtype)
        if data_weights.shape != (N,):
            raise ValueError(f"data_weights must be ({N},), got {data_weights.shape}")
    G = groups.n_groups
    L_max = groups.max_size
    S = config.projection_dim
    # reference draws n_subsample_select group CANDIDATES with replacement
    # (bcores.py:91-98) — deliberately not clamped to G, so a candidate set
    # larger than G covers every group w.h.p.
    n_sel = config.n_subsample_select
    n_opt = None if config.n_subsample_opt is None else min(N, config.n_subsample_opt)
    dtype = data.dtype
    gid = group_ids_from_groups(groups, N)
    group_sizes = groups.sizes
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=dtype)
    step_sizes = jnp.asarray(step_sizes, dtype=dtype)

    def _resolve(ctx):
        if contextual:
            return model(ctx), sampler(ctx)
        return model, sampler

    def _project(mdl, pts, samples, beta):
        if config.use_beta:
            return project_beta(mdl, pts, samples, beta)
        return project_ll(mdl, pts, samples)

    def _bind(data, gid, u):
        # data/gid/u are jit ARGUMENTS of the entry point below — a
        # closed-over dataset embeds into the HLO (see incremental._bind)
        use_onehot = N * G * 4 <= ONEHOT_MAX_BYTES

        def _group_reduce(vecs):
            """(G, S) sum of each group's member rows (pad segment dropped)."""
            if use_onehot:
                onehot = (gid[:, None] == jnp.arange(G, dtype=gid.dtype)[None, :])
                return jax.lax.dot_general(
                    onehot.astype(vecs.dtype), vecs, (((0,), (0,)), ((), ())))
            return jax.ops.segment_sum(vecs, gid, num_segments=G + 1)[:G]

        def _group_vecs(mdl, samples, beta):
            """(G, S) group tangent vectors via one full projection + a
            group reduction (weighted: sum_{n in g} u_n v_n)."""
            vecs = _project(mdl, data, samples, beta)  # (N, S)
            if u is not None:
                vecs = u[:, None] * vecs
            return _group_reduce(vecs)

        # Σ_g (group vector g) = Σ_{n: gid_n < G} u_n v_n: the refinement
        # target never needs the per-group split, so the optimize path does a
        # masked weighted column sum — one fused projection+reduction pass,
        # no (G, S) scatter/matmul at all (same math as
        # _group_vecs(...).sum(0) up to float summation order)
        in_group = (gid < G)

        def _target_total(vecs):
            w_eff = (in_group.astype(vecs.dtype) if u is None
                     else u * in_group.astype(vecs.dtype))
            return w_eff @ vecs

        if u is None:
            eff_sizes, g_mass = group_sizes, None
        else:
            # effective member counts / masses under u (u==0 members are
            # dropped at append time; zero-mass groups are unselectable)
            eff_sizes = jax.ops.segment_sum(
                (u > 0).astype(jnp.int32), gid, num_segments=G + 1)[:G]
            g_mass = jax.ops.segment_sum(u, gid, num_segments=G + 1)[:G]

        def _corevecs(mdl, st: CoresetState, samples, beta):
            return _project(mdl, st.pts, samples, beta) * st.slot_mask[:, None].astype(dtype)

        def _select(key, gst: GroupCoresetState, ctx) -> GroupCoresetState:
            mdl, smp = _resolve(ctx)
            st = gst.core
            k_samp, k_sub = jax.random.split(key)
            samples, aux = smp(k_samp, S, st.wts, st.pts, st.sampler_aux)
            gvecs_all = _group_vecs(mdl, samples, st.beta)
            if n_sel is None:
                gvecs = gvecs_all
                cand_gidx = jnp.arange(G, dtype=jnp.int32)
                scaling = jnp.asarray(1.0, dtype=dtype)
            else:
                cand_gidx = jax.random.randint(k_sub, (n_sel,), 0, G).astype(jnp.int32)
                gvecs = gvecs_all[cand_gidx]
                scaling = jnp.asarray(G / n_sel, dtype=dtype)
            corevecs = _corevecs(mdl, st, samples, st.beta)
            resid = scaling * gvecs.sum(axis=0) - st.wts @ corevecs

            vn = jnp.sqrt(jnp.sum(gvecs * gvecs, axis=1))
            vn = jnp.where(vn > 0, vn, jnp.inf)
            corrs = (gvecs @ resid) / vn / S
            if not config.dedup_select:
                # corecorrs exist only for the parity take_new comparison;
                # dedup mode never compares against selected groups
                cn = jnp.sqrt(jnp.sum(corevecs * corevecs, axis=1))
                cn = jnp.where(cn > 0, cn, jnp.inf)
                slot_ids = jnp.arange(st.wts.shape[0])
                compare_mask = jnp.logical_and(st.slot_mask, slot_ids >= gst.initialized)
                corecorrs = jnp.where(compare_mask,
                                      jnp.abs(corevecs @ resid) / cn / S, -jnp.inf)

            # groups too large for the remaining static capacity are masked
            # OUT of the argmax (not merely rejected after winning): a
            # rejected winner would win every subsequent iteration and
            # permanently block smaller groups that fit — a stall the
            # reference, which grows arrays unboundedly, cannot hit.
            # Already-selected groups keep the reference's semantics
            # (winning is a no-op iteration, bcores.py:91-98).
            M_max = st.wts.shape[0]
            fits = eff_sizes[cand_gidx] + st.m <= M_max
            corrs = jnp.where(fits, corrs, -jnp.inf)
            if g_mass is not None:
                # zero-mass groups contribute nothing to the target: never
                # selectable (incremental.py weighted select)
                corrs = jnp.where(g_mass[cand_gidx] > 0, corrs, -jnp.inf)
            if config.dedup_select:
                # dedup mode (round 5, mirrors incremental.py): mask
                # already-selected groups out of the candidate argmax and
                # always install the best remaining fitting group — a
                # selected group winning is never a skipped iteration
                corrs = jnp.where(gst.selected[cand_gidx], -jnp.inf, corrs)
            best = jnp.argmax(corrs)
            f = cand_gidx[best]
            size_f = eff_sizes[f]
            room = st.m + size_f <= M_max
            if config.dedup_select:
                add = jnp.logical_and(room, jnp.isfinite(corrs[best]))
            else:
                take_new = jnp.logical_or(st.m == 0, corrs[best] > jnp.max(corecorrs))
                fresh = jnp.logical_not(gst.selected[f])
                add = jnp.logical_and(take_new, jnp.logical_and(fresh, room))
                if g_mass is not None:
                    # the m==0 arm of take_new bypasses the -inf masks above
                    add = jnp.logical_and(add, jnp.isfinite(corrs[best]))

            members = groups.members[f]                      # (L_max,) padded -1
            if u is not None:
                # stable-partition u>0 members to the front; u==0 members
                # (non-data) are dropped — they never enter the coreset
                keep = jnp.logical_and(members >= 0,
                                       u[jnp.maximum(members, 0)] > 0)
                order = jnp.argsort(jnp.logical_not(keep), stable=True)
                members = jnp.where(keep, members, -1)[order]
            j = jnp.arange(L_max)
            pos = st.m + j
            valid = jnp.logical_and(jnp.logical_and(j < size_f, add), pos < M_max)
            pos_safe = jnp.where(valid, pos, M_max)          # out-of-range -> dropped
            mem_safe = jnp.maximum(members, 0)
            idcs_new = st.idcs.at[pos_safe].set(members, mode="drop")
            pts_new = st.pts.at[pos_safe].set(data[mem_safe], mode="drop")
            wts_new = st.wts.at[pos_safe].set(jnp.zeros(L_max, dtype=dtype), mode="drop")
            m_new = jnp.where(add, st.m + size_f, st.m)
            st = st._replace(wts=wts_new, idcs=idcs_new, pts=pts_new, m=m_new, sampler_aux=aux)
            return GroupCoresetState(core=st, selected=gst.selected.at[f].set(
                jnp.logical_or(gst.selected[f], add)), initialized=gst.initialized)

        def _optimize(key, gst: GroupCoresetState, ctx) -> GroupCoresetState:
            mdl, smp = _resolve(ctx)
            st = gst.core

            def _grad_from_samples(w, samples, k_sub):
                if n_opt is None:
                    vecs_all = _project(mdl, data, samples, st.beta)
                    vec_total = _target_total(vecs_all)
                    scaling = jnp.asarray(1.0, dtype=dtype)
                else:
                    sub_idcs, scaling = draw_subsample(k_sub, N, n_opt)
                    vecs_o = _project(mdl, data[sub_idcs], samples, st.beta)
                    vec_total = (vecs_o.sum(axis=0) if u is None
                                 else u[sub_idcs] @ vecs_o)
                corevecs = _corevecs(mdl, st, samples, st.beta)
                resid = scaling * vec_total - w @ corevecs
                return -(corevecs @ resid) / S

            fit = getattr(smp, "fit", None)
            from_fit = getattr(smp, "from_fit", None)
            fit_aux = getattr(smp, "fit_aux", None)
            draw_noise = getattr(smp, "draw_noise", None)
            if (config.refit_every > 1 and fit is not None and from_fit is not None
                    and fit_aux is not None and draw_noise is not None):
                # lagged posterior refits (config.refit_every, same contract
                # as coresets/incremental.py and parallel/sharded.py)
                k_refit = config.refit_every

                def grad_fn(w, lap, k, i):
                    k_samp, k_sub = jax.random.split(k)
                    lap = jax.lax.cond(
                        jnp.logical_and(i % k_refit == 0, i > 0),
                        lambda: fit(w, st.pts, fit_aux(lap)),
                        lambda: lap)
                    samples = from_fit(lap, draw_noise(k_samp, S, w, st.pts,
                                                       fit_aux(lap)))
                    return _grad_from_samples(w, samples, k_sub), lap

                lap0 = fit(st.wts, st.pts, st.sampler_aux)
                w_new, lap = nn_adam(st.wts, grad_fn, lap0, key, step_sizes,
                                     xs=jnp.arange(step_sizes.shape[0]))
                return gst._replace(core=st._replace(wts=w_new,
                                                     sampler_aux=fit_aux(lap)))

            def grad_fn(w, aux, k):
                k_samp, k_sub = jax.random.split(k)
                samples, aux = smp(k_samp, S, w, st.pts, aux)
                return _grad_from_samples(w, samples, k_sub), aux

            w_new, aux = nn_adam(st.wts, grad_fn, st.sampler_aux, key, step_sizes)
            return gst._replace(core=st._replace(wts=w_new, sampler_aux=aux))

        return _select, _optimize

    @jax.jit
    def _build_d(data, gid, u, key, gst: GroupCoresetState, itrs, ctx=None) -> GroupCoresetState:
        # dynamic itrs: one compiled program for all build sizes
        _select, _optimize = _bind(data, gid, u)

        def body(i, gst):
            k1, k2 = jax.random.split(jax.random.fold_in(key, i))
            gst = _select(k1, gst, ctx)
            gst = _optimize(k2, gst, ctx)
            return gst

        return jax.lax.fori_loop(0, itrs, body, gst)

    @partial(jax.jit, static_argnums=5)
    def _build_trace_d(data, gid, u, key, gst: GroupCoresetState, itrs: int, ctx=None):
        # itrs iterations as ONE device program, recording per-iteration
        # compact state AND the selected-group mask — the group-selection
        # driver recovers the full selection ORDER from one device call
        # instead of a `build(1); selected_groups` host loop per iteration
        _select, _optimize = _bind(data, gid, u)

        def body(gst, i):
            k1, k2 = jax.random.split(jax.random.fold_in(key, i))
            gst = _select(k1, gst, ctx)
            gst = _optimize(k2, gst, ctx)
            st = gst.core
            return gst, (st.wts, st.idcs, st.beta, gst.selected)

        gst, per_itr = jax.lax.scan(body, gst, jnp.arange(itrs))
        return gst, per_itr

    uw = data_weights if weighted else None
    build = lambda key, gst, itrs, ctx=None: _build_d(data, gid, uw, key, gst, itrs, ctx)
    build.build_trace = (
        lambda key, gst, itrs, ctx=None: _build_trace_d(data, gid, uw, key, gst,
                                                        int(itrs), ctx))
    return build
