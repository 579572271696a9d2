"""Sharded multi-chip GROUP-mode coreset builds.

Multi-chip version of ``coresets/groups.py`` (reference bcores.py:91-123 /
sparsevi.py:97-126 group branches — demographic-group data valuation and
batch acquisition). The dataset's N axis is sharded over the mesh's ``data``
axis and the posterior-sample S axis over ``samp``; the group axis G is
small and REPLICATED. Per build iteration:

  * every device projects its own N/P rows and group-reduces them locally
    (one-hot MXU matmul below the HBM gate, scatter fallback above — see
    coresets/groups.py); one psum('data') of the (G, S_loc) partial sums
    yields the replicated group tangent vectors — the single heavy step,
    and it is embarrassingly row-parallel;
  * candidate drawing, scoring, and the group argmax run REPLICATED (G is
    tiny) — unlike point mode there is no distributed argmax;
  * the winning group's member points are gathered from their owning shards
    with one psum('data') of an (L_max, d) block (each member row lives on
    exactly one shard);
  * weight refinement is the replicated projected Adam, with the
    Sigma-over-N term either a stratified per-shard subsample (n_subsample_opt
    set, like the sharded point builder) or the full psum'd group sums.

Same-key single-device equivalence: with ``n_subsample_select=None`` and
``n_subsample_opt=None`` the sharded program computes the same quantities as
``make_group_incremental_builder`` up to float summation order (tested);
with subsampling the candidate stream is identical (replicated draw) but the
optimize subsample is stratified per shard, so equivalence is statistical.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..coresets.groups import GroupCoresetState
from ..coresets.incremental import IncrementalConfig
from ..coresets.state import CoresetState
from ..ops.projection import Groups
from ..utils.opt import nn_adam, step_schedule
from .mesh import DATA_AXIS, SAMP_AXIS, require_axes


def shard_group_ids(gid: jnp.ndarray, mesh, n_groups: int):
    """Place an (N,) per-point group-id vector sharded over the data axis,
    padded (like ``shard_data``) with id ``n_groups`` — the dropped segment,
    so padding rows join no group."""
    n_data = mesh.shape[DATA_AXIS]
    pad = (-gid.shape[0]) % n_data
    if pad:
        gid = jnp.concatenate([gid, jnp.full((pad,), n_groups, dtype=jnp.int32)])
    return jax.device_put(gid, NamedSharding(mesh, P(DATA_AXIS)))


def make_sharded_group_builder(
    data_sharded: jnp.ndarray,
    gid_sharded: jnp.ndarray,
    n_true: int,
    groups: Groups,
    model,
    sampler: Callable,
    config: IncrementalConfig,
    mesh,
    step_sizes: Optional[jnp.ndarray] = None,
    data_weights: Optional[jnp.ndarray] = None,
) -> Callable:
    """Returns jitted ``build(key, gstate, itrs) -> gstate`` with
    ``data_sharded``/``gid_sharded`` row-sharded over the data axis
    (``shard_data`` / ``shard_group_ids``; ``n_true`` unpadded rows) and the
    (core, selected, initialized) group state replicated.

    ``data_weights`` (optional, the output of ``shard_weights`` — sharded
    like the rows, zero-padded) gives point n mass ``u_n``: group tangent
    vectors become ``sum_{n in g} u_n v_n``, zero-mass groups are
    unselectable, and u==0 members are dropped at append time — the same
    semantics as the single-device weighted group builder
    (coresets/groups.py). ``None`` keeps the unweighted program
    bit-identical."""
    if getattr(config, "learn_beta", False):
        raise NotImplementedError(
            "group-mode builders do not implement learn_beta (the joint "
            "(w, beta) refinement exists on the point builders only; the "
            "reference's group mode never learns beta either) — silently "
            "keeping beta fixed while the caller asked to learn it would "
            "be a wrong-result trap. Use learn_beta=False (and "
            "coresets/select_beta.py to choose beta robustly).")
    n_data, n_samp = require_axes(mesh)
    weighted = data_weights is not None
    if weighted:
        if data_weights.shape != (data_sharded.shape[0],):
            raise ValueError(
                f"data_weights must be ({data_sharded.shape[0]},) (padded like "
                f"the sharded rows — use shard_weights), got {data_weights.shape}")
        data_weights = jnp.asarray(data_weights, dtype=data_sharded.dtype)
    S = config.projection_dim
    if S % n_samp:
        raise ValueError(f"projection_dim {S} must divide over samp axis {n_samp}")
    S_loc = S // n_samp
    G = groups.n_groups
    L_max = groups.max_size
    n_sel = config.n_subsample_select  # group CANDIDATES, with replacement
    n_opt = config.n_subsample_opt
    n_opt_loc = None if n_opt is None else max(1, n_opt // n_data)
    dtype = data_sharded.dtype
    group_sizes = groups.sizes
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=dtype)
    step_sizes = jnp.asarray(step_sizes, dtype=dtype)

    def _center_S(lls):
        mean = jax.lax.psum(lls.sum(axis=1), SAMP_AXIS) / S
        return lls - mean[:, None]

    def _proj(pts, samples_loc, beta):
        if config.use_beta:
            return _center_S(model.beta_likelihood(pts, samples_loc, beta))
        return _center_S(model.log_likelihood(pts, samples_loc))

    def _dot_S(a, b):
        return jax.lax.psum(a @ b, SAMP_AXIS)

    # (G, S_loc) group reduction as a local one-hot matmul or the
    # scatter-add XLA emits for segment_sum, gated on the local onehot's
    # footprint exactly like the single-device builder (shared gate
    # constant there)
    def _group_vecs(data_local, gid_local, u_local, samples_loc, beta):
        """Replicated (G, S_loc) group tangent vectors: local projection +
        local group reduction, one psum('data'). Padding rows carry id G.
        Weighted: sum_{n in g} u_n v_n."""
        vecs = _proj(data_local, samples_loc, beta)            # (rows_loc, S_loc)
        if u_local is not None:
            vecs = u_local[:, None] * vecs
        from ..coresets.groups import ONEHOT_MAX_BYTES
        if data_local.shape[0] * G * 4 <= ONEHOT_MAX_BYTES:
            onehot = (gid_local[:, None] == jnp.arange(G, dtype=gid_local.dtype))
            part = jax.lax.dot_general(
                onehot.astype(vecs.dtype), vecs, (((0,), (0,)), ((), ())))
        else:
            part = jax.ops.segment_sum(vecs, gid_local, num_segments=G + 1)[:G]
        return jax.lax.psum(part, DATA_AXIS)

    def _group_stats(gid_local, u_local):
        """(eff_sizes, g_mass) under u — replicated, constant per build.
        Unweighted: (static group_sizes, None)."""
        if u_local is None:
            return group_sizes, None
        eff = jax.lax.psum(jax.ops.segment_sum(
            (u_local > 0).astype(jnp.int32), gid_local, num_segments=G + 1)[:G],
            DATA_AXIS)
        mass = jax.lax.psum(jax.ops.segment_sum(
            u_local, gid_local, num_segments=G + 1)[:G], DATA_AXIS)
        return eff, mass

    def _gather_members(data_local, members, ax_d):
        """(L_max, d) points of a padded member-index block, each row owned
        by exactly one shard -> psum('data') assembles the replicated block."""
        rows_loc = data_local.shape[0]
        rel = members - ax_d * rows_loc
        owner = jnp.logical_and(members >= 0,
                                jnp.logical_and(rel >= 0, rel < rows_loc))
        local = jnp.where(owner[:, None],
                          data_local[jnp.clip(rel, 0, rows_loc - 1)], 0.0)
        return jax.lax.psum(local, DATA_AXIS)

    def _gather_member_u(u_local, members, ax_d):
        """(L_max,) base weights of a padded member block (same owner-shard
        assembly as the points)."""
        rows_loc = u_local.shape[0]
        rel = members - ax_d * rows_loc
        owner = jnp.logical_and(members >= 0,
                                jnp.logical_and(rel >= 0, rel < rows_loc))
        local = jnp.where(owner, u_local[jnp.clip(rel, 0, rows_loc - 1)], 0.0)
        return jax.lax.psum(local, DATA_AXIS)

    def _step(data_local, gid_local, u_local, members, key,
              gst: GroupCoresetState, eff_sizes, g_mass) -> GroupCoresetState:
        ax_d = jax.lax.axis_index(DATA_AXIS)
        ax_s = jax.lax.axis_index(SAMP_AXIS)
        rows_loc = data_local.shape[0]
        local_valid = jnp.clip(n_true - ax_d * rows_loc, 0, rows_loc)
        k_sel, k_opt = jax.random.split(key)
        st = gst.core

        # ---- select (replicated group argmax) ----
        k_samp, k_sub = jax.random.split(k_sel)
        samples, aux = sampler(k_samp, S, st.wts, st.pts, st.sampler_aux)
        samples_loc = jax.lax.dynamic_slice_in_dim(samples, ax_s * S_loc, S_loc, axis=0)
        gvecs_all = _group_vecs(data_local, gid_local, u_local, samples_loc, st.beta)
        if n_sel is None:
            gvecs = gvecs_all
            cand_gidx = jnp.arange(G, dtype=jnp.int32)
            scaling = jnp.asarray(1.0, dtype=dtype)
        else:
            # replicated draw (same key on every device), reference
            # bcores.py:91-98: candidates with replacement, not clamped to G
            cand_gidx = jax.random.randint(k_sub, (n_sel,), 0, G).astype(jnp.int32)
            gvecs = gvecs_all[cand_gidx]
            scaling = jnp.asarray(G / n_sel, dtype=dtype)
        mask = st.slot_mask[:, None].astype(dtype)
        corevecs = _proj(st.pts, samples_loc, st.beta) * mask
        resid = scaling * gvecs.sum(axis=0) - st.wts @ corevecs   # (S_loc,)

        vn = jnp.sqrt(jax.lax.psum(jnp.sum(gvecs * gvecs, axis=1), SAMP_AXIS))
        vn = jnp.where(vn > 0, vn, jnp.inf)
        corrs = _dot_S(gvecs, resid) / vn / S
        if not config.dedup_select:
            # corecorrs (and their SAMP_AXIS psum) exist only for the
            # parity take_new comparison — never traced in dedup mode
            # (matches incremental.py / sharded.py branch placement)
            cn = jnp.sqrt(jax.lax.psum(jnp.sum(corevecs * corevecs, axis=1), SAMP_AXIS))
            cn = jnp.where(cn > 0, cn, jnp.inf)
            slot_ids = jnp.arange(st.wts.shape[0])
            compare_mask = jnp.logical_and(st.slot_mask, slot_ids >= gst.initialized)
            corecorrs = jnp.where(compare_mask,
                                  jnp.abs(_dot_S(corevecs, resid)) / cn / S, -jnp.inf)

        # capacity-aware masking (see coresets/groups.py: a rejected
        # too-large winner would stall every later iteration)
        M_max = st.wts.shape[0]
        fits = eff_sizes[cand_gidx] + st.m <= M_max
        corrs = jnp.where(fits, corrs, -jnp.inf)
        if g_mass is not None:
            # zero-mass groups contribute nothing to the target: never
            # selectable (coresets/groups.py weighted select)
            corrs = jnp.where(g_mass[cand_gidx] > 0, corrs, -jnp.inf)
        if config.dedup_select:
            # dedup mode (round 5, mirrors coresets/groups.py): selected
            # groups are masked out of the argmax (replicated state ->
            # local test) and the best remaining fitting group always adds
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

        mem_f = members[f]                                   # (L_max,) padded -1
        pts_f = _gather_members(data_local, mem_f, ax_d)     # (L_max, d)
        if u_local is not None:
            # stable-partition u>0 members (and their gathered points) to
            # the front; u==0 members never enter the coreset
            u_f = _gather_member_u(u_local, mem_f, ax_d)
            keep = jnp.logical_and(mem_f >= 0, u_f > 0)
            order = jnp.argsort(jnp.logical_not(keep), stable=True)
            mem_f = jnp.where(keep, mem_f, -1)[order]
            pts_f = jnp.where(keep[:, None], pts_f, 0.0)[order]
        j = jnp.arange(L_max)
        pos = st.m + j
        valid = jnp.logical_and(jnp.logical_and(j < size_f, add), pos < M_max)
        pos_safe = jnp.where(valid, pos, M_max)              # out-of-range -> dropped
        idcs_new = st.idcs.at[pos_safe].set(mem_f, mode="drop")
        pts_new = st.pts.at[pos_safe].set(pts_f, mode="drop")
        wts_new = st.wts.at[pos_safe].set(jnp.zeros(L_max, dtype=dtype), mode="drop")
        m_new = jnp.where(add, st.m + size_f, st.m)
        st = st._replace(wts=wts_new, idcs=idcs_new, pts=pts_new, m=m_new,
                         sampler_aux=aux)
        gst = GroupCoresetState(
            core=st,
            selected=gst.selected.at[f].set(jnp.logical_or(gst.selected[f], add)),
            initialized=gst.initialized)

        # ---- optimize (replicated Adam over point-level weights) ----
        def grad_fn(w, aux, k):
            k_samp, k_sub = jax.random.split(k)
            samples, aux = sampler(k_samp, S, w, st.pts, aux)
            samples_loc = jax.lax.dynamic_slice_in_dim(samples, ax_s * S_loc, S_loc, axis=0)
            if n_opt_loc is None:
                # Σ_g (group vector g) = Σ_{n: gid_n < G} u_n v_n — the
                # refinement target needs no per-group split, so this is a
                # masked weighted column sum fused into the projection pass
                # (no (G, S) reduction at all; same restructure as
                # coresets/groups.py _target_total)
                vecs_all = _proj(data_local, samples_loc, st.beta)
                w_eff = (gid_local < G).astype(dtype)
                if u_local is not None:
                    w_eff = u_local * w_eff
                vec_total = jax.lax.psum(w_eff @ vecs_all, DATA_AXIS)
            else:
                # stratified per-shard POINT subsample (reference subsamples
                # individual points in optimize, bcores.py:51) with the
                # unbiased per-shard rescale of the sharded point builder
                sub = jax.random.randint(jax.random.fold_in(k_sub, ax_d),
                                         (n_opt_loc,), 0, jnp.maximum(local_valid, 1))
                vecs_o = _proj(data_local[sub], samples_loc, st.beta)
                vecs_o = vecs_o * (local_valid > 0).astype(dtype)
                rowsum = (vecs_o.sum(axis=0) if u_local is None
                          else u_local[sub] @ vecs_o)
                shard_scale = local_valid.astype(dtype) / n_opt_loc
                vec_total = jax.lax.psum(shard_scale * rowsum, DATA_AXIS)
            corevecs = _proj(st.pts, samples_loc, st.beta) \
                * st.slot_mask[:, None].astype(dtype)
            resid = vec_total - w @ corevecs
            return -_dot_S(corevecs, resid) / S, aux

        w_new, aux = nn_adam(st.wts, grad_fn, st.sampler_aux, k_opt, step_sizes)
        return gst._replace(core=st._replace(wts=w_new, sampler_aux=aux))

    def _build_local(data_local, gid_local, u_local, members, key, itrs, gst):
        eff_sizes, g_mass = _group_stats(gid_local, u_local)  # constant per build

        def body(i, gst):
            return _step(data_local, gid_local, u_local, members,
                         jax.random.fold_in(key, i), gst, eff_sizes, g_mass)

        return jax.lax.fori_loop(0, itrs, body, gst)

    def _trace_local(data_local, gid_local, u_local, members, key, itrs, gst):
        eff_sizes, g_mass = _group_stats(gid_local, u_local)

        def body(gst, i):
            gst = _step(data_local, gid_local, u_local, members,
                        jax.random.fold_in(key, i), gst, eff_sizes, g_mass)
            return gst, (gst.core.wts, gst.core.idcs, gst.selected)

        return jax.lax.scan(body, gst, jnp.arange(itrs))

    core_spec = CoresetState(wts=P(), idcs=P(), pts=P(), m=P(), beta=P(), sampler_aux=P())
    gstate_spec = GroupCoresetState(core=core_spec, selected=P(), initialized=P())

    if weighted:
        @jax.jit
        def _build_w(data, gid, u, members, key, gst: GroupCoresetState, itrs):
            return jax.shard_map(
                _build_local,
                mesh=mesh,
                in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS),
                          P(), P(), P(), gstate_spec),
                out_specs=gstate_spec,
                check_vma=False,
            )(data, gid, u, members, key, itrs, gst)

        @partial(jax.jit, static_argnums=6)
        def _trace_w(data, gid, u, members, key, gst: GroupCoresetState, itrs: int):
            return jax.shard_map(
                lambda d, g, uu, m, k, s: _trace_local(d, g, uu, m, k, itrs, s),
                mesh=mesh,
                in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS),
                          P(), P(), gstate_spec),
                out_specs=(gstate_spec, (P(), P(), P())),
                check_vma=False,
            )(data, gid, u, members, key, gst)

        build = lambda key, gst, itrs: _build_w(
            data_sharded, gid_sharded, data_weights, groups.members, key, gst,
            jnp.asarray(itrs, dtype=jnp.int32))
        build.trace = lambda key, gst, itrs: _trace_w(
            data_sharded, gid_sharded, data_weights, groups.members, key, gst,
            int(itrs))
        return build

    @jax.jit
    def _build_d(data, gid, members, key, gst: GroupCoresetState, itrs):
        # data/gid/members are jit ARGUMENTS (a closed-over dataset embeds
        # into the HLO, coresets/incremental.py _bind); itrs is traced so one
        # program serves every build size
        return jax.shard_map(
            lambda d, g, m, k, i, s: _build_local(d, g, None, m, k, i, s),
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(), P(), P(), gstate_spec),
            out_specs=gstate_spec,
            check_vma=False,
        )(data, gid, members, key, itrs, gst)

    @partial(jax.jit, static_argnums=5)
    def _trace_d(data, gid, members, key, gst: GroupCoresetState, itrs: int):
        # static itrs (output shape); per-iteration records are replicated
        return jax.shard_map(
            lambda d, g, m, k, s: _trace_local(d, g, None, m, k, itrs, s),
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(), P(), gstate_spec),
            out_specs=(gstate_spec, (P(), P(), P())),
            check_vma=False,
        )(data, gid, members, key, gst)

    build = lambda key, gst, itrs: _build_d(
        data_sharded, gid_sharded, groups.members, key, gst,
        jnp.asarray(itrs, dtype=jnp.int32))
    # per-iteration (wts, idcs, selected) trace, same key stream as build
    build.trace = lambda key, gst, itrs: _trace_d(
        data_sharded, gid_sharded, groups.members, key, gst, int(itrs))
    return build
