"""Group-level data valuation: Monte-Carlo (distributional) Shapley.

Spec: reference examples/zellner_logreg/group_selection.py:145-171
(``update_per_t``/``dshapley``) and examples/zellner_logreg/tmcshapley.py —
the beta-Cores paper's data-valuation baselines. Per Monte-Carlo round, a
random permutation of the groups is scanned; the value (test accuracy of
the posterior fit to the prefix's data points, with per-group size caps)
is evaluated at each prefix; each group accumulates its marginal
contribution, normalized by occurrence counts.

On-device design replacing the reference's Pool(100) of Stan fits:
  * the value function fits a jitted Newton-Laplace posterior on the FULL
    (N, d) data with a {0, 1} membership weight vector — static shapes, so
    every (permutation, prefix) evaluation is the same compiled program;
  * prefix membership is pure arithmetic: point i is in prefix j iff
    pos[gid[i]] <= j where pos is the permutation rank of its group;
  * group-size caps are applied on-device with a top-k trick;
  * permutations run under ``lax.map`` (sequential chunks of a vmap-able
    body, bounding memory), prefixes under ``lax.scan``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..inference.laplace import newton_laplace, sample_laplace
from ..models import logreg
from ..ops.projection import Groups


def capped_member_mask(key: jax.Array, groups: Groups, cap: Optional[int], n_data: int) -> jnp.ndarray:
    """(N,) bool mask keeping at most ``cap`` uniformly-chosen members per
    group (reference group_selection.py:152 ``random.sample(g, groupcap)``)."""
    if cap is None or cap >= groups.max_size:
        return jnp.ones(n_data, dtype=bool)
    G, L = groups.members.shape
    valid = groups.members >= 0
    u = jax.random.uniform(key, (G, L))
    u = jnp.where(valid, u, -jnp.inf)
    kth = jax.lax.top_k(u, cap)[0][:, -1]  # cap-th largest per group
    keep = jnp.logical_and(u >= kth[:, None], valid)
    mask = jnp.zeros(n_data, dtype=bool)
    flat = groups.members.reshape(-1)
    return mask.at[jnp.where(flat >= 0, flat, n_data - 1)].max(keep.reshape(-1))


def logreg_laplace_value_fn(n_samples: int = 256, n_newton: int = 10) -> Callable:
    """Value of a data subset = posterior-predictive test accuracy under the
    Laplace approximation (on-device replacement for the reference's per-subset
    Stan NUTS fit, group_selection.py:166-171).

    Returns ``value(key, w, Z, Xt, Yt)``: the data arrays are call-time
    OPERANDS, passed to ``make_dshapley/make_tmc_shapley`` via
    ``value_args=(Z, Xt, Yt)`` so the jitted permutation runner threads
    them as jit arguments (CLAUDE.md: a closure over the dataset embeds it
    into the HLO as constants — round-3 review)."""

    def value(key, w, Z, Xt, Yt):
        d = Z.shape[1]
        lj = lambda th: logreg.log_joint(Z, th, w)
        g = lambda th: logreg.grad_th_log_joint(Z, th, w)
        h = lambda th: logreg.hess_th_log_joint(Z, th, w)
        lap = newton_laplace(lj, g, h, jnp.zeros(d, dtype=Z.dtype), n_iters=n_newton)
        thetas = sample_laplace(key, lap, n_samples)
        return logreg.compute_accuracy(Xt, Yt, thetas)

    return value


def _make_perm_runner(one_perm: Callable, mesh) -> Callable:
    """jitted ``run(key, T) -> (phis, occs)`` accumulated over T Monte-Carlo
    permutations. Single-device: ``lax.map`` (sequential, memory-bounded —
    the compiled analogue of the reference's worker loop). With a ``mesh``:
    the permutation axis is the reference's Pool(100) axis
    (group_selection.py:158-160, tmcshapley.py:89-93) — shard the T lanes
    over ALL mesh devices and vmap; each device runs its permutations'
    Laplace fits locally, zero collectives until the final sum."""
    if mesh is None:

        @partial(jax.jit, static_argnums=1)
        def run(key, T: int, vargs=()):
            phis, occs = jax.lax.map(lambda k: one_perm(k, vargs),
                                     jax.random.split(key, T))
            return phis.sum(axis=0), occs.sum(axis=0)

        return run

    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..parallel.mesh import DATA_AXIS, SAMP_AXIS, require_axes

    n_data, n_samp = require_axes(mesh)
    n_dev = n_data * n_samp
    lane_sharding = NamedSharding(mesh, P((DATA_AXIS, SAMP_AXIS)))

    @partial(jax.jit, static_argnums=1)
    def _vmapped(keys, T: int, vargs=()):
        phis, occs = jax.vmap(lambda k: one_perm(k, vargs))(keys)
        # padding lanes (index >= T) are dropped from the accumulation
        live = (jnp.arange(keys.shape[0]) < T).astype(phis.dtype)
        return (phis * live[:, None]).sum(axis=0), (occs * live[:, None]).sum(axis=0)

    def run(key, T: int, vargs=()):
        pad = (-T) % n_dev
        keys = jax.device_put(jax.random.split(key, T + pad), lane_sharding)
        return _vmapped(keys, T, vargs)

    return run


def make_dshapley(gid: jnp.ndarray, groups: Groups, value_fn: Callable,
                  max_groups: int, group_cap: Optional[int] = None,
                  prior_value: float = 0.5, mesh=None,
                  value_args: tuple = ()) -> Callable:
    """Returns jitted ``dshapley(key, T) -> phis (G,)``.

    ``prior_value`` is the value of the empty prefix (accuracy 0.5 under the
    prior, reference group_selection.py:148). ``mesh`` shards the T
    Monte-Carlo permutations over all devices (see _make_perm_runner)."""
    G = groups.n_groups
    N = gid.shape[0]
    mg = min(max_groups, G)

    def one_perm(key, vargs=()):
        kp, kc, kv = jax.random.split(key, 3)
        perm = jax.random.permutation(kp, G)
        pos = jnp.zeros(G, dtype=jnp.int32).at[perm].set(jnp.arange(G, dtype=jnp.int32))
        cmask = capped_member_mask(kc, groups, group_cap, N)

        def prefix(carry, j):
            v_prev = carry
            w = jnp.logical_and(jnp.logical_and(pos[gid] <= j, gid < G), cmask)
            v = value_fn(jax.random.fold_in(kv, j), w.astype(jnp.float32), *vargs)
            marg = v - v_prev
            return v, (perm[j], marg)

        _, (gsel, margs) = jax.lax.scan(
            prefix, jnp.asarray(prior_value, dtype=jnp.float32),
            jnp.arange(mg, dtype=jnp.int32))
        phis = jnp.zeros(G, dtype=jnp.float32).at[gsel].add(margs)
        occs = jnp.zeros(G, dtype=jnp.float32).at[gsel].add(1.0)
        return phis, occs

    run = _make_perm_runner(one_perm, mesh)

    vargs = tuple(jnp.asarray(a) for a in value_args)

    def dshapley(key, T: int):
        phis, occs = run(key, T, vargs)
        return jnp.where(occs > 0, phis / occs, 0.0)

    return dshapley


def make_tmc_shapley(gid: jnp.ndarray, groups: Groups, value_fn: Callable,
                     full_value: float, tol: float = 0.01,
                     group_cap: Optional[int] = None,
                     prior_value: float = 0.5, mesh=None,
                     value_args: tuple = ()) -> Callable:
    """Truncated Monte-Carlo Shapley (reference tmcshapley.py:79-106):
    scan the FULL permutation but zero marginals once the prefix value is
    within ``tol`` of the full-data value (truncation), matching the
    Ghorbani & Zou TMC estimator."""
    G = groups.n_groups
    N = gid.shape[0]

    def one_perm(key, vargs=()):
        kp, kc, kv = jax.random.split(key, 3)
        perm = jax.random.permutation(kp, G)
        pos = jnp.zeros(G, dtype=jnp.int32).at[perm].set(jnp.arange(G, dtype=jnp.int32))
        cmask = capped_member_mask(kc, groups, group_cap, N)

        def prefix(carry, j):
            v_prev, truncated = carry
            w = jnp.logical_and(jnp.logical_and(pos[gid] <= j, gid < G), cmask)
            # lax.cond actually SKIPS the fit once truncated (the point of
            # the TMC estimator); a jnp.where would evaluate it anyway
            v = jax.lax.cond(
                truncated,
                lambda _: v_prev,
                lambda w_: value_fn(jax.random.fold_in(kv, j),
                                    w_.astype(jnp.float32), *vargs),
                w,
            )
            marg = jnp.where(truncated, 0.0, v - v_prev)
            truncated = jnp.logical_or(truncated, jnp.abs(full_value - v) < tol)
            return (v, truncated), (perm[j], marg)

        (_, _), (gsel, margs) = jax.lax.scan(
            prefix, (jnp.asarray(prior_value, dtype=jnp.float32), jnp.asarray(False)),
            jnp.arange(G, dtype=jnp.int32))
        phis = jnp.zeros(G, dtype=jnp.float32).at[gsel].add(margs)
        occs = jnp.zeros(G, dtype=jnp.float32).at[gsel].add(1.0)
        return phis, occs

    run = _make_perm_runner(one_perm, mesh)

    vargs = tuple(jnp.asarray(a) for a in value_args)

    def tmc(key, T: int):
        phis, occs = run(key, T, vargs)
        return jnp.where(occs > 0, phis / occs, 0.0)

    return tmc
