"""Batch pseudo-coreset (PSVI) builder.

Spec: reference coreset/bpsvi.py:6-65. One-shot: initialize the pseudo-points
as a uniform without-replacement subsample with weights N/sz, then jointly
optimize weights AND point locations with projected Adam (weights clipped to
>= 0, locations free). Point gradients come from the model's
grad-wrt-datapoint; both scalar and gradient projections are centered over
the *sample* axis (the reference centers gradients over the coordinate axis,
projector.py:30-31 — a bias bug not reproduced; see ops/projection.py).

The reference parallelizes builds across coreset sizes with a 100-process
multiprocessing.Pool (zellner_logreg/main.py:177-179). Here a single build
is one compiled scan, and :func:`bpsvi_build_batch` pads sizes to the max
and ``vmap``s the whole optimization across them — the accelerator
replacement (SURVEY.md section 7 delta 6): padded slots get zero weight and zero
gradient, so each lane reproduces its standalone build.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.projection import draw_subsample, project_ll, project_ll_with_grad
from ..utils.opt import nn_adam, step_schedule


@dataclasses.dataclass(frozen=True)
class BPSVIConfig:
    projection_dim: int = 100
    n_subsample_opt: Optional[int] = None
    opt_itrs: int = 100
    i0: float = 0.1


def make_bpsvi_builder(data: jnp.ndarray, model, sampler: Callable, config: BPSVIConfig,
                       step_sizes=None, data_weights=None) -> Callable:
    """Returns jitted ``build(key, sz, aux0, size_mask=None) -> (wts, pts, idcs)``
    with ``sz`` static. ``size_mask`` (bool (sz,)) deactivates padding slots
    when called through the vmapped batch builder. ``step_sizes`` overrides
    the default i0/(1+i) schedule.

    ``data_weights`` (optional (N,), a jit argument like ``data``): row n
    counts u_n times in the residual target (same contract as the
    incremental/Hilbert builders — streaming merge-reduce leaf unions, row
    multiplicity); pseudo-point init draws proportionally to u (u==0 rows
    are never drawn) with total initial mass sum(u)."""
    N, D = data.shape
    S = config.projection_dim
    n_opt = None if config.n_subsample_opt is None else min(N, config.n_subsample_opt)
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data.dtype)
    step_sizes = jnp.asarray(step_sizes, dtype=data.dtype)
    uw = None if data_weights is None else jnp.asarray(data_weights, dtype=data.dtype)

    def _build(data, u, key, sz: int, aux0, size_mask=None):
        # data (and the optional base weights u) are jit ARGUMENTS:
        # closed-over datasets embed into the HLO (see incremental.py _bind)
        active = jnp.ones(sz, dtype=bool) if size_mask is None else size_mask
        n_active = jnp.sum(active).astype(data.dtype)
        k_init, k_opt = jax.random.split(key)
        if u is None:
            init_idcs = jax.random.choice(k_init, N, (sz,), replace=False)
            total = jnp.asarray(float(N), dtype=data.dtype)
        else:
            init_idcs = jax.random.choice(k_init, N, (sz,), replace=False,
                                          p=u / u.sum())
            total = u.sum()
        pts0 = data[init_idcs] * active[:, None].astype(data.dtype)
        w0 = jnp.where(active, total / n_active, 0.0).astype(data.dtype)

        def grad_fn(x, aux, k):
            w = x[:sz] * active
            p = x[sz:].reshape(sz, D)
            k_samp, k_sub = jax.random.split(k)
            samples, aux = sampler(k_samp, S, w, p, aux)
            if n_opt is None:
                vecs = project_ll(model, data, samples)
                scaling = jnp.asarray(1.0, dtype=data.dtype)
                tsum = vecs.sum(axis=0) if u is None else u @ vecs
            else:
                sub_idcs, scaling = draw_subsample(k_sub, N, n_opt)
                vecs = project_ll(model, data[sub_idcs], samples)
                tsum = vecs.sum(axis=0) if u is None else u[sub_idcs] @ vecs
            corevecs, pgrads = project_ll_with_grad(model, p, samples)
            corevecs = corevecs * active[:, None].astype(data.dtype)
            resid = scaling * tsum - w @ corevecs
            wgrad = -(corevecs @ resid) / S
            ugrad = -jnp.einsum("i,isd,s->id", w, pgrads, resid) / S
            act = active.astype(data.dtype)
            return jnp.concatenate([wgrad * act, (ugrad * act[:, None]).reshape(-1)]), aux

        nn_mask = jnp.concatenate([jnp.ones(sz, dtype=bool), jnp.zeros(sz * D, dtype=bool)])
        x0 = jnp.concatenate([w0, pts0.reshape(-1)])
        xf, _ = nn_adam(x0, grad_fn, aux0, k_opt, step_sizes, nn_mask=nn_mask)
        wts = xf[:sz] * active
        pts = xf[sz:].reshape(sz, D)
        return wts, pts, init_idcs

    _jit = jax.jit(_build, static_argnums=3)
    n_pos = None if uw is None else int(np.sum(np.asarray(uw) > 0))

    def build(key, sz, aux0, size_mask=None):
        if n_pos is not None and sz > n_pos:
            # jax.random.choice(replace=False, p=u) silently returns
            # zero-probability indices once positives are exhausted — the
            # init would seed pseudo-points from non-data rows
            raise ValueError(
                f"BPSVI init: sz={sz} exceeds the {n_pos} rows with positive "
                f"data_weights — shrink sz or drop dead rows")
        return _jit(data, uw, key, sz, aux0, size_mask)

    return build


def bpsvi_build_batch(builder: Callable, key: jax.Array, sizes, max_size: int, aux0) -> Tuple:
    """Build coresets for every size in ``sizes`` concurrently: pad each lane
    to ``max_size`` slots, mask the inactive tail, and vmap the full
    optimization. Replaces reference zellner_gaussian/main.py:130-138's
    process pool."""
    sizes = jnp.asarray(sizes, dtype=jnp.int32)
    keys = jax.random.split(key, sizes.shape[0])
    masks = jnp.arange(max_size)[None, :] < sizes[:, None]

    def one(k, mask):
        return builder(k, max_size, aux0, mask)

    return jax.vmap(one)(keys, masks)
