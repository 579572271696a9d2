"""Deterministic post-build weight refinement (quasi-Newton polish).

Beyond-reference feature, after Naik et al., "Fast Bayesian Coresets via
Subsampling and Quasi-Newton Refinement" (arXiv:2203.09675, PAPERS.md): the
incremental builders refine weights by Monte-Carlo Adam with FRESH posterior
samples per step (matching the reference's nn_opt loop), whose final iterate
carries O(1/sqrt(S)) sampling noise. This module adds a final polish: freeze
ONE large sample draw S_big from the current coreset posterior, build the
deterministic tangent-space least squares

    min_{w >= 0, supp(w) ⊆ selected}  || V_core^T w - v_total ||^2

(V_core the (M, S_big) coreset projections, v_total the Sigma-over-N data
projection, optionally subsampled with the usual N/n rescale), and solve it
with the second-order FISTA NNLS used by the snnls family. One call costs
about as much as ~2 Adam steps at S_big.

WHEN TO USE: clean-data KL builds (SparseVI / Hilbert settings), where the
tangent residual is the right surrogate and the polish tightens posterior
KL at fixed support. Do NOT apply it to beta-divergence builds on
contaminated data: there, matching the corrupted full-data projection sum
EXACTLY pulls the posterior toward the contamination (measured on the
zellner_gaussian config: rKL vs the clean posterior 256 -> 485), while the
Monte-Carlo Adam refinement's fresh-sample noise acts as the regularizer
the robustness relies on.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.projection import draw_subsample, project_beta, project_ll
from ..snnls.nnls import nnls_on_support
from .state import CoresetState


def refine_weights(
    key: jax.Array,
    data: jnp.ndarray,
    model,
    sampler: Callable,
    state: CoresetState,
    n_samples: int = 500,
    n_subsample: Optional[int] = None,
    use_beta: bool = False,
    nnls_iters: int = 600,
    data_weights: Optional[jnp.ndarray] = None,
) -> CoresetState:
    """Return ``state`` with weights re-solved on the frozen projection.
    Jit-safe (static shapes); the support is the current slot mask.

    ``data_weights`` (optional (N,) array) makes row n count ``u_n`` times in
    the frozen target ``v_total = scaling * sum_n u_n v_n`` — the same
    weighted-posterior tangent vector the incremental builders use
    (incremental.py::_sum_rows), so the polish targets the WEIGHTED build's
    posterior. Subsampled estimates keep the uniform-draw + ``u[sub]``
    convention of ``make_tangent_error``. ``None`` is bit-identical to the
    unweighted program."""
    if data_weights is not None:
        data_weights = jnp.asarray(data_weights, dtype=data.dtype)
        if data_weights.shape != (data.shape[0],):
            raise ValueError(
                f"data_weights must be ({data.shape[0]},), got {data_weights.shape}")

    try:
        # reuse one jitted program per (model, sampler, config): a fresh
        # jax.jit wrapper per call would RECOMPILE on every refine() in a
        # per-round acquisition loop
        refine_fn = _cached_refine(model, sampler, n_samples, n_subsample,
                                   use_beta, nnls_iters)
    except TypeError:  # unhashable model/sampler: fall back to per-call jit
        refine_fn = _make_refine(model, sampler, n_samples, n_subsample,
                                 use_beta, nnls_iters)
    return refine_fn(data, data_weights, key, state)


@lru_cache(maxsize=64)
def _cached_refine(model, sampler, n_samples, n_subsample, use_beta,
                   nnls_iters):
    return _make_refine(model, sampler, n_samples, n_subsample, use_beta,
                        nnls_iters)


def _make_refine(model, sampler, n_samples: int, n_subsample, use_beta: bool,
                 nnls_iters: int):
    @jax.jit
    def _refine(data, u, key, st: CoresetState) -> CoresetState:
        k_samp, k_sub = jax.random.split(key)
        samples, aux = sampler(k_samp, n_samples, st.wts, st.pts, st.sampler_aux)
        proj = (lambda p: project_beta(model, p, samples, st.beta)) if use_beta \
            else (lambda p: project_ll(model, p, samples))
        N = data.shape[0]
        if n_subsample is None or n_subsample >= N:
            vecs = proj(data)
            v_total = vecs.sum(axis=0) if u is None else u @ vecs
        else:
            sub_idcs, scaling = draw_subsample(k_sub, N, n_subsample)
            vecs = proj(data[sub_idcs])
            v_total = scaling * (vecs.sum(axis=0) if u is None
                                 else u[sub_idcs] @ vecs)
        Vc = proj(st.pts) * st.slot_mask[:, None].astype(data.dtype)  # (M, S)
        M_max = st.wts.shape[0]
        w_new = nnls_on_support(Vc.T, v_total, st.slot_mask, M_max,
                                n_iters=nnls_iters)
        # keep the refinement only if it tightens the frozen objective
        err_old = jnp.linalg.norm(Vc.T @ st.wts - v_total)
        err_new = jnp.linalg.norm(Vc.T @ w_new - v_total)
        improved = err_new <= err_old
        return st._replace(wts=jnp.where(improved, w_new, st.wts),
                           sampler_aux=aux)

    return _refine
