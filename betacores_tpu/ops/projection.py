"""Projection engine: finite-dimensional tangent-space embeddings.

Spec: reference bayesiancoresets/coreset/projector.py. A "projection" of a
point z under S posterior samples {th_s} is the S-vector of centered
(beta-)log-likelihoods  v_n = ll(z_n, th_s) - mean_s ll(z_n, th_s); coreset
algorithms operate on the (N, S) matrix of these vectors. The matrix is one
matmul plus elementwise work, so we always materialize the full (N, S)
block per call and let XLA fuse the centering.

Design deltas vs the reference (SURVEY.md section 7):
  * subsampling indices and ``sum_scaling`` are explicit inputs/outputs with
    a caller-provided PRNG key (reference draws from the global numpy stream
    at sparsevi.py:52, bcores.py:55);
  * gradient projections are centered over the *sample* axis. The reference
    centers ``glls`` over the coordinate axis (projector.py:30-31,
    ``glls.mean(axis=2)``), which does not make the Monte-Carlo tangent
    estimator unbiased — centering must match the scalar projection's
    sample-axis centering. Verified by the moment tests;
  * group projections use a padded (G, L_max) member-index matrix with -1
    padding instead of Python lists of lists (reference bcores.py:46-61).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp


def center(v: jnp.ndarray, axis: int = 1) -> jnp.ndarray:
    return v - v.mean(axis=axis, keepdims=True)


def project_ll(model, pts, samples):
    """Centered (N, S) log-likelihood projection (reference projector.py:23-26)."""
    return center(model.log_likelihood(pts, samples))


def project_beta(model, pts, samples, beta):
    """Centered (N, S) beta-likelihood projection (reference projector.py:51-55)."""
    return center(model.beta_likelihood(pts, samples, beta))


def project_ll_with_grad(model, pts, samples):
    """Centered scalar + gradient projections for BPSVI point updates.
    Returns ((N, S), (N, S, D)); both centered over the sample axis."""
    lls = center(model.log_likelihood(pts, samples))
    glls = model.grad_z_log_likelihood(pts, samples)
    glls = glls - glls.mean(axis=1, keepdims=True)
    return lls, glls


def project_beta_with_grad(model, pts, samples, beta):
    """Centered beta projection + its d/d(beta) (reference projector.py:56-61),
    for the learn-beta path."""
    bls = center(model.beta_likelihood(pts, samples, beta))
    gbs = center(model.beta_gradient(pts, samples, beta))
    return bls, gbs


def draw_subsample(key: jax.Array, n_total: int, n_subsample: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform with-replacement subsample indices + importance rescale
    sum_scaling = N / n (reference bcores.py:52-55)."""
    idcs = jax.random.randint(key, (n_subsample,), 0, n_total)
    return idcs, jnp.asarray(n_total / n_subsample)


class Groups(NamedTuple):
    """Group-structured data for batch (group-level) selection
    (reference bcores.py:46-61, examples/data/preproc_adult.py:20-31).

    members: (G, L_max) int32, row g lists data indices of group g, padded
    with -1. sizes: (G,) true member counts.
    """

    members: jnp.ndarray
    sizes: jnp.ndarray

    @staticmethod
    def from_lists(group_lists) -> "Groups":
        import numpy as np

        G = len(group_lists)
        L = max(len(g) for g in group_lists)
        m = -np.ones((G, L), dtype=np.int32)
        seen = set()
        for i, g in enumerate(group_lists):
            dup = seen.intersection(g)
            if dup:
                # the segment-sum group projections (and Shapley prefix
                # masks) assign each point to exactly one group; overlap
                # would silently drop members from all but one group
                raise ValueError(f"groups must be disjoint; shared points {sorted(dup)[:5]}...")
            seen.update(int(x) for x in g)
            m[i, : len(g)] = np.asarray(g, dtype=np.int32)
        sizes = np.asarray([len(g) for g in group_lists], dtype=np.int32)
        return Groups(members=jnp.asarray(m), sizes=jnp.asarray(sizes))

    @property
    def n_groups(self) -> int:
        return self.members.shape[0]

    @property
    def max_size(self) -> int:
        return self.members.shape[1]


def project_groups(project_fn, data: jnp.ndarray, groups: Groups, group_idcs: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """(G_sel, S) group projection: the group vector is the sum of its
    members' projected vectors (reference bcores.py:50,60). ``project_fn``
    maps an (n, D) point block to its centered (n, S) projection. Padded
    slots (-1) contribute zero."""
    members = groups.members if group_idcs is None else groups.members[group_idcs]
    G, L = members.shape
    flat = members.reshape(-1)
    safe = jnp.maximum(flat, 0)
    vecs = project_fn(data[safe])  # (G*L, S)
    mask = (flat >= 0).astype(vecs.dtype)[:, None]
    return (vecs * mask).reshape(G, L, -1).sum(axis=1)
