"""Static-shape coreset state.

The reference grows numpy arrays one point at a time with ``np.resize``
(reference coreset/bcores.py:85-90). Under jit all shapes are static, so the
coreset lives in pre-allocated (M_max, ...) buffers with an active-slot
count ``m`` (SURVEY.md section 7 delta 1): slot k < m holds a selected point
(weight may be 0 after refinement, like the reference's appended-but-zero
points); slots >= m are padding masked out of every reduction.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp


class CoresetState(NamedTuple):
    wts: jnp.ndarray      # (M_max,)
    idcs: jnp.ndarray     # (M_max,) int32; -1 in padding slots
    pts: jnp.ndarray      # (M_max, D)
    m: jnp.ndarray        # scalar int32: active slot count
    beta: jnp.ndarray     # scalar: beta-divergence parameter (bcores)
    sampler_aux: Any      # warm-start state threaded to the sampler

    @property
    def slot_mask(self) -> jnp.ndarray:
        return jnp.arange(self.wts.shape[0]) < self.m


def init_state(max_size: int, dim: int, beta: float = 0.5, sampler_aux: Any = None,
               dtype=jnp.float32) -> CoresetState:
    if sampler_aux is None:
        sampler_aux = jnp.zeros(dim, dtype=dtype)  # default: Laplace warm-start mode
    return CoresetState(
        wts=jnp.zeros(max_size, dtype=dtype),
        idcs=-jnp.ones(max_size, dtype=jnp.int32),
        pts=jnp.zeros((max_size, dim), dtype=dtype),
        m=jnp.asarray(0, dtype=jnp.int32),
        beta=jnp.asarray(beta, dtype=dtype),
        sampler_aux=sampler_aux,
    )


def warm_start_state(max_size: int, wts, idcs, pts, beta: float = 0.5,
                     sampler_aux: Any = None) -> CoresetState:
    """Seed a state with an existing coreset (reference constructor kwargs
    wts/idcs/pts at coreset/coreset.py:8-14, used for warm-started batch
    acquisition at zellner_neural_linear/main.py:146-150).

    Padding is assembled host-side in numpy and transferred once: eager
    ``.at[:k].set`` with data-dependent k would compile a fresh tiny
    executable per distinct coreset size."""
    import numpy as np

    wts = np.asarray(wts)
    pts = np.atleast_2d(np.asarray(pts))
    k, d = pts.shape
    dtype = wts.dtype
    w_buf = np.zeros(max_size, dtype=dtype)
    i_buf = -np.ones(max_size, dtype=np.int32)
    p_buf = np.zeros((max_size, d), dtype=dtype)
    w_buf[:k] = wts
    i_buf[:k] = np.asarray(idcs, dtype=np.int32)
    p_buf[:k] = pts
    if sampler_aux is None:
        sampler_aux = jnp.zeros(d, dtype=jnp.asarray(w_buf).dtype)
    return CoresetState(
        wts=jnp.asarray(w_buf),
        idcs=jnp.asarray(i_buf),
        pts=jnp.asarray(p_buf),
        m=jnp.asarray(k, dtype=jnp.int32),
        beta=jnp.asarray(beta, dtype=jnp.asarray(w_buf).dtype),
        sampler_aux=sampler_aux,
    )


def get(state: CoresetState):
    """Extract (wts, pts, idcs) of the strictly-positive-weight support, the
    reference's ``Coreset.get()`` filter (coreset/coreset.py:25-26). Eager
    (shape depends on data); returns numpy arrays."""
    import numpy as np

    w = np.asarray(state.wts)
    keep = w > 0
    return w[keep], np.asarray(state.pts)[keep], np.asarray(state.idcs)[keep]
