"""Model bundle interface.

The reference wires model math into algorithms through "projector" objects
holding loose callbacks (reference: bayesiancoresets/coreset/projector.py).
Here a model family is a :class:`ModelFns` bundle of pure, jit/vmap-friendly
functions over

    pts     : (N, D) data points (for regression models a row is z = [x, y]
              or z = y*x, matching the reference's conventions)
    thetas  : (S, d) posterior parameter samples
    beta    : scalar beta-divergence robustness parameter

All (N, S) likelihood matrices follow these conventions:
  * ``log_likelihood(pts, thetas)[n, s]`` = log p(pts[n] | thetas[s])
  * ``beta_likelihood`` is the beta-divergence surrogate likelihood
    f_beta(z, th) = (beta+1)/beta * p^beta - integral p^(beta+1)
    (positive convention). NOTE: the reference's logistic-regression
    variant returns the *negation* of this (reference:
    examples/common/model_lr.py:81-86); since every use of the projection
    is bilinear (corrs = vecs . resid, wgrad = -corevecs . resid), a global
    sign flip leaves selection and optimization trajectories unchanged, so
    we use the positive convention everywhere for consistency.
  * ``beta_gradient`` is d/d(beta) of ``beta_likelihood`` — computed with
    autodiff, which makes the reference's dead ``learn_beta`` path
    (reference: coreset/bcores.py:127-140, missing ``_get_projection_ii``)
    actually work.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class ModelFns(NamedTuple):
    """Pure-function bundle for one model family."""

    # (N, D), (S, d) -> (N, S)
    log_likelihood: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]
    # (N, D), (S, d), beta -> (N, S)
    beta_likelihood: Optional[Callable] = None
    # (N, D), (S, d), beta -> (N, S): d/d(beta) of beta_likelihood
    beta_gradient: Optional[Callable] = None
    # (N, D), (S, d) -> (N, S, D): gradient w.r.t. the data point (BPSVI)
    grad_z_log_likelihood: Optional[Callable] = None


def beta_gradient_from_autodiff(beta_likelihood: Callable) -> Callable:
    """Exact d/d(beta) of a beta-likelihood via forward-mode autodiff.

    Forward mode is the right transform here: beta is a scalar input and the
    output is the full (N, S) matrix, so one JVP gives the whole gradient.
    """

    def beta_gradient(pts, thetas, beta):
        beta = jnp.asarray(beta, dtype=jnp.result_type(pts))
        _, tangent = jax.jvp(
            lambda b: beta_likelihood(pts, thetas, b), (beta,), (jnp.ones_like(beta),)
        )
        return tangent

    return beta_gradient
