"""Multivariate Gaussian with known covariance (unknown mean).

Spec: reference examples/common/gaussian.py. Data x ~ N(theta, Sig) with Sig
known; prior theta ~ N(mu0, Sig0). The weighted posterior is conjugate and
exact, which makes this family the framework's closed-form ground truth for
end-to-end KL validation (reference: examples/zellner_gaussian/main.py:157-167).

All (N, S) kernels are built around one pairwise squared-Mahalanobis matrix
d2[n, s] = (x_n - th_s)^T Siginv (x_n - th_s); the N x S cross term is a
single matmul.

NOTE on a reference bug not reproduced here: the reference's
``weighted_post`` (gaussian.py:28-32) composes the triangular factors in the
wrong order — with LSigpInv = chol(SigpInv) it uses Sigp := LSigp @ LSigp.T
= L^{-1} L^{-T}, but (L L^T)^{-1} = L^{-T} L^{-1}. Its posterior means and
sample covariances are therefore systematically off (verified numerically).
We return the mathematically correct posterior; ``sample_gaussian_prec``
draws with the correct covariance.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from .base import ModelFns, beta_gradient_from_autodiff

_LOG2PI = math.log(2.0 * math.pi)


def pairwise_mahalanobis_sq(x: jnp.ndarray, th: jnp.ndarray, Siginv: jnp.ndarray) -> jnp.ndarray:
    """d2[n, s] = (x_n - th_s)^T Siginv (x_n - th_s), shape (N, S)."""
    xS = x @ Siginv
    thS = th @ Siginv
    x_quad = jnp.sum(xS * x, axis=-1)
    th_quad = jnp.sum(thS * th, axis=-1)
    cross = xS @ th.T
    return x_quad[:, None] + th_quad[None, :] - 2.0 * cross


def log_likelihood(x, th, Siginv, logdetSig):
    """(N, S) Gaussian log-density log N(x_n | th_s, Sig).
    Spec: reference gaussian.py:7-15."""
    d = x.shape[-1]
    return -0.5 * d * _LOG2PI - 0.5 * logdetSig - 0.5 * pairwise_mahalanobis_sq(x, th, Siginv)


def grad_x_log_likelihood(x, th, Siginv):
    """(N, S, d) gradient w.r.t. the data point x_n: Siginv (th_s - x_n).
    Spec: reference gaussian.py:17-20."""
    return (th @ Siginv)[None, :, :] - (x @ Siginv)[:, None, :]


def beta_likelihood(x, th, beta, Siginv, logdetSig):
    """(N, S) beta-divergence surrogate likelihood
    (1/beta) exp(-beta/2 d2) - (1+beta)^(-d/2-1).
    Spec: reference gaussian.py:34-44 (which computes but drops the
    normalizing cnst factor; we match the dropped-cnst form)."""
    del logdetSig  # the reference's cnst factor is computed but unused
    d = x.shape[-1]
    d2 = pairwise_mahalanobis_sq(x, th, Siginv)
    return (1.0 / beta) * jnp.exp(-0.5 * beta * d2) - (1.0 + beta) ** (-0.5 * d - 1.0)


def beta_gradient_reference(x, th, beta, Siginv, logdetSig):
    """The reference's hand-derived d/d(beta) (gaussian.py:46-62), kept for
    parity checks. It includes logcnst terms of the normalizer its own
    ``beta_likelihood`` drops, so it is NOT the exact derivative of
    :func:`beta_likelihood`; the live ``learn_beta`` path uses the autodiff
    gradient from :func:`bundle` instead."""
    d = float(x.shape[-1])
    d2 = pairwise_mahalanobis_sq(x, th, Siginv)
    logcnst = -0.5 * d * _LOG2PI - 0.5 * logdetSig
    gaussq = jnp.exp(-0.5 * beta * d2)
    t11 = gaussq / beta
    t12 = (1.0 + beta) ** (-0.5 * d - 1.0)
    t1 = logcnst * (t11 - t12)
    t2 = gaussq / beta**2
    t3 = d2 / (2.0 * beta) * gaussq
    t4 = t12 * jnp.log1p(beta)
    return t1 - t2 - t3 - t4


class GaussianPosterior(NamedTuple):
    """Weighted conjugate posterior N(mu, Sigp) stored via the Cholesky
    factor L of the precision: SigpInv = L @ L.T, Sigp = L^{-T} L^{-1}."""

    mu: jnp.ndarray          # (d,)
    prec_chol: jnp.ndarray   # (d, d) lower: chol(SigpInv)

    @property
    def cov(self) -> jnp.ndarray:
        Linv = solve_triangular(self.prec_chol, jnp.eye(self.prec_chol.shape[0], dtype=self.prec_chol.dtype), lower=True)
        return Linv.T @ Linv

    @property
    def prec(self) -> jnp.ndarray:
        return self.prec_chol @ self.prec_chol.T


def weighted_post(th0, Sig0inv, Siginv, x, w) -> GaussianPosterior:
    """Exact conjugate weighted posterior (correct-factor version of
    reference gaussian.py:28-32):
        SigpInv = Sig0inv + (sum_i w_i) Siginv
        mu      = Sigp (Sig0inv th0 + Siginv sum_i w_i x_i)
    """
    prec = Sig0inv + jnp.sum(w) * Siginv
    L = jnp.linalg.cholesky(prec)
    rhs = Sig0inv @ th0 + Siginv @ jnp.sum(w[:, None] * x, axis=0)
    mu = jax.scipy.linalg.cho_solve((L, True), rhs)
    return GaussianPosterior(mu=mu, prec_chol=L)


def sample_gaussian_prec_from_noise(post: GaussianPosterior, z: jnp.ndarray) -> jnp.ndarray:
    """theta = mu + L^{-T} z for pre-drawn standard normals z (n, d) — the
    noise-in half of ``sample_gaussian_prec`` (builders pre-draw a whole
    refinement loop's noise in one vmapped call; values are bit-identical)."""
    return post.mu + solve_triangular(post.prec_chol.T, z.T, lower=False).T


def sample_gaussian_prec(key, post: GaussianPosterior, n_samples: int) -> jnp.ndarray:
    """Draw (S, d) samples theta = mu + L^{-T} z, z ~ N(0, I): exact
    covariance Sigp = L^{-T} L^{-1}. (The reference draws mu + z @ LSig.T
    with LSig = L^{-1}, giving covariance L^{-1} L^{-T} != Sigp — a bug we
    do not reproduce; see module docstring.)"""
    d = post.mu.shape[0]
    z = jax.random.normal(key, (n_samples, d), dtype=post.mu.dtype)
    # theta_s = mu + L^{-T} z_s  ==  mu + solve(L.T, z_s)
    return sample_gaussian_prec_from_noise(post, z)


def gaussian_KL(mu0, Sig0, mu1, Sig1inv):
    """KL(N(mu0, Sig0) || N(mu1, Sig1)) with the second argument given by its
    precision. Spec: reference gaussian.py:22-26."""
    t1 = jnp.trace(Sig1inv @ Sig0)
    diff = mu1 - mu0
    t2 = diff @ (Sig1inv @ diff)
    t3 = -jnp.linalg.slogdet(Sig1inv)[1] - jnp.linalg.slogdet(Sig0)[1]
    return 0.5 * (t1 + t2 + t3 - mu0.shape[0])


def bundle(Siginv, logdetSig) -> ModelFns:
    """ModelFns closure over the fixed observation covariance. The
    projection is one matmul + elementwise + centering, which XLA fuses to
    a single pass on its own."""
    blik = partial(beta_likelihood, Siginv=Siginv, logdetSig=logdetSig)

    def _blik(pts, thetas, beta):
        return blik(pts, thetas, beta=beta)

    return ModelFns(
        log_likelihood=lambda pts, thetas: log_likelihood(pts, thetas, Siginv, logdetSig),
        beta_likelihood=_blik,
        beta_gradient=beta_gradient_from_autodiff(_blik),
        grad_z_log_likelihood=lambda pts, thetas: grad_x_log_likelihood(pts, thetas, Siginv),
    )
