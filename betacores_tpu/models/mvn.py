"""Multivariate Gaussian with UNKNOWN covariance (Normal-Inverse-Wishart).

The reference ships this family only as a dead sketch
(examples/common/mvn.py: numpy shadowed by ``import jax.numpy as np`` at :3,
non-Python math ``-.5(nu0+...)``/``^T`` at :22, undefined ``z`` at :24) with
an NIW prior hard-coded as nu0=N+1, kappa0=1 (:15-18). This is the intended
capability — robust summarization when Sigma must be inferred — working:

  prior      (mu, Sigma) ~ NIW(mu0, kappa0, Psi0, nu0)
  posterior  conjugate weighted NIW update (``weighted_post``)
  samples    exact NIW draws via the Bartlett decomposition
             (``mvn_niw_sampler``), packed as rows
             th = [mu (d), vec(L) (d*d)] with L = chol(Lambda),
             Lambda = Sigma^{-1} — the precision Cholesky makes every
             likelihood evaluation a triangular matvec, no solves.

(N, S) likelihood conventions follow models/base.py; ``beta_likelihood`` is
the positive-convention density-power surrogate with the closed-form mass
integral p^(1+beta) dx = (2 pi)^(-beta d/2) |Sigma|^(-beta/2)
(1+beta)^(-d/2); ``beta_gradient`` is exact forward-mode autodiff.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .base import ModelFns, beta_gradient_from_autodiff

_LOG2PI = math.log(2.0 * math.pi)


def pack(mu, L):
    """(S, d), (S, d, d) -> (S, d + d*d) packed parameter rows."""
    S, d = mu.shape
    return jnp.concatenate([mu, L.reshape(S, d * d)], axis=1)


def unpack(thetas, d: int):
    """(S, d + d*d) -> mu (S, d), L (S, d, d) precision Cholesky."""
    mu = thetas[:, :d]
    L = thetas[:, d:].reshape(thetas.shape[0], d, d)
    return mu, L


def _half_logdet(L):
    """(S,): log |Lambda|^(1/2) = sum log diag L."""
    return jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


def log_likelihood(z, thetas):
    """(N, S): log N(z_n | mu_s, Sigma_s) via the precision Cholesky.

    Deliberately the FACTORED quadratic form ||L^T (z - mu)||^2, not the
    expanded vec(zz^T) . vec(Lambda) two-matmul version: the expansion
    avoids the (N, S, d) intermediate but catastrophically cancels in f32
    (nats of error in the tails), and XLA fuses this einsum well."""
    d = z.shape[1]
    mu, L = unpack(thetas, d)
    diff = z[:, None, :] - mu[None, :, :]                      # (N, S, d)
    y = jnp.einsum("nsd,sde->nse", diff, L)                    # L^T diff
    quad = jnp.sum(y * y, axis=-1)                             # (N, S)
    return -0.5 * d * _LOG2PI + _half_logdet(L)[None, :] - 0.5 * quad


def beta_likelihood(z, thetas, beta):
    """(N, S) density-power surrogate, positive convention:
    (beta+1)/beta p^beta - (2 pi)^(-beta d/2) |Sigma|^(-beta/2) (1+beta)^(-d/2)."""
    d = z.shape[1]
    _, L = unpack(thetas, d)
    ll = log_likelihood(z, thetas)
    log_mass = beta * (_half_logdet(L) - 0.5 * d * _LOG2PI) \
        - 0.5 * d * jnp.log1p(beta)                            # (S,)
    return (beta + 1.0) / beta * jnp.exp(beta * ll) - jnp.exp(log_mass)[None, :]


def grad_z_log_likelihood(z, thetas):
    """(N, S, d): d/dz log N(z | mu_s, Sigma_s) = -Lambda (z - mu) (BPSVI
    pseudo-point updates, reference mvn.py:31-32 intent)."""
    d = z.shape[1]
    mu, L = unpack(thetas, d)
    diff = z[:, None, :] - mu[None, :, :]
    y = jnp.einsum("nsd,sde->nse", diff, L)
    return -jnp.einsum("sde,nse->nsd", L, y)


class NIWPosterior(NamedTuple):
    mu: jnp.ndarray     # (d,)
    kappa: jnp.ndarray  # scalar
    Psi: jnp.ndarray    # (d, d) scale matrix
    nu: jnp.ndarray     # scalar degrees of freedom


def weighted_post(mu0, kappa0, Psi0, nu0, x, w) -> NIWPosterior:
    """Exact conjugate weighted NIW update (the reference's broken
    log_prior/log_joint at mvn.py:15-24 define this model). Weighted
    sufficient statistics: W = sum w, xbar = sum w x / W, scatter =
    sum w (x-xbar)(x-xbar)^T. W = 0 returns the prior."""
    dtype = x.dtype
    w = jnp.asarray(w, dtype=dtype)
    W = jnp.sum(w)
    safe_W = jnp.maximum(W, jnp.asarray(1e-12, dtype))
    xbar = (w @ x) / safe_W
    diff = x - xbar
    scatter = jnp.einsum("n,nd,ne->de", w, diff, diff)
    kappa_n = kappa0 + W
    mu_n = (kappa0 * mu0 + W * xbar) / kappa_n
    nu_n = nu0 + W
    dm = xbar - mu0
    Psi_n = Psi0 + scatter + (kappa0 * W / kappa_n) * jnp.outer(dm, dm)
    # W == 0: prior (xbar is garbage but multiplied by W = 0 except in mu_n,
    # which reduces to mu0 exactly; Psi term has factor W = 0)
    return NIWPosterior(mu=mu_n, kappa=kappa_n, Psi=Psi_n, nu=nu_n)


def sample_niw(key, post: NIWPosterior, n: int):
    """(n, d + d*d) exact NIW draws packed as [mu, vec(chol(Lambda))].

    Bartlett: Lambda ~ Wishart(nu, Psi^{-1}) has chol factor L = C A where
    C = chol(Psi^{-1}) and A is lower-triangular with A_ii^2 ~ chi2(nu-i)
    and subdiagonal N(0,1); then mu | Lambda ~ N(mu_n, (kappa Lambda)^{-1})
    is mu_n + L^{-T} xi / sqrt(kappa)."""
    d = post.mu.shape[0]
    dtype = post.mu.dtype
    k_diag, k_off, k_mu = jax.random.split(key, 3)
    # C = chol(Psi^{-1}) via the inverse of chol(Psi): Psi = P P^T =>
    # Psi^{-1} = P^{-T} P^{-1}; its lower Cholesky is C with C C^T = Psi^{-1}.
    P = jnp.linalg.cholesky(post.Psi)
    Pinv = jax.scipy.linalg.solve_triangular(P, jnp.eye(d, dtype=dtype), lower=True)
    C = jnp.linalg.cholesky(Pinv.T @ Pinv)   # chol(Psi^{-1}), d is small

    i = jnp.arange(d, dtype=dtype)
    df = post.nu - i                                            # chi2 dof per diag
    gam = jax.random.gamma(k_diag, 0.5 * df[None, :].repeat(n, 0)) * 2.0
    diag = jnp.sqrt(gam)                                        # (n, d)
    off = jax.random.normal(k_off, (n, d, d), dtype=dtype)
    tril = jnp.tril(off, -1)
    A = tril + jax.vmap(jnp.diag)(diag).astype(dtype)
    L = jnp.einsum("de,nef->ndf", C, A)                         # (n, d, d) lower
    xi = jax.random.normal(k_mu, (n, d), dtype=dtype)
    # mu = mu_n + L^{-T} xi / sqrt(kappa)
    solve = jax.vmap(lambda Ls, v: jax.scipy.linalg.solve_triangular(
        Ls.T, v, lower=False))
    mu = post.mu[None, :] + solve(L, xi) / jnp.sqrt(post.kappa)
    return pack(mu.astype(dtype), L.astype(dtype))


def _multigammaln(a, d: int):
    return jax.scipy.special.multigammaln(a, d)


def _multidigamma(a, d: int):
    i = jnp.arange(d, dtype=a.dtype)
    return jnp.sum(jax.scipy.special.digamma(a - 0.5 * i))


def niw_logpdf(th_packed, post: NIWPosterior):
    """log NIW density of a packed [mu, vec(chol(Lambda))] row, in the
    (mu, Sigma) parameterization (no Jacobian for the packing — evaluate at
    draws produced by ``sample_niw`` only for ratios of the SAME packing)."""
    d = post.mu.shape[0]
    mu, L = unpack(th_packed[None, :], d)
    mu, L = mu[0], L[0]
    Lam = L @ L.T
    half_logdet_lam = jnp.sum(jnp.log(jnp.diagonal(L)))        # log|Sigma|^{-1/2}
    dm = mu - post.mu
    # N(mu; m, Sigma/kappa)
    log_n = (-0.5 * d * _LOG2PI + 0.5 * d * jnp.log(post.kappa)
             + half_logdet_lam - 0.5 * post.kappa * dm @ Lam @ dm)
    # IW(Sigma; Psi, nu): log|Psi|^{nu/2} ... with log|Sigma| = -2 half_logdet_lam
    _, logdet_psi = jnp.linalg.slogdet(post.Psi)
    log_iw = (0.5 * post.nu * logdet_psi - 0.5 * post.nu * d * jnp.log(2.0)
              - _multigammaln(0.5 * post.nu, d)
              + (post.nu + d + 1.0) * half_logdet_lam
              - 0.5 * jnp.trace(post.Psi @ Lam))
    return log_n + log_iw


def niw_kl(p: NIWPosterior, q: NIWPosterior):
    """Closed-form KL(NIW_p || NIW_q): the conditional-normal expectation
    plus the inverse-Wishart (= transformed Wishart) KL. Gives the MVN
    family the same KL-based coreset evaluation the known-covariance family
    gets from gaussian_KL."""
    d = p.mu.shape[0]
    dm = p.mu - q.mu
    Pinv = jnp.linalg.inv(p.Psi)
    # E_p[KL(N(mu; m_p, Sig/k_p) || N(mu; m_q, Sig/k_q))], E_p[Sig^{-1}] = nu_p Psi_p^{-1}
    kl_n = 0.5 * (d * q.kappa / p.kappa - d + d * jnp.log(p.kappa / q.kappa)
                  + q.kappa * p.nu * dm @ Pinv @ dm)
    # KL(IW(Psi_p, nu_p) || IW(Psi_q, nu_q)) = KL(W(Psi_p^{-1}, nu_p) || W(Psi_q^{-1}, nu_q))
    _, logdet_qp = jnp.linalg.slogdet(q.Psi @ Pinv)
    kl_w = (0.5 * q.nu * (-logdet_qp)                     # -(nu_q/2) log|V_q^{-1} V_p|
            + 0.5 * p.nu * (jnp.trace(q.Psi @ Pinv) - d)
            + _multigammaln(0.5 * q.nu, d) - _multigammaln(0.5 * p.nu, d)
            + 0.5 * (p.nu - q.nu) * _multidigamma(0.5 * p.nu, d))
    return kl_n + kl_w


def predictive_logpdf(x, post: NIWPosterior):
    """(N,) posterior-predictive log density: integrating the NIW posterior
    gives the multivariate Student-t
        t_{nu-d+1}(mu, Psi (kappa+1) / (kappa (nu-d+1))).
    The family's analogue of logreg's predictive log-likelihood metric."""
    d = post.mu.shape[0]
    v = post.nu - d + 1.0
    S = post.Psi * (post.kappa + 1.0) / (post.kappa * v)
    P = jnp.linalg.cholesky(S)
    diff = x - post.mu[None, :]
    y = jax.scipy.linalg.solve_triangular(P, diff.T, lower=True).T   # (N, d)
    quad = jnp.sum(y * y, axis=-1)
    half_logdet = jnp.sum(jnp.log(jnp.diagonal(P)))
    return (jax.scipy.special.gammaln(0.5 * (v + d))
            - jax.scipy.special.gammaln(0.5 * v)
            - 0.5 * d * jnp.log(v * jnp.pi) - half_logdet
            - 0.5 * (v + d) * jnp.log1p(quad / v))


def mvn_niw_sampler(mu0, kappa0, Psi0, nu0):
    """SamplerFn: exact weighted NIW posterior draws for the coreset
    projectors ((key, n, wts, pts, aux) -> (samples, aux))."""
    mu0 = jnp.asarray(mu0)
    Psi0 = jnp.asarray(Psi0, dtype=mu0.dtype)
    kappa0 = jnp.asarray(kappa0, dtype=mu0.dtype)
    nu0 = jnp.asarray(nu0, dtype=mu0.dtype)

    def sampler(key, n, wts, pts, aux):
        post = weighted_post(mu0, kappa0, Psi0, nu0, pts, wts)
        return sample_niw(key, post, n), aux

    return sampler


def bundle(d: int) -> ModelFns:
    """ModelFns for the unknown-covariance Gaussian; parameter rows are
    (d + d*d)-dim packed [mu, vec(chol(Sigma^{-1}))] (pass
    ``theta_dim=d + d*d`` to the projectors)."""
    return ModelFns(
        log_likelihood=log_likelihood,
        beta_likelihood=beta_likelihood,
        beta_gradient=beta_gradient_from_autodiff(beta_likelihood),
        grad_z_log_likelihood=grad_z_log_likelihood,
    )
