"""Bayesian Poisson regression (counts) with softplus link.

Spec: the reference's Poisson Stan program (examples/common/stan_code.py:22-42)
used by its MCMC helpers (examples/common/mcmc.py, mcmc_noXt.py) on the
packaged count datasets (synth_poiss / biketrips / airportdelays npz):

    y_n ~ Poisson(f_n),   f_n = -log_inv_logit(-(x_n . th)) = softplus(x_n . th)
    th  ~ N(0, I)

(the Stan program's separate intercept ``theta0`` corresponds to the intercept
column the preprocessing appends to x; here it is folded into th).

Data rows follow the linreg convention z_n = [x_n, y_n] (counts stored as
floats in the last column), so the coreset machinery sees one (N, D) array.

The reference never implements a beta-likelihood for Poisson (its robust
experiments are logreg/gaussian/neurlinr only). We provide one — the
density-power surrogate

    f_beta(z, th) = (beta+1)/beta * p(y|th)^beta - sum_k p(k|th)^(beta+1)

with the mass-sum term evaluated by a static-length truncated sum over
k = 0..K (Poisson mass beyond a few sd above the rate is negligible; K is a
bundle-time constant so shapes stay static under jit).

Laplace support: the exact log-joint Hessian of a softplus-link Poisson GLM
is not globally negative definite, so ``hess_th_log_joint`` returns the
*expected* Hessian (negative Fisher information − prior precision), which is
negative definite everywhere — Newton becomes Fisher scoring, the standard
GLM fit, and stays compatible with the Cholesky-based
``inference.laplace.newton_laplace``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from .base import ModelFns, beta_gradient_from_autodiff

_LOG2PI = math.log(2.0 * math.pi)


def _split(z):
    """(N, D) rows [x, y] -> x: (N, D-1), y: (N,)."""
    return z[..., :-1], z[..., -1]


def _rate(x, th):
    """(N, S) Poisson rates f = softplus(x . th), and eta for reuse."""
    eta = x @ th.T
    return jax.nn.softplus(eta), eta


def _log_softplus(eta):
    """log(softplus(eta)), stable for all eta: for eta << 0,
    softplus(eta) ~ exp(eta) underflows f32 near eta < -88 (log of the
    clamped value poisons y*log f); there log softplus(eta) -> eta."""
    sp = jax.nn.softplus(eta)
    return jnp.where(eta < -30.0, eta, jnp.log(jnp.maximum(sp, jnp.finfo(eta.dtype).tiny)))


def _sig_over_f(eta):
    """sigmoid(eta)/softplus(eta), stable for all eta: naive y/f overflows
    to inf when softplus underflows, but the ratio -> 1 as eta -> -inf
    (both ~ exp(eta)). Computed as exp(log sigmoid - log softplus)."""
    return jnp.exp(jax.nn.log_sigmoid(eta) - _log_softplus(eta))


def log_likelihood(z, th):
    """(N, S): y log f - f - lgamma(y+1), f = softplus(x.th)."""
    x, y = _split(z)
    f, eta = _rate(x, th)
    return y[:, None] * _log_softplus(eta) - f - gammaln(y + 1.0)[:, None]


def beta_likelihood(z, th, beta, k_max: int = 64, gaussian_mass: bool = False):
    """(N, S) density-power surrogate, positive convention:
        (beta+1)/beta p(y|f)^beta - sum_{k=0..k_max} p(k|f)^(beta+1).
    The truncated mass sum is exact to machine precision once
    k_max >> max rate (Poisson tails are sub-exponential).

    ``gaussian_mass=True`` replaces the O(k_max) sum with the closed form
    under the Poisson ~ N(f, f) approximation,
        sum_k p(k)^(b+1) ~ integral N(y; f, f)^(b+1) dy
                         = (2 pi f)^(-b/2) (1+b)^(-1/2),
    accurate for rates f >~ 10 — use it for large-count datasets where an
    exact grid over 0..max(y) would dominate the projection cost."""
    x, y = _split(z)
    f, eta = _rate(x, th)
    logf = _log_softplus(eta)
    ll = y[:, None] * logf - f - gammaln(y + 1.0)[:, None]        # (N, S)
    if gaussian_mass:
        mass = jnp.exp(-0.5 * beta * (jnp.log(2.0 * jnp.pi) + logf)
                       - 0.5 * jnp.log1p(beta))
    else:
        ks = jnp.arange(k_max + 1, dtype=z.dtype)                 # (K+1,)
        # log p(k | f): (N, S, K+1)
        ll_k = (ks[None, None, :] * logf[:, :, None]
                - f[:, :, None] - gammaln(ks + 1.0)[None, None, :])
        mass = jnp.exp(jax.scipy.special.logsumexp((beta + 1.0) * ll_k, axis=-1))
    return (beta + 1.0) / beta * jnp.exp(beta * ll) - mass


def grad_z_log_likelihood(z, th):
    """(N, S, D) gradient w.r.t. the data row z = [x, y] (BPSVI pseudo-point
    updates; counts relaxed to continuous y):
        d/dx = (y/f - 1) sigmoid(eta) th,   d/dy = log f - digamma(y+1)."""
    x, y = _split(z)
    f, eta = _rate(x, th)
    s = jax.nn.sigmoid(eta)                                       # f' = sigmoid
    # y s / f via the stable ratio: naive y/f overflows when f underflows
    gx = (y[:, None] * _sig_over_f(eta) - s)[:, :, None] * th[None, :, :]
    gy = _log_softplus(eta) - jax.scipy.special.digamma(y + 1.0)[:, None]
    return jnp.concatenate([gx, gy[:, :, None]], axis=-1)


# --- single-theta weighted joint (Laplace / HMC target) ---------------------


def log_prior(th):
    return -0.5 * th.shape[-1] * _LOG2PI - 0.5 * jnp.sum(th * th, axis=-1)


def log_joint(z, th, wts):
    """Weighted log joint for a single th (d,). Matches the weighted
    extension of the reference Stan program (stan_code.py:36-41)."""
    x, y = _split(z)
    eta = x @ th
    f = jax.nn.softplus(eta)
    ll = y * _log_softplus(eta) - f - gammaln(y + 1.0)
    return jnp.sum(wts * ll) + log_prior(th)


def grad_th_log_joint(z, th, wts):
    """(d,): sum_n w_n (y_n/f_n - 1) sigmoid(eta_n) x_n - th."""
    x, y = _split(z)
    eta = x @ th
    c = wts * (y * _sig_over_f(eta) - jax.nn.sigmoid(eta))
    return c @ x - th


def hess_th_log_joint(z, th, wts):
    """(d, d) expected Hessian (Fisher scoring): -I - sum w_n s_n^2/f_n x x^T,
    negative definite for all th (see module docstring)."""
    x, y = _split(z)
    eta = x @ th
    s = jax.nn.sigmoid(eta)
    c = wts * s * _sig_over_f(eta)
    d = th.shape[-1]
    return -jnp.eye(d, dtype=th.dtype) - (c[:, None] * x).T @ x


def diag_hess_th_log_joint(z, th, wts):
    x, y = _split(z)
    eta = x @ th
    s = jax.nn.sigmoid(eta)
    c = wts * s * _sig_over_f(eta)
    return -jnp.ones_like(th) - c @ (x * x)


# --- prediction --------------------------------------------------------------


def predictive_loglik(Zt, thetas):
    """Mean posterior-predictive log-likelihood: mean_n log mean_s p(z_n|th_s)."""
    ll = log_likelihood(Zt, thetas)
    S = thetas.shape[0]
    return jnp.mean(jax.scipy.special.logsumexp(ll, axis=1) - jnp.log(S))


def bundle(k_max: int = 64, gaussian_mass: bool = False) -> ModelFns:
    """XLA fuses the (N, S, k_max+1) logsumexp chain into its reduction
    loop without materializing the intermediate."""
    blik = lambda z, th, b: beta_likelihood(z, th, b, k_max=k_max,
                                            gaussian_mass=gaussian_mass)
    return ModelFns(
        log_likelihood=log_likelihood,
        beta_likelihood=blik,
        beta_gradient=beta_gradient_from_autodiff(blik),
        grad_z_log_likelihood=grad_z_log_likelihood,
    )
