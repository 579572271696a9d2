"""Bayesian logistic regression.

Spec: reference examples/common/model_lr.py:72-153. Data rows are
z_n = y_n * x_n with labels y in {-1, +1} (the reference's convention —
model_lr.py's ``std_cov`` returns Z = Y[:, None] * X), so

    log p(y_n | x_n, th) = -softplus(-z_n . th)            [= log sigmoid(z.th)]

Prior: th ~ N(0, I) (reference model_lr.py:88-90).

The (N, S) projections reduce to one N x S matmul M = Z @ Th.T followed by
elementwise transforms, which XLA fuses into one pass.
Stability: the reference guards exp overflow with an m < 100 branch
(model_lr.py:75-79); we use mathematically-identical softplus/logsumexp
forms that are stable for all inputs and branch-free (jit/vmap friendly).

Sign convention: ``beta_likelihood`` uses the positive form
(beta+1)/beta p^beta - p^(beta+1) - (1-p)^(beta+1); the reference returns
its negation (model_lr.py:81-86), which leaves all selection/optimization
trajectories unchanged because every use is bilinear (see models/base.py).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .base import ModelFns, beta_gradient_from_autodiff

_LOG2PI = math.log(2.0 * math.pi)


def log_likelihood(z, th):
    """(N, S): log sigmoid(z_n . th_s) = -softplus(-z_n . th_s).
    Spec: reference model_lr.py:72-79."""
    m = -(z @ th.T)
    return -jax.nn.softplus(m)


def beta_likelihood(z, th, beta):
    """(N, S) beta-divergence surrogate for Bernoulli likelihood, positive
    convention. With p = sigmoid(z.th) and m = -z.th:
        (beta+1)/beta * p^beta - p^(beta+1) - (1-p)^(beta+1)
    where p^a = exp(-a softplus(m)) and (1-p)^a = exp(-a softplus(-m)),
    both overflow-free. Spec: reference model_lr.py:81-86 (negated there)."""
    m = -(z @ th.T)
    sp_pos = jax.nn.softplus(m)    # -log p
    sp_neg = jax.nn.softplus(-m)   # -log(1-p)
    return (
        (beta + 1.0) / beta * jnp.exp(-beta * sp_pos)
        - jnp.exp(-(beta + 1.0) * sp_pos)
        - jnp.exp(-(beta + 1.0) * sp_neg)
    )


def grad_z_log_likelihood(z, th):
    """(N, S, D) gradient w.r.t. the data row z_n: sigmoid(-z.th) * th.
    Spec: reference model_lr.py:109-116."""
    m = -(z @ th.T)
    return jax.nn.sigmoid(m)[:, :, None] * th[None, :, :]


def grad_th_log_likelihood(z, th):
    """(N, S, D) gradient w.r.t. theta: sigmoid(-z.th) * z.
    Spec: reference model_lr.py:101-107."""
    m = -(z @ th.T)
    return jax.nn.sigmoid(m)[:, :, None] * z[:, None, :]


# --- single-theta weighted joint (Laplace / NUTS target) -------------------


def log_prior(th):
    """Standard normal prior, th: (d,) -> scalar. Spec: model_lr.py:88-90."""
    return -0.5 * th.shape[-1] * _LOG2PI - 0.5 * jnp.sum(th * th, axis=-1)


def log_joint(z, th, wts):
    """Weighted log joint for a single th (d,): sum_n w_n log p(z_n|th) + log prior.
    Spec: reference model_lr.py:92-93."""
    m = -(z @ th)
    return jnp.sum(wts * (-jax.nn.softplus(m))) + log_prior(th)


def grad_th_log_joint(z, th, wts):
    """(d,) gradient of the weighted log joint. Spec: model_lr.py:118-121."""
    m = -(z @ th)
    return -th + (wts * jax.nn.sigmoid(m)) @ z


def hess_th_log_joint(z, th, wts):
    """(d, d) Hessian of the weighted log joint (concave: negative definite).
    Spec: model_lr.py:123-133."""
    m = -(z @ th)
    s = jax.nn.sigmoid(m)
    c = wts * s * (1.0 - s)
    d = th.shape[-1]
    return -jnp.eye(d, dtype=th.dtype) - (c[:, None] * z).T @ z


def diag_hess_th_log_joint(z, th, wts):
    """(d,) diagonal of the Hessian. Spec: model_lr.py:141-153."""
    m = -(z @ th)
    s = jax.nn.sigmoid(m)
    c = wts * s * (1.0 - s)
    return -jnp.ones_like(th) - c @ (z * z)


# --- prediction -------------------------------------------------------------


def compute_accuracy(Xt, Yt, thetas):
    """Posterior max-log-likelihood predictions, averaged over (test points x
    samples). Spec: reference model_lr.py:32-42: predict +1 where
    ll(+x) >= ll(-x), i.e. sign(x . th)."""
    scores = Xt @ thetas.T  # (Nt, S)
    preds = jnp.where(scores >= 0.0, 1.0, -1.0)
    return jnp.mean(Yt[:, None] == preds)


def predictive_loglik(Zt, thetas):
    """Mean posterior-predictive log-likelihood on test rows z = y*x:
    mean_n log( mean_s p(z_n | th_s) ), computed with logsumexp."""
    ll = log_likelihood(Zt, thetas)  # (Nt, S)
    S = thetas.shape[0]
    return jnp.mean(jax.scipy.special.logsumexp(ll, axis=1) - jnp.log(S))


def bundle() -> ModelFns:
    """ModelFns for Bayesian logistic regression. A projection is one
    matmul + elementwise + centering, which XLA fuses on its own."""
    return ModelFns(
        log_likelihood=log_likelihood,
        beta_likelihood=beta_likelihood,
        beta_gradient=beta_gradient_from_autodiff(beta_likelihood),
        grad_z_log_likelihood=grad_z_log_likelihood,
    )
