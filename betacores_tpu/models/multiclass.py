"""Bayesian multiclass (softmax) logistic regression.

BEYOND REFERENCE: the reference binarizes every multiclass dataset
(examples/data/convert_mnist_to_2class.py; preproc_covtype.py collapses
covertype to a 2-class task) because its model zoo has only binary logistic
regression. This family summarizes K-class problems natively.

Data rows are z_n = [x_n, y_n] with the class label y in {0..K-1} stored as
a float in the LAST column (the framework's single-(N, D)-array convention,
like models/poisson.py). Parameters are a packed theta of dim K*d
(row-major (K, d)); the (N, S) projection reduces to one (N, d) @ (d, S*K)
matmul followed by per-class elementwise transforms.

    log p(y | x, th) = x . th_y - logsumexp_k(x . th_k)

Prior: th ~ N(0, I) over all K*d coordinates (the softmax overparametrization
is identified by the prior, like one-hot GLMs in practice).

beta-likelihood (positive convention, models/base.py): the density-power
surrogate for a discrete likelihood,

    f_beta(z, th) = (beta+1)/beta * p_y^beta - sum_k p_k^(beta+1)

computed overflow-free from log-probabilities. Under label-flip
contamination p_y is tiny for corrupted rows, so f_beta -> 0 and the
corrupted rows lose all influence — the same mechanism as the binary
beta-likelihood (reference model_lr.py:81-86).

BPSVI: ``grad_z_log_likelihood`` differentiates the FEATURES and holds the
label coordinate fixed (labels are discrete; pseudo-points move in x only).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .base import ModelFns, beta_gradient_from_autodiff

_LOG2PI = math.log(2.0 * math.pi)


def _split(z):
    """(N, D) rows -> ((N, d) features, (N,) int labels)."""
    return z[:, :-1], z[:, -1].astype(jnp.int32)


def _log_probs(x, th, n_classes: int):
    """(N, S, K) log softmax probabilities for packed thetas (S, K*d)."""
    S = th.shape[0]
    d = x.shape[1]
    Th = th.reshape(S, n_classes, d)
    logits = jnp.einsum("nd,skd->nsk", x, Th)
    return jax.nn.log_softmax(logits, axis=-1)


def make_log_likelihood(n_classes: int):
    def log_likelihood(z, th):
        """(N, S): log p(y_n | x_n, th_s)."""
        x, y = _split(z)
        lp = _log_probs(x, th, n_classes)
        return jnp.take_along_axis(lp, y[:, None, None], axis=2)[:, :, 0]

    return log_likelihood


def make_beta_likelihood(n_classes: int):
    def beta_likelihood(z, th, beta):
        """(N, S) density-power surrogate, positive convention:
        (beta+1)/beta * p_y^beta - sum_k p_k^(1+beta)."""
        x, y = _split(z)
        lp = _log_probs(x, th, n_classes)               # (N, S, K)
        lp_y = jnp.take_along_axis(lp, y[:, None, None], axis=2)[:, :, 0]
        mass = jnp.exp(jax.scipy.special.logsumexp((1.0 + beta) * lp, axis=2))
        return (beta + 1.0) / beta * jnp.exp(beta * lp_y) - mass

    return beta_likelihood


def make_grad_z_log_likelihood(n_classes: int):
    def grad_z_log_likelihood(z, th):
        """(N, S, D) gradient w.r.t. the data row: d/dx = (e_y - p) . Th per
        class stack; the label coordinate gets 0 (discrete — BPSVI
        pseudo-points move in feature space only)."""
        x, y = _split(z)
        S = th.shape[0]
        d = x.shape[1]
        Th = th.reshape(S, n_classes, d)
        lp = _log_probs(x, th, n_classes)               # (N, S, K)
        coef = -jnp.exp(lp)                             # -p_k
        coef = coef.at[
            jnp.arange(z.shape[0])[:, None],
            jnp.arange(S)[None, :],
            y[:, None],
        ].add(1.0)                                      # e_y - p
        gx = jnp.einsum("nsk,skd->nsd", coef, Th)
        return jnp.concatenate([gx, jnp.zeros_like(gx[:, :, :1])], axis=2)

    return grad_z_log_likelihood


# --- single-theta weighted joint (Laplace / HMC target) ---------------------


def log_prior(th):
    return -0.5 * th.shape[-1] * _LOG2PI - 0.5 * jnp.sum(th * th, axis=-1)


def make_log_joint(n_classes: int):
    def log_joint(z, th, wts):
        """Weighted log joint for ONE packed theta (K*d,)."""
        x, y = _split(z)
        d = x.shape[1]
        logits = x @ th.reshape(n_classes, d).T          # (N, K)
        lp = jax.nn.log_softmax(logits, axis=-1)
        ll = jnp.take_along_axis(lp, y[:, None], axis=1)[:, 0]
        return jnp.sum(wts * ll) + log_prior(th)

    return log_joint


# --- prediction --------------------------------------------------------------


def predictive_probs(Xt, thetas, n_classes: int):
    """(Nt, K) posterior-mean class probabilities."""
    lp = _log_probs(Xt, thetas, n_classes)               # (Nt, S, K)
    return jnp.exp(jax.scipy.special.logsumexp(lp, axis=1)
                   - jnp.log(thetas.shape[0]))


def compute_accuracy(Xt, Yt, thetas, n_classes: int):
    preds = jnp.argmax(predictive_probs(Xt, thetas, n_classes), axis=1)
    return jnp.mean(preds == Yt.astype(jnp.int32))


def predictive_loglik(Zt, thetas, n_classes: int):
    """Mean posterior-predictive log-likelihood on test rows z = [x, y]."""
    ll = make_log_likelihood(n_classes)(Zt, thetas)      # (Nt, S)
    S = thetas.shape[0]
    return jnp.mean(jax.scipy.special.logsumexp(ll, axis=1) - jnp.log(S))


def bundle(n_classes: int) -> ModelFns:
    """ModelFns for a K-class softmax family. Pass
    ``theta_dim=n_classes * d_x`` to the projector constructors (packed
    parameter rows, like models/mvn.py)."""
    if n_classes < 2:
        raise ValueError("n_classes must be >= 2")
    beta_likelihood = make_beta_likelihood(n_classes)
    return ModelFns(
        log_likelihood=make_log_likelihood(n_classes),
        beta_likelihood=beta_likelihood,
        beta_gradient=beta_gradient_from_autodiff(beta_likelihood),
        grad_z_log_likelihood=make_grad_z_log_likelihood(n_classes),
    )


def make_grad_th_log_joint(n_classes: int):
    def grad_th_log_joint(z, th, wts):
        """(K*d,) analytic gradient: -th + sum_n w_n (e_{y_n} - p_n) ⊗ x_n."""
        x, y = _split(z)
        d = x.shape[1]
        logits = x @ th.reshape(n_classes, d).T          # (N, K)
        p = jax.nn.softmax(logits, axis=-1)
        coef = -p
        coef = coef.at[jnp.arange(x.shape[0]), y].add(1.0)  # e_y - p
        g = (wts[:, None] * coef).T @ x                  # (K, d)
        return -th + g.reshape(-1)

    return grad_th_log_joint


def make_hess_th_log_joint(n_classes: int):
    def hess_th_log_joint(z, th, wts):
        """(K*d, K*d) analytic Hessian:
        -I - sum_n w_n (diag(p_n) - p_n p_n^T) ⊗ x_n x_n^T
        (negative definite: softmax log-likelihoods are concave)."""
        x, y = _split(z)
        d = x.shape[1]
        K = n_classes
        logits = x @ th.reshape(K, d).T
        p = jax.nn.softmax(logits, axis=-1)              # (N, K)
        # W_n = diag(p_n) - p_n p_n^T, weighted by w_n
        Wp = wts[:, None, None] * (
            jnp.einsum("nk,kl->nkl", p, jnp.eye(K, dtype=p.dtype))
            - jnp.einsum("nk,nl->nkl", p, p))
        H = jnp.einsum("nkl,nd,ne->kdle", Wp, x, x)      # (K, d, K, d)
        Kd = K * d
        return -jnp.eye(Kd, dtype=th.dtype) - H.reshape(Kd, Kd)

    return hess_th_log_joint
