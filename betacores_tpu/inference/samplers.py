"""Posterior samplers for projection construction.

The sampler protocol is the framework's replacement for the reference's
callback soup (reference: BlackBoxProjector.update at projector.py:36-37,
per-experiment ``sampler_w`` closures at zellner_gaussian/main.py:87-94 and
zellner_logreg/main.py:139-144):

    sampler(key, n_samples, wts, pts, aux) -> (samples (S, d), aux)

``aux`` threads warm-start state (the Laplace mode) through scan loops; pure
conjugate samplers ignore it. ``wts``/``pts`` may be zero-padded fixed-size
buffers — zero weights contribute nothing, which also covers the reference's
empty-coreset special case (sampling from the prior; zellner_gaussian
main.py:88-91 emulates it with a single zero-weight point).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..models import gaussian as gauss_model
from ..models import linreg as linreg_model
from ..models import logreg as logreg_model
from ..models import poisson as poisson_model
from .laplace import (newton_laplace, newton_laplace_diag,
                      sample_laplace_from_noise)

SamplerFn = Callable  # (key, n, wts, pts, aux) -> (samples, aux)
# Samplers may additionally carry a noise-split pair of attributes:
#     sampler.draw_noise(key, n, wts, pts, aux) -> z   (n, theta_dim) N(0,1)
#     sampler.from_noise(z, wts, pts, aux) -> (samples, aux)
# with sampler(key, n, w, p, a) == from_noise(draw_noise(key, n, w, p, a),
# w, p, a) BIT-IDENTICALLY — each sampler below is literally defined as that
# composition, so the contract cannot drift. ``wts``/``pts``/``aux`` enter
# draw_noise for their shapes/dtypes only (the z dtype must match what the
# composed sampler's arithmetic promotes to, or the pre-drawn stream would
# diverge from the per-step stream — a real bug once: a f32 prior with f64
# data drew f32 noise in the fast path and f64 in the per-step path).
# Builders use the pair to pre-draw a whole refinement loop's noise in ONE
# vmapped call instead of one randn kernel per Adam step; the build loop is
# latency-bound, so each removed per-step kernel is wall-clock off the
# headline build.


def gaussian_conjugate_sampler(mu0, Sig0inv, Siginv) -> SamplerFn:
    """Exact weighted-posterior sampler for the known-covariance Gaussian
    model (reference zellner_gaussian/main.py:87-94, exact instead of the
    reference's wrong-factor-order draw)."""

    def draw_noise(key, n, wts, pts, aux):
        # dtype via the posterior itself (the shape/dtype read costs nothing:
        # XLA CSEs the weighted_post with from_noise's identical call), so the
        # pre-drawn stream matches sample_gaussian_prec's exactly under any
        # input-dtype promotion.
        post = gauss_model.weighted_post(mu0, Sig0inv, Siginv, pts, wts)
        return jax.random.normal(key, (n, post.mu.shape[0]), dtype=post.mu.dtype)

    def from_noise(z, wts, pts, aux):
        post = gauss_model.weighted_post(mu0, Sig0inv, Siginv, pts, wts)
        return gauss_model.sample_gaussian_prec_from_noise(post, z), aux

    def sampler(key, n, wts, pts, aux):
        return from_noise(draw_noise(key, n, wts, pts, aux), wts, pts, aux)

    sampler.draw_noise = draw_noise
    sampler.from_noise = from_noise
    return sampler


def linreg_conjugate_sampler(mu0, Sig0inv, sigsq) -> SamplerFn:
    """Exact weighted-posterior sampler for Bayesian linear regression /
    neural-linear last layer (reference model_neurlinr.py:115-122)."""

    def draw_noise(key, n, wts, pts, aux):
        post = linreg_model.weighted_post(mu0, Sig0inv, sigsq, pts, wts)
        return jax.random.normal(key, (n, post.mu.shape[0]), dtype=post.mu.dtype)

    def from_noise(z, wts, pts, aux):
        post = linreg_model.weighted_post(mu0, Sig0inv, sigsq, pts, wts)
        return gauss_model.sample_gaussian_prec_from_noise(post, z), aux

    def sampler(key, n, wts, pts, aux):
        return from_noise(draw_noise(key, n, wts, pts, aux), wts, pts, aux)

    sampler.draw_noise = draw_noise
    sampler.from_noise = from_noise
    return sampler


def _laplace_noise(key, n, wts, pts, aux):
    """Standard-normal block matching ``sample_laplace``'s internal draw: the
    Laplace mode lives in aux's space, and Newton's arithmetic promotes its
    dtype over (wts, pts, aux) — asserted equal to the fitted ``lap.mu.dtype``
    by tests/test_inference.py (mixed f32/f64 cases), since a mismatch would
    silently fork the pre-drawn stream from the per-step stream."""
    dt = jnp.result_type(wts, pts, aux)
    return jax.random.normal(key, (n, aux.shape[-1]), dtype=dt)


def logreg_laplace_sampler(diag: bool = False, n_newton: int = 8,
                           warm_start: bool = True) -> SamplerFn:
    """Laplace-approximation sampler for Bayesian logistic regression
    (reference zellner_logreg/main.py:139-144). ``aux`` is the previous mode
    (warm start); pass zeros initially."""

    def _fit(wts, pts, aux):
        mu_ws = aux if warm_start else jnp.zeros_like(aux)
        lj = lambda th: logreg_model.log_joint(pts, th, wts)
        g = lambda th: logreg_model.grad_th_log_joint(pts, th, wts)
        if diag:
            dh = lambda th: logreg_model.diag_hess_th_log_joint(pts, th, wts)
            return newton_laplace_diag(lj, g, dh, mu_ws, n_iters=n_newton + 4)
        h = lambda th: logreg_model.hess_th_log_joint(pts, th, wts)
        return newton_laplace(lj, g, h, mu_ws, n_iters=n_newton)

    def from_noise(z, wts, pts, aux):
        lap = _fit(wts, pts, aux)
        return sample_laplace_from_noise(lap, z), lap.mu

    def sampler(key, n, wts, pts, aux):
        return from_noise(_laplace_noise(key, n, wts, pts, aux), wts, pts, aux)

    sampler.draw_noise = _laplace_noise
    sampler.from_noise = from_noise
    # lagged-refit split (IncrementalConfig.refit_every): fit once, reuse
    # the (mu, chol) fit state across several noise transforms
    sampler.fit = _fit
    sampler.from_fit = sample_laplace_from_noise
    sampler.fit_aux = lambda lap: lap.mu
    return sampler


def multiclass_laplace_sampler(n_classes: int, n_newton: int = 12,
                               warm_start: bool = True) -> SamplerFn:
    """Laplace sampler for K-class softmax regression (models/multiclass.py;
    beyond reference — the reference binarizes every multiclass dataset).
    theta is packed (K*d,); gradient and Hessian are the ANALYTIC softmax
    GLM forms (models/multiclass.py, verified equal to autodiff; kept for
    the explicit math and the N-row eval fits where reverse-over-forward
    autodiff would trace the joint K*d times). ``aux`` is the previous packed mode."""
    from ..models import multiclass as mc_model

    lj_of = mc_model.make_log_joint(n_classes)
    g_of = mc_model.make_grad_th_log_joint(n_classes)
    h_of = mc_model.make_hess_th_log_joint(n_classes)

    def _fit(wts, pts, aux):
        mu_ws = aux if warm_start else jnp.zeros_like(aux)
        return newton_laplace(lambda th: lj_of(pts, th, wts),
                              lambda th: g_of(pts, th, wts),
                              lambda th: h_of(pts, th, wts), mu_ws,
                              n_iters=n_newton)

    def from_noise(z, wts, pts, aux):
        lap = _fit(wts, pts, aux)
        return sample_laplace_from_noise(lap, z), lap.mu

    def sampler(key, n, wts, pts, aux):
        return from_noise(_laplace_noise(key, n, wts, pts, aux), wts, pts, aux)

    sampler.draw_noise = _laplace_noise
    sampler.from_noise = from_noise
    # lagged-refit split (IncrementalConfig.refit_every)
    sampler.fit = _fit
    sampler.from_fit = sample_laplace_from_noise
    sampler.fit_aux = lambda lap: lap.mu
    return sampler


def poisson_laplace_sampler(diag: bool = False, n_newton: int = 10,
                            warm_start: bool = True) -> SamplerFn:
    """Laplace sampler for Poisson regression (softplus link). Newton uses
    the expected (Fisher) Hessian — globally negative definite — so this is
    Fisher scoring, the standard GLM fit (models/poisson.py docstring)."""

    def _fit(wts, pts, aux):
        mu_ws = aux if warm_start else jnp.zeros_like(aux)
        lj = lambda th: poisson_model.log_joint(pts, th, wts)
        g = lambda th: poisson_model.grad_th_log_joint(pts, th, wts)
        if diag:
            dh = lambda th: poisson_model.diag_hess_th_log_joint(pts, th, wts)
            return newton_laplace_diag(lj, g, dh, mu_ws, n_iters=n_newton + 4)
        h = lambda th: poisson_model.hess_th_log_joint(pts, th, wts)
        return newton_laplace(lj, g, h, mu_ws, n_iters=n_newton)

    def from_noise(z, wts, pts, aux):
        lap = _fit(wts, pts, aux)
        return sample_laplace_from_noise(lap, z), lap.mu

    def sampler(key, n, wts, pts, aux):
        return from_noise(_laplace_noise(key, n, wts, pts, aux), wts, pts, aux)

    sampler.draw_noise = _laplace_noise
    sampler.from_noise = from_noise
    # lagged-refit split (IncrementalConfig.refit_every): fit once, reuse
    # the (mu, chol) fit state across several noise transforms
    sampler.fit = _fit
    sampler.from_fit = sample_laplace_from_noise
    sampler.fit_aux = lambda lap: lap.mu
    return sampler


def fixed_sampler(samples: jnp.ndarray) -> SamplerFn:
    """Deterministic sampler returning a fixed (S, d) matrix — used by the
    optimally/realistically-tuned Hilbert projectors (reference
    zellner_gaussian/main.py:71-84) and by golden tests that drive the JAX
    and oracle builds down identical trajectories."""

    def sampler(key, n, wts, pts, aux):
        return samples[:n], aux

    return sampler


def prior_gaussian_sampler(mu, LSig) -> SamplerFn:
    """Draws from a fixed Gaussian N(mu, LSig @ LSig.T) regardless of the
    coreset — the 'realistic' mis-tuned projector pattern."""

    def sampler(key, n, wts, pts, aux):
        z = jax.random.normal(key, (n, mu.shape[0]), dtype=mu.dtype)
        return mu + z @ LSig.T, aux

    return sampler
