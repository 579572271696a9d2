"""Jitted Laplace approximation via damped Newton.

Replaces the reference's scipy BFGS-with-10-jittered-retries Laplace fit
(reference: examples/zellner_logreg/main.py:86-111, util/opt.py:10-33) with a
fixed-iteration damped Newton solve that is jit/scan-friendly and supports
warm starting — the critical hot-path optimization: the reference re-runs a
cold BFGS inside *every* Adam gradient step of every selection round
(call stack SURVEY.md 3.2).

The target log-joint is concave for all supported models (Gaussian prior +
log-concave likelihood), so Newton with backtracking converges
quadratically; from a warm start 2-3 iterations reach float32 precision.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


class LaplaceApprox(NamedTuple):
    mu: jnp.ndarray          # (d,) mode of the weighted log-joint
    prec_chol: jnp.ndarray   # (d, d) lower chol of -Hessian at the mode
    # diagonal variant: prec_chol holds sqrt(-diag_hess) on the diagonal


# Backtracking grid: candidate step sizes tried per Newton iteration.
# (numpy, not jnp: must not initialize the JAX backend at import time)
import numpy as _np

_TS = _np.asarray([1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625, 0.0078125])


def newton_laplace(
    log_joint: Callable[[jnp.ndarray], jnp.ndarray],
    grad: Callable[[jnp.ndarray], jnp.ndarray],
    hess: Callable[[jnp.ndarray], jnp.ndarray],
    mu0: jnp.ndarray,
    n_iters: int = 8,
) -> LaplaceApprox:
    """Maximize a concave log-joint by damped Newton with a static
    backtracking grid (each candidate evaluation is O(M d) — tiny next to
    the N x S projection work).

    The loop is adaptive: it stops once the Newton decrement
    lambda^2 = g . (-H)^{-1} g falls below ``tol`` relative to |log_joint|
    (affine-invariant; quadratic convergence makes the remaining mode error
    O(lambda^4)). Warm-started refits inside the Adam hot loop therefore pay
    1-2 iterations instead of the full ``n_iters`` budget — measured 2.4x
    off the N=1M headline build — while cold starts keep the full budget.

    The loop is structured so the decrement test runs BEFORE each line
    search, and the line search reuses the previous iteration's best value
    as its f0. The build hot loop is latency-bound (50k dependent refits in
    the headline config), and versus the test-after-stepping form this
    removes one 8-candidate line search plus one log_joint evaluation from
    EVERY refit — a converged-at-entry warm start costs exactly one
    grad+hess+cholesky+solve chain and nothing else. It also means the
    returned ``prec_chol`` is always the exact factor at the returned mode
    for free (an earlier variant carried a one-step-stale factor out of the
    loop to save a refactorization; a lax.cond refactorization was measured
    SLOWER than the factorization it saved — conditionals break fusion in
    the hot loop — all moot now that exactness costs nothing)."""

    def eval_at(mu):
        g = grad(mu)
        H = hess(mu)
        # Newton direction: solve (-H) p = g ; -H is SPD for concave targets.
        L = jnp.linalg.cholesky(-H)
        p = jax.scipy.linalg.cho_solve((L, True), g)
        lam2 = g @ p  # Newton decrement^2: predicted improvement scale
        return L, p, lam2

    f0 = log_joint(mu0)
    L0, p0, lam20 = eval_at(mu0)
    # the body promotes mu through the Newton step (e.g. an f32 warm-start
    # mode against f64 data), so the carry must start at the promoted dtype
    # or while_loop rejects the carry type mismatch
    mu0 = mu0.astype(jnp.result_type(mu0, p0))
    tol = 1e-7 if mu0.dtype == jnp.float64 else 1e-5
    done0 = lam20 <= tol * (1.0 + jnp.abs(f0))

    def cond(carry):
        return (carry[4] < n_iters) & ~carry[5]

    def body(carry):
        mu, f, _, p, it, _ = carry
        # grid cast to the carry dtype: f64 _TS must not promote an f32 mu
        # (scan carry type mismatch under enable_x64)
        cands = mu[None, :] + jnp.asarray(_TS, dtype=mu.dtype)[:, None] * p[None, :]
        vals = jax.vmap(log_joint)(cands)
        vals = jnp.where(jnp.isfinite(vals), vals, -jnp.inf)
        best = jnp.argmax(vals)
        improved = vals[best] > f
        mu_new = jnp.where(improved, cands[best], mu)
        f_new = jnp.where(improved, vals[best], f)
        L2, p2, lam2 = eval_at(mu_new)
        # ~improved exits: retrying the identical step cannot succeed
        done = (lam2 <= tol * (1.0 + jnp.abs(f_new))) | ~improved
        return mu_new, f_new, L2, p2, it + 1, done

    mu, _, L, _, _, _ = jax.lax.while_loop(
        cond, body,
        (mu0, f0, L0, p0, jnp.asarray(0, dtype=jnp.int32), done0))
    return LaplaceApprox(mu=mu, prec_chol=L)


def newton_laplace_diag(
    log_joint: Callable,
    grad: Callable,
    diag_hess: Callable,
    mu0: jnp.ndarray,
    n_iters: int = 12,
) -> LaplaceApprox:
    """Diagonal-Hessian variant (reference ``graddiag`` flag,
    zellner_logreg/main.py:104-106): Newton direction g / (-diag_hess),
    covariance approximated as diag(1 / -diag_hess)."""

    def body(mu, _):
        g = grad(mu)
        dh = diag_hess(mu)
        p = g / (-dh)
        cands = mu[None, :] + jnp.asarray(_TS, dtype=mu.dtype)[:, None] * p[None, :]
        vals = jax.vmap(log_joint)(cands)
        vals = jnp.where(jnp.isfinite(vals), vals, -jnp.inf)
        best = jnp.argmax(vals)
        improved = vals[best] > log_joint(mu)
        return jnp.where(improved, cands[best], mu), None

    # promote the carry as in newton_laplace (f32 warm start vs f64 data)
    mu0 = mu0.astype(jnp.result_type(mu0, grad(mu0)))
    mu, _ = jax.lax.scan(body, mu0, None, length=n_iters)
    L = jnp.diag(jnp.sqrt(-diag_hess(mu)))
    return LaplaceApprox(mu=mu, prec_chol=L)


def sample_laplace_from_noise(lap: LaplaceApprox, z: jnp.ndarray) -> jnp.ndarray:
    """theta = mu + L^{-T} z for pre-drawn standard normals z (n, d): the
    noise-in half of ``sample_laplace``, used by builders that pre-draw the
    whole refinement loop's noise in one vmapped call (bit-identical values,
    one kernel instead of one per step)."""
    return lap.mu + solve_triangular(lap.prec_chol.T, z.T, lower=False).T


def sample_laplace(key: jax.Array, lap: LaplaceApprox, n_samples: int) -> jnp.ndarray:
    """(S, d) draws theta = mu + L^{-T} z with the *correct* covariance
    Sig = L^{-T} L^{-1} = (-H)^{-1}. (The reference draws mu + z @ LSig.T
    with LSig = L^{-1}, i.e. covariance L^{-1} L^{-T} — the factor-order bug
    documented in models/gaussian.py; not reproduced.)"""
    d = lap.mu.shape[0]
    z = jax.random.normal(key, (n_samples, d), dtype=lap.mu.dtype)
    return sample_laplace_from_noise(lap, z)
