"""Accelerated Iterative Hard Thresholding for Bayesian coresets.

Beyond-reference solver from "Bayesian Coresets: Revisiting the Nonconvex
Optimization Perspective" (arXiv:2007.00715): instead of growing a support
greedily one column per step (GIGA/FW/OMP — reference snnls/*), attack

    min_w ||b - A w||^2   s.t.   ||w||_0 <= K,  w >= 0

directly with projected gradient + momentum (A-IHT II style):

  g      = A^T (b - A z)
  eta    = ||g_U||^2 / ||A g_U||^2  restricted to the union support U of the
           current iterate and the top-K positive gradient coordinates
           (the paper's exact line search on the active subspace)
  w'     = P_{K,+}(z + eta g)          nonneg hard threshold
  debias: one more exact-step projected gradient restricted to supp(w')
  z'     = w' + tau (w' - w_prev)      FISTA-style momentum, tau = t/(t+3)

The iterate can move ALL K weights (and swap support atoms) every step, so
at equal sparsity it typically reaches lower ||Aw - b|| than the greedy
solvers (tested); the reference's one-per-step greedy semantics do not
apply.

Shape: every step is two (N,)-vector matvecs against A plus masked
reductions — the same pattern as GIGA. The nonneg top-K projection
ranks by a stable argsort (ties -> lower index, the framework's
distributed-argmax convention) so the sparsity budget K can stay a TRACED
operand: one compiled program serves every K (latency rules in CLAUDE.md).

Eager semantics: ``build(itrs)`` ADDS ``itrs`` to the sparsity budget K and
re-solves (``inner_itrs`` accelerated steps, warm-started from the current
iterate); the best-error iterate is kept, so error is non-increasing across
calls like the greedy solvers. ``build_trace(itrs)`` records the solution at
each intermediate budget K+1..K+itrs (row m-1 = weights at total budget m,
matching the greedy solvers' per-size trace contract).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .base import SparseNNLS


def project_nonneg_topk(x: jnp.ndarray, K) -> jnp.ndarray:
    """Euclidean projection onto {w >= 0, ||w||_0 <= K}: clip to >= 0, keep
    the K largest (stable rank: exact ties resolve to the lower index). K
    may be traced."""
    xp = jnp.maximum(x, 0.0)
    order = jnp.argsort(-xp)  # stable -> ties keep lower index first
    rank = jnp.zeros(x.shape[0], dtype=jnp.int32).at[order].set(
        jnp.arange(x.shape[0], dtype=jnp.int32))
    return jnp.where(rank < K, xp, 0.0)


class IHTState(NamedTuple):
    w: jnp.ndarray
    w_prev: jnp.ndarray
    z: jnp.ndarray
    best_w: jnp.ndarray
    best_err: jnp.ndarray


def _exact_step(A, r, g, mask):
    """Exact line-search step size on the masked subspace:
    eta = ||g_m||^2 / ||A g_m||^2 (zero-gradient guard -> 0)."""
    gm = jnp.where(mask, g, 0.0)
    num = jnp.sum(gm * gm)
    Agm = A @ gm
    den = jnp.sum(Agm * Agm)
    return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0), gm


def aiht_solve(A: jnp.ndarray, b: jnp.ndarray, K, w0: jnp.ndarray,
               inner_itrs) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run ``inner_itrs`` accelerated-IHT steps at sparsity budget K from
    warm start w0. Returns (best_w, best_err); K and inner_itrs may be
    traced.

    Column-norm preconditioning: iterate in v = ||a_i|| w_i over unit
    columns (the l0 constraint and w >= 0 are invariant under the diagonal
    rescale; gradient steps are far better conditioned — GIGA gets the same
    effect from its sphere normalization)."""
    norms = jnp.sqrt(jnp.sum(A * A, axis=0))
    safe = jnp.where(norms > 0, norms, 1.0)
    A = A / safe[None, :]
    w0 = w0 * safe
    dtype = A.dtype
    w0 = project_nonneg_topk(w0, K)
    err0 = jnp.linalg.norm(A @ w0 - b)

    def body(t, st: IHTState) -> IHTState:
        r = b - A @ st.z
        g = A.T @ r
        # union support: current iterate + top-K positive-gradient coords
        cand = project_nonneg_topk(g, K) > 0
        mask = jnp.logical_or(st.z > 0, cand)
        eta, _ = _exact_step(A, r, g, mask)
        w_new = project_nonneg_topk(st.z + eta * g, K)
        # debias: a few exact projected-gradient steps on the FIXED new
        # support (cheap matvecs; approximates the restricted least-squares
        # re-solve that makes hard-thresholding competitive with greedy)
        supp = w_new > 0

        def debias(_, w):
            r2 = b - A @ w
            g2 = A.T @ r2
            eta2, g2m = _exact_step(A, r2, g2, supp)
            return jnp.maximum(w + eta2 * g2m, 0.0)

        w_new = jax.lax.fori_loop(0, 5, debias, w_new)
        # exact momentum (paper Alg. 2): tau minimizing ||b - A z|| along the
        # momentum direction, clipped to [0, 1] (FISTA schedules overshoot on
        # ill-conditioned supports), with adaptive restart: a non-improving
        # step drops the momentum entirely (O'Donoghue-Candes restart)
        dw = w_new - st.w
        Adw = A @ dw
        den_m = jnp.sum(Adw * Adw)
        err = jnp.linalg.norm(A @ w_new - b)
        tau = jnp.where(den_m > 0,
                        jnp.sum((b - A @ w_new) * Adw) / jnp.where(den_m > 0, den_m, 1.0),
                        0.0)
        tau = jnp.where(err <= st.best_err, jnp.clip(tau, 0.0, 1.0), 0.0)
        z_new = w_new + tau * dw
        better = err < st.best_err
        return IHTState(
            w=w_new, w_prev=st.w, z=z_new,
            best_w=jnp.where(better, w_new, st.best_w),
            best_err=jnp.minimum(err, st.best_err),
        )

    st0 = IHTState(w=w0, w_prev=w0, z=w0, best_w=w0, best_err=err0)
    st = jax.lax.fori_loop(0, inner_itrs, body, st0)
    return st.best_w / safe, st.best_err


def aiht_solve_hybrid(A: jnp.ndarray, b: jnp.ndarray, K, w0: jnp.ndarray,
                      inner_itrs, tol=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """GIGA-initialized A-IHT: run K greedy GIGA steps from scratch, take
    the better of (greedy solution, warm start w0), refine with IHT.

    IHT's projected-gradient landscape has bad local minima on some
    geometries (measured: pure IHT beats GIGA on only ~3 of 8 random
    problems, with 2-5x error swings either way); seeding with the greedy
    solution makes the result provably no worse than GIGA at equal sparsity
    (best-so-far includes the seed) while keeping IHT's ability to SWAP
    support atoms, which greedy construction can never do."""
    from .base import build as greedy_build
    from .giga import giga_precompute, giga_step

    pre = giga_precompute(A, b)
    err_fn = lambda w: jnp.linalg.norm(A @ w - b)
    # tol is threaded as an OPERAND so set_tolerance() between builds
    # affects already-compiled programs (snnls/base.py contract; a None
    # default here would bake errors.TOL in at trace time — round-3 review)
    gst = greedy_build(lambda w: giga_step(pre, w, tol), err_fn,
                       jnp.zeros_like(w0), K)
    w_init = jnp.where(err_fn(gst.w) < err_fn(w0), gst.w, w0)
    return aiht_solve(A, b, K, w_init, inner_itrs)


class AccIHT(SparseNNLS):
    """Eager wrapper with the shared snnls surface. ``build(itrs)`` grows
    the sparsity budget by ``itrs`` and re-solves (see module docstring);
    ``optimize()`` is the inherited exact NNLS re-solve on the final
    support. ``init='giga'`` (default) seeds every solve with a greedy GIGA
    run — never worse than GIGA at equal sparsity; ``init='zero'`` is the
    paper's pure A-IHT."""

    def __init__(self, A, b, max_support: int | None = None,
                 inner_itrs: int = 100, init: str = "giga"):
        if init not in ("giga", "zero"):
            raise ValueError(f"init must be 'giga' or 'zero', got {init!r}")
        self.inner_itrs = int(inner_itrs)
        self.K = 0
        super().__init__(A, b, max_support=max_support)
        if init == "giga" and bool(jnp.any(jnp.sum(self.A * self.A, axis=0) == 0)):
            raise ValueError("AccIHT(init='giga'): A must not have zero columns")
        if init == "giga":
            solve = aiht_solve_hybrid
        else:
            solve = lambda A, b, K, w0, inner, tol: aiht_solve(A, b, K, w0, inner)

        def _trace(A, b, Ks, w0, inner, tol):
            def body(w, K):
                w_new, _ = solve(A, b, K, w, inner, tol)
                return w_new, w_new

            return jax.lax.scan(body, w0, Ks)

        self._jit_solve = jax.jit(solve)
        self._jit_solve_trace = jax.jit(_trace)

    def _precompute(self):
        return None

    def _step_pre(self, pre, w, tol=None):  # pragma: no cover - greedy path unused
        raise NotImplementedError("AccIHT overrides build()")

    def reset(self):
        super().reset()
        self.K = 0

    def build(self, itrs: int) -> None:
        if self.reached_numeric_limit:
            self.log.warning("numeric limit already reached; returning")
            return
        if self.A.size == 0:
            self.log.warning("no data; returning")
            return
        self.K = min(self.K + int(itrs), self.max_support)
        # aiht_solve seeds best-so-far with the warm start, so the returned
        # iterate never has higher error than self.w (monotone contract)
        from ..utils import errors
        self.w, _ = self._jit_solve(self.A, self.b, jnp.asarray(self.K),
                                    self.w, jnp.asarray(self.inner_itrs),
                                    jnp.asarray(errors.TOL, self.A.dtype))

    def build_trace(self, itrs: int) -> jnp.ndarray:
        """(itrs, N) weights at budgets K+1..K+itrs, one device program."""
        K0 = self.K
        Ks = jnp.minimum(jnp.arange(K0 + 1, K0 + int(itrs) + 1), self.max_support)
        from ..utils import errors
        w_final, ws = self._jit_solve_trace(self.A, self.b, Ks, self.w,
                                            jnp.asarray(self.inner_itrs),
                                            jnp.asarray(errors.TOL, self.A.dtype))
        self.K = int(Ks[-1])
        self.w = w_final
        return ws
