"""Sparse non-negative least squares: functional core + eager API.

Spec: reference bayesiancoresets/snnls/snnls.py:8-106. Solves
min_w ||A w - b||, w >= 0, growing support greedily one column per
iteration. The reference's failure contract (snnls.py:40-79) — on a
numerics failure revert weights, stabilize, retry once, then latch
``reached_numeric_limit`` and stop growing — is preserved exactly, but as
branch-free ``lax`` control flow carrying (w, retried, latched) instead of
exceptions (SURVEY.md section 7 delta 5).

A solver provides a pure ``step(w) -> (w_new, ok)`` combining the
reference's ``_select`` + ``_reweight``; the shared :func:`build` driver
adds the monotone-error check and retry/latch logic. Eager class wrappers
at the bottom mirror the reference's OO API.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import errors
from ..utils.errors import NumericalPrecisionError
from ..utils.logging import get_logger
from .nnls import nnls_on_support


class BuildState(NamedTuple):
    w: jnp.ndarray
    retried: jnp.ndarray  # bool: last iteration failed once already
    latched: jnp.ndarray  # bool: reached_numeric_limit


StepFn = Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]]


def _iterate(st: BuildState, step_fn: StepFn, error_fn: Callable,
             check_monotone: bool) -> BuildState:
    """One guarded greedy iteration: select/reweight with monotone-error
    check, revert-once retry, latch (reference snnls.py:31-79)."""

    def active(st: BuildState) -> BuildState:
        had_support = jnp.any(st.w > 0)
        prev_err = error_fn(st.w)
        w_new, ok = step_fn(st.w)
        mono_fail = jnp.logical_and(
            jnp.asarray(check_monotone), jnp.logical_and(had_support, error_fn(w_new) > prev_err)
        )
        fail = jnp.logical_or(jnp.logical_not(ok), mono_fail)
        return BuildState(
            w=jnp.where(fail, st.w, w_new),
            retried=jnp.logical_and(fail, jnp.logical_not(st.retried)),
            latched=jnp.logical_or(st.latched, jnp.logical_and(fail, st.retried)),
        )

    return jax.lax.cond(st.latched, lambda s: s, active, st)


def build(step_fn: StepFn, error_fn: Callable, w0: jnp.ndarray, itrs,
          check_monotone: bool = True) -> BuildState:
    """Run ``itrs`` greedy iterations (reference snnls.py:31-79 loop).

    A failed iteration consumes an iteration slot, exactly like the
    reference's try/except inside ``for i in range(itrs)``. ``itrs`` may be a
    traced scalar: the loop lowers to a while_loop, so ONE compiled program
    serves every requested iteration count (compilations cost seconds —
    this matters more than unrolling).
    """

    def body(_, st: BuildState) -> BuildState:
        return _iterate(st, step_fn, error_fn, check_monotone)

    st0 = BuildState(w=w0, retried=jnp.asarray(False), latched=jnp.asarray(False))
    return jax.lax.fori_loop(0, itrs, body, st0)


def build_trace(step_fn: StepFn, error_fn: Callable, w0: jnp.ndarray, itrs: int,
                check_monotone: bool = True) -> Tuple[jnp.ndarray, BuildState]:
    """Like :func:`build` but records the weight vector after every
    iteration, returning ((itrs, N) weights, final state) — ONE device
    program for a whole incremental build loop. Eliminates the per-size
    host<->device round trips of ``for m: build(1, m); get()`` driver
    loops. ``itrs`` is static (output shape)."""

    def body(st: BuildState, _):
        st = _iterate(st, step_fn, error_fn, check_monotone)
        return st, st.w

    st0 = BuildState(w=w0, retried=jnp.asarray(False), latched=jnp.asarray(False))
    st, ws = jax.lax.scan(body, st0, None, length=itrs)
    return ws, st


def optimize(A: jnp.ndarray, b: jnp.ndarray, w: jnp.ndarray, max_support: int,
             n_iters: int = 400, tol=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Post-build exact weight re-solve on the active support with
    cost-increase rollback (reference snnls.py:82-97, scipy ``nnls``
    replaced by the jitted solver in snnls/nnls.py).

    Returns (w_new, rolled_back). ``tol`` is a traced operand (defaults to
    the current ``errors.TOL`` at trace time; the eager API threads the
    live value through so ``set_tolerance()`` affects compiled programs)."""
    if tol is None:
        tol = errors.TOL
    prev_err = jnp.linalg.norm(A @ w - b)
    w_new = nnls_on_support(A, b, w > 0, max_support, n_iters=n_iters)
    new_err = jnp.linalg.norm(A @ w_new - b)
    ok = new_err <= prev_err * (1.0 + tol)
    return jnp.where(ok, w_new, w), jnp.logical_not(ok)


# --------------------------------------------------------------------------
# Eager object API (reference-compatible surface)
# --------------------------------------------------------------------------


class SparseNNLS:
    """Eager wrapper with the reference's interface: ``build(itrs)``,
    ``optimize()``, ``weights()``, ``error()``, ``size()``, ``reset()``,
    ``reached_numeric_limit`` (reference snnls/snnls.py:8-106)."""

    check_error_monotone = True

    def __init__(self, A, b, max_support: int | None = None):
        try:
            A = jnp.asarray(A)
            b = jnp.asarray(b)
        except (TypeError, ValueError) as e:
            # reference contract: garbage input raises ValueError
            raise ValueError(f"A, b must be numeric arrays: {e}") from None
        if A.dtype.kind not in "fiu" or b.dtype.kind not in "fiu":
            raise ValueError(f"A, b must be numeric, got {A.dtype}, {b.dtype}")
        if A.ndim != 2 or b.ndim != 1 or A.shape[0] != b.shape[0]:
            raise ValueError("A must be (D, N) and b (D,)")
        self.A = A
        self.b = b
        self.max_support = int(max_support) if max_support is not None else min(A.shape)
        self.log = get_logger(self.__class__.__name__)
        self._pre = self._precompute()
        self.w = jnp.zeros(A.shape[1], dtype=A.dtype)
        self.reached_numeric_limit = False
        # pre/A/b are jit ARGUMENTS: closed-over matrices embed into the
        # compiled program as constants (an N-column A -> huge HLO, slow
        # compiles, one cache entry per dataset). itrs stays a traced
        # operand so one compilation serves all build sizes.
        # tol is a traced OPERAND of every compiled entry (not a trace-time
        # capture of the mutable errors.TOL): set_tolerance() between builds
        # affects already-compiled programs without retracing.
        self._jit_build = jax.jit(
            lambda pre, A, b, w0, itrs, tol: build(
                lambda w: self._step_pre(pre, w, tol),
                lambda w: jnp.linalg.norm(A @ w - b),
                w0, itrs, self.check_error_monotone),
        )
        self._jit_trace = jax.jit(
            lambda pre, A, b, w0, itrs, tol: build_trace(
                lambda w: self._step_pre(pre, w, tol),
                lambda w: jnp.linalg.norm(A @ w - b),
                w0, itrs, self.check_error_monotone),
            static_argnums=4,
        )
        self._jit_optimize = jax.jit(
            lambda A, b, w, tol: optimize(A, b, w, self.max_support, tol=tol))

    # --- subclass hooks ---
    def _precompute(self):
        return None

    def _step_pre(self, pre, w, tol):
        """One select+reweight step from the (traced) precompute pytree.
        ``tol`` is the traced numeric tolerance operand (solvers that don't
        use it just ignore it)."""
        raise NotImplementedError

    # --- shared ---
    def _error(self, w):
        return jnp.linalg.norm(self.A @ w - self.b)

    def reset(self):
        self.w = jnp.zeros(self.A.shape[1], dtype=self.A.dtype)
        self.reached_numeric_limit = False

    def size(self) -> int:
        return int((self.w > 0).sum())

    def weights(self) -> np.ndarray:
        return np.asarray(self.w).copy()

    def error(self) -> float:
        return float(self._error(self.w))

    def build(self, itrs: int) -> None:
        if self.reached_numeric_limit:
            self.log.warning("numeric limit already reached; returning")
            return
        if self.A.size == 0:
            self.log.warning("no data; returning")
            return
        st = self._jit_build(self._pre, self.A, self.b, self.w, int(itrs),
                             jnp.asarray(errors.TOL, dtype=self.A.dtype))
        self.w = st.w
        if bool(st.latched):
            self.reached_numeric_limit = True
            self.log.warning(
                "numeric limit reached: size=%d error=%g", self.size(), self.error()
            )

    def build_trace(self, itrs: int) -> jnp.ndarray:
        """Run ``itrs`` iterations recording the weight vector after each:
        returns an on-device (itrs, N) array whose row m-1 equals the
        weights after ``build`` of m total iterations. Advances this
        solver's state to the final iteration."""
        ws, st = self._jit_trace(self._pre, self.A, self.b, self.w, int(itrs),
                                 jnp.asarray(errors.TOL, dtype=self.A.dtype))
        self.w = st.w
        if bool(st.latched):
            self.reached_numeric_limit = True
        return ws

    def optimize(self) -> None:
        w_new, rolled_back = self._jit_optimize(self.A, self.b, self.w,
                                                jnp.asarray(errors.TOL, dtype=self.A.dtype))
        self.w = w_new
        if bool(rolled_back):
            self.reached_numeric_limit = True
            self.log.warning("optimize() increased cost; rolled back and latched")
