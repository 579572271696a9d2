"""Sampling-based snnls baselines.

Spec: reference bayesiancoresets/snnls/sampling.py. Importance sampling with
p_n proportional to ||A_n|| (uniform for UniformSampling); after ``itrs``
draws the weights are w = (counts / total) / p. The reference draws
sequentially from the global numpy stream, but the result depends only on
the multiset of draws, so the jitted build vectorizes all draws into one
``jax.random.choice`` + bincount — an exact semantic match and one
device op. Monotone-error checking is disabled (reference sampling.py:16).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.logging import get_logger
from ..utils.prng import KeySequence, key_from_seed


def sampling_build(key: jax.Array, ps: jnp.ndarray, counts: jnp.ndarray, itrs,
                   cap: int | None = None):
    """Draw ``itrs`` indices from p and fold them into running counts;
    returns (counts, w) with w = (counts/sum) / ps.

    ``cap`` (static) is the draw-buffer capacity: ``itrs`` itself is a
    TRACED operand — ``cap`` draws are made and the first ``itrs`` counted
    (mask-weighted bincount), so one compiled program serves every build
    size up to ``cap`` (a ``build(1, m)`` driver loop would otherwise
    recompile per size; distribution-identical to drawing exactly ``itrs``,
    which is this class's documented contract vs the reference's sequential
    stream)."""
    cap = int(cap if cap is not None else itrs)
    draws = jax.random.choice(key, ps.shape[0], shape=(cap,), p=ps)
    mask = (jnp.arange(cap) < itrs).astype(ps.dtype)
    counts = counts + jnp.bincount(draws, weights=mask,
                                   length=ps.shape[0]).astype(ps.dtype)
    w = (counts / jnp.sum(counts)) / ps
    return counts, w


# ps/counts are jit ARGUMENTS (CLAUDE.md: never close a jitted program over
# dataset-sized arrays — round-3 review) and the module-level program is
# shared across instances; only the rarely-changing capacity is static.
_jit_sampling_build = jax.jit(sampling_build, static_argnums=4)


def _round_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


class ImportanceSampling:
    """Eager wrapper mirroring the reference API (plus an explicit seed)."""

    check_error_monotone = False

    def __init__(self, A, b, seed: int | jax.Array = 0):
        self.A = jnp.asarray(A)
        self.b = jnp.asarray(b)
        self.log = get_logger(self.__class__.__name__)
        self.keys = KeySequence(key_from_seed(seed))
        self.ps = self._probs()
        self.counts = jnp.zeros(self.A.shape[1], dtype=self.A.dtype)
        self.w = jnp.zeros(self.A.shape[1], dtype=self.A.dtype)
        self.reached_numeric_limit = False

    def _probs(self):
        ps = jnp.sqrt(jnp.sum(self.A * self.A, axis=0))
        total = jnp.sum(ps)
        n = self.A.shape[1]
        return jnp.where(total > 0, ps / total, jnp.ones(n, dtype=self.A.dtype) / n)

    def reset(self):
        self.counts = jnp.zeros_like(self.counts)
        self.w = jnp.zeros_like(self.w)
        self.reached_numeric_limit = False

    def size(self) -> int:
        return int((self.w > 0).sum())

    def weights(self) -> np.ndarray:
        return np.asarray(self.w).copy()

    def error(self) -> float:
        return float(jnp.linalg.norm(self.A @ self.w - self.b))

    def build(self, itrs: int) -> None:
        self.counts, self.w = _jit_sampling_build(
            self.keys(), self.ps, self.counts, int(itrs),
            _round_pow2(int(itrs)))

    def optimize(self) -> None:  # parity: reference inherits the nnls re-solve
        from .base import optimize as _opt

        w_new, rolled_back = _opt(self.A, self.b, self.w, min(self.A.shape))
        self.w = w_new
        if bool(rolled_back):
            self.reached_numeric_limit = True


class UniformSampling(ImportanceSampling):
    def _probs(self):
        n = self.A.shape[1]
        return jnp.ones(n, dtype=self.A.dtype) / n
