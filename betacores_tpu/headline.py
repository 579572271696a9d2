"""The reference's headline logistic-regression build (reference
zellner_logreg/main.py:115-127), defined once for every script that runs it
(``bench.py``, ``chip_smoke.py``, ``examples/trace_build.py``):

N=1,000,000 rows of ``gen_synthetic_logreg`` at d=10, 10% of them corrupted
by ``perturb_logreg``; M=100 selections; S=100 projection samples; 500 Adam
steps per selection; n_subsample_select=1000, n_subsample_opt=200; beta=0.1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .coresets import IncrementalConfig
from .data import gen_synthetic_logreg, perturb_logreg

N, D, M, S = 1_000_000, 10, 100, 100
N_SEL, N_OPT, OPT_ITRS, BETA = 1000, 200, 500, 0.1
F_RATE = 0.1
M_BUF = 128          # coreset buffer rows of the state (init_state)


def data(key: jax.Array, n: int = N, dtype=jnp.float32) -> jax.Array:
    """The contaminated rows Z = y * X, shape (n, D)."""
    kx, kp = jax.random.split(key)
    X, y, _ = gen_synthetic_logreg(kx, n, d=D, dtype=dtype)
    _, _, Z, _ = perturb_logreg(kp, X, y, f_rate=F_RATE)
    return Z


def config(**overrides) -> IncrementalConfig:
    """The headline ``IncrementalConfig``; ``overrides`` replace its fields."""
    kw = dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
              opt_itrs=OPT_ITRS, i0=1.0, use_beta=True)
    kw.update(overrides)
    return IncrementalConfig(**kw)
