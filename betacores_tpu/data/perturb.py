"""Data-corruption (fault-injection) generators.

The reference's signature robustness machinery is data-level fault
injection: feature-noise + label-flip corruption at rate ``f_rate``, or a
structured boundary attack (reference examples/common/model_lr.py:44-60 and
model_neurlinr.py:50-66). beta-Cores' whole point is surviving these; the
generators are first-class library members here (SURVEY.md section 5).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .synthetic import gen_synthetic_logreg


def perturb_logreg(key: jax.Array, X: jnp.ndarray, y: jnp.ndarray,
                   noise_x: Tuple[float, float] = (0.0, 5.0), f_rate: float = 0.1,
                   flip: bool = True, structured: bool = False, mean_val: float = 0.1,
                   std_val: float = 1.0, theta_val: float = -1.0):
    """Corrupt a fraction ``f_rate`` of rows (reference model_lr.py:44-60):
    unstructured — replace half the feature columns with N(noise_x) noise on
    one random row subset and flip labels on another; structured — replace
    rows with draws from an adversarial logistic model. Returns
    (X, y, Z=y*X, outlier_idcs)."""
    import numpy as np

    N, D = X.shape
    o = int(N * f_rate)
    kx, ky, kc, kn, ks = jax.random.split(key, 5)
    # Corruption indices are drawn (and uniq'd) HOST-SIDE: jnp.unique is a
    # dynamic-shape op that needs a device-to-host sync, and the index set
    # is bookkeeping, not compute.
    idxx = np.asarray(jax.random.randint(kx, (o,), 0, N)) if o else np.zeros(0, dtype=np.int32)
    if not structured:
        idxy = np.asarray(jax.random.randint(ky, (o,), 0, N)) if o else np.zeros(0, dtype=np.int32)
        cols = jax.random.choice(kc, D, (D // 2,), replace=False)
        noise = noise_x[0] + noise_x[1] * jax.random.normal(kn, (o, D // 2), dtype=X.dtype)
        if o:
            X = X.at[jnp.asarray(idxx)[:, None], cols[None, :]].set(noise)
            if flip:
                jy = jnp.asarray(idxy)
                y = y.at[jy].set(-y[jy])
        out_idx = np.unique(np.concatenate([idxx, idxy])) if o else idxx
    else:
        Xa, ya, _ = gen_synthetic_logreg(ks, o, d=D, mean_val=mean_val,
                                         std_val=std_val, theta_val=theta_val, dtype=X.dtype)
        if o:
            jx = jnp.asarray(idxx)
            X = X.at[jx].set(Xa)
            y = y.at[jx].set(ya)
        out_idx = np.unique(idxx)
    return X, y, y[:, None] * X, out_idx


def perturb_regression(key: jax.Array, X: jnp.ndarray, y: jnp.ndarray,
                       noise_x: Tuple[float, float] = (1.0, 10.0), f_rate: float = 0.1,
                       y_noise: Tuple[float, float] = (0.0, 5.0)):
    """Point-level regression corruption (reference
    model_neurlinr.py:68-78 ``perturb_old``): feature noise on half the
    columns + large-noise response replacement."""
    N, D = X.shape
    o = int(N * f_rate)
    if o == 0:
        return X, y
    kx, kc, kn, kyn = jax.random.split(key, 4)
    idxx = jax.random.randint(kx, (o,), 0, N)
    cols = jax.random.choice(kc, D, (max(D // 2, 1),), replace=False)
    noise = noise_x[0] + noise_x[1] * jax.random.normal(kn, (o, cols.shape[0]), dtype=X.dtype)
    X = X.at[idxx[:, None], cols[None, :]].set(noise)
    y = y.at[idxx, 0].set(y_noise[0] + y_noise[1] * jax.random.normal(kyn, (o,), dtype=y.dtype))
    return X, y


def perturb_groups(key: jax.Array, X: jnp.ndarray, y: jnp.ndarray, groups,
                   noise_x: Tuple[float, float] = (1.0, 1.0), f_rate: float = 0.1,
                   corrupt_frac: float = 0.7, y_noise: Tuple[float, float] = (10.0, 0.5)):
    """Group-targeted corruption (reference model_neurlinr.py:50-66): pick
    f_rate of the groups, corrupt ``corrupt_frac`` of each picked group's
    members. ``groups`` is a list of index lists."""
    import numpy as np

    rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 2**31 - 1)))
    X = np.asarray(X).copy()
    y = np.asarray(y).copy()
    N, D = X.shape
    lg = len(groups)
    o = int(lg * f_rate)
    if o == 0:
        return jnp.asarray(X), jnp.asarray(y)
    picked = rng.choice(lg, size=o)
    rows = np.concatenate([
        rng.choice(np.asarray(groups[g]), size=int(len(groups[g]) * corrupt_frac), replace=False)
        for g in picked
    ]).astype(int)
    cols = rng.choice(D, max(D // 2, 1), replace=False)
    for c in cols:
        X[rows, c] = rng.normal(noise_x[0], noise_x[1], size=len(rows))
    y[rows] = rng.normal(y_noise[0], y_noise[1], size=(len(rows),) + y.shape[1:])
    return jnp.asarray(X), jnp.asarray(y)
