"""GIGA: Greedy Iterative Geodesic Ascent.

Spec: reference bayesiancoresets/snnls/giga.py (Campbell & Broderick 2018).
Works on the unit sphere: columns of A and the target b are normalized; each
iteration picks the column maximizing the geodesic-alignment score
< An, cdir > / sqrt(1 - <An, xw>^2) where cdir is the (normalized) component
of bn orthogonal to the current iterate direction xw, then takes a
closed-form geodesic step and rescales by the optimal projection onto b.

Shape: the select phase is one (N, D) x (D, 2) matmul over the full
column block, followed by elementwise masking and a single argmax — a
fully-materialized ``lax``-loop design.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..utils import errors
from .base import SparseNNLS


class GigaPre(NamedTuple):
    A: jnp.ndarray       # (D, N)
    An: jnp.ndarray      # (D, N) unit columns
    bn: jnp.ndarray      # (D,) unit target
    bnorm: jnp.ndarray   # scalar


def giga_precompute(A: jnp.ndarray, b: jnp.ndarray) -> GigaPre:
    norms = jnp.sqrt(jnp.sum(A * A, axis=0))
    bnorm = jnp.linalg.norm(b)
    return GigaPre(A=A, An=A / norms[None, :], bn=b / bnorm, bnorm=bnorm)


def geodesic_reweight(xw, nw, xwn, xf, wf_old, bn, bnorm):
    """Closed-form geodesic step scalars (reference giga.py:40-64), shared
    by the single-device step and the distributed step in
    parallel/hilbert.py (whose exact-equality contract depends on both
    using THIS math). Returns (a, scale, new_wf, ok_geo): the global weight
    rescale is ``a * scale * w`` and the selected column's new weight is
    ``new_wf``. Zero-norm guards make degenerate inputs yield finite values
    with ok_geo=False (the reference raises NumericalPrecisionError)."""
    nf_raw = jnp.linalg.norm(xf)
    nf = jnp.where(nf_raw == 0.0, 1.0, nf_raw)
    xfn = xf / nf
    bn_f = bn @ xfn
    bn_w = bn @ xwn
    f_w = xwn @ xfn
    gA = bn_f - bn_w * f_w
    gB = bn_w - bn_f * f_w
    ok_geo = jnp.logical_and(gA > 0.0, gB >= 0.0)
    gsum = jnp.where(gA + gB == 0.0, 1.0, gA + gB)
    a = gB / gsum / nw
    bcoef = gA / gsum / nf
    x = a * xw + bcoef * xf
    nx = jnp.where(jnp.linalg.norm(x) == 0.0, 1.0, jnp.linalg.norm(x))
    scale = bnorm / nx * ((x / nx) @ bn)
    new_wf = jnp.maximum(0.0, wf_old * a * scale + bcoef * scale)
    return a, scale, new_wf, ok_geo


def giga_step(pre: GigaPre, w: jnp.ndarray, tol=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One select+reweight step (reference giga.py:20-64). Returns
    (w_new, ok); any degenerate-geometry condition the reference signals via
    NumericalPrecisionError maps to ok=False with w_new unused. ``tol`` is a
    TRACED operand (defaults to the current ``errors.TOL``) so
    ``set_tolerance()`` affects already-compiled programs when the caller
    threads it through, per the eager API contract."""
    if tol is None:
        tol = errors.TOL
    A, An, bn, bnorm = pre

    # --- select (giga.py:20-38) ---
    xw = A @ w
    nw_raw = jnp.linalg.norm(xw)
    nw = jnp.where(nw_raw == 0.0, 1.0, nw_raw)
    xwn = xw / nw
    cdir = bn - (bn @ xwn) * xwn
    cnrm = jnp.linalg.norm(cdir)
    ok_select = cnrm >= tol
    cdirn = cdir / jnp.where(cnrm == 0.0, 1.0, cnrm)
    num = An.T @ cdirn
    dxw = An.T @ xwn
    stable = jnp.logical_and(dxw > -1.0 + 1e-14, 1.0 - dxw * dxw > 0.0)
    denom = jnp.where(stable, jnp.sqrt(jnp.maximum(1.0 - dxw * dxw, 0.0)), jnp.inf)
    f = jnp.argmax(num / denom)

    # --- reweight (giga.py:40-64) ---
    a, scale, new_wf, ok_geo = geodesic_reweight(xw, nw, xwn, A[:, f], w[f], bn, bnorm)
    w_new = a * scale * w
    w_new = w_new.at[f].set(new_wf)
    ok = jnp.logical_and(ok_select, ok_geo)
    return w_new, ok


class GIGA(SparseNNLS):
    def _precompute(self) -> GigaPre:
        norms = jnp.sqrt(jnp.sum(self.A * self.A, axis=0))
        if bool(jnp.any(norms == 0)):
            raise ValueError("GIGA: A must not have any zero columns")
        if float(jnp.linalg.norm(self.b)) == 0.0:
            raise errors.NumericalPrecisionError("GIGA: norm of b must be > 0")
        return giga_precompute(self.A, self.b)

    def _step_pre(self, pre, w, tol):
        return giga_step(pre, w, tol)
