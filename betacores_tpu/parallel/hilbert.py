"""Sharded Hilbert coreset: data-parallel projection + distributed GIGA.

Scale-out counterpart of ``coresets.HilbertCoreset`` (reference
coreset/hilbert.py + snnls/giga.py): the (N, S) projection matrix is
row-sharded over the mesh's ``data`` axis, and every GIGA iteration runs as

  * LOCAL column scoring: each shard scores its own rows against the
    replicated geodesic direction (one (N_loc, S) x (S, 2) matmul);
  * DISTRIBUTED ARGMAX: per-shard top-1, then an all_gather('data') of
    (score, row, weight, global index) candidates and a replicated argmax.
    The gathered order is shard order, so ``jnp.argmax``'s first-max rule
    breaks exact ties toward the lower shard — identical to the
    single-device first-argmax under the same row ordering (SURVEY.md hard
    part 5), which makes the sharded build EXACTLY equivalent to the
    single-device solve (same floats in f64, not just statistically);
  * REPLICATED geodesic reweight: the closed-form (alpha, beta) step is a
    handful of scalars; the S-dim iterate ``xw`` is one psum('data').

The monotone-error / revert / stabilize-retry / latch failure contract is
inherited unchanged from ``snnls.base.build`` — its state (w, retried,
latched) is (sharded, replicated, replicated) and all its control flow is
replicated, so the same driver runs inside ``shard_map``.

The ``samp`` axis, if present in the mesh, is pure replication here: S for
Hilbert builds is small (100-500) and every shard needs full-S rows for the
argmax, so sharding S would only add collectives to the scoring matmul.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..ops.projection import project_beta, project_ll
from ..snnls import base as snnls_base
from ..snnls.giga import geodesic_reweight
from ..utils import errors
from .mesh import DATA_AXIS, require_axes


def _tangent_error_local(vecs_loc, b, w_loc):
    """||psum(w @ vecs) - b||: the ONE residual definition shared by the
    build-time monotone check and the public error() (they must not
    diverge)."""
    return jnp.linalg.norm(jax.lax.psum(w_loc @ vecs_loc, DATA_AXIS) - b)


def _giga_step_local(vecs_loc, norms_loc, selectable, bn, bnorm, tol, w_loc):
    """One distributed GIGA select+reweight (reference snnls/giga.py:20-64).

    ``vecs_loc`` is this shard's (N_loc, S) row block with padding rows
    zeroed; ``selectable`` masks rows that may win the argmax (valid and
    nonzero-norm). Returns (w_loc_new, ok) with replicated ``ok``."""
    safe_norms = jnp.where(norms_loc > 0, norms_loc, jnp.inf)

    # --- select ---
    xw = jax.lax.psum(w_loc @ vecs_loc, DATA_AXIS)          # (S,) replicated
    nw_raw = jnp.linalg.norm(xw)
    nw = jnp.where(nw_raw == 0.0, 1.0, nw_raw)
    xwn = xw / nw
    cdir = bn - (bn @ xwn) * xwn
    cnrm = jnp.linalg.norm(cdir)
    ok_select = cnrm >= tol
    cdirn = cdir / jnp.where(cnrm == 0.0, 1.0, cnrm)
    num = (vecs_loc @ cdirn) / safe_norms
    dxw = (vecs_loc @ xwn) / safe_norms
    stable = jnp.logical_and(dxw > -1.0 + 1e-14, 1.0 - dxw * dxw > 0.0)
    denom = jnp.where(stable, jnp.sqrt(jnp.maximum(1.0 - dxw * dxw, 0.0)), jnp.inf)
    scores = jnp.where(selectable, num / denom, -jnp.inf)

    best = jnp.argmax(scores)
    sc_g = jax.lax.all_gather(scores[best], DATA_AXIS)       # (n_data,)
    xf_g = jax.lax.all_gather(vecs_loc[best], DATA_AXIS)     # (n_data, S)
    wf_g = jax.lax.all_gather(w_loc[best], DATA_AXIS)
    win = jnp.argmax(sc_g)                                   # ties -> lower shard
    xf, wf_old = xf_g[win], wf_g[win]

    # --- reweight (replicated scalars; the SAME closed form as the
    # single-device solver — the exact-equality contract) ---
    a, scale, new_wf, ok_geo = geodesic_reweight(xw, nw, xwn, xf, wf_old, bn, bnorm)
    w_new = a * scale * w_loc
    is_owner = jax.lax.axis_index(DATA_AXIS) == win
    w_new = jnp.where(is_owner, w_new.at[best].set(new_wf), w_new)
    ok = jnp.logical_and(jnp.logical_and(ok_select, ok_geo), jnp.isfinite(sc_g[win]))
    return w_new, ok


class ShardedHilbertCoreset:
    """Eager wrapper mirroring ``SparseNNLS``/``HilbertCoreset``'s surface
    (``build``, ``build_trace``, ``weights``, ``error``, ``size``, ``reset``,
    ``reached_numeric_limit``, ``get``) over a mesh-sharded dataset.

    ``data_sharded, n_true`` come from ``parallel.shard_data``; ``samples``
    is a replicated (S, theta_dim) posterior-sample array (draw it once from
    the model's sampler, as the single-device HilbertCoreset does at
    construction — reference coreset/hilbert.py:7-20). ``beta`` switches the
    tangent space to beta-likelihood projections."""

    def __init__(self, data_sharded, n_true: int, model, samples, mesh,
                 beta: Optional[float] = None):
        self.data = data_sharded
        self.n_true = int(n_true)
        self.mesh = mesh
        self.model = model
        dtype = data_sharded.dtype
        self._beta = None if beta is None else jnp.asarray(beta, dtype=dtype)
        self.reached_numeric_limit = False
        n_data, _ = require_axes(mesh)
        if data_sharded.shape[0] % n_data:
            raise ValueError("data rows must divide the data axis — use shard_data()")
        rows_loc = data_sharded.shape[0] // n_data
        n_true_ = self.n_true
        use_beta = self._beta is not None

        # ---- project ONCE (like the single-device HilbertCoreset,
        # coresets/api.py:408): the (N, S) tangent matrix, row norms,
        # selectability mask and target b are fixed for the object's
        # lifetime; build/trace/error take them as jit OPERANDS (a
        # closed-over matrix would embed into the HLO — see
        # coresets/incremental.py _bind) ----
        @jax.jit
        def _project_d(data, samples, beta):
            def local(data_loc, samples, beta):
                ax_d = jax.lax.axis_index(DATA_AXIS)
                # padding rows are zero POINTS, not zero projections — mask
                valid = (ax_d * rows_loc + jnp.arange(rows_loc)) < n_true_
                if use_beta:
                    vecs = project_beta(model, data_loc, samples, beta)
                else:
                    vecs = project_ll(model, data_loc, samples)
                vecs = vecs * valid[:, None].astype(data_loc.dtype)
                norms = jnp.sqrt(jnp.sum(vecs * vecs, axis=1))
                # zero-norm rows are inert, matching the reference's row
                # drop (hilbert.py:16): never selected, zero share of b
                selectable = jnp.logical_and(valid, norms > 0)
                b = jax.lax.psum(vecs.sum(axis=0), DATA_AXIS)
                return vecs, norms, selectable, b

            return jax.shard_map(
                local, mesh=mesh,
                in_specs=(P(DATA_AXIS, None), P(), P()),
                out_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS), P()),
                check_vma=False,
            )(data, samples, beta)

        def _bind(vecs, norms, selectable, b, tol):
            bnorm = jnp.linalg.norm(b)
            bn = b / jnp.where(bnorm == 0.0, 1.0, bnorm)
            step_fn = partial(_giga_step_local, vecs, norms, selectable, bn, bnorm, tol)
            return step_fn, partial(_tangent_error_local, vecs, b)

        st_spec = snnls_base.BuildState(w=P(DATA_AXIS), retried=P(), latched=P())
        pre_specs = (P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS), P())

        @jax.jit
        def _build_d(vecs, norms, selectable, b, w, itrs, tol):
            def local(vecs, norms, selectable, b, w_loc, itrs, tol):
                step_fn, error_fn = _bind(vecs, norms, selectable, b, tol)
                return snnls_base.build(step_fn, error_fn, w_loc, itrs)

            return jax.shard_map(
                local, mesh=mesh,
                in_specs=pre_specs + (P(DATA_AXIS), P(), P()),
                out_specs=st_spec, check_vma=False,
            )(vecs, norms, selectable, b, w, itrs, tol)

        @partial(jax.jit, static_argnums=5)
        def _trace_d(vecs, norms, selectable, b, w, itrs: int, tol=None):
            if tol is None:
                tol = jnp.asarray(errors.TOL, dtype=dtype)

            def local(vecs, norms, selectable, b, w_loc, tol):
                step_fn, error_fn = _bind(vecs, norms, selectable, b, tol)
                return snnls_base.build_trace(step_fn, error_fn, w_loc, itrs)

            return jax.shard_map(
                local, mesh=mesh,
                in_specs=pre_specs + (P(DATA_AXIS), P()),
                out_specs=(P(None, DATA_AXIS), st_spec), check_vma=False,
            )(vecs, norms, selectable, b, w, tol)

        @jax.jit
        def _error_d(vecs, norms, selectable, b, w):
            def local(vecs, norms, selectable, b, w_loc):
                return _tangent_error_local(vecs, b, w_loc)

            return jax.shard_map(
                local, mesh=mesh,
                in_specs=pre_specs + (P(DATA_AXIS),),
                out_specs=P(), check_vma=False,
            )(vecs, norms, selectable, b, w)

        self._build_d, self._trace_d, self._error_d = _build_d, _trace_d, _error_d
        samples = jnp.asarray(samples, dtype=dtype)
        beta_arg = self._beta if use_beta else jnp.asarray(0.0, dtype=dtype)
        self._pre = _project_d(data_sharded, samples, beta_arg)
        self._w0 = jax.device_put(
            jnp.zeros(data_sharded.shape[0], dtype=dtype),
            jax.sharding.NamedSharding(mesh, P(DATA_AXIS)))
        self.w = self._w0

    def build(self, itrs: int) -> None:
        if self.reached_numeric_limit:
            return
        st = self._build_d(*self._pre, self.w, jnp.asarray(int(itrs), dtype=jnp.int32),
                           jnp.asarray(errors.TOL, dtype=self.data.dtype))
        self.w = st.w
        if bool(st.latched):
            self.reached_numeric_limit = True

    def build_trace(self, itrs: int):
        """(itrs, N_padded) per-iteration weights, row m-1 == weights after m
        total iterations; stays sharded over the data axis on device."""
        ws, st = self._trace_d(*self._pre, self.w, int(itrs),
                               jnp.asarray(errors.TOL, dtype=self.data.dtype))
        self.w = st.w
        if bool(st.latched):  # sticky, like SparseNNLS (snnls/base.py:209-211)
            self.reached_numeric_limit = True
        return ws

    def error(self) -> float:
        return float(self._error_d(*self._pre, self.w))

    def size(self) -> int:
        return int((self.w > 0).sum())

    def weights(self) -> np.ndarray:
        """Host copy of the weight vector over the true (unpadded) rows."""
        return np.asarray(self.w)[: self.n_true].copy()

    def reset(self) -> None:
        self.w = self._w0
        self.reached_numeric_limit = False

    def get(self):
        """(wts, pts, idcs) of the selected rows, reference Coreset.get().
        Selected rows are gathered ON DEVICE — materializing the sharded
        dataset on the host to pick ~M rows would transfer GBs at the
        scales this class exists for."""
        w = self.weights()
        idcs = np.where(w > 0)[0]
        pts = np.asarray(self.data[jnp.asarray(idcs)])
        return w[idcs], pts, idcs
