"""Eager object API, mirroring the reference's user-facing surface.

Reference: bayesiancoresets/coreset/coreset.py (Coreset ABC),
coreset/__init__.py exports. These classes hold a jitted functional core
(state pytrees + compiled build programs) behind the reference's mutable
interface: ``build(itrs, sz)``, ``optimize()``, ``get()``, ``size()``,
``reset()``, ``error()``. Randomness is an explicit per-instance
``KeySequence`` seeded at construction instead of the global numpy stream.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import ModelFns, beta_gradient_from_autodiff
from ..ops.projection import center, project_ll
from ..snnls.giga import GIGA
from ..utils.errors import NumericalPrecisionError
from ..utils.logging import get_logger
from ..utils.prng import KeySequence
from . import state as state_lib
from .bpsvi import BPSVIConfig, make_bpsvi_builder
from .incremental import (IncrementalConfig, make_incremental_builder,
                          make_tangent_error)


# module-level jit: a per-instance jax.jit(project_ll) wrapper would
# recompile the projection for every HilbertCoreset constructed in a sweep
_project_ll_jit = jax.jit(project_ll, static_argnums=0)


def _round_capacity(sz: int) -> int:
    return max(64, int(np.ceil(sz / 64.0)) * 64)


def _steps_to_i0(step_sched, opt_itrs: int) -> np.ndarray:
    """Evaluate a reference-style ``step_sched(i)`` callable into the static
    learning-rate array the jitted Adam scan consumes."""
    return np.asarray([float(step_sched(i)) for i in range(opt_itrs)])


class BlackBoxProjector:
    """Bundle (sampler, projection_dim, model functions): the reference's
    BlackBoxProjector (projector.py:12-37) re-expressed as pure functions.
    ``sampler(key, n, wts, pts, aux) -> (samples, aux)``.

    ``model=`` (optional) passes a full :class:`ModelFns` bundle instead of
    loose callbacks (e.g. ``logreg.bundle()``)."""

    def __init__(self, sampler, projection_dimension: int, loglikelihood=None,
                 grad_loglikelihood=None, theta_dim: int = None, model=None):
        self.sampler = sampler
        self.projection_dimension = projection_dimension
        # parameter dimension when != data row dim (e.g. rows z = [x, y] with
        # a Laplace sampler whose warm-start mode is d = D - 1)
        self.theta_dim = theta_dim
        if model is not None:
            self.model = model
        else:
            if loglikelihood is None:
                raise ValueError("pass loglikelihood or model=")
            self.model = ModelFns(
                log_likelihood=loglikelihood,
                grad_z_log_likelihood=grad_loglikelihood,
            )


class BetaBlackBoxProjector:
    """Beta-divergence projector bundle (reference projector.py:39-66).
    ``model=`` as in :class:`BlackBoxProjector`."""

    def __init__(self, sampler, projection_dimension: int, beta_likelihood=None,
                 loglikelihood=None, beta_gradient=None, theta_dim: int = None,
                 model=None):
        self.sampler = sampler
        self.projection_dimension = projection_dimension
        self.theta_dim = theta_dim
        if model is not None:
            if model.beta_likelihood is None:
                raise ValueError("model= bundle must carry beta_likelihood")
            self.model = model
        else:
            if beta_likelihood is None or loglikelihood is None:
                raise ValueError("pass (beta_likelihood, loglikelihood) or model=")
            if beta_gradient is None:
                beta_gradient = beta_gradient_from_autodiff(beta_likelihood)
            self.model = ModelFns(
                log_likelihood=loglikelihood,
                beta_likelihood=beta_likelihood,
                beta_gradient=beta_gradient,
            )


class ContextualProjector:
    """Projector whose model/sampler depend on trainable context — e.g. the
    neural-linear encoder parameters (the reference's ``nl=`` projector
    kwarg, projector.py:20-21). ``model_factory``/``sampler_factory`` map a
    traced ctx pytree to a ModelFns / sampler; set ``alg.ctx`` (e.g. to
    ``nl.variables``) before each ``build``."""

    contextual = True

    def __init__(self, sampler_factory, projection_dimension: int, model_factory):
        self.sampler = sampler_factory
        self.projection_dimension = projection_dimension
        self.model = model_factory


class Coreset:
    """Base eager coreset (reference coreset/coreset.py:7-71)."""

    def __init__(self, data, *, seed: int = 0, max_size: int = 0,
                 wts=None, idcs=None, pts=None, beta: float = 0.5):
        # reference contract: garbage input raises ValueError (reference
        # tests/test_snnls/test_sampling.py:100-123). Validate metadata only
        # — no device->host transfer for on-device arrays.
        if not isinstance(data, jnp.ndarray):
            try:
                data = np.asarray(data)
            except (TypeError, ValueError) as e:
                raise ValueError(f"coreset data must be a numeric array: {e}") from None
        if data.dtype.kind not in "fiu":
            raise ValueError(f"coreset data must be numeric, got dtype {data.dtype}")
        if data.ndim != 2 or data.shape[0] < 1 or data.shape[1] < 1:
            raise ValueError(f"coreset data must be (N, D) with N,D >= 1, got {data.shape}")
        self.data = jnp.asarray(data)
        self.log = get_logger(self.__class__.__name__)
        self.keys = KeySequence(seed)
        self.reached_numeric_limit = False
        self._beta0 = float(beta)
        cap = _round_capacity(max_size or 1)
        if wts is not None:
            cap = max(cap, _round_capacity(len(np.asarray(wts))))
            self.state = state_lib.warm_start_state(
                cap, np.asarray(wts, dtype=self.data.dtype), idcs, np.asarray(pts, dtype=self.data.dtype), beta=beta,
                sampler_aux=self._init_aux(),
            )
            self.initialized = int(self.state.m)
        else:
            self.state = state_lib.init_state(cap, self.data.shape[1], beta=beta,
                                              sampler_aux=self._init_aux(), dtype=self.data.dtype)
            self.initialized = 0

    def _init_aux(self):
        td = getattr(getattr(self, "projector", None), "theta_dim", None)
        return jnp.zeros(td or self.data.shape[1], dtype=jnp.asarray(self.data).dtype)

    # --- reference API ---
    def reset(self):
        cap = self.state.wts.shape[0]
        self.state = state_lib.init_state(cap, self.data.shape[1], beta=self._beta0,
                                          sampler_aux=self._init_aux(), dtype=self.data.dtype)
        self.reached_numeric_limit = False

    def size(self) -> int:
        return int((np.asarray(self.state.wts) > 0).sum())

    def get(self):
        return state_lib.get(self.state)

    def error(self) -> float:
        return 0.0  # parity: reference bcores.py:152-153 / sparsevi.py:138-139

    def build(self, itrs: int, sz: int) -> None:
        if self.reached_numeric_limit:
            return
        if sz < self.size():
            raise ValueError(
                f"{self.__class__.__name__}.build(): cannot shrink coreset "
                f"(requested {sz} < current {self.size()})"
            )
        self._ensure_capacity(sz)
        self._build(itrs, sz)

    # relative error increase beyond which a failed optimize() LATCHES
    # reached_numeric_limit (refuses further growth). Below it the state is
    # still reverted (reference contract, coreset.py:48-65) but the latch is
    # NOT set: with a real Monte-Carlo error() (unlike the reference's
    # hard-coded 0) a converged coreset re-optimized under fresh sampling
    # noise increases the shared-key error by O(noise) about half the time,
    # and latching on that would block builds forever. PARITY.md.
    LATCH_REL_INCREASE = 0.05

    def optimize(self):
        """Re-run weight refinement with rollback on cost increase
        (reference coreset.py:48-65)."""
        from ..utils import errors

        prev_cost = self.error()
        prev_state = self.state
        try:
            self._optimize()
            # mutable global tolerance (reference coreset.py:57 uses
            # util.TOL, adjustable via set_tolerance)
            new_cost = self.error()
            if new_cost > prev_cost * (1.0 + errors.TOL):
                self.log.warning("optimize() increased error (%g -> %g); reverting",
                                 prev_cost, new_cost)
                self.state = prev_state
                if new_cost > prev_cost * (1.0 + self.LATCH_REL_INCREASE):
                    raise NumericalPrecisionError("optimize() materially increased error")
        except NumericalPrecisionError as e:
            self.log.warning("%s", e)
            self.state = prev_state
            self.reached_numeric_limit = True

    # --- hooks ---
    def _ensure_capacity(self, sz: int) -> None:
        cap = self.state.wts.shape[0]
        if sz > cap:
            new_cap = _round_capacity(sz)
            w, p, i = (np.asarray(self.state.wts), np.asarray(self.state.pts), np.asarray(self.state.idcs))
            m = int(self.state.m)
            st = state_lib.init_state(new_cap, self.data.shape[1], beta=float(self.state.beta),
                                      sampler_aux=self.state.sampler_aux, dtype=self.data.dtype)
            self.state = st._replace(
                wts=st.wts.at[:cap].set(w), idcs=st.idcs.at[:cap].set(i),
                pts=st.pts.at[:cap].set(p), m=jnp.asarray(m, dtype=jnp.int32),
            )

    def _build(self, itrs: int, sz: int) -> None:
        raise NotImplementedError

    def _optimize(self) -> None:
        raise NotImplementedError


class _IncrementalCoreset(Coreset):
    """Shared eager wrapper for SparseVI / beta-Cores."""

    _use_beta = False
    _learn_beta = False

    def __init__(self, data, ll_projector, n_subsample_select=None, n_subsample_opt=None,
                 opt_itrs: int = 100, step_sched: Callable = lambda i: 1.0 / (1.0 + i),
                 beta: float = 0.5, learn_beta: Optional[bool] = None,
                 beta_cap: float = 1.0, seed: int = 0,
                 max_size: int = 0, groups=None, initialized: bool = False,
                 data_weights=None, refit_every: int = 1,
                 dedup_select: bool = False, **kw):
        if groups is not None and not max_size:
            # group appends add up to max-group-size slots per iteration
            max_size = sum(len(g) for g in groups)
        self.projector = ll_projector  # before super(): _init_aux reads theta_dim
        super().__init__(data, seed=seed, max_size=max_size, beta=beta, **kw)
        if learn_beta is not None:
            self._learn_beta = learn_beta
        step_sizes = jnp.asarray(_steps_to_i0(step_sched, opt_itrs), dtype=self.data.dtype)
        cfg = IncrementalConfig(
            projection_dim=ll_projector.projection_dimension,
            n_subsample_select=n_subsample_select,
            n_subsample_opt=n_subsample_opt,
            opt_itrs=opt_itrs,
            use_beta=self._use_beta,
            learn_beta=self._learn_beta,
            beta_cap=beta_cap,
            refit_every=refit_every,
            dedup_select=dedup_select,
        )
        self._cfg = cfg
        self.groups = groups
        self._data_weights = data_weights
        self.ctx = None  # traced context for contextual projectors
        contextual = getattr(ll_projector, "contextual", False)
        if groups is None:
            self._builder = make_incremental_builder(self.data, ll_projector.model,
                                                     ll_projector.sampler, cfg,
                                                     step_sizes=step_sizes,
                                                     contextual=contextual,
                                                     data_weights=data_weights)
        else:
            from ..ops.projection import Groups
            from .groups import init_group_state, make_group_incremental_builder

            self._groups_padded = Groups.from_lists(groups)
            self._builder = make_group_incremental_builder(
                self.data, self._groups_padded, ll_projector.model,
                ll_projector.sampler, cfg, step_sizes=step_sizes,
                contextual=contextual, data_weights=data_weights)
            self._gstate = init_group_state(
                self.state, len(groups),
                initialized=int(self.state.m) if initialized else 0)
        # real tangent-space error (the reference returns 0 here, making its
        # optimize() rollback vacuous — deviation documented in PARITY.md).
        # The key is refreshed once per build, NOT per error() call, so the
        # before/after comparison inside optimize() shares one projection.
        # Keys come from a SEPARATE seed-derived sequence: drawing them from
        # self.keys would shift the build key stream and change every
        # published fixed-seed trajectory.
        if groups is None:
            self._error_fn = self._builder.error
        else:
            self._error_fn = make_tangent_error(self.data, ll_projector.model,
                                                ll_projector.sampler, cfg,
                                                contextual=contextual,
                                                data_weights=data_weights)
        self._error_keys = KeySequence(seed ^ 0x5EED0)
        self._error_key = self._error_keys()

    @property
    def selected_groups(self):
        """Indices of groups selected so far (reference bcores.py:114-115)."""
        if self.groups is None:
            return []
        return np.where(np.asarray(self._gstate.selected))[0].tolist()

    def _build(self, itrs: int, sz: int) -> None:
        if self.groups is None:
            if self.size() + itrs > sz:
                raise ValueError(
                    f"{self.__class__.__name__}._build(): itrs + current size "
                    f"({self.size()} + {itrs}) exceeds desired size {sz}"
                )
            self.state = self._builder.build(self.keys(), self.state, int(itrs), self.ctx)
        else:
            self._gstate = self._gstate._replace(core=self.state)
            self._gstate = self._builder(self.keys(), self._gstate, int(itrs), self.ctx)
            self.state = self._gstate.core
        self._error_key = self._error_keys()

    def error(self) -> float:
        """Tangent-space residual norm of the current coreset under a fresh
        (but per-build-fixed) posterior projection. Deviates from the
        reference's hard-coded 0 (bcores.py:152-153) so that
        ``optimize()``'s rollback guard can actually fire (PARITY.md)."""
        return float(self._error_fn(self._error_key, self.state, self.ctx))

    def _ensure_capacity(self, sz: int) -> None:
        if self.groups is None:
            super()._ensure_capacity(sz)
        # group mode pre-allocates the full capacity at construction

    def _optimize(self) -> None:
        if self.groups is None:
            self.state = self._builder.optimize(self.keys(), self.state, self.ctx)

    def refine(self, n_samples: int = 500, n_subsample=None) -> None:
        """Deterministic quasi-Newton weight polish on a frozen S_big-sample
        projection (coresets/refine.py; beyond-reference, arXiv:2203.09675).
        Keeps the result only if it tightens the frozen tangent-space
        objective. Intended for clean-data KL builds — see coresets/refine.py
        for why NOT to polish contaminated beta builds. Group mode refines at
        the individual-point level over the appended members (exactly what
        the group build's own Adam pass does); group membership constrains
        selection, not the weight polish."""
        from .refine import refine_weights

        if getattr(self.projector, "contextual", False):
            # resolve the factories at the CURRENT context (neural-linear
            # encoder state); the polish retraces per ctx — fine for a
            # once-per-acquisition-round call
            mdl, smp = self.projector.model(self.ctx), self.projector.sampler(self.ctx)
        else:
            mdl, smp = self.projector.model, self.projector.sampler
        self.state = refine_weights(self.keys(), self.data, mdl, smp, self.state,
                                    n_samples=n_samples, n_subsample=n_subsample,
                                    use_beta=self._use_beta,
                                    data_weights=self._data_weights)

    def build_trace(self, itrs: int, return_selected: bool = False):
        """Run ``itrs`` incremental iterations as ONE device program,
        returning per-iteration compact coresets
        ``[(wts_m, pts_m, idcs_m, beta_m)] * itrs`` — what a
        ``for m: build(1, m); get()`` loop produces, without its hundreds
        of per-size host round trips. Advances this coreset to the final
        size.

        Group mode records the per-iteration selected-group mask alongside;
        pass ``return_selected=True`` to get ``(out, selected)`` where
        ``selected`` is the (itrs, G) boolean trace — the group-selection
        order is the sequence of columns that turn on."""
        pts0 = np.asarray(self.state.pts)  # pre-build buffer: warm slots
        if self.groups is not None:
            self._gstate = self._gstate._replace(core=self.state)
            gst, (W, I, B, Sel) = self._builder.build_trace(
                self.keys(), self._gstate, int(itrs), self.ctx)
            self._gstate = gst
            self.state = gst.core
        else:
            if return_selected:
                raise ValueError("return_selected: group mode only")
            self._ensure_capacity(int(self.state.m) + itrs)
            pts0 = np.asarray(self.state.pts)  # after capacity growth
            st, (W, I, B) = self._builder.build_trace(self.keys(), self.state,
                                                      int(itrs), self.ctx)
            self.state = st
        self._error_key = self._error_keys()  # same per-build refresh as _build
        W, I, B = np.asarray(W), np.asarray(I), np.asarray(B)
        N = self.data.shape[0]
        # one padded gather for every iteration's points: (itrs, cap, d)
        P = np.asarray(self.data[jnp.asarray(np.clip(I, 0, N - 1))])
        # warm-start slots may carry EXTERNAL sentinel indices (e.g. the
        # neural-linear driver's 1e7+i inducing points, reference
        # zellner_neural_linear/main.py:146-150): their coordinates live
        # in the state buffer, never in data — a clamp-gather would
        # silently report data[N-1] for them. A slot only changes at
        # selection (which writes a real data row + its index), so the
        # pre-build buffer is exact for every out-of-range index.
        ext = (I < 0) | (I >= N)
        if ext.any():
            P = np.array(P)  # np.asarray of a jax array is read-only
            slot = np.broadcast_to(np.arange(I.shape[1]), I.shape)
            P[ext] = pts0[slot[ext]]
        out = []
        for m in range(itrs):
            keep = W[m] > 0
            out.append((W[m][keep], P[m][keep], I[m][keep], float(B[m])))
        if return_selected:
            return out, np.asarray(Sel)
        return out


class SparseVICoreset(_IncrementalCoreset):
    """Sparse variational-inference coreset (Campbell & Beronov 2019).
    Spec: reference coreset/sparsevi.py."""

    _use_beta = False
    _learn_beta = False


class BetaCoreset(_IncrementalCoreset):
    """beta-Cores: robust coreset under the beta-divergence (Manousakas &
    Mascolo, WSDM 2021). Spec: reference coreset/bcores.py, with a working
    ``learn_beta`` path."""

    _use_beta = True

    def __init__(self, data, ll_projector, beta: float = 0.5, learn_beta: bool = False, **kw):
        super().__init__(data, ll_projector, beta=beta, learn_beta=learn_beta, **kw)

    def get(self):
        w, p, i = super().get()
        return w, p, i, float(self.state.beta)


class BatchPSVICoreset(Coreset):
    """Batch pseudo-coreset (spec: reference coreset/bpsvi.py)."""

    def __init__(self, data, ll_projector, opt_itrs: int = 100, n_subsample_opt=None,
                 step_sched: Callable = lambda m: (lambda i: 1.0 / (1.0 + i)),
                 seed: int = 0, data_weights=None, **kw):
        self.projector = ll_projector  # before super(): _init_aux reads theta_dim
        super().__init__(data, seed=seed, **kw)
        self.opt_itrs = opt_itrs
        self.n_subsample_opt = n_subsample_opt
        self.step_sched = step_sched
        self._data_weights = data_weights
        self._builders = {}

    def _builder_for(self, sz: int):
        if sz not in self._builders:
            sched = self.step_sched(sz)
            step_sizes = _steps_to_i0(sched, self.opt_itrs)
            cfg = BPSVIConfig(
                projection_dim=self.projector.projection_dimension,
                n_subsample_opt=self.n_subsample_opt,
                opt_itrs=self.opt_itrs,
            )
            self._builders[sz] = make_bpsvi_builder(self.data, self.projector.model,
                                                    self.projector.sampler, cfg,
                                                    step_sizes=step_sizes,
                                                    data_weights=self._data_weights)
        return self._builders[sz]

    def _build(self, itrs: int, sz: int) -> None:
        wts, pts, idcs = self._builder_for(sz)(self.keys(), sz, self._init_aux())
        self._ensure_capacity(sz)
        st = self.state
        # full-buffer replace (reference bpsvi.py:19-22 rebuilds wts/pts
        # wholesale): slot-sz writes would leave stale tail weights when
        # rebuilding to a smaller size than a previous build
        cap = st.wts.shape[0]
        w_buf = jnp.zeros_like(st.wts).at[:sz].set(wts)
        p_buf = jnp.zeros_like(st.pts).at[:sz].set(pts)
        i_buf = (-jnp.ones_like(st.idcs)).at[:sz].set(idcs.astype(jnp.int32))
        self.state = st._replace(wts=w_buf, pts=p_buf, idcs=i_buf,
                                 m=jnp.asarray(sz, dtype=jnp.int32))

    def _optimize(self) -> None:
        pass  # BPSVI's build IS the optimization (one-shot)


class HilbertCoreset(Coreset):
    """Project once into a fixed tangent space, then sparse-NNLS
    (spec: reference coreset/hilbert.py)."""

    def __init__(self, data, ll_projector, n_subsample=None, snnls=GIGA, seed: int = 0,
                 data_weights=None, **kw):
        self.projector = ll_projector  # before super(): _init_aux reads theta_dim
        super().__init__(data, seed=seed, **kw)
        key = self.keys()
        d = self.data.shape[1]
        empty_w = jnp.zeros(1, dtype=self.data.dtype)
        empty_p = jnp.zeros((1, d), dtype=self.data.dtype)
        samples, _ = ll_projector.sampler(
            key, ll_projector.projection_dimension, empty_w, empty_p, self._init_aux()
        )
        if n_subsample is None:
            sub_idcs = None
            x = self.data
        else:
            n_subsample = min(self.data.shape[0], n_subsample)
            sub_idcs = np.asarray(
                jax.random.randint(self.keys(), (n_subsample,), 0, self.data.shape[0])
            )
            x = self.data[sub_idcs]
        # all on-device (only the small zero-row mask crosses to host —
        # the (N, S) block never does)
        vecs = _project_ll_jit(ll_projector.model, x, samples)
        norm_pos = np.asarray(jnp.linalg.norm(vecs, axis=1) > 0.0)
        if data_weights is None:
            nonzero = norm_pos
            b = None  # computed from the filtered vecs below (bit-identical path)
        else:
            # weighted base data (merge-reduce leaf unions, row multiplicity):
            # the snnls target is sum_n u_n v_n, computed over ALL rows before
            # the candidate filter; u==0 rows are non-data and leave the pool
            u = jnp.asarray(data_weights, dtype=self.data.dtype)
            if u.shape != (self.data.shape[0],):
                # a short vector would silently clamp-gather under
                # n_subsample (JAX out-of-range gather semantics) — validate
                # like the incremental/uniform paths do
                raise ValueError(
                    f"data_weights must be ({self.data.shape[0]},), got {u.shape}")
            u_sel = u if sub_idcs is None else u[jnp.asarray(sub_idcs)]
            b = u_sel @ vecs
            nonzero = norm_pos & np.asarray(u_sel > 0)
        keep = np.where(nonzero)[0]
        if len(keep) != vecs.shape[0]:
            vecs = vecs[jnp.asarray(keep)]
        self._row_map = (sub_idcs[keep] if sub_idcs is not None else keep)
        self.snnls = snnls(vecs.T, vecs.sum(axis=0) if b is None else b)

    def reset(self):
        self.snnls.reset()
        super().reset()

    def _sync_state(self):
        w = self.snnls.weights()
        keep = w > 0
        wts = w[keep]
        idcs = self._row_map[keep]
        cap = max(self.state.wts.shape[0], _round_capacity(len(wts)))
        # gather the selected rows on device with a capacity-padded index
        # vector: per-m index shapes would force one recompile per coreset
        # size (padded shapes take the handful of capacities instead)
        pad_idcs = np.zeros(cap, dtype=np.int32)
        pad_idcs[: len(idcs)] = idcs
        pts = np.asarray(self.data[jnp.asarray(pad_idcs)])[: len(idcs)]
        self.state = state_lib.warm_start_state(cap, wts.astype(self.data.dtype),
                                                idcs, pts, beta=self._beta0,
                                                sampler_aux=self._init_aux())

    def _build(self, itrs: int, sz: int) -> None:
        if self.snnls.size() + itrs > sz:
            raise ValueError(
                f"HilbertCoreset._build(): itrs + current size exceeds desired size {sz}"
            )
        self.snnls.build(itrs)
        self.reached_numeric_limit = self.snnls.reached_numeric_limit
        self._sync_state()

    def _optimize(self) -> None:
        self.snnls.optimize()
        self._sync_state()

    def error(self) -> float:
        return self.snnls.error()


def uniform_coreset_draws(key, n: int, N: int, start: int = 0):
    """Draws ``start .. start+n-1`` of the UniformSamplingCoreset point
    stream rooted at ``key``: iid uniform indices in [0, N), one
    ``fold_in`` per draw counter — so a batched call and one-at-a-time
    calls produce the IDENTICAL sequence (``build_trace`` vs a
    ``build(1, m)`` loop), and a jitted pipeline on any backend can replay
    the eager baseline's draws bit-for-bit from the same key."""
    ks = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, start + jnp.arange(n))
    return jax.vmap(lambda k: jax.random.randint(k, (), 0, N))(ks)


def weighted_coreset_draws(key, n: int, p=None, start: int = 0, cdf=None):
    """Counter-indexed iid categorical draws (pure, jittable; inverse CDF).
    Same stream contract as ``uniform_coreset_draws``. Pass ``cdf`` (a
    normalized, non-decreasing CDF over the support — the eager class
    precomputes it once in float64 numpy, so every entry is CORRECTLY
    ROUNDED even on x64-disabled backends) or, for back-compat, raw
    probabilities ``p`` (CDF then accumulates in p.dtype — on float32
    backends large supports pick up cumsum rounding drift; round-3 advisor).
    Callers needing exact zero-mass exclusion should compact to the
    positive support first (the eager class does).

    x64 note: the uniform draws follow the backend's x64 config (float64
    under the test conftest, float32 by default), so the draw
    STREAM is bit-identical across backends only at matching
    ``jax_enable_x64`` — within one process it always replays exactly."""
    if cdf is None:
        if p is None:
            raise ValueError("pass p or cdf")
        cum = jnp.cumsum(p)
        cdf = cum / cum[-1]
    ks = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, start + jnp.arange(n))
    u = jax.vmap(lambda k: jax.random.uniform(k, dtype=cdf.dtype))(ks)
    return jnp.clip(jnp.searchsorted(cdf, u, side="right"),
                    0, cdf.shape[0] - 1)


class UniformSamplingCoreset(Coreset):
    """Uniform-sampling baseline (spec: reference coreset/sampling.py):
    iid uniform draws with multiplicity counts, w = N * cts / sum(cts).

    Selection is pure host-side bookkeeping; the device-side ``state``
    pytree is materialized lazily on first read after a build. A
    ``for m: build(1, m); get()`` driver loop therefore pays one device
    round trip per *read*, not several per build call. Draws follow the framework's explicit-JAX-PRNG
    discipline (utils/prng.py): a committed-to-CPU threefry key stream
    feeds the pure ``uniform_coreset_draws``/``weighted_coreset_draws``
    functions (replayable under jit on any backend, bit-identical), with
    zero accelerator round trips."""

    def __init__(self, data, seed: int = 0, groups=None, data_weights=None, **kw):
        self._dirty = False
        super().__init__(data, seed=seed, **kw)
        # weighted base data (streaming leaf unions): draws become iid
        # importance draws ~ u / sum(u), and the multiplicity weights scale
        # by total mass sum(u) instead of N — the same estimator, targeting
        # the weighted posterior. u==0 rows are never drawn. Group mode
        # draws GROUPS ~ group mass, appends only u>0 members, and counts
        # each member with multiplicity u_n (its within-group share).
        if data_weights is not None:
            uw = np.asarray(data_weights, dtype=np.float64)
            if uw.shape != (len(data),):
                raise ValueError(
                    f"data_weights must be ({len(data)},), got {uw.shape}")
            if not (uw.sum() > 0):
                raise ValueError("data_weights: total mass must be positive")
            self._u = uw
            self._u_total = float(uw.sum())
            self._u_p = uw / self._u_total
            if groups is not None:
                gm = np.array([uw[g].sum() for g in groups])
                if gm.sum() <= 0:
                    raise ValueError("data_weights: every group has zero mass")
                self._g_p = gm / gm.sum()
        else:
            self._u = None
            self._u_total = None
            self._u_p = None
            self._g_p = None
        # constructor warm start becomes a persistent count-1 prefix
        # (reference sampling.py seeds cts=[1]*len(idcs)); the points may be
        # EXTERNAL to the dataset (sentinel indices, e.g. the neural-linear
        # driver's 1e7+i inducing points), so their coordinates are kept
        # verbatim rather than re-gathered from data
        self.cts: dict[int, int] = {}
        if kw.get("wts") is not None and kw.get("idcs") is not None:
            self._warm = (np.asarray(kw["idcs"], dtype=np.int64).copy(),
                          np.atleast_2d(np.asarray(kw["pts"])).copy())
        else:
            self._warm = None
        self.groups = groups
        self.selected_groups: list[int] = []
        # Explicit-JAX-PRNG draw stream, committed to the host CPU backend:
        # key splits and draws never touch the accelerator (no device round
        # trips per build) yet are bit-reproducible under jit on ANY backend
        # from the same key (threefry is platform-deterministic). Weighted
        # draws are compacted to the positive support so zero-mass rows /
        # groups are structurally excluded, not just measure-zero.
        self._cpu = jax.devices("cpu")[0]
        self._n_drawn = 0
        with jax.default_device(self._cpu):
            self._draw_key = jax.device_put(jax.random.key(seed), self._cpu)
            if self._u_p is not None:
                self._u_pos = np.flatnonzero(self._u > 0)
                # CDF precomputed ONCE in float64 numpy (round-3 advisor):
                # each entry correctly rounded on device regardless of the
                # backend's x64 config — a per-call f32 jnp.cumsum would
                # accumulate rounding drift over large supports
                cdf = np.cumsum(self._u[self._u_pos])
                self._u_cdf_dev = jax.device_put(
                    jnp.asarray(cdf / cdf[-1]), self._cpu)
            if groups is not None and self._g_p is not None:
                self._g_pos = np.flatnonzero(self._g_p > 0)
                gcdf = np.cumsum(np.asarray(self._g_p[self._g_pos],
                                            dtype=np.float64))
                self._g_cdf_dev = jax.device_put(
                    jnp.asarray(gcdf / gcdf[-1]), self._cpu)

    @property
    def state(self):
        if self._dirty:
            self._dirty = False
            self._sync_device_state()
        return self._state

    @state.setter
    def state(self, value):
        self._state = value

    def reset(self):
        self.cts = {}
        self.selected_groups = []
        self._dirty = False
        self._warm = None
        # rewind the draw counter: a reset instance replays the SAME stream
        # as a freshly constructed one (the uniform_coreset_draws replay
        # contract; round-3 advisor — the counter previously kept running,
        # so post-reset draws were not reproducible from counter 0)
        self._n_drawn = 0
        super().reset()

    def size(self) -> int:
        n_warm = 0 if self._warm is None else len(self._warm[0])
        if self.cts or self._dirty:
            return len(self.cts) + n_warm
        return super().size()

    def _ensure_capacity(self, sz: int) -> None:
        # capacity check must not trigger the lazy device sync (it reads
        # only the buffer shape); the property getter would sync per build
        if sz > self._state.wts.shape[0]:
            was_dirty, self._dirty = self._dirty, False
            super()._ensure_capacity(sz)
            self._dirty = was_dirty

    def _draw_points(self, itrs: int):
        N = self.data.shape[0]
        start, self._n_drawn = self._n_drawn, self._n_drawn + itrs
        with jax.default_device(self._cpu):
            if self._u_p is None:
                return np.asarray(
                    uniform_coreset_draws(self._draw_key, itrs, N, start))
            j = np.asarray(weighted_coreset_draws(
                self._draw_key, itrs, start=start, cdf=self._u_cdf_dev))
        return self._u_pos[j]

    def _draw_groups(self, itrs: int):
        # group mode (reference sampling.py:37-52); weighted: draws ~ group
        # mass (zero-mass groups excluded via support compaction)
        G = len(self.groups)
        start, self._n_drawn = self._n_drawn, self._n_drawn + itrs
        with jax.default_device(self._cpu):
            if self._u is None:
                return np.asarray(
                    uniform_coreset_draws(self._draw_key, itrs, G, start))
            j = np.asarray(weighted_coreset_draws(
                self._draw_key, itrs, start=start, cdf=self._g_cdf_dev))
        return self._g_pos[j]

    def _append_group(self, g: int) -> None:
        """Append every member of a NEW group once (weighted: u==0 members
        dropped, multiplicity u_n — its within-group share)."""
        if g not in self.selected_groups:
            self.selected_groups.append(g)
            for f in self.groups[g]:
                mult = 1.0 if self._u is None else float(self._u[int(f)])
                if mult > 0:
                    self.cts[int(f)] = self.cts.get(int(f), 0) + mult

    def _build(self, itrs: int, sz: int) -> None:
        if self.groups is None:
            if self.size() + itrs > sz:
                raise ValueError("UniformSamplingCoreset._build(): size overrun")
            for f in self._draw_points(itrs):
                self.cts[int(f)] = self.cts.get(int(f), 0) + 1
        else:
            for g in self._draw_groups(itrs):
                self._append_group(int(g))
        if self.cts:
            self._dirty = True

    def build_trace(self, itrs: int):
        """Per-iteration compact coresets [(wts, pts, idcs)] * itrs — the
        output of a ``for m: build(1, m); get()`` loop (same draw-key
        stream) with ONE device gather at the end instead of per-size
        round trips. A constructor warm start (count-1 prefix, possibly
        EXTERNAL points — see __init__) appears in every snapshot exactly
        as ``get()`` would report it."""
        N = self.data.shape[0]
        total = float(N) if self._u_total is None else self._u_total
        if self._warm is not None:
            widcs, wpts = self._warm
            n_warm = len(widcs)
        else:
            widcs = np.zeros(0, dtype=np.int64)
            n_warm = 0

        def snapshot():
            idcs = np.fromiter(self.cts.keys(), dtype=np.int64)
            cts = np.fromiter(self.cts.values(), dtype=np.float64)
            # warm slots count 1 each (same normalization as
            # _sync_device_state: concat(ones(warm), cts))
            allc = np.concatenate([np.ones(n_warm), cts])
            wts = (total * allc / allc.sum() if allc.sum() > 0
                   else np.zeros(n_warm))  # only empty groups drawn so far
            return (np.concatenate([widcs, idcs]), wts)

        snaps = []
        if self.groups is not None:
            for g in self._draw_groups(itrs):
                self._append_group(int(g))
                snaps.append(snapshot())
        else:
            for f in self._draw_points(itrs):
                self.cts[int(f)] = self.cts.get(int(f), 0) + 1
                snaps.append(snapshot())
        self._dirty = True
        all_idcs = np.fromiter(self.cts.keys(), dtype=np.int64)
        row_of = {int(i): r for r, i in enumerate(all_idcs)}
        cap = _round_capacity(max(1, len(all_idcs)))
        pad = np.zeros(cap, dtype=np.int32)
        pad[: len(all_idcs)] = np.clip(all_idcs, 0, N - 1)
        P = np.asarray(self.data[jnp.asarray(pad)])[: len(all_idcs)]
        dtype = np.asarray(P).dtype
        # warm points come from their stored coordinates, never a data
        # gather: their indices may be external sentinels (e.g. 1e7+i)
        wP = (np.zeros((0, self.data.shape[1]), dtype=dtype) if n_warm == 0
              else np.atleast_2d(np.asarray(self._warm[1])).astype(dtype))
        return [(wts.astype(dtype),
                 np.concatenate([wP, P[[row_of[int(i)] for i in idcs[n_warm:]]]]),
                 idcs)
                for idcs, wts in snaps]

    def _sync_device_state(self) -> None:
        N = self.data.shape[0]
        idcs = np.fromiter(self.cts.keys(), dtype=np.int64)
        cts = np.fromiter(self.cts.values(), dtype=np.float64)
        self._ensure_capacity(len(idcs) + (0 if self._warm is None else len(self._warm[0])))
        cap = self._state.wts.shape[0]
        # capacity-padded gather: per-size index shapes would recompile per
        # build call (see HilbertCoreset._sync_state)
        pad_idcs = np.zeros(cap, dtype=np.int32)
        pad_idcs[: len(idcs)] = np.clip(idcs, 0, N - 1)
        pts = np.asarray(self.data[jnp.asarray(pad_idcs)])[: len(idcs)]
        if self._warm is not None:
            widcs, wpts = self._warm
            idcs = np.concatenate([widcs, idcs])
            pts = np.concatenate([wpts.astype(pts.dtype), pts], axis=0)
            cts = np.concatenate([np.ones(len(widcs)), cts])
        total = float(N) if self._u_total is None else self._u_total
        wts = total * cts / cts.sum()
        self.state = state_lib.warm_start_state(cap, wts.astype(self.data.dtype),
                                                idcs, pts, beta=self._beta0,
                                                sampler_aux=self._init_aux())

    def _optimize(self) -> None:
        pass
