"""Differentially-private batch pseudo-coreset (DP-BPSVI).

The reference package exports ``DiffPrivBatchPSVICoreset``
(bayesiancoresets/coreset/__init__.py:6) but the implementing module was
deleted from the tree — the import is broken (SURVEY.md section 0). This is
a working implementation of the evident design: BPSVI whose optimization
touches the private data ONLY through the per-step projection sum
Sigma_n v_n (the resid term, coreset/bpsvi.py:52), privatized by the
Gaussian mechanism —

  1. each data point's centered projection vector v_n (an S-vector) is
     clipped to L2 norm <= clip_norm;
  2. isotropic Gaussian noise N(0, (noise_multiplier * clip_norm)^2 I) is
     added to the (rescaled) sum.

Everything downstream (weight/pseudo-point gradients, Adam updates) is
post-processing of the privatized statistics plus the SYNTHETIC pseudo-
points, so the released coreset satisfies (eps, delta)-DP by RDP
composition of T per-step sum releases plus ONE noised clipped-mean
release seeding the pseudo-point initialization (clip/spread are the
PUBLIC ``DPConfig.init_clip_norm/init_spread`` constants; no other data
statistic touches the init).

Two sampling/accounting regimes (``DPConfig.sampling``):

  * ``"poisson"`` (default, round 4): each record enters the per-step batch
    independently with probability q = n_subsample_opt / N — the sampled
    Gaussian mechanism. Accounted with the subsampled-Gaussian RDP bound
    (Mironov, Talwar & Zhang 2019, arXiv:1908.10530, the integer-alpha
    formula of section 3.3) under the ADD/REMOVE neighboring relation
    (Poisson sampling's natural relation; per-step sum sensitivity is ONE
    clip norm). Amplification by subsampling buys roughly a q^2 factor in
    the per-step RDP — single-digit eps at noise_multiplier ~ 1 where the
    unamplified bound needed nm = 16 (RESULTS.md DP table).
  * ``"swr"`` — the round-3 behavior: fixed-size subsample drawn WITHOUT
    replacement, accounted as T unamplified Gaussian mechanisms under the
    SUBSTITUTION relation (one substituted record moves the clipped sum by
    at most 2 * clip_norm). Valid but much looser; kept for comparison.

``epsilon(delta)`` reports the composed bound for the configured regime.
The Poisson batch is materialized into a fixed-capacity buffer for XLA
(static shapes); the astronomically-rare overflow truncation is accounted
as an additive delta via a Bernstein tail bound (see ``poisson_overflow_p``),
never silently ignored.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.projection import center, project_ll_with_grad
from ..utils.opt import nn_adam, step_schedule
from .bpsvi import BPSVIConfig


@dataclasses.dataclass(frozen=True)
class DPConfig:
    clip_norm: float = 1.0
    noise_multiplier: float = 1.0
    delta: float = 1e-5
    # PUBLIC init constants (round-3 review: the original init read
    # jnp.std(data) and the median row norm un-noised, which leaked through
    # the released pseudo-points; all init knobs must be data-independent)
    init_clip_norm: float = 10.0   # per-row L2 clip of the noised-mean release
    init_spread: float = 1.0       # public pseudo-point scatter around the mean
    # "poisson": independent-inclusion batches + subsampled-Gaussian RDP
    # (add/remove relation); "swr": fixed-size without-replacement batches +
    # unamplified substitution accounting (the round-3 behavior)
    sampling: str = "poisson"

    def __post_init__(self):
        if self.sampling not in ("poisson", "swr"):
            raise ValueError(f"sampling must be 'poisson' or 'swr', got {self.sampling!r}")


def _rdp_epsilon_from_ratio2(total_ratio2: float, delta: float) -> float:
    """eps for a composition of Gaussian mechanisms with
    ``total_ratio2 = sum_i (Delta_i / sigma_i)^2`` via RDP (Mironov 2017):
    RDP_alpha = total_ratio2 * alpha / 2; eps = min_alpha RDP_alpha +
    log(1/delta)/(alpha - 1)."""
    alphas = np.concatenate([np.linspace(1.01, 64.0, 512), np.arange(65, 512)])
    rdp = total_ratio2 * alphas / 2.0
    eps = rdp + math.log(1.0 / delta) / (alphas - 1.0)
    return float(np.min(eps))


def gaussian_rdp_epsilon(steps: int, noise_multiplier: float, delta: float,
                         sens_factor: float = 2.0,
                         init_releases: int = 1) -> float:
    """(eps, delta) bound for one DP-BPSVI build: ``steps`` releases of the
    clipped per-step projection sum plus ``init_releases`` noised-mean init
    release, composed via RDP. No subsampling amplification is claimed.

    Neighboring relation: SUBSTITUTION of one record in a fixed-size
    dataset. The per-step subsample is drawn WITHOUT replacement, so a
    substituted record changes the clipped sum by at most
    ``sens_factor = 2`` clip norms (remove its vector, add the
    replacement's); the init mean release has substitution sensitivity
    ``2 * init_clip_norm / N`` and noise ``noise_multiplier`` times exactly
    that. Per-step noise is ``noise_multiplier * clip_norm`` against a
    ``sens_factor * clip_norm`` sensitivity, so the (Delta/sigma)^2 terms
    are ``sens_factor^2 / noise_multiplier^2`` (steps) and
    ``1 / noise_multiplier^2`` (init)."""
    nm2 = noise_multiplier ** 2
    return _rdp_epsilon_from_ratio2(
        (steps * sens_factor ** 2 + init_releases) / nm2, delta)


# integer Renyi orders for the subsampled-Gaussian accountant (the
# integer-alpha formula below is exact; fractional orders would need the
# paper's section-3.3 stable series and buy little on these curves)
_SGM_ORDERS = np.concatenate([np.arange(2, 129), np.arange(136, 513, 8)])


def sgm_rdp(q: float, noise_multiplier: float,
            orders: np.ndarray = _SGM_ORDERS) -> np.ndarray:
    """RDP curve of ONE sampled-Gaussian-mechanism release (Mironov, Talwar
    & Zhang 2019, arXiv:1908.10530): Poisson-sample each record with
    probability ``q``, sum their (unit-)clipped vectors, add
    N(0, noise_multiplier^2 I). For integer alpha the Renyi divergence of
    the mixture mu = (1-q) N(0,s^2) + q N(1,s^2) against N(0,s^2) has the
    closed form (their section 3.3; also tf-privacy's ``_compute_log_a_int``)

        RDP(alpha) = 1/(alpha-1) * logsumexp_k [ log C(alpha,k)
                     + k log q + (alpha-k) log(1-q) + k(k-1)/(2 s^2) ]

    which this evaluates in log space (exact, no series truncation). Pinned
    in tests against (a) the q=1 Gaussian identity alpha/(2 s^2), (b) the
    small-q leading order, and (c) direct numerical integration of the
    Renyi integral (tests/test_aux.py)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    s2 = float(noise_multiplier) ** 2
    if q == 1.0:
        return np.asarray(orders, dtype=float) / (2.0 * s2)
    if q == 0.0:
        return np.zeros(len(orders))
    out = np.empty(len(orders))
    from scipy.special import gammaln, logsumexp  # noqa: PLC0415

    logq, log1q = math.log(q), math.log1p(-q)
    for i, a in enumerate(np.asarray(orders, dtype=int)):
        k = np.arange(a + 1)
        log_binom = gammaln(a + 1) - gammaln(k + 1) - gammaln(a - k + 1)
        terms = log_binom + k * logq + (a - k) * log1q + k * (k - 1) / (2.0 * s2)
        out[i] = logsumexp(terms) / (a - 1)
    return out


def poisson_overflow_p(n: int, q: float, cap: int) -> float:
    """Upper bound on P(Binomial(n, q) > cap) (Bernstein): the probability
    ONE step's Poisson batch overflows its fixed-capacity XLA buffer and is
    truncated. Truncation breaks the exact Poisson-sampling semantics the
    accountant assumes, so the caller folds ``steps * p`` into delta (the
    truncated mechanism couples to the true one except on this event)."""
    mean, var = n * q, n * q * (1.0 - q)
    t = cap - mean
    if t <= 0:
        return 1.0
    return float(math.exp(-t * t / (2.0 * (var + t / 3.0))))


def poisson_batch_cap(n: int, q: float) -> int:
    """Fixed XLA buffer capacity for a Poisson batch: mean + 10 sigma + 16
    rows (overflow probability < 1e-16 per step via ``poisson_overflow_p``),
    rounded up to 8 for aligned row tiles."""
    mean = n * q
    sd = math.sqrt(max(n * q * (1.0 - q), 1.0))
    cap = int(math.ceil(mean + 10.0 * sd + 16.0))
    return min(n, ((cap + 7) // 8) * 8)


def subsampled_gaussian_epsilon(steps: int, q: float, noise_multiplier: float,
                                delta: float, init_releases: int = 1,
                                n: Optional[int] = None,
                                cap: Optional[int] = None) -> float:
    """(eps, delta) bound for one Poisson-sampled DP-BPSVI build under the
    ADD/REMOVE relation: ``steps`` sampled-Gaussian releases at rate ``q``
    composed (RDP curves add) with ``init_releases`` plain Gaussian init
    releases whose (Delta/sigma)^2 = 1/(2 nm)^2 (init noise is
    ``nm * 2 * C_init / N`` against add/remove sensitivity ``C_init / N``
    with N public). When ``n``/``cap`` are given, the per-step buffer-
    overflow probability is charged to delta (union bound over steps)
    before the RDP-to-DP conversion."""
    if n is not None and cap is not None:
        delta_trunc = steps * poisson_overflow_p(n, q, cap)
        if delta_trunc >= delta / 2:
            raise ValueError(
                f"Poisson buffer truncation mass {delta_trunc:.3e} eats the "
                f"delta budget {delta:.1e}; raise the cap")
        delta = delta - delta_trunc
    orders = np.asarray(_SGM_ORDERS, dtype=float)
    rdp = steps * sgm_rdp(q, noise_multiplier, _SGM_ORDERS)
    rdp = rdp + init_releases * (1.0 / (4.0 * noise_multiplier ** 2)) * orders / 2.0
    eps = rdp + math.log(1.0 / delta) / (orders - 1.0)
    return float(np.min(eps))


def make_dp_bpsvi_builder(data: jnp.ndarray, model, sampler: Callable,
                          config: BPSVIConfig, dp: DPConfig,
                          step_sizes=None) -> Callable:
    """Returns jitted ``build(key, sz, aux0) -> (wts, pts)``. The returned
    coreset contains only pseudo-points (no data indices are released)."""
    N, D = data.shape
    S = config.projection_dim
    n_opt = min(N, config.n_subsample_opt) if config.n_subsample_opt else N
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data.dtype)
    step_sizes = jnp.asarray(step_sizes, dtype=data.dtype)
    C = dp.clip_norm
    noise_std = dp.noise_multiplier * C
    poisson = dp.sampling == "poisson"
    if poisson:
        q = n_opt / N
        cap = poisson_batch_cap(N, q)

    # private initialization: pseudo-points scatter around a Gaussian-
    # mechanism release of the clipped data mean. EVERY data-dependent
    # quantity here is clipped to the PUBLIC dp.init_clip_norm and noised
    # (accounted as one extra mechanism in epsilon()); the scatter scale is
    # the public dp.init_spread constant. Round-3 review: the previous init
    # read jnp.std(data) and the median row norm raw — unbounded-sensitivity
    # statistics flowing into the released points with no covering noise.
    def _private_init(key, sz):
        k1, k2 = jax.random.split(key)
        C_init = jnp.asarray(dp.init_clip_norm, dtype=data.dtype)
        row_norms = jnp.linalg.norm(data, axis=1, keepdims=True)
        clipped = data * jnp.minimum(1.0, C_init / jnp.maximum(row_norms, 1e-12))
        # substitution sensitivity of the mean is 2*C_init/N; noise is
        # noise_multiplier times THAT, so this release's (Delta/sigma)^2 is
        # 1/nm^2 — exactly the init_releases=1 term in epsilon()
        mean = clipped.sum(axis=0) / N + (dp.noise_multiplier * 2.0 * C_init / N) * \
            jax.random.normal(k1, (D,), dtype=data.dtype)
        pts0 = mean + dp.init_spread * jax.random.normal(
            k2, (sz, D), dtype=data.dtype)
        return pts0

    def _build(key, sz: int, aux0):
        k_init, k_opt = jax.random.split(key)
        pts0 = _private_init(k_init, sz)
        w0 = (N / sz) * jnp.ones(sz, dtype=data.dtype)

        def grad_fn(x, aux, k):
            w = x[:sz]
            p = x[sz:].reshape(sz, D)
            k_samp, k_sub, k_noise = jax.random.split(k, 3)
            samples, aux = sampler(k_samp, S, w, p, aux)
            if poisson:
                # Poisson sampling: independent Bernoulli(q) inclusion per
                # record — the sampled Gaussian mechanism the subsampled-RDP
                # accountant assumes. The variable-size batch lands in a
                # fixed ``cap``-row buffer (static XLA shapes); overflow
                # truncation mass is charged to delta in epsilon().
                mask = jax.random.bernoulli(k_sub, q, (N,))
                idx = jnp.nonzero(mask, size=cap, fill_value=N)[0]
                valid = (idx < N).astype(data.dtype)[:, None]
                rows = data[jnp.minimum(idx, N - 1)]
                vecs = center(model.log_likelihood(rows, samples)) * valid
                # 1/q inverse-inclusion rescale: E[(1/q) sum_B v] = sum_N v
                scaling = jnp.asarray(1.0 / q, dtype=data.dtype)
            else:
                # WITHOUT replacement (round-3 review): with replacement a
                # record drawn k times shifts the clipped sum by k*C while
                # the noise covers only the accounted 2*C substitution
                # sensitivity
                sub_idcs = jax.random.permutation(k_sub, N)[:n_opt]
                scaling = jnp.asarray(N / n_opt, dtype=data.dtype)
                vecs = center(model.log_likelihood(data[sub_idcs], samples))
            # --- the ONLY data-dependent statistic: clip + noise its sum ---
            norms = jnp.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = vecs * jnp.minimum(1.0, C / jnp.maximum(norms, 1e-12))
            vec_sum = vecs.sum(axis=0) + noise_std * jax.random.normal(
                k_noise, (S,), dtype=data.dtype)
            # ---------------------------------------------------------------
            corevecs, pgrads = project_ll_with_grad(model, p, samples)
            resid = scaling * vec_sum - w @ corevecs
            wgrad = -(corevecs @ resid) / S
            ugrad = -jnp.einsum("i,isd,s->id", w, pgrads, resid) / S
            return jnp.concatenate([wgrad, ugrad.reshape(-1)]), aux

        nn_mask = jnp.concatenate([jnp.ones(sz, dtype=bool), jnp.zeros(sz * D, dtype=bool)])
        x0 = jnp.concatenate([w0, pts0.reshape(-1)])
        xf, _ = nn_adam(x0, grad_fn, aux0, k_opt, step_sizes, nn_mask=nn_mask)
        return xf[:sz], xf[sz:].reshape(sz, D)

    return jax.jit(_build, static_argnums=1)


class DiffPrivBatchPSVICoreset:
    """Eager wrapper (the class the reference exports but does not ship).
    API mirrors BatchPSVICoreset; ``get()`` returns (wts, pts) only —
    pseudo-points carry no data indices."""

    def __init__(self, data, ll_projector, opt_itrs: int = 100, n_subsample_opt=None,
                 step_sched: Callable = lambda m: (lambda i: 1.0 / (1.0 + i)),
                 clip_norm: float = 1.0, noise_multiplier: float = 1.0,
                 delta: float = 1e-5, seed: int = 0,
                 init_clip_norm: float = 10.0, init_spread: float = 1.0,
                 sampling: str = "poisson"):
        from ..utils.prng import KeySequence

        self.data = jnp.asarray(data)
        self.projector = ll_projector
        self.opt_itrs = opt_itrs
        self.n_subsample_opt = n_subsample_opt
        self.step_sched = step_sched
        self.dp = DPConfig(clip_norm=clip_norm, noise_multiplier=noise_multiplier,
                           delta=delta, init_clip_norm=init_clip_norm,
                           init_spread=init_spread, sampling=sampling)
        self.keys = KeySequence(seed)
        self.wts = np.zeros(0)
        self.pts = np.zeros((0, self.data.shape[1]))
        self._builders = {}

    def epsilon(self, delta: Optional[float] = None) -> float:
        """(eps, delta)-DP guarantee of one completed build. Poisson mode:
        subsampled-Gaussian RDP under add/remove (buffer-truncation mass
        charged to delta); swr mode: unamplified substitution bound."""
        delta = delta if delta is not None else self.dp.delta
        if self.dp.sampling == "poisson":
            N = self.data.shape[0]
            n_opt = min(N, self.n_subsample_opt) if self.n_subsample_opt else N
            q = n_opt / N
            return subsampled_gaussian_epsilon(
                self.opt_itrs, q, self.dp.noise_multiplier, delta,
                n=N, cap=poisson_batch_cap(N, q))
        return gaussian_rdp_epsilon(self.opt_itrs, self.dp.noise_multiplier,
                                    delta)

    def build(self, itrs: int, sz: int) -> None:
        if sz not in self._builders:
            sched = self.step_sched(sz)
            steps = np.asarray([float(sched(i)) for i in range(self.opt_itrs)])
            cfg = BPSVIConfig(projection_dim=self.projector.projection_dimension,
                              n_subsample_opt=self.n_subsample_opt,
                              opt_itrs=self.opt_itrs)
            self._builders[sz] = make_dp_bpsvi_builder(
                self.data, self.projector.model, self.projector.sampler, cfg,
                self.dp, step_sizes=steps)
        aux0 = jnp.zeros(self.data.shape[1], dtype=self.data.dtype)
        w, p = self._builders[sz](self.keys(), sz, aux0)
        self.wts, self.pts = np.asarray(w), np.asarray(p)

    def get(self):
        keep = self.wts > 0
        return self.wts[keep], self.pts[keep]

    def size(self) -> int:
        return int((self.wts > 0).sum())
