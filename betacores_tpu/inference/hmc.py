"""On-device MCMC for coreset-posterior evaluation.

Replaces the reference's PyStan NUTS evaluation sampler (reference:
examples/common/mcmc.py:21-59; weighted-likelihood Stan programs at
zellner_logreg/main.py:24-43) so the whole pipeline runs on-device
(SURVEY.md section 7 delta 7). The target density is the weighted coreset
posterior  log p(th) = log prior(th) + sum_m w_m loglik(z_m | th).

Sampler: multinomial HMC with jittered path lengths and Stan-style warmup —
dual-averaging step-size adaptation to a target acceptance statistic plus a
diagonal mass matrix estimated from warmup draws. Each iteration draws
L ~ Uniform{1..L_max} leapfrog steps and samples a state from the whole
trajectory by progressive multinomial (reservoir) sampling under the
canonical density exp(-H). Jittered-length multinomial HMC is a standard
dynamic-HMC scheme (exactly invariant for the target); it matches NUTS-grade
mixing on the low-dimensional, log-concave-ish posteriors evaluated here
while staying static-shape (a fixed L_max-step scan with masking) — the
jit-friendly design NUTS's recursive tree is not.

Everything (warmup + sampling, all chains) is one compiled program; chains
vmap.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp


class HMCConfig(NamedTuple):
    n_samples: int = 1000
    n_warmup: int = 1000
    L_max: int = 32
    target_accept: float = 0.8
    init_step_size: float = 0.1
    # dual averaging constants (Hoffman & Gelman 2014, as in Stan)
    da_gamma: float = 0.05
    da_t0: float = 10.0
    da_kappa: float = 0.75


def _leapfrog_trajectory(key, logprob_and_grad, theta, eps, L, L_max, inv_mass):
    """Multinomial HMC over a length-L trajectory CONTAINING the current
    state at a uniformly random offset: draw j ~ U{0..L}, integrate j steps
    backward (negated momentum) and L-j steps forward from the seed, then
    sample one of the L+1 states with weight exp(-H). The uniform offset is
    what makes the proposal exactly invariant — a forward-only trajectory
    pins the current state at position 0 and the multinomial normalizers of
    the forward/reverse moves differ, biasing the stationary distribution
    (Neal's windowed HMC / Betancourt's multinomial scheme). One masked scan
    of L_max leapfrog steps: the backward phase runs first, then the
    integrator resets to the seed and runs forward, so compute is unchanged.
    Returns (theta_new, accept_stat)."""
    d = theta.shape[0]
    k_mom, k_sel, k_off = jax.random.split(key, 3)
    p0 = jax.random.normal(k_mom, (d,), dtype=theta.dtype) / jnp.sqrt(inv_mass)
    lp0, g0 = logprob_and_grad(theta)
    H0 = -lp0 + 0.5 * jnp.sum(inv_mass * p0 * p0)
    j = jax.random.randint(k_off, (), 0, L + 1)  # backward steps

    sel_keys = jax.random.split(k_sel, L_max)

    def step(carry, inp):
        th, p, g, chosen_th, logw_tot, acc_sum = carry
        k, i = inp
        active = i < L
        # phase boundary: reset the integrator to the seed with forward
        # momentum (backward phase i < j integrates from (theta, -p0))
        reset = i == j
        th = jnp.where(reset, theta, th)
        p = jnp.where(reset, p0, p)
        g = jnp.where(reset, g0, g)
        # leapfrog
        p_half = p + 0.5 * eps * g
        th_new = th + eps * inv_mass * p_half
        lp_new, g_new = logprob_and_grad(th_new)
        p_new = p_half + 0.5 * eps * g_new
        H = -lp_new + 0.5 * jnp.sum(inv_mass * p_new * p_new)
        H = jnp.where(jnp.isfinite(H), H, jnp.inf)
        logw = -(H - H0)
        # reservoir multinomial sampling over trajectory states
        logw_new_tot = jnp.logaddexp(logw_tot, jnp.where(active, logw, -jnp.inf))
        take = jnp.log(jax.random.uniform(k)) < (logw - logw_new_tot)
        take = jnp.logical_and(take, active)
        chosen_th = jnp.where(take, th_new, chosen_th)
        acc_sum = acc_sum + jnp.where(active, jnp.minimum(1.0, jnp.exp(logw)), 0.0)
        # freeze the integrator once past L
        th = jnp.where(active, th_new, th)
        p = jnp.where(active, p_new, p)
        g = jnp.where(active, g_new, g)
        return (th, p, g, chosen_th, logw_new_tot, acc_sum), None

    # logw of the initial state is 0 == -(H0 - H0); it seeds the reservoir
    init = (theta, -p0, g0, theta, jnp.asarray(0.0, theta.dtype), jnp.asarray(0.0, theta.dtype))
    carry, _ = jax.lax.scan(step, init, (sel_keys, jnp.arange(L_max)))
    chosen_th, acc_sum = carry[3], carry[5]
    accept_stat = acc_sum / jnp.maximum(L.astype(theta.dtype), 1.0)
    return chosen_th, accept_stat


def make_precise_logprob_and_grad(logprob):
    """value_and_grad of the target at full f32 matmul precision.

    At default precision a GPU may run float32 products in TF32 (10-bit
    mantissa); the target's x @ th products (and their grads) then carry
    ~1e-3 relative error, which is catastrophic for leapfrog energies on
    sharply curved posteriors: the Hamiltonian's error no longer shrinks
    with the step size, so chains stop mixing. The targets are tiny
    (M x d), so full f32 precision costs nothing."""
    def _lp(th):
        with jax.default_matmul_precision("highest"):
            return logprob(th)

    lpg = jax.value_and_grad(_lp)

    def logprob_and_grad(th):
        v, g = lpg(th)
        return v, g

    return logprob_and_grad


def hmc_sample(
    key: jax.Array,
    logprob: Callable[[jnp.ndarray], jnp.ndarray],
    theta0: jnp.ndarray,
    config: HMCConfig = HMCConfig(),
) -> Tuple[jnp.ndarray, dict]:
    """Single-chain adaptive HMC. Returns (samples (n_samples, d), stats)."""
    cfg = config
    logprob_and_grad = make_precise_logprob_and_grad(logprob)

    def kernel(key, th, eps, inv_mass):
        k_traj, k_L = jax.random.split(key)
        L = jax.random.randint(k_L, (), 1, cfg.L_max + 1)
        th, astat = _leapfrog_trajectory(k_traj, logprob_and_grad, th, eps, L,
                                         cfg.L_max, inv_mass)
        return th, astat, ()

    return adaptive_mcmc(key, kernel, theta0, cfg)


def adaptive_mcmc(key, kernel, theta0, cfg) -> Tuple[jnp.ndarray, dict]:
    """Stan-style adaptive sampling loop around any transition ``kernel``:
    ``kernel(key, th, eps, inv_mass) -> (th', accept_stat, extras)``.
    ``cfg`` supplies n_samples/n_warmup/target_accept/init_step_size and the
    dual-averaging constants (HMCConfig and nuts.NUTSConfig both do).
    ``extras`` is a pytree of per-draw kernel statistics, stacked over the
    sampling scan and returned under stats["extras"]."""
    dtype = theta0.dtype

    def one_iter(key, th, eps, inv_mass):
        # NOTE the key handling lives in the kernel (hmc splits k_traj/k_L —
        # streams bit-identical to the pre-refactor hmc_sample)
        return kernel(key, th, eps, inv_mass)

    # ---- warmup, two phases (Stan-style windows): ----
    # phase A: dual-average eps under identity mass, Welford-estimate the
    #          posterior variance over its second half;
    # phase B: switch to the estimated diagonal mass and re-adapt eps
    #          (changing the metric invalidates the phase-A step size).
    d = theta0.shape[0]
    n_a = cfg.n_warmup // 2
    n_b = cfg.n_warmup - n_a

    def make_warmup_phase(n_steps, collect_var, mu_da):
        # mu_da: the dual-averaging shrink anchor. Phase A anchors at
        # log(10 * init_step_size) (Hoffman & Gelman); phase B re-anchors at
        # 10x the PHASE-A ADAPTED step (Stan re-centers mu per window) —
        # anchoring B at the init again biases eps toward a stale value on
        # badly scaled targets, exactly what re-adaptation exists to fix
        # (round-3 review)
        def warmup_step(carry, inp):
            th, logeps, logeps_bar, h_bar, mean, m2, inv_mass = carry
            k, i = inp
            th, astat, _ = one_iter(k, th, jnp.exp(logeps), inv_mass)
            t = i + 1.0
            eta = 1.0 / (t + cfg.da_t0)
            h_bar = (1.0 - eta) * h_bar + eta * (cfg.target_accept - astat)
            logeps = mu_da - jnp.sqrt(t) / cfg.da_gamma * h_bar
            w = t ** (-cfg.da_kappa)
            logeps_bar = w * logeps + (1.0 - w) * logeps_bar
            if collect_var:
                in_window = i >= n_steps // 2
                cnt = jnp.maximum(i - n_steps // 2 + 1.0, 1.0)
                delta = th - mean
                mean = jnp.where(in_window, mean + delta / cnt, mean)
                m2 = jnp.where(in_window, m2 + delta * (th - mean), m2)
            return (th, logeps, logeps_bar, h_bar, mean, m2, inv_mass), astat

        return warmup_step

    logeps0 = jnp.log(jnp.asarray(cfg.init_step_size, dtype))
    init_a = (theta0, logeps0, logeps0, jnp.asarray(0.0, dtype),
              jnp.zeros(d, dtype), jnp.zeros(d, dtype), jnp.ones(d, dtype))
    keys_a = jax.random.split(jax.random.fold_in(key, 0), n_a)
    mu_a = jnp.log(10.0 * cfg.init_step_size)
    (th, _, logeps_bar_a, _, mean, m2, _), astats_a = jax.lax.scan(
        make_warmup_phase(n_a, True, mu_a), init_a,
        (keys_a, jnp.arange(n_a, dtype=dtype))
    )
    var = m2 / jnp.maximum(n_a - n_a // 2 - 1.0, 1.0)
    inv_mass = jnp.where(var > 1e-10, var, 1.0)  # inverse mass = posterior variance

    init_b = (th, logeps_bar_a, logeps_bar_a, jnp.asarray(0.0, dtype),
              jnp.zeros(d, dtype), jnp.zeros(d, dtype), inv_mass)
    keys_b = jax.random.split(jax.random.fold_in(key, 2), n_b)
    (th, _, logeps_bar, _, _, _, _), astats_b = jax.lax.scan(
        make_warmup_phase(n_b, False, logeps_bar_a + jnp.log(10.0)), init_b,
        (keys_b, jnp.arange(n_b, dtype=dtype))
    )
    wu_astats = jnp.concatenate([astats_a, astats_b])
    eps = jnp.exp(logeps_bar)

    # ---- sampling ----
    def sample_step(th, inp):
        k, _ = inp
        th, astat, extra = one_iter(k, th, eps, inv_mass)
        return th, (th, astat, extra)

    keys_s = jax.random.split(jax.random.fold_in(key, 1), cfg.n_samples)
    th, (samples, astats, extras) = jax.lax.scan(
        sample_step, th, (keys_s, jnp.arange(cfg.n_samples))
    )
    stats = {"step_size": eps, "accept_stat": jnp.mean(astats),
             "inv_mass": inv_mass, "warmup_accept": jnp.mean(wu_astats)}
    if extras != ():
        stats["extras"] = extras
    return samples, stats


@partial(jax.jit, static_argnums=(1, 3, 4))
def run_chains(key, logprob, theta0, n_chains: int = 1, config: HMCConfig = HMCConfig()):
    """vmap chains; theta0 (d,) is jittered per chain."""
    keys = jax.random.split(key, n_chains)
    inits = theta0 + 0.1 * jax.random.normal(jax.random.fold_in(key, 99),
                                             (n_chains,) + theta0.shape, dtype=theta0.dtype)
    return jax.vmap(lambda k, t0: hmc_sample(k, logprob, t0, config))(keys, inits)


def run_chains_sharded(key, logprob, theta0, n_chains: int, mesh,
                       config: HMCConfig = HMCConfig()):
    """``run_chains`` with the chain axis sharded over all mesh devices
    (lane parallelism, like the BPSVI size axis): each device runs its
    chains' full warmup+sampling locally, zero collectives. True chains use
    ``run_chains``'s exact key/init streams; padding lanes (to reach a
    device multiple) are dropped. Feed the result to
    ``inference.diagnostics.summarize_chains`` for split-R-hat / ESS.

    Pass a ``nuts.NUTSConfig`` to run dynamic-trajectory NUTS chains
    instead of jittered HMC (same key/init streams as
    ``nuts.run_chains_nuts``)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..parallel.mesh import DATA_AXIS, SAMP_AXIS, require_axes

    n_data, n_samp = require_axes(mesh)
    n_dev = n_data * n_samp
    pad = (-n_chains) % n_dev
    lane = NamedSharding(mesh, P((DATA_AXIS, SAMP_AXIS)))
    keys = jax.random.split(key, n_chains)
    inits = theta0 + 0.1 * jax.random.normal(jax.random.fold_in(key, 99),
                                             (n_chains,) + theta0.shape, dtype=theta0.dtype)
    if pad:
        keys = jnp.concatenate(
            [keys, jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(pad))])
        inits = jnp.concatenate([inits, jnp.broadcast_to(theta0, (pad,) + theta0.shape)])
    keys = jax.device_put(keys, lane)
    inits = jax.device_put(inits, lane)
    return _run_chains_padded(keys, inits, logprob, config, n_chains)


@partial(jax.jit, static_argnums=(2, 3, 4))
def _run_chains_padded(keys, inits, logprob, config, n_true: int):
    # module-level jit: one compiled program per (logprob, config, shapes) —
    # a per-call inner jit would recompile the whole warmup+sampling program
    # on every invocation. Dispatch on the config type (duck-typed to avoid
    # a module-import cycle: nuts.py imports this module).
    if hasattr(config, "max_treedepth"):
        from .nuts import nuts_sample as _sample
    else:
        _sample = hmc_sample
    samples, stats = jax.vmap(lambda k, t0: _sample(k, logprob, t0, config))(keys, inits)
    return samples[:n_true], jax.tree.map(lambda s: s[:n_true], stats)


def weighted_logreg_logprob(Z, w):
    """The weighted Bayesian-logreg evaluation target (the reference's
    weighted Stan program, zellner_logreg/main.py:24-43)."""
    from ..models import logreg

    return lambda th: logreg.log_joint(Z, th, w)


def hmc_sample_full_logreg(key, Z, theta0, config: HMCConfig = HMCConfig(),
                           n_subsample: int = 5000):
    """Full-data logreg posterior via HMC on a uniform data subsample with
    unit weights (reference mcmc_noXt.py:19-46: Stan NUTS on 5k random rows
    as a tractable stand-in for the full posterior). Returns
    (samples, stats); pass n_subsample >= len(Z) to skip subsampling."""
    k_sub, k_hmc = jax.random.split(key)
    n = min(n_subsample, Z.shape[0])
    if n >= Z.shape[0]:
        # actually skip (round-3 review): the old path always drew WITH
        # replacement, so n == N was a bootstrap resample (~36.8% of rows
        # dropped), not the full posterior the docstring promises
        Zs = Z
    else:
        idcs = jax.random.randint(k_sub, (n,), 0, Z.shape[0])
        Zs = Z[idcs]
    return hmc_sample_weighted_logreg(k_hmc, Zs, jnp.ones(n, dtype=Zs.dtype),
                                      theta0, config)


def make_weighted_hmc(log_joint):
    """Jitted weighted-posterior HMC entry points for any model exposing
    ``log_joint(Z, theta, w)`` (logreg, poisson, ... — each the weighted
    extension of the reference's Stan programs). Returns ``(sample, chains)``
    with the coreset (Z, w) as ARGUMENTS: one compiled program serves every
    same-shape coreset (zero-weight rows are inert, so pad sizes to one
    capacity; a closure over (Z, w) would re-trace per coreset).

    ``sample(key, Z, w, theta0, config)`` -> ((n, d) draws, stats);
    ``chains(key, Z, w, theta0, n_chains, config)`` -> ((C, n, d), per-chain
    stats) — feed the stack to ``diagnostics.summarize_chains``. (The
    reference evaluates with a single unchecked PyStan chain,
    examples/common/mcmc.py:32 ``chains=1``.)"""

    @partial(jax.jit, static_argnums=(4,))
    def sample(key, Z, w, theta0, config: HMCConfig = HMCConfig()):
        return hmc_sample(key, lambda th: log_joint(Z, th, w), theta0, config)

    @partial(jax.jit, static_argnums=(4, 5))
    def chains(key, Z, w, theta0, n_chains: int = 2,
               config: HMCConfig = HMCConfig()):
        logprob = lambda th: log_joint(Z, th, w)
        keys = jax.random.split(key, n_chains)
        inits = theta0 + 0.1 * jax.random.normal(
            jax.random.fold_in(key, 99), (n_chains,) + theta0.shape,
            dtype=theta0.dtype)
        return jax.vmap(lambda k, t0: hmc_sample(k, logprob, t0, config))(keys, inits)

    return sample, chains


def _logreg_weighted():
    from ..models import logreg

    return make_weighted_hmc(logreg.log_joint)


def _poisson_weighted():
    from ..models import poisson

    return make_weighted_hmc(poisson.log_joint)


def hmc_sample_weighted_logreg(key, Z, w, theta0, config: HMCConfig = HMCConfig()):
    """Weighted-logreg HMC (see ``make_weighted_hmc``)."""
    global _LOGREG_HMC
    if _LOGREG_HMC is None:
        _LOGREG_HMC = _logreg_weighted()
    return _LOGREG_HMC[0](key, Z, w, theta0, config)


def run_chains_weighted_logreg(key, Z, w, theta0, n_chains: int = 2,
                               config: HMCConfig = HMCConfig()):
    """Multi-chain weighted-logreg HMC (see ``make_weighted_hmc``)."""
    global _LOGREG_HMC
    if _LOGREG_HMC is None:
        _LOGREG_HMC = _logreg_weighted()
    return _LOGREG_HMC[1](key, Z, w, theta0, n_chains, config)


def hmc_sample_weighted_poisson(key, Z, w, theta0, config: HMCConfig = HMCConfig()):
    """Weighted-Poisson HMC: the weighted extension of the reference's
    Poisson Stan program (stan_code.py:22-42), which the reference samples
    with PyStan NUTS but ships no driver for."""
    global _POISSON_HMC
    if _POISSON_HMC is None:
        _POISSON_HMC = _poisson_weighted()
    return _POISSON_HMC[0](key, Z, w, theta0, config)


def run_chains_weighted_poisson(key, Z, w, theta0, n_chains: int = 2,
                                config: HMCConfig = HMCConfig()):
    """Multi-chain weighted-Poisson HMC (see ``make_weighted_hmc``)."""
    global _POISSON_HMC
    if _POISSON_HMC is None:
        _POISSON_HMC = _poisson_weighted()
    return _POISSON_HMC[1](key, Z, w, theta0, n_chains, config)


_LOGREG_HMC = None
_POISSON_HMC = None
