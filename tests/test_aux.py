"""Auxiliary subsystems: checkpoint/resume, profiling, DP-BPSVI, plotting,
sweep grids."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import betacores_tpu as bc
from betacores_tpu.config import linearize
from betacores_tpu.coresets import gaussian_rdp_epsilon, init_state
from betacores_tpu.inference import fixed_sampler
from betacores_tpu.models import gaussian as gmod
from betacores_tpu.utils.checkpoint import config_tag, load_state, save_state
from betacores_tpu.utils.profiling import Timings


def test_checkpoint_roundtrip(tmp_path):
    st = init_state(16, 3, beta=0.25, dtype=jnp.float64)
    st = st._replace(wts=st.wts.at[0].set(2.5), idcs=st.idcs.at[0].set(7),
                     m=jnp.asarray(1, dtype=jnp.int32))
    key = jax.random.key(5)
    path = os.path.join(tmp_path, "ck")
    save_state(path, st, key=key, extra={"alg": "BCORES"})
    st2, key2, extra = load_state(path)
    np.testing.assert_allclose(np.asarray(st2.wts), np.asarray(st.wts))
    np.testing.assert_array_equal(np.asarray(st2.idcs), np.asarray(st.idcs))
    assert int(st2.m) == 1 and float(st2.beta) == pytest.approx(0.25)
    assert extra["alg"] == "BCORES"
    # restored key generates the identical stream
    np.testing.assert_array_equal(
        np.asarray(jax.random.normal(key2, (4,))),
        np.asarray(jax.random.normal(key, (4,))))


def test_config_tag_and_linearize():
    assert config_tag({"alg": "BCORES", "f_rate": 0.1}) == "alg_BCORES_f_rate_0.1"
    grid = linearize({"a": [1, 2], "b": ["x", "y", "z"]})
    assert len(grid) == 6 and grid[0] == {"a": 1, "b": "x"}


def test_timings(tmp_path):
    t = Timings()
    with t.section("projection") as sec:
        sec.hold(jnp.ones(10).sum())
    assert t.total("projection") > 0
    t.save(os.path.join(tmp_path, "run"))
    assert os.path.exists(os.path.join(tmp_path, "run_projection_time.npy"))


def test_rdp_accountant_monotone():
    e1 = gaussian_rdp_epsilon(100, 1.0, 1e-5)
    e2 = gaussian_rdp_epsilon(400, 1.0, 1e-5)
    e3 = gaussian_rdp_epsilon(100, 2.0, 1e-5)
    assert e2 > e1 > e3 > 0


def test_sgm_rdp_gaussian_identity_and_small_q():
    """q=1 must equal the plain Gaussian RDP alpha/(2 sigma^2) exactly; the
    small-q leading order is C(a,2) q^2 (e^{1/s^2}-1) / (a-1)."""
    from betacores_tpu.coresets import sgm_rdp

    orders = np.array([2, 4, 16, 64])
    np.testing.assert_allclose(sgm_rdp(1.0, 2.0, orders), orders / (2 * 4.0),
                               rtol=1e-12)
    # small-q leading (k=2) order — only where the k=alpha tail term
    # q^a e^{a(a-1)/2s^2} is negligible (at high alpha / small sigma that
    # tail genuinely dominates: the known SGM large-order blow-up)
    q, s = 1e-5, 1.5
    low = np.array([2, 4, 16])
    lead = (low * q ** 2 * (np.exp(1.0 / s ** 2) - 1.0) / 2)
    np.testing.assert_allclose(sgm_rdp(q, s, low), lead, rtol=1e-3)
    assert np.all(sgm_rdp(0.0, 1.0, orders) == 0.0)


@pytest.mark.parametrize("q,sigma", [(0.1, 1.0), (0.01, 2.0), (0.5, 0.8)])
def test_sgm_rdp_matches_numerical_integration(q, sigma):
    """Independent oracle: the Renyi divergence of the sampled Gaussian
    mechanism's mixture mu = (1-q)N(0,s^2) + qN(1,s^2) against N(0,s^2),
    D_a = 1/(a-1) log E_{z~mu0}[(mu/mu0)^a], by direct quadrature —
    validates the closed-form integer-alpha formula (Mironov et al. 2019)
    the accountant uses, with no shared code."""
    from scipy.integrate import quad

    from betacores_tpu.coresets import sgm_rdp

    for a in (2, 3, 8, 32):
        def log_integrand(z):
            log_p0 = -z ** 2 / (2 * sigma ** 2) - 0.5 * np.log(2 * np.pi * sigma ** 2)
            log_ratio = np.logaddexp(np.log1p(-q),
                                     np.log(q) + (2 * z - 1) / (2 * sigma ** 2))
            return log_p0 + a * log_ratio

        # the raw integrand overflows float64 at small sigma / large alpha
        # (the integral itself is e^{hundreds}); integrate the shifted
        # exp(logI - shift) and add the shift back in log space
        zg = np.linspace(-50 * sigma, 50 * sigma + 1, 20001)
        shift = float(np.max(log_integrand(zg)))
        val, _ = quad(lambda z: np.exp(log_integrand(z) - shift),
                      -50 * sigma, 50 * sigma + 1, limit=400)
        oracle = (shift + np.log(val)) / (a - 1)
        got = float(sgm_rdp(q, sigma, np.array([a]))[0])
        assert got == pytest.approx(oracle, rel=1e-6), (a, got, oracle)


def test_subsampled_epsilon_amplification():
    """The canonical DP-SGD anchor (Abadi-style MNIST config: q=256/60000,
    nm=1.1, ~60 epochs, delta=1e-5) lands at the well-known eps ~ 3; the
    amplified bound must crush the unamplified one at the dp_bpsvi example
    config; and the truncation mass must be charged, not ignored."""
    from betacores_tpu.coresets import (poisson_batch_cap, poisson_overflow_p,
                                        subsampled_gaussian_epsilon)

    eps_anchor = subsampled_gaussian_epsilon(
        14060, 256 / 60000, 1.1, 1e-5, init_releases=0)
    assert 2.2 < eps_anchor < 3.6, eps_anchor
    # dp_bpsvi frontier shape: N=5000, n_opt=200 -> q=0.04, T=300
    eps_amp = subsampled_gaussian_epsilon(300, 0.04, 1.0, 1e-5)
    eps_unamp = gaussian_rdp_epsilon(300, 1.0, 1e-5)
    assert eps_amp < eps_unamp / 20
    assert 0 < eps_amp < 10
    # overflow accounting: a tight cap must raise, a sane cap is negligible
    cap = poisson_batch_cap(5000, 0.1)
    assert poisson_overflow_p(5000, 0.1, cap) < 1e-16
    with pytest.raises(ValueError):
        subsampled_gaussian_epsilon(300, 0.1, 1.0, 1e-5, n=5000, cap=500)


def test_dp_bpsvi_build(rng):
    d = 3
    Sig = np.eye(d)
    X = rng.normal(size=(200, d))
    model = gmod.bundle(jnp.asarray(Sig), 0.0)
    samples = jnp.asarray(rng.normal(size=(8, d)))
    prj = bc.BlackBoxProjector(fixed_sampler(samples), 8, model.log_likelihood,
                               model.grad_z_log_likelihood)
    alg = bc.DiffPrivBatchPSVICoreset(jnp.asarray(X), prj, opt_itrs=30,
                                      n_subsample_opt=64, noise_multiplier=1.0,
                                      seed=0, sampling="swr")
    alg.build(1, 6)
    w, p = alg.get()
    assert len(w) >= 1 and (w >= 0).all()
    assert np.isfinite(p).all()
    eps = alg.epsilon()
    # honest substitution accounting (round 3): 30 steps at sens 2C + the
    # init release at nm=1 compose to eps ~ 114
    assert 0 < eps < 200
    assert eps == pytest.approx(gaussian_rdp_epsilon(30, 1.0, 1e-5))
    # pseudo-points must not be raw data rows (privacy of initialization)
    dists = np.min(np.linalg.norm(p[:, None, :] - X[None, :, :], axis=-1), axis=1)
    assert (dists > 1e-6).all()


def test_dp_bpsvi_poisson_build(rng):
    """Default (round 4) Poisson mode: builds run, epsilon uses the
    amplified accountant, and the pseudo-points stay off the raw rows."""
    from betacores_tpu.coresets import poisson_batch_cap, subsampled_gaussian_epsilon

    d = 3
    Sig = np.eye(d)
    X = rng.normal(size=(200, d))
    model = gmod.bundle(jnp.asarray(Sig), 0.0)
    samples = jnp.asarray(rng.normal(size=(8, d)))
    prj = bc.BlackBoxProjector(fixed_sampler(samples), 8, model.log_likelihood,
                               model.grad_z_log_likelihood)
    alg = bc.DiffPrivBatchPSVICoreset(jnp.asarray(X), prj, opt_itrs=30,
                                      n_subsample_opt=64, noise_multiplier=1.0,
                                      seed=0)
    alg.build(1, 6)
    w, p = alg.get()
    assert len(w) >= 1 and (w >= 0).all() and np.isfinite(p).all()
    q = 64 / 200
    expect = subsampled_gaussian_epsilon(30, q, 1.0, 1e-5, n=200,
                                         cap=poisson_batch_cap(200, q))
    assert alg.epsilon() == pytest.approx(expect)
    assert alg.epsilon() < gaussian_rdp_epsilon(30, 1.0, 1e-5)
    dists = np.min(np.linalg.norm(p[:, None, :] - X[None, :, :], axis=-1), axis=1)
    assert (dists > 1e-6).all()


def test_plotting_helpers(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from betacores_tpu.plotting import median_iqr, plot_curves, plot_gaussian_ellipse

    arr = np.random.default_rng(0).normal(size=(5, 10)) ** 2 + 0.1
    med, lo, hi = median_iqr(arr)
    assert (lo <= med).all() and (med <= hi).all()
    fig, ax = plt.subplots()
    plot_curves(ax, {"BCORES": arr, "RAND": arr * 2}, ylabel="kl")
    plot_gaussian_ellipse(ax, np.zeros(2), np.eye(2))
    fig.savefig(os.path.join(tmp_path, "p.png"))


def test_persistent_cache_repoints_and_survives_bad_env(tmp_path, monkeypatch):
    from betacores_tpu.utils import cache

    import jax

    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(cache, "_enabled_dir", None)
    monkeypatch.delenv("BETACORES_NO_COMPILATION_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    # malformed size cap must not raise (import-time path)
    monkeypatch.setenv("BETACORES_COMPILATION_CACHE_MAX_GB", "10GB")
    # cpu-only platforms skip (conftest forces cpu)
    assert cache.enable_persistent_cache(str(tmp_path / "a")) is None

    # pretend a GPU platform: enabling, then re-pointing to a NEW dir works
    monkeypatch.setattr(cache, "_cpu_only", lambda: False)
    d1 = cache.enable_persistent_cache(str(tmp_path / "a"))
    d2 = cache.enable_persistent_cache(str(tmp_path / "a"))  # idempotent
    d3 = cache.enable_persistent_cache(str(tmp_path / "b"))  # explicit re-point
    assert d1 == str(tmp_path / "a") == d2
    assert d3 == str(tmp_path / "b")
    jax.config.update("jax_compilation_cache_dir", prev)


def test_persistent_cache_env_dir_wins(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR is the cache, whatever the caller asks for
    and even in a CPU-only process; no other directory is set."""
    import jax

    from betacores_tpu.utils import cache

    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(cache, "_enabled_dir", None)
    monkeypatch.delenv("BETACORES_NO_COMPILATION_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    try:
        assert cache.enable_persistent_cache(str(tmp_path / "arg")) == str(tmp_path / "env")
        assert cache.enable_persistent_cache() == str(tmp_path / "env")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "env")
        assert not (tmp_path / "arg").exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_persistent_cache_default_dir_is_in_checkout(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache sits at the fixed,
    gitignored path <checkout>/.cache/jax_compile, never under HOME."""
    import jax

    from betacores_tpu.utils import cache

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expected = os.path.join(root, ".cache", "jax_compile")
    assert cache.DEFAULT_DIR == expected
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(cache, "_enabled_dir", None)
    monkeypatch.setattr(cache, "_cpu_only", lambda: False)
    monkeypatch.delenv("BETACORES_NO_COMPILATION_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", "/nonexistent-home")
    try:
        assert cache.enable_persistent_cache() == expected
        assert jax.config.jax_compilation_cache_dir == expected
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".cache/" in fh.read().split()


def test_shf_params_checkpoint_roundtrip(tmp_path):
    """Generic NamedTuple param checkpoint: a trained flow resumes exactly."""
    from betacores_tpu.inference import SHFConfig, SHFParams, init_shf_params
    from betacores_tpu.utils.checkpoint import load_params, save_params

    params = init_shf_params(jnp.ones((5, 3)), 3, 100,
                             SHFConfig(n_blocks=2))
    params = params._replace(w=params.w.at[0].set(7.5))
    path = os.path.join(tmp_path, "flow")
    save_params(path, params, extra={"beta": 0.5})
    p2, extra = load_params(path, SHFParams)
    for a, b in zip(params, p2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert extra["beta"] == 0.5


def test_logging_adapter_and_verbosity():
    """Reference log contract (util/log.py): tagged per-instance adapters,
    'levelname - id.funcName(): message' format, set_verbosity knob,
    invalid level rejected."""
    import logging

    from betacores_tpu.utils.logging import _FMT, get_logger, set_verbosity

    assert _FMT == "%(levelname)s - %(id)s.%(funcName)s(): %(message)s"
    log = get_logger("TestAlg")
    assert log.extra["id"].startswith("TestAlg-")
    import io

    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    h.setFormatter(logging.Formatter(_FMT))
    root = logging.getLogger("betacores_tpu")
    root.addHandler(h)
    try:
        log.error("boom")
    finally:
        root.removeHandler(h)
    assert (f"ERROR - {log.extra['id']}.test_logging_adapter_and_verbosity(): "
            "boom") in buf.getvalue()
    try:
        set_verbosity("info")
        root = logging.getLogger("betacores_tpu")
        assert root.level == logging.INFO
        log2 = get_logger("TestAlg")
        assert log2.extra["id"] != log.extra["id"]  # fresh tag per instance
        with pytest.raises(ValueError):
            set_verbosity("loud")
    finally:
        set_verbosity("error")


def test_evaluation_metrics_closed_forms(rng):
    """reverse_forward_kl on identical posteriors is (0, 0); regression
    RMSE/NLL match a hand computation."""
    import math

    from betacores_tpu.evaluation import regression_rmse_nll, reverse_forward_kl
    from betacores_tpu.models.gaussian import weighted_post

    d = 3
    X = jnp.asarray(rng.normal(size=(40, d)))
    post = weighted_post(jnp.zeros(d), jnp.eye(d), jnp.eye(d), X, jnp.ones(40))
    rkl, fkl = reverse_forward_kl(post, post)
    assert abs(float(rkl)) < 1e-8 and abs(float(fkl)) < 1e-8

    Xt = jnp.asarray(rng.normal(size=(10, d)))
    yt = jnp.asarray(rng.normal(size=10))
    thetas = jnp.asarray(rng.normal(size=(5, d)))
    rmse, nll = regression_rmse_nll(Xt, yt, thetas, sigsq=2.0)
    preds = np.asarray(Xt @ thetas.T)
    want_rmse = np.sqrt(np.mean((preds.mean(1) - np.asarray(yt)) ** 2))
    np.testing.assert_allclose(float(rmse), want_rmse, rtol=1e-6)
    ll = (-0.5 * np.log(2 * math.pi * 2.0)
          - (np.asarray(yt)[:, None] - preds) ** 2 / 4.0)
    want_nll = -np.mean(np.log(np.exp(ll).mean(axis=1)))
    np.testing.assert_allclose(float(nll), want_nll, rtol=1e-5)


def test_export_program_roundtrip(tmp_path, rng):
    """utils/export.py deployment artifacts: the serialized+reloaded build
    program is bit-identical to the live builder, itrs stays a traced
    operand (one artifact, every build size), and a multi-platform artifact
    lowers for cuda without a GPU."""
    import jax

    from betacores_tpu.coresets import IncrementalConfig, init_state, make_incremental_builder
    from betacores_tpu.inference import gaussian_conjugate_sampler
    from betacores_tpu.models import gaussian as gmod
    from betacores_tpu.utils import (export_incremental_build, load_program,
                                     load_program_file, save_program)

    d = 3
    Sig = np.eye(d) * 2.0
    Siginv = np.linalg.inv(Sig)
    X = jnp.asarray(rng.normal(size=(40, d)))
    model = gmod.bundle(jnp.asarray(Siginv), np.linalg.slogdet(Sig)[1])
    smp = gaussian_conjugate_sampler(jnp.zeros(d), jnp.eye(d), jnp.asarray(Siginv))
    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=16,
                            n_subsample_opt=12, opt_itrs=6, i0=0.5, use_beta=True)
    builder = make_incremental_builder(X, model, smp, cfg)
    st0 = init_state(8, d, beta=0.4, dtype=X.dtype)
    key = jax.random.key(5)

    data = export_incremental_build(builder, X, st0)
    call = load_program(data)
    for itrs in (2, 5):  # traced operand: one artifact, every size
        st_live = builder.build(key, st0, itrs)
        st_art = call(X, key, st0, jnp.asarray(itrs, dtype=jnp.int32))
        np.testing.assert_array_equal(np.asarray(st_live.wts), np.asarray(st_art.wts))
        np.testing.assert_array_equal(np.asarray(st_live.idcs), np.asarray(st_art.idcs))

    # file roundtrip
    p = save_program(str(tmp_path / "build.jaxexport"),
                     lambda dd, k, s, i: builder.build_with_data(dd, None, k, s, i),
                     X, key, st0, jnp.zeros((), jnp.int32))
    st_f = load_program_file(p)(X, key, st0, jnp.asarray(3, jnp.int32))
    np.testing.assert_array_equal(np.asarray(st_f.idcs),
                                  np.asarray(builder.build(key, st0, 3).idcs))

    # cross-platform artifact (serving parity with the AOT dress rehearsal)
    multi = export_incremental_build(builder, X, st0, platforms=("cpu", "cuda"))
    st_m = load_program(multi)(X, key, st0, jnp.asarray(2, jnp.int32))
    np.testing.assert_array_equal(np.asarray(st_m.idcs),
                                  np.asarray(builder.build(key, st0, 2).idcs))


def test_export_weighted_builder_defaults_to_weighted_program(tmp_path, rng):
    """A builder constructed with data_weights must export the WEIGHTED
    program by default: the artifact's selections match the live builder and
    never include zero-weight rows (code-review regression)."""
    import jax

    from betacores_tpu.coresets import IncrementalConfig, init_state, make_incremental_builder
    from betacores_tpu.inference import gaussian_conjugate_sampler
    from betacores_tpu.models import gaussian as gmod
    from betacores_tpu.utils import export_incremental_build, load_program

    d = 3
    Siginv = np.linalg.inv(np.eye(d) * 2.0)
    X = jnp.asarray(rng.normal(size=(40, d)))
    u = np.ones(40)
    u[:20] = 0.0
    model = gmod.bundle(jnp.asarray(Siginv), float(np.linalg.slogdet(np.eye(d) * 2.0)[1]))
    smp = gaussian_conjugate_sampler(jnp.zeros(d), jnp.eye(d), jnp.asarray(Siginv))
    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=16,
                            n_subsample_opt=12, opt_itrs=6, i0=0.5)
    b = make_incremental_builder(X, model, smp, cfg,
                                 data_weights=jnp.asarray(u, dtype=X.dtype))
    st0 = init_state(8, d, dtype=X.dtype)
    key = jax.random.key(2)
    art = export_incremental_build(b, X, st0)
    # the weighted artifact takes (data, u, key, state, itrs)
    st_art = load_program(art)(X, jnp.asarray(u, dtype=X.dtype), key, st0,
                               jnp.asarray(5, jnp.int32))
    st_live = b.build(key, st0, 5)
    np.testing.assert_array_equal(np.asarray(st_art.idcs), np.asarray(st_live.idcs))
    sel = np.asarray(st_art.idcs)[: int(st_art.m)]
    assert (sel >= 20).all(), sel


def test_export_logreg_headline_builder_for_cpu_and_cuda(rng):
    """The headline model (logreg + warm-started Newton-Laplace sampler on
    the pre-drawn refinement path) exports as one ("cpu", "cuda") artifact
    on a host without a GPU; the CUDA half lowers its Cholesky to cuSOLVER,
    and the CPU half reproduces the live build exactly."""
    import jax

    from betacores_tpu.coresets import IncrementalConfig, init_state, make_incremental_builder
    from betacores_tpu.inference import logreg_laplace_sampler
    from betacores_tpu.models import logreg
    from betacores_tpu.utils import export_incremental_build, load_program

    X = rng.normal(1.0, 1.0, size=(300, 4))
    y = np.where(rng.uniform(size=300) < 0.8, 1.0, -1.0)
    Z = jnp.asarray(y[:, None] * X)
    b = make_incremental_builder(
        Z, logreg.bundle(), logreg_laplace_sampler(),
        IncrementalConfig(projection_dim=8, n_subsample_select=32,
                          n_subsample_opt=20, opt_itrs=4, use_beta=True))
    st0 = init_state(8, 4, beta=0.3, dtype=Z.dtype)
    key = jax.random.key(1)
    art = export_incremental_build(b, Z, st0, platforms=("cpu", "cuda"))
    exp = jax.export.deserialize(art)
    assert exp.platforms == ("cpu", "cuda")
    assert "cusolver" in exp.mlir_module()
    st_art = load_program(art)(Z, key, st0, jnp.asarray(3, jnp.int32))
    st_live = b.build(key, st0, 3)
    np.testing.assert_array_equal(np.asarray(st_art.idcs), np.asarray(st_live.idcs))
    np.testing.assert_array_equal(np.asarray(st_art.wts), np.asarray(st_live.wts))


def test_trace_reduction_interval_union():
    """examples/trace_build.py's busy time is the union of device event
    intervals: overlaps and nesting count once, gaps not at all."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "trace_build", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples", "trace_build.py"))
    tb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tb)
    assert tb.union_ns([]) == 0
    assert tb.union_ns([(0, 10)]) == 10
    assert tb.union_ns([(0, 10), (5, 15)]) == 15          # overlap
    assert tb.union_ns([(0, 10), (2, 3), (20, 25)]) == 15  # nested + gap
    assert tb.union_ns([(20, 25), (0, 10), (10, 12)]) == 17  # unsorted, touching
