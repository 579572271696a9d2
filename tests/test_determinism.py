"""Determinism and jit/no-jit equivalence (SURVEY.md section 4 additions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import betacores_tpu as bc
from betacores_tpu.coresets import IncrementalConfig, init_state, make_incremental_builder
from betacores_tpu.inference import gaussian_conjugate_sampler
from betacores_tpu.models import gaussian as gmod


@pytest.fixture
def problem(rng):
    d = 3
    Sig = 2.0 * np.eye(d)
    Siginv = jnp.asarray(np.linalg.inv(Sig))
    ld = float(np.linalg.slogdet(Sig)[1])
    X = jnp.asarray(rng.normal(size=(120, d)))
    model = gmod.bundle(Siginv, ld)
    sampler = gaussian_conjugate_sampler(jnp.zeros(d), jnp.eye(d), Siginv)
    cfg = IncrementalConfig(projection_dim=16, n_subsample_select=32,
                            n_subsample_opt=16, opt_itrs=10, i0=0.5)
    return X, model, sampler, cfg


def test_same_key_same_build(problem):
    X, model, sampler, cfg = problem
    b = make_incremental_builder(X, model, sampler, cfg)
    st0 = init_state(16, X.shape[1], dtype=X.dtype)
    s1 = b.build(jax.random.key(7), st0, 5)
    s2 = b.build(jax.random.key(7), st0, 5)
    np.testing.assert_array_equal(np.asarray(s1.idcs), np.asarray(s2.idcs))
    np.testing.assert_allclose(np.asarray(s1.wts), np.asarray(s2.wts), rtol=0)


def test_different_key_different_build(problem):
    X, model, sampler, cfg = problem
    b = make_incremental_builder(X, model, sampler, cfg)
    st0 = init_state(16, X.shape[1], dtype=X.dtype)
    s1 = b.build(jax.random.key(7), st0, 5)
    s2 = b.build(jax.random.key(8), st0, 5)
    assert not np.array_equal(np.asarray(s1.idcs), np.asarray(s2.idcs)) or \
        not np.allclose(np.asarray(s1.wts), np.asarray(s2.wts))


def test_jit_no_jit_equivalence(problem):
    """The jitted build equals the same trace evaluated eagerly. Small step
    budget on purpose: equivalence is per-op, not per-step, and the eager
    arm dispatches every op through Python (this test dominated the suite
    at the fixture's 10x3 budget — 99 s, nearly all disable_jit time)."""
    import dataclasses

    X, model, sampler, cfg = problem
    cfg = dataclasses.replace(cfg, opt_itrs=2)
    b = make_incremental_builder(X, model, sampler, cfg)
    st0 = init_state(16, X.shape[1], dtype=X.dtype)
    jitted = np.asarray(b.build(jax.random.key(3), st0, 2).wts)
    with jax.disable_jit():
        eager = np.asarray(b.build(jax.random.key(3), st0, 2).wts)
    np.testing.assert_allclose(jitted, eager, rtol=1e-10, atol=1e-12)


def test_dynamic_itrs_single_compilation(problem):
    """itrs is a traced operand: different build sizes reuse one compiled
    program (each compilation costs seconds)."""
    X, model, sampler, cfg = problem
    b = make_incremental_builder(X, model, sampler, cfg)
    st0 = init_state(16, X.shape[1], dtype=X.dtype)
    _ = b.build(jax.random.key(0), st0, 1)
    n0 = b.build._cache_size()
    _ = b.build(jax.random.key(0), st0, 4)
    _ = b.build(jax.random.key(0), st0, 9)
    assert b.build._cache_size() == n0 == 1


def test_eager_wrapper_seed_reproducibility(problem, rng):
    """Two eager instances with the same seed produce identical coresets;
    different seeds differ (replaces the reference's global np.random.seed
    coupling, zellner_logreg/main.py:22)."""
    X, model, sampler, cfg = problem
    prj = bc.BlackBoxProjector(sampler, 16, model.log_likelihood)
    mk = lambda seed: bc.SparseVICoreset(X, prj, opt_itrs=10, seed=seed,
                                         n_subsample_select=32, n_subsample_opt=16)
    a, b2 = mk(9), mk(9)
    for m in range(1, 4):
        a.build(1, m)
        b2.build(1, m)
    wa, pa, ia = a.get()
    wb, pb, ib = b2.get()
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(wa, wb, rtol=0)


class TestInputValidation:
    """Reference contract: garbage constructor input raises ValueError
    (reference tests/test_snnls/test_sampling.py:100-123)."""

    BAD = ["fdas", np.array(["fdsa", "asdf"]), np.zeros((0, 3)), np.zeros(5)]

    def test_coreset_classes_reject_garbage(self):
        for bad in self.BAD:
            for cls in (bc.UniformSamplingCoreset,):
                with pytest.raises(ValueError):
                    cls(bad, seed=0)

    def test_snnls_rejects_garbage(self):
        from betacores_tpu.snnls import GIGA
        for bad in ("fdas", np.array(["a", "b"]), np.zeros(4)):
            with pytest.raises(ValueError):
                GIGA(bad, np.ones(3))
        with pytest.raises(ValueError):
            GIGA(np.ones((3, 5)), np.ones(4))  # shape mismatch


def test_builds_do_not_mutate_input(problem):
    """Reference invariant: construction/builds leave the input data intact
    (reference tests/test_snnls/test_sampling.py:65-66)."""
    X, model, sampler, cfg = problem
    X0 = np.asarray(X).copy()
    prj = bc.BlackBoxProjector(sampler, 16, model.log_likelihood)
    alg = bc.SparseVICoreset(X, prj, opt_itrs=5, seed=0, max_size=8)
    alg.build(3, 3)
    np.testing.assert_array_equal(np.asarray(X), X0)
    alg2 = bc.UniformSamplingCoreset(X, seed=0)
    alg2.build(3, 3)
    alg2.get()
    np.testing.assert_array_equal(np.asarray(X), X0)


def test_build_clean_under_debug_nans(problem):
    """The JAX equivalent of the reference's np.seterr(all='raise') in tests
    (reference test_deterministic.py:6): a representative beta build must
    not produce NaN/inf in any intermediate under jax_debug_nans."""
    X, model, sampler, cfg = problem
    cfg = IncrementalConfig(projection_dim=16, n_subsample_select=32,
                            n_subsample_opt=16, opt_itrs=8, i0=0.5,
                            use_beta=True, learn_beta=True)
    b = make_incremental_builder(X, model, sampler, cfg)
    st0 = init_state(16, X.shape[1], beta=0.3, dtype=X.dtype)
    jax.config.update("jax_debug_nans", True)
    try:
        with jax.disable_jit():  # debug_nans checks intermediates when eager
            st = b.build(jax.random.key(0), st0, 3)
        assert np.isfinite(np.asarray(st.wts)).all()
    finally:
        jax.config.update("jax_debug_nans", False)
