"""snnls solver tests: the deterministic invariant battery over pathological
data generators (SURVEY.md section 4 item 1, mirroring reference
tests/test_snnls/test_deterministic.py:18-112) plus golden trajectory
agreement with the independent NumPy oracle and the jitted-NNLS vs
Lawson-Hanson check."""

import jax.numpy as jnp
import numpy as np
import pytest

from betacores_tpu import snnls
from oracle.opt import nnls_lawson_hanson
from oracle.snnls import OracleFrankWolfe, OracleGIGA, OracleOrthoPursuit


def gendata(rng, N, D, dist):
    """Pathological data generator (spec: reference test_deterministic.py:18-35)."""
    if dist == "gauss":
        x = rng.normal(size=(N, D))
    elif dist == "bin":
        x = (rng.uniform(size=(N, D)) > 0.5).astype(float)
    elif dist == "gauss_colinear":
        x = rng.normal(size=D)
        y = rng.uniform(size=N) * 2.0 - 1.0
        x = y[:, None] * x
    elif dist == "bin_colinear":
        x = (rng.uniform(size=D) > 0.5).astype(float)
        y = rng.uniform(size=N) * 2.0 - 1.0
        x = y[:, None] * x
    else:  # axis-aligned
        x = np.zeros((N, D))
        for i in range(N):
            x[i, i % D] = 1.0 + rng.normal() * 0.1
    # drop zero rows (solvers require nonzero columns)
    keep = np.sqrt((x**2).sum(axis=1)) > 1e-9
    x = x[keep]
    return x


SOLVERS = {
    "GIGA": (snnls.GIGA, OracleGIGA),
    "FrankWolfe": (snnls.FrankWolfe, OracleFrankWolfe),
    "OrthoPursuit": (snnls.OrthoPursuit, OracleOrthoPursuit),
}

CASES = [
    (dist, N, D)
    for dist in ["gauss", "bin", "gauss_colinear", "axis"]
    for N in [1, 10, 50]
    for D in [1, 3, 10]
]


@pytest.mark.parametrize("name", list(SOLVERS))
@pytest.mark.parametrize("dist,N,D", CASES)
def test_invariants(name, dist, N, D, rng):
    cls, _ = SOLVERS[name]
    x = gendata(rng, N, D, dist)
    if x.shape[0] == 0:
        pytest.skip("degenerate draw")
    A = x.T  # (D, N)
    b = x.sum(axis=0)
    if np.linalg.norm(b) == 0:
        pytest.skip("zero target")
    alg = cls(A, b, max_support=x.shape[0])

    prev_err = np.inf
    m_total = 0
    for m in [1, 3, 6]:
        alg.build(m - m_total)
        m_total = m
        w = alg.weights()
        # nnz(w) <= iterations, weights >= 0
        assert (w > 0).sum() <= m
        assert (w >= 0).all()
        # error() consistent with recomputed residual norm
        err = alg.error()
        np.testing.assert_allclose(err, np.sqrt(((A @ w - b) ** 2).sum()), rtol=1e-8, atol=1e-12)
        # error never increases across builds
        assert err <= prev_err * (1 + 1e-9) or alg.reached_numeric_limit
        prev_err = min(prev_err, err)

    # colinear data: optimal after 1 iteration (GIGA rescales onto b exactly;
    # OMP re-solves exactly; FW's first step only lands on the constraint
    # polytope, so it is excluded)
    if dist == "gauss_colinear" and name != "FrankWolfe" and not alg.reached_numeric_limit:
        alg2 = cls(A, b, max_support=x.shape[0])
        alg2.build(1)
        assert alg2.error() < 1e-5 * max(1.0, np.linalg.norm(b))

    # N=1: immediately optimal
    if x.shape[0] == 1:
        alg3 = cls(A, b, max_support=1)
        alg3.build(1)
        assert alg3.error() < 1e-6 * max(1.0, np.linalg.norm(b))

    # reset restores initial state
    alg.reset()
    assert alg.size() == 0 and not alg.reached_numeric_limit
    assert (alg.weights() == 0).all()


@pytest.mark.parametrize("name", list(SOLVERS))
def test_incremental_equals_oneshot(name, rng):
    cls, _ = SOLVERS[name]
    x = gendata(rng, 40, 5, "gauss")
    A, b = x.T, x.sum(axis=0)
    a1 = cls(A, b, max_support=40)
    a2 = cls(A, b, max_support=40)
    a1.build(10)
    for _ in range(10):
        a2.build(1)
    np.testing.assert_allclose(a1.weights(), a2.weights(), rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("name", list(SOLVERS))
def test_full_weights_zero_error(name, rng):
    """w = 1 achieves zero error for b = sum of columns; solvers should get
    near-zero error with enough iterations on small problems."""
    cls, _ = SOLVERS[name]
    x = gendata(rng, 8, 8, "axis")
    A, b = x.T, x.sum(axis=0)
    alg = cls(A, b, max_support=8)
    alg.build(30)
    alg.optimize()
    assert alg.error() < 1e-5 * np.linalg.norm(b)


@pytest.mark.parametrize("name", list(SOLVERS))
@pytest.mark.parametrize("dist", ["gauss", "bin", "axis"])
def test_golden_vs_oracle(name, dist, rng):
    """Trajectory-for-trajectory agreement with the independent NumPy oracle."""
    cls, ocls = SOLVERS[name]
    x = gendata(rng, 30, 6, dist)
    A, b = x.T, x.sum(axis=0)
    alg = cls(A, b, max_support=30)
    oalg = ocls(A, b)
    alg.build(12)
    oalg.build(12)
    np.testing.assert_allclose(alg.weights(), oalg.weights(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(alg.error(), oalg.error(), rtol=1e-6, atol=1e-9)


def test_sampling_solvers(rng):
    x = gendata(rng, 50, 4, "gauss")
    A, b = x.T, x.sum(axis=0)
    for cls in [snnls.ImportanceSampling, snnls.UniformSampling]:
        alg = cls(A, b, seed=3)
        alg.build(500)
        w = alg.weights()
        assert (w >= 0).all() and (w > 0).sum() > 5
        # unbiasedness: with many draws the weighted sum approximates b
        rel = np.linalg.norm(A @ w - b) / np.linalg.norm(b)
        assert rel < 0.5
        alg.reset()
        assert alg.size() == 0


def test_nnls_fista_matches_lawson_hanson(rng):
    for trial in range(5):
        D, N = 12, 8
        A = rng.normal(size=(D, N))
        b = rng.normal(size=D) + A @ np.abs(rng.normal(size=N))
        w_lh = nnls_lawson_hanson(A, b)
        w_j = np.asarray(
            snnls.nnls_on_support(jnp.asarray(A), jnp.asarray(b), jnp.ones(N, dtype=bool), N, n_iters=2000)
        )
        np.testing.assert_allclose(w_j, w_lh, rtol=1e-5, atol=1e-6)


def test_input_validation():
    with pytest.raises(ValueError):
        snnls.GIGA(np.zeros((3, 2)), np.ones(3))  # zero columns
    with pytest.raises(ValueError):
        snnls.GIGA(np.ones((3, 2)), np.ones(4))  # shape mismatch


def test_build_trace_matches_sequential_builds(rng):
    from betacores_tpu.snnls import GIGA

    A = jnp.asarray(rng.normal(size=(10, 40)))
    b = jnp.asarray(np.asarray(A).sum(axis=1))
    seq = GIGA(A, b)
    tr = GIGA(A, b)
    ws = np.asarray(tr.build_trace(6))
    for m in range(1, 7):
        seq.build(1)
        np.testing.assert_allclose(ws[m - 1], seq.weights(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tr.weights(), seq.weights(), rtol=1e-12)


class TestLAR:
    """Working least-angle solver (dead in the reference, lar.py:9)."""

    def test_converges_to_exact_solution(self, rng):
        from betacores_tpu.snnls import LAR

        A = jnp.asarray(rng.normal(size=(8, 30)))
        b = jnp.asarray(np.asarray(A).sum(axis=1))
        alg = LAR(A, b)
        alg.build(40)
        assert alg.error() < 1e-5 * float(jnp.linalg.norm(b))
        assert (alg.weights() >= 0).all()

    def test_support_grows_at_most_one_per_iteration(self, rng):
        from betacores_tpu.snnls import LAR

        A = jnp.asarray(rng.normal(size=(6, 20)))
        b = jnp.asarray(np.abs(np.asarray(A)) @ np.ones(20))
        alg = LAR(A, b)
        sizes = []
        for _ in range(8):
            alg.build(1)
            sizes.append(alg.size())
        assert all(s2 - s1 <= 1 for s1, s2 in zip(sizes, sizes[1:]))
        # idempotent once converged
        e1 = alg.error()
        alg.build(5)
        assert alg.error() <= e1 + 1e-10

    def test_rejects_zero_columns(self, rng):
        from betacores_tpu.snnls import LAR

        A = np.asarray(rng.normal(size=(5, 10)))
        A[:, 3] = 0.0
        with pytest.raises(ValueError):
            LAR(jnp.asarray(A), jnp.ones(5))


class TestAccIHT:
    """Accelerated IHT (arXiv:2007.00715) — beyond-reference solver. Greedy
    one-per-step invariants don't apply; its contract: nnz <= budget K,
    w >= 0, error non-increasing across incremental budget growth, and at
    equal sparsity it at least matches the greedy solvers on average."""

    def test_invariants_and_monotonicity(self, rng):
        x = gendata(rng, 50, 10, "gauss")
        A, b = x.T, x.sum(axis=0)
        alg = snnls.AccIHT(A, b, max_support=50)
        prev_err = np.inf
        for m in [1, 3, 6, 10]:
            alg.build(m - alg.K)
            w = alg.weights()
            assert (w > 0).sum() <= m
            assert (w >= 0).all()
            err = alg.error()
            np.testing.assert_allclose(
                err, np.sqrt(((A @ w - b) ** 2).sum()), rtol=1e-6, atol=1e-10)
            assert err <= prev_err * (1 + 1e-9)
            prev_err = err
        alg.reset()
        assert alg.size() == 0 and alg.K == 0 and (alg.weights() == 0).all()

    def test_never_worse_than_giga_and_usually_better(self, rng):
        """The giga-init hybrid is PROVABLY never worse than GIGA at equal
        sparsity (best-so-far includes the greedy seed), and its support
        swaps should strictly improve on most problems (measured 8/8)."""
        strict = 0
        for seed in range(5):
            r = np.random.default_rng(seed)
            x = r.normal(size=(60, 8))
            A, b = x.T, x.sum(axis=0)
            K = 6
            iht = snnls.AccIHT(A, b, max_support=60)
            iht.build(K)
            giga = snnls.GIGA(A, b, max_support=60)
            giga.build(K)
            assert iht.error() <= giga.error() * (1 + 1e-6), seed
            strict += iht.error() < giga.error() * (1 - 1e-6)
        assert strict >= 3, f"IHT strictly improved on only {strict}/5 problems"

    def test_pure_iht_mode(self, rng):
        """init='zero' (the paper's pure A-IHT) still satisfies the sparsity
        and monotonicity contract."""
        x = gendata(rng, 40, 6, "gauss")
        A, b = x.T, x.sum(axis=0)
        alg = snnls.AccIHT(A, b, max_support=40, init="zero")
        prev = np.inf
        for m in [2, 4, 8]:
            alg.build(m - alg.K)
            assert (alg.weights() > 0).sum() <= m
            assert alg.error() <= prev * (1 + 1e-9)
            prev = alg.error()

    def test_full_budget_zero_error(self, rng):
        x = gendata(rng, 8, 8, "axis")
        A, b = x.T, x.sum(axis=0)
        alg = snnls.AccIHT(A, b, max_support=8)
        alg.build(8)
        alg.optimize()
        assert alg.error() < 1e-5 * np.linalg.norm(b)

    def test_trace_matches_incremental_builds(self, rng):
        x = gendata(rng, 30, 6, "gauss")
        A, b = x.T, x.sum(axis=0)
        a1 = snnls.AccIHT(A, b, max_support=30)
        ws = np.asarray(a1.build_trace(5))
        a2 = snnls.AccIHT(A, b, max_support=30)
        for m in range(5):
            a2.build(1)
            np.testing.assert_allclose(ws[m], a2.weights(), rtol=1e-7, atol=1e-12)
        np.testing.assert_allclose(a1.weights(), a2.weights(), rtol=1e-7, atol=1e-12)

    def test_projection_ties_resolve_to_lower_index(self):
        from betacores_tpu.snnls import project_nonneg_topk

        x = jnp.asarray([1.0, 2.0, 2.0, 2.0, -1.0])
        out = np.asarray(project_nonneg_topk(x, 2))
        np.testing.assert_array_equal(out, [0.0, 2.0, 2.0, 0.0, 0.0])

    def test_hilbert_coreset_with_iht(self, rng):
        """AccIHT plugs into HilbertCoreset via the snnls= kwarg."""
        import betacores_tpu as bc
        from betacores_tpu.inference import fixed_sampler
        from betacores_tpu.models import gaussian as gmod

        d = 3
        X = jnp.asarray(rng.normal(size=(80, d)))
        samples = jnp.asarray(rng.normal(size=(16, d)))
        model = gmod.bundle(jnp.eye(d), 0.0)
        prj = bc.BlackBoxProjector(fixed_sampler(samples), 16, model.log_likelihood)
        alg = bc.HilbertCoreset(X, prj, snnls=snnls.AccIHT)
        alg.build(1, 10)
        w, p, i = alg.get()
        assert 0 < len(w) <= 10 and (np.asarray(w) > 0).all()
        giga = bc.HilbertCoreset(X, prj, snnls=snnls.GIGA)
        giga.build(1, 10)
        assert alg.error() <= giga.error() * (1 + 1e-6)  # hybrid guarantee


class TestToleranceOperand:
    def test_set_tolerance_affects_compiled_solver(self, rng):
        """TOL is a traced OPERAND of the compiled build programs, not a
        trace-time capture of the mutable global:
        set_tolerance() between builds must change the behavior of an
        ALREADY-COMPILED solver without retracing."""
        from betacores_tpu.utils import errors

        A = jnp.asarray(rng.normal(size=(5, 30)))
        b = jnp.asarray(rng.normal(size=5))
        g = snnls.GIGA(A, b)
        g.build(3)  # compiles with the default TOL
        assert g.size() > 0 and not g.reached_numeric_limit

        old = errors.get_tolerance()
        try:
            # an absurd tolerance makes GIGA's cnrm >= tol select-guard fail
            # every step -> revert, retry, latch after two failed iterations
            errors.set_tolerance(1e10)
            g.reset()
            g.build(3)  # same shapes: reuses the compiled program
            assert g.reached_numeric_limit, (
                "set_tolerance() had no effect on the compiled build")
        finally:
            errors.set_tolerance(old)
        g.reset()
        g.build(3)
        assert g.size() > 0 and not g.reached_numeric_limit
