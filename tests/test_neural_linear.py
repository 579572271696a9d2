"""Neural-linear tests: exact Bayesian last layer against direct linear
algebra, encoder training reduces loss, and the contextual coreset build
threads encoder params without retracing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import betacores_tpu as bc
from betacores_tpu.models.neural_linear import (
    NeuralLinear,
    bayesian_regression_posterior,
    full_bayesian_regression_posterior,
    neural_linear_model_factory,
    neural_linear_sampler_factory,
    predictive,
)


def test_bayes_last_layer_closed_form(rng):
    n, f = 40, 6
    X = rng.normal(size=(n, f))
    y = rng.normal(size=(n, 1))
    sigsq, s = 0.5, 2.0
    layer = bayesian_regression_posterior(jnp.asarray(X), jnp.asarray(y), sigsq, s)
    cov_want = sigsq * np.linalg.inv(X.T @ X + sigsq * s * np.eye(f))
    mean_want = cov_want / sigsq @ X.T @ y
    np.testing.assert_allclose(np.asarray(layer.theta_cov), cov_want, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(layer.theta_mean), mean_want, rtol=1e-8)
    mean, var = predictive(layer, jnp.asarray(X[:5]), sigsq)
    var_want = sigsq + np.sum((X[:5] @ cov_want) * X[:5], axis=1)
    np.testing.assert_allclose(np.asarray(var).ravel(), var_want, rtol=1e-8)


def test_student_t_layer(rng):
    n, f = 30, 4
    X = rng.normal(size=(n, f))
    y = rng.normal(size=(n, 1))
    layer = full_bayesian_regression_posterior(jnp.asarray(X), jnp.asarray(y), a0=1.0, b0=1.0, s=1.0)
    assert float(layer.a_tilde) == pytest.approx(1.0 + n / 2)
    assert float(layer.b_tilde) > 0
    assert float(layer.nu) == pytest.approx(2.0 * (1.0 + n / 2))
    mean, var = predictive(layer, jnp.asarray(X[:3]))
    assert np.all(np.asarray(var) > 0)


def test_encoder_training_reduces_loss(rng):
    n, d = 64, 5
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=(d, 1))
    y = (X @ w_true + 0.05 * rng.normal(size=(n, 1))).astype(np.float32)
    Z = np.hstack([X, y])
    nl = NeuralLinear(Z, out_features=8, sigmasq=0.1, seed=0)
    nll0, rmse0 = nl.test(Z)
    losses = nl.optimize(np.ones(n, dtype=np.float32), Z, num_epochs=60, initial_lr=1e-2)
    nll1, rmse1 = nl.test(Z)
    assert losses[-1] < losses[0]
    assert rmse1 < rmse0


def test_contextual_coreset_build(rng):
    n, d, F = 80, 4, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X.sum(axis=1, keepdims=True) + 0.1 * rng.normal(size=(n, 1))).astype(np.float32)
    Z = np.hstack([X, y])
    nl = NeuralLinear(Z[:10], out_features=F, sigmasq=0.5, seed=1)
    mf = neural_linear_model_factory(nl.module, 0.5)
    sf = neural_linear_sampler_factory(nl.module, jnp.zeros(F), jnp.eye(F), 0.5)
    prj = bc.coresets.ContextualProjector(sf, 16, mf)
    alg = bc.SparseVICoreset(jnp.asarray(Z), prj, opt_itrs=10, seed=2,
                             n_subsample_select=40, n_subsample_opt=20)
    alg.ctx = nl.variables
    alg.build(2, 2)
    assert alg.state.m >= 1
    w1 = np.asarray(alg.state.wts).copy()
    # retrain encoder, rebuild with new ctx — no error, params actually used
    nl.optimize(np.ones(n, dtype=np.float32), Z, num_epochs=10)
    alg.ctx = nl.variables
    alg.build(1, 3)
    assert alg.state.m >= 1

    # contextual refine(): factories resolved at the current encoder state
    alg.refine(n_samples=32)
    w, _, i = alg.get()
    assert (w >= 0).all() and len(i) >= 1

    # beta-coreset contextual path too
    balg = bc.BetaCoreset(jnp.asarray(Z), prj, beta=0.3, learn_beta=False,
                          opt_itrs=10, seed=3, n_subsample_select=40, n_subsample_opt=20)
    balg.ctx = nl.variables
    balg.build(2, 2)
    assert balg.state.m >= 1


def test_encoder_batchnorm_train_eval_contract(rng):
    """The plain-JAX encoder keeps the flax parameter names the decay mask
    relies on; in training each BatchNorm normalizes with the batch mean
    and biased variance and moves its running statistics by
    r <- 0.9 r + 0.1 batch; in evaluation it normalizes with the running
    statistics. Checked layer by layer against NumPy in float64."""
    from betacores_tpu.models.neural_linear import Encoder, _mask_kernels

    n, d, F = 32, 5, 7
    x = rng.normal(size=(n, d))
    enc = Encoder(out_features=F)
    v = enc.init(jax.random.key(0), jnp.asarray(x[:2]))
    assert set(v["params"]) == {"Dense_0", "Dense_1", "BatchNorm_0", "BatchNorm_1"}
    assert v["params"]["Dense_0"]["kernel"].shape == (d, F)
    assert v["params"]["Dense_1"]["kernel"].shape == (F, F)
    mask = _mask_kernels(v["params"])
    assert mask["Dense_0"] == {"kernel": True, "bias": False}
    assert mask["BatchNorm_1"] == {"scale": True, "bias": False}
    # non-trivial scale/bias and running statistics
    p = jax.tree_util.tree_map(lambda a: a + 0.3, v["params"])
    stats = jax.tree_util.tree_map(lambda a: a + 0.2, v["batch_stats"])
    var = {"params": p, "batch_stats": stats}

    def numpy_forward(train):
        h, new = x, {}
        for i in range(2):
            dense, bn = p[f"Dense_{i}"], p[f"BatchNorm_{i}"]
            run = stats[f"BatchNorm_{i}"]
            h = h @ np.asarray(dense["kernel"]) + np.asarray(dense["bias"])
            if train:
                mean, vr = h.mean(axis=0), h.var(axis=0)
                new[i] = (0.9 * np.asarray(run["mean"]) + 0.1 * mean,
                          0.9 * np.asarray(run["var"]) + 0.1 * vr)
            else:
                mean, vr = np.asarray(run["mean"]), np.asarray(run["var"])
            h = ((h - mean) / np.sqrt(vr + 1e-5) * np.asarray(bn["scale"])
                 + np.asarray(bn["bias"]))
            h = np.maximum(h, 0.0)
        return h, new

    feats, mutated = enc.apply(var, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    want, new = numpy_forward(train=True)
    np.testing.assert_allclose(np.asarray(feats), want, rtol=1e-10, atol=1e-12)
    for i in range(2):
        got = mutated["batch_stats"][f"BatchNorm_{i}"]
        np.testing.assert_allclose(np.asarray(got["mean"]), new[i][0], rtol=1e-10)
        np.testing.assert_allclose(np.asarray(got["var"]), new[i][1], rtol=1e-10)
    feats_eval = enc.apply(var, jnp.asarray(x), train=False)
    want_eval, _ = numpy_forward(train=False)
    np.testing.assert_allclose(np.asarray(feats_eval), want_eval, rtol=1e-10, atol=1e-12)
    # evaluation leaves the running statistics alone
    _, same = enc.apply(var, jnp.asarray(x), train=False, mutable=["batch_stats"])
    np.testing.assert_array_equal(np.asarray(same["batch_stats"]["BatchNorm_0"]["mean"]),
                                  np.asarray(stats["BatchNorm_0"]["mean"]))
