"""Model-layer unit tests: JAX impls vs NumPy oracle, exact gradients vs
finite differences, and exact Gaussian log-likelihood moments vs Monte Carlo
(test strategy: SURVEY.md section 4, items 2 and 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from betacores_tpu.models import gaussian, linreg, logreg
import oracle.models as om


def _rand_spd(rng, d, scale=1.0):
    A = rng.normal(size=(d, d))
    return scale * (A @ A.T + d * np.eye(d))


class TestGaussian:
    @pytest.fixture(autouse=True)
    def setup(self, rng):
        self.d = 5
        self.Sig = _rand_spd(rng, self.d)
        self.Siginv = np.linalg.inv(self.Sig)
        self.logdetSig = np.linalg.slogdet(self.Sig)[1]
        self.x = rng.normal(size=(7, self.d))
        self.th = rng.normal(size=(4, self.d))

    def test_loglik_matches_oracle(self):
        got = gaussian.log_likelihood(jnp.asarray(self.x), jnp.asarray(self.th), jnp.asarray(self.Siginv), self.logdetSig)
        want = om.gauss_log_likelihood(self.x, self.th, self.Siginv, self.logdetSig)
        np.testing.assert_allclose(got, want, rtol=1e-9)

    def test_loglik_matches_scipy_density(self):
        from scipy.stats import multivariate_normal

        got = np.asarray(
            gaussian.log_likelihood(jnp.asarray(self.x), jnp.asarray(self.th), jnp.asarray(self.Siginv), self.logdetSig)
        )
        for s in range(self.th.shape[0]):
            want = multivariate_normal.logpdf(self.x, self.th[s], self.Sig)
            np.testing.assert_allclose(got[:, s], want, rtol=1e-8)

    def test_beta_likelihood_matches_oracle(self):
        for beta in (0.1, 0.5, 0.9):
            got = gaussian.beta_likelihood(jnp.asarray(self.x), jnp.asarray(self.th), beta, jnp.asarray(self.Siginv), self.logdetSig)
            want = om.gauss_beta_likelihood(self.x, self.th, beta, self.Siginv)
            np.testing.assert_allclose(got, want, rtol=1e-9)

    def test_beta_gradient_autodiff_vs_fd(self):
        m = gaussian.bundle(jnp.asarray(self.Siginv), self.logdetSig)
        beta, h = 0.3, 1e-6
        got = m.beta_gradient(jnp.asarray(self.x), jnp.asarray(self.th), beta)
        fd = (
            np.asarray(m.beta_likelihood(jnp.asarray(self.x), jnp.asarray(self.th), beta + h))
            - np.asarray(m.beta_likelihood(jnp.asarray(self.x), jnp.asarray(self.th), beta - h))
        ) / (2 * h)
        np.testing.assert_allclose(got, fd, rtol=1e-4, atol=1e-7)

    def test_grad_x_loglik_vs_autodiff(self):
        f = lambda x: gaussian.log_likelihood(x[None, :], jnp.asarray(self.th), jnp.asarray(self.Siginv), self.logdetSig)[0]
        got = gaussian.grad_x_log_likelihood(jnp.asarray(self.x), jnp.asarray(self.th), jnp.asarray(self.Siginv))
        for n in range(3):
            want = jax.jacobian(f)(jnp.asarray(self.x[n]))
            np.testing.assert_allclose(got[n], want, rtol=1e-8)

    def test_weighted_post_is_true_minimizer(self, rng):
        """The conjugate posterior mean must maximize the weighted log joint
        (this catches the reference's triangular-factor-order bug, which our
        implementation fixes — see models/gaussian.py docstring)."""
        w = rng.uniform(0.5, 2.0, size=self.x.shape[0])
        mu0 = rng.normal(size=self.d)
        Sig0inv = np.linalg.inv(_rand_spd(rng, self.d))
        post = gaussian.weighted_post(jnp.asarray(mu0), jnp.asarray(Sig0inv), jnp.asarray(self.Siginv), jnp.asarray(self.x), jnp.asarray(w))

        def neg_log_joint(th):
            ll = om.gauss_log_likelihood(self.x, th[None, :], self.Siginv, self.logdetSig)[:, 0]
            pr = -0.5 * (th - mu0) @ Sig0inv @ (th - mu0)
            return -(np.sum(w * ll) + pr)

        from scipy.optimize import minimize

        res = minimize(neg_log_joint, np.zeros(self.d), method="BFGS", options={"gtol": 1e-10})
        np.testing.assert_allclose(np.asarray(post.mu), res.x, rtol=1e-5, atol=1e-7)
        # covariance: inverse of (Sig0inv + sum(w) Siginv)
        want_cov = np.linalg.inv(Sig0inv + w.sum() * self.Siginv)
        np.testing.assert_allclose(np.asarray(post.cov), want_cov, rtol=1e-8)

    def test_sample_covariance(self):
        """Empirical covariance of sample_gaussian_prec must converge to Sigp."""
        post = gaussian.weighted_post(
            jnp.zeros(self.d), jnp.eye(self.d), jnp.asarray(self.Siginv), jnp.asarray(self.x), jnp.ones(self.x.shape[0])
        )
        samps = np.asarray(gaussian.sample_gaussian_prec(jax.random.key(0), post, 200_000))
        emp_cov = np.cov(samps, rowvar=False)
        np.testing.assert_allclose(emp_cov, np.asarray(post.cov), atol=8e-3, rtol=5e-2)
        np.testing.assert_allclose(samps.mean(0), np.asarray(post.mu), atol=5e-3)

    def test_exact_ll_moments_vs_mc(self):
        """Tangent-space estimator unbiasedness (SURVEY section 4 item 2/4):
        MC mean/var of centered log-lik vectors match closed forms."""
        mu = np.zeros(self.d)
        post = gaussian.GaussianPosterior(mu=jnp.asarray(mu), prec_chol=jnp.asarray(np.linalg.cholesky(self.Siginv)))
        Sig = np.asarray(post.cov)
        samps = gaussian.sample_gaussian_prec(jax.random.key(1), post, 150_000)
        ll = np.asarray(gaussian.log_likelihood(jnp.asarray(self.x), samps, jnp.asarray(self.Siginv), self.logdetSig))
        mean_want, var_want = om.gauss_ll_moments_exact(self.x, mu, Sig, self.Siginv, self.logdetSig)
        np.testing.assert_allclose(ll.mean(axis=1), mean_want, rtol=4e-2)
        np.testing.assert_allclose(ll.var(axis=1), var_want, rtol=1e-1)

    def test_kl_zero_and_positive(self, rng):
        Sig0 = _rand_spd(rng, self.d)
        mu = rng.normal(size=self.d)
        kl_same = gaussian.gaussian_KL(jnp.asarray(mu), jnp.asarray(Sig0), jnp.asarray(mu), jnp.asarray(np.linalg.inv(Sig0)))
        assert abs(float(kl_same)) < 1e-8
        mu2 = mu + 1.0
        kl = gaussian.gaussian_KL(jnp.asarray(mu), jnp.asarray(Sig0), jnp.asarray(mu2), jnp.asarray(np.linalg.inv(Sig0)))
        assert float(kl) > 0
        want = om.gaussian_KL(mu, Sig0, mu2, np.linalg.inv(Sig0))
        np.testing.assert_allclose(float(kl), want, rtol=1e-9)


class TestLogreg:
    @pytest.fixture(autouse=True)
    def setup(self, rng):
        self.d = 6
        X = rng.normal(size=(9, self.d))
        y = np.where(rng.uniform(size=9) > 0.5, 1.0, -1.0)
        self.z = y[:, None] * X
        self.th = rng.normal(size=(5, self.d))

    def test_loglik_matches_oracle(self):
        got = logreg.log_likelihood(jnp.asarray(self.z), jnp.asarray(self.th))
        want = om.lr_log_likelihood(self.z, self.th)
        np.testing.assert_allclose(got, want, rtol=1e-9)

    def test_loglik_extreme_margins_stable(self):
        z = jnp.asarray([[1000.0, 0.0], [-1000.0, 0.0]])
        th = jnp.asarray([[1.0, 0.0]])
        got = np.asarray(logreg.log_likelihood(z, th))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[0, 0], 0.0, atol=1e-12)
        np.testing.assert_allclose(got[1, 0], -1000.0, rtol=1e-12)

    def test_beta_likelihood_matches_oracle_and_is_negated_reference(self):
        for beta in (0.2, 0.5):
            got = logreg.beta_likelihood(jnp.asarray(self.z), jnp.asarray(self.th), beta)
            want = om.lr_beta_likelihood(self.z, self.th, beta)
            np.testing.assert_allclose(got, want, rtol=1e-9)
            # direct check of the positive-convention formula
            p = 1.0 / (1.0 + np.exp(-(self.z @ self.th.T)))
            direct = (beta + 1) / beta * p**beta - p ** (beta + 1) - (1 - p) ** (beta + 1)
            np.testing.assert_allclose(got, direct, rtol=1e-7)

    def test_beta_gradient_vs_fd(self):
        m = logreg.bundle()
        beta, h = 0.4, 1e-6
        got = m.beta_gradient(jnp.asarray(self.z), jnp.asarray(self.th), beta)
        fd = (
            np.asarray(m.beta_likelihood(jnp.asarray(self.z), jnp.asarray(self.th), beta + h))
            - np.asarray(m.beta_likelihood(jnp.asarray(self.z), jnp.asarray(self.th), beta - h))
        ) / (2 * h)
        np.testing.assert_allclose(got, fd, rtol=1e-4, atol=1e-8)

    def test_grads_vs_autodiff(self):
        z, th = jnp.asarray(self.z), jnp.asarray(self.th)
        got_z = logreg.grad_z_log_likelihood(z, th)
        got_th = logreg.grad_th_log_likelihood(z, th)
        for n in range(2):
            for s in range(2):
                want_z = jax.grad(lambda zz: logreg.log_likelihood(zz[None], th[s][None])[0, 0])(z[n])
                want_th = jax.grad(lambda tt: logreg.log_likelihood(z[n][None], tt[None])[0, 0])(th[s])
                np.testing.assert_allclose(got_z[n, s], want_z, rtol=1e-8)
                np.testing.assert_allclose(got_th[n, s], want_th, rtol=1e-8)

    def test_joint_grad_hess_vs_autodiff(self, rng):
        w = jnp.asarray(rng.uniform(0.1, 3.0, size=self.z.shape[0]))
        th = jnp.asarray(rng.normal(size=self.d))
        z = jnp.asarray(self.z)
        got_g = logreg.grad_th_log_joint(z, th, w)
        want_g = jax.grad(lambda t: logreg.log_joint(z, t, w))(th)
        np.testing.assert_allclose(got_g, want_g, rtol=1e-8)
        got_h = logreg.hess_th_log_joint(z, th, w)
        want_h = jax.hessian(lambda t: logreg.log_joint(z, t, w))(th)
        np.testing.assert_allclose(got_h, want_h, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(logreg.diag_hess_th_log_joint(z, th, w), jnp.diagonal(want_h), rtol=1e-8)

    def test_accuracy_perfect_separator(self):
        X = np.array([[1.0, 0.0], [2.0, 0.0], [-1.0, 0.0]])
        Y = np.array([1.0, 1.0, -1.0])
        thetas = jnp.asarray([[5.0, 0.0], [3.0, 1.0]])
        acc = logreg.compute_accuracy(jnp.asarray(X), jnp.asarray(Y), thetas)
        assert float(acc) == 1.0


class TestLinreg:
    @pytest.fixture(autouse=True)
    def setup(self, rng):
        self.d = 4
        x = rng.normal(size=(8, self.d))
        y = rng.normal(size=(8, 1))
        self.z = np.hstack([x, y])
        self.th = rng.normal(size=(3, self.d))
        self.sigsq = 0.7

    def test_loglik_matches_oracle_and_gaussian_density(self):
        got = linreg.log_likelihood(jnp.asarray(self.z), jnp.asarray(self.th), self.sigsq)
        want = om.linreg_log_likelihood(self.z, self.th, self.sigsq)
        np.testing.assert_allclose(got, want, rtol=1e-9)
        from scipy.stats import norm

        x, y = self.z[:, :-1], self.z[:, -1]
        for s in range(self.th.shape[0]):
            direct = norm.logpdf(y, x @ self.th[s], np.sqrt(self.sigsq))
            np.testing.assert_allclose(np.asarray(got)[:, s], direct, rtol=1e-8)

    def test_beta_likelihood_matches_oracle(self):
        got = linreg.beta_likelihood(jnp.asarray(self.z), jnp.asarray(self.th), 0.3, self.sigsq)
        want = om.linreg_beta_likelihood(self.z, self.th, 0.3, self.sigsq)
        np.testing.assert_allclose(got, want, rtol=1e-9)

    def test_grad_z_vs_autodiff(self):
        z, th = jnp.asarray(self.z), jnp.asarray(self.th)
        got = linreg.grad_z_log_likelihood(z, th, self.sigsq)
        for n in range(2):
            for s in range(2):
                want = jax.grad(lambda zz: linreg.log_likelihood(zz[None], th[s][None], self.sigsq)[0, 0])(z[n])
                np.testing.assert_allclose(got[n, s], want, rtol=1e-8)

    def test_weighted_post_matches_oracle(self, rng):
        w = rng.uniform(0.1, 2.0, size=self.z.shape[0])
        mu0 = rng.normal(size=self.d)
        Sig0inv = np.eye(self.d)
        post = linreg.weighted_post(jnp.asarray(mu0), jnp.asarray(Sig0inv), self.sigsq, jnp.asarray(self.z), jnp.asarray(w))
        mu_want, Sig_want = om.linreg_weighted_post(mu0, Sig0inv, self.sigsq, self.z, w)
        np.testing.assert_allclose(np.asarray(post.mu), mu_want, rtol=1e-8)
        np.testing.assert_allclose(np.asarray(post.cov), Sig_want, rtol=1e-8)


def test_linreg_likelihood_f32_stable_at_large_targets():
    """Regression (round-3 review): the reference expands (y - pred)^2 into
    y^2 - 2 pred y + pred^2 (model_linreg.py:10), which catastrophically
    cancels in f32 at |y| >> |resid|. The factored form must match the f64
    answer at realistic unstandardized targets."""
    from betacores_tpu.models import linreg

    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 3))
    th = rng.normal(size=(4, 3))
    y64 = (x @ th[0]) * 1000.0 + 0.1 * rng.normal(size=16)
    z32 = jnp.asarray(np.c_[x, y64], dtype=jnp.float32)
    th32 = jnp.asarray(th * 1000.0, dtype=jnp.float32)
    ll32 = np.asarray(linreg.log_likelihood(z32, th32, 2.0))
    ll64 = np.asarray(linreg.log_likelihood(
        jnp.asarray(np.c_[x, y64]), jnp.asarray(th * 1000.0), 2.0))
    # expanded form errs by ~100% here; factored stays within f32 rounding
    np.testing.assert_allclose(ll32, ll64, rtol=2e-3, atol=2e-1)
