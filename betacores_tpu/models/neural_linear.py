"""Neural-linear model: deep feature extractor + exact Bayesian last layer.

Spec: reference examples/common/neural.py (torch; derived from Pinsler &
Gordon's active-bayesian-coresets) rebuilt in plain JAX + optax:

  * ``Encoder``: 2 x (Dense -> BatchNorm -> ReLU) feature extractor
    (neural.py:126-133), with a flax-style ``init``/``apply`` interface and
    flax's parameter names;
  * ``bayesian_regression_posterior``: exact last-layer posterior
    theta_cov = sigsq (X'X + sigsq s I)^-1, theta_mean = theta_cov/sigsq X'y
    (neural.py:56-62), with the Student-t hyper-prior variant
    (neural.py:96-108);
  * ``train_encoder``: weighted predictive-NLL minibatch training with
    AdamW-style weight decay on kernel weights only and cosine annealing
    (neural.py:160-197), as one jitted optax loop;
  * ctx factories plugging the encoder into the coreset builders: the
    encoder parameters flow through the jitted build as a traced pytree, so
    interleaving NN training with coreset iterations (reference
    zellner_neural_linear/main.py:191-205) does not retrace.

The coreset operates on rows z = [x, y]; the model sees [encode(x), y]
(reference ``deep_encoder`` bridge at zellner_neural_linear/main.py:110-111,
which crosses torch<->numpy every call — here it fuses into the jitted
projection).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from . import linreg
from .base import ModelFns, beta_gradient_from_autodiff
from .gaussian import GaussianPosterior


class Encoder:
    """2 x (Dense -> BatchNorm -> ReLU). Variables are
    ``{"params": {"Dense_i": {"kernel", "bias"}, "BatchNorm_i": {"scale",
    "bias"}}, "batch_stats": {"BatchNorm_i": {"mean", "var"}}}``.

    BatchNorm contract (torch's BatchNorm1d as the reference uses it, and
    flax's): in training it normalizes with the batch mean and biased
    variance and moves the running statistics toward them,
    ``r <- momentum * r + (1 - momentum) * batch``; in evaluation it
    normalizes with the running statistics."""

    n_layers = 2
    momentum = 0.9
    epsilon = 1e-5

    def __init__(self, out_features: int = 30):
        self.out_features = out_features

    def init(self, key, x, train: bool = False):
        del train
        params, stats = {}, {}
        fan_in = x.shape[-1]
        F = self.out_features
        for i, k in enumerate(jax.random.split(key, self.n_layers)):
            # LeCun-normal kernel (truncated normal, variance 1/fan_in)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            params[f"Dense_{i}"] = {
                "kernel": std * jax.random.truncated_normal(
                    k, -2.0, 2.0, (fan_in, F), x.dtype),
                "bias": jnp.zeros((F,), x.dtype)}
            params[f"BatchNorm_{i}"] = {"scale": jnp.ones((F,), x.dtype),
                                        "bias": jnp.zeros((F,), x.dtype)}
            stats[f"BatchNorm_{i}"] = {"mean": jnp.zeros((F,), x.dtype),
                                       "var": jnp.ones((F,), x.dtype)}
            fan_in = F
        return {"params": params, "batch_stats": stats}

    def apply(self, variables, x, train: bool = False, mutable=False):
        """Features of ``x``. With ``mutable`` (training) also returns
        ``{"batch_stats": updated running statistics}``."""
        params, stats = variables["params"], variables["batch_stats"]
        new_stats = {}
        for i in range(self.n_layers):
            dense, bn = params[f"Dense_{i}"], params[f"BatchNorm_{i}"]
            x = x @ dense["kernel"] + dense["bias"]
            run = stats[f"BatchNorm_{i}"]
            if train:
                mean = jnp.mean(x, axis=0)
                var = jnp.mean(jnp.square(x), axis=0) - jnp.square(mean)
                m = self.momentum
                new_stats[f"BatchNorm_{i}"] = {
                    "mean": m * run["mean"] + (1.0 - m) * mean,
                    "var": m * run["var"] + (1.0 - m) * var}
            else:
                mean, var = run["mean"], run["var"]
                new_stats[f"BatchNorm_{i}"] = run
            x = (x - mean) * jax.lax.rsqrt(var + self.epsilon) * bn["scale"] + bn["bias"]
            x = jax.nn.relu(x)
        if mutable:
            return x, {"batch_stats": new_stats}
        return x


class BayesLastLayer(NamedTuple):
    """Exact Bayesian last-layer posterior over weights (and, for the
    Student-t variant, the noise posterior)."""

    theta_mean: jnp.ndarray   # (F, 1)
    theta_cov: jnp.ndarray    # (F, F)
    a_tilde: Optional[jnp.ndarray] = None
    b_tilde: Optional[jnp.ndarray] = None

    @property
    def nu(self):
        return None if self.a_tilde is None else 2.0 * self.a_tilde


def bayesian_regression_posterior(X, y, sigsq: float = 1.0, s: float = 1.0) -> BayesLastLayer:
    """Reference neural.py:56-62 (BayesianRegressionDense._compute_posterior)."""
    F = X.shape[1]
    prec = X.T @ X + sigsq * s * jnp.eye(F, dtype=X.dtype)
    cov = sigsq * jnp.linalg.inv(prec)
    mean = cov / sigsq @ (X.T @ y)
    return BayesLastLayer(theta_mean=mean, theta_cov=cov)


def full_bayesian_regression_posterior(X, y, a0: float = 1.0, b0: float = 1.0,
                                       s: float = 1.0) -> BayesLastLayer:
    """Student-t variant with IG hyper-prior on the noise variance
    (reference neural.py:96-108)."""
    F = X.shape[1]
    prec = X.T @ X + s * jnp.eye(F, dtype=X.dtype)
    cov = jnp.linalg.inv(prec)
    mean = cov @ (X.T @ y)
    a_t = a0 + X.shape[0] / 2.0
    b_t = b0 + 0.5 * (y.T @ y - mean.T @ prec @ mean).reshape(())
    return BayesLastLayer(theta_mean=mean, theta_cov=cov, a_tilde=jnp.asarray(a_t), b_tilde=b_t)


def predictive(layer: BayesLastLayer, x, sigsq: float = 1.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Predictive mean/variance at encoded inputs x (reference
    neural.py:46-54 / :83-94)."""
    mean = x @ layer.theta_mean
    quad = jnp.sum((x @ layer.theta_cov) * x, axis=-1)
    if layer.a_tilde is None:
        var = sigsq + quad
    else:
        var = layer.b_tilde / layer.a_tilde * (1.0 + quad)
    return mean, var[:, None]


def gaussian_log_density(y, mean, var):
    return -0.5 * ((y - mean) ** 2 / var + jnp.log(var) + math.log(2 * math.pi))


def students_t_log_density(y, mean, var, nu):
    """Reference neural.py:18-31."""
    std = jnp.sqrt(var)
    z = (y - mean) / std
    nu_t = (nu + 1.0) / 2.0
    return (jax.scipy.special.gammaln(nu_t)
            - jnp.log(jnp.sqrt(nu * math.pi) * std)
            - jax.scipy.special.gammaln(nu / 2.0)
            - nu_t * jnp.log1p(z * z / nu))


class NeuralLinear:
    """Eager neural-linear wrapper mirroring the reference's torch API
    (neural.py:112-250): ``encode``, ``update_batch``, ``optimize``,
    ``test``, plus ``variables`` exposing the encoder variables as the
    builders' ctx pytree. ``student_t=True`` gives the NeuralLinearTB variant."""

    def __init__(self, Z_init: np.ndarray, out_features: int = 30,
                 output_mean: float = 0.0, output_std: float = 1.0,
                 sigmasq: float = 1.0, s: float = 1.0, student_t: bool = False,
                 seed: int = 42):
        self.module = Encoder(out_features=out_features)
        self.out_features = out_features
        self.sigmasq = float(sigmasq)
        self.s = float(s)
        self.student_t = student_t
        self.output_mean = float(np.asarray(output_mean).reshape(-1)[0])
        self.output_std = float(np.asarray(output_std).reshape(-1)[0])
        Z_init = jnp.asarray(Z_init)
        self.x_train, self.y_train = Z_init[:, :-1], Z_init[:, -1:]
        self.variables = self.module.init(jax.random.key(seed), self.x_train[:2], train=False)
        self._key = jax.random.key(seed + 1)

    # --- reference API ---
    def encode(self, x, variables=None):
        v = self.variables if variables is None else variables
        return self.module.apply(v, jnp.asarray(x), train=False)

    def update_batch(self, Z):
        Z = jnp.asarray(Z)
        self.x_train, self.y_train = Z[:, :-1], Z[:, -1:]

    def _posterior(self, feats):
        if self.student_t:
            return full_bayesian_regression_posterior(feats, self.y_train, s=self.s)
        return bayesian_regression_posterior(feats, self.y_train, sigsq=self.sigmasq, s=self.s)

    def forward(self, x):
        feats_train = self.encode(self.x_train)
        layer = self._posterior(feats_train)
        return predictive(layer, self.encode(x), sigsq=self.sigmasq)

    def optimize(self, wts, pts, num_epochs: int = 1000, initial_lr: float = 1e-2,
                 weight_decay: float = 1e-1, batch_size: Optional[int] = None):
        """Weighted-NLL encoder training (reference neural.py:160-197). The
        whole epochs x minibatch loop runs as one jitted lax.scan."""
        wts = jnp.asarray(wts, dtype=jnp.float32)
        pts = jnp.asarray(pts, dtype=jnp.float32)
        n = pts.shape[0]
        if batch_size is None:
            batch_size = _batch_size_pow2(n)
        n_batches = max(n // batch_size, 1)
        sched = optax.cosine_decay_schedule(initial_lr, num_epochs * n_batches, alpha=1e-5 / initial_lr)
        # weight decay on kernel AND BatchNorm-scale weights (reference
        # param groups decay every '*.weight', neural.py:170-175)
        decay_mask = _mask_kernels(self.variables["params"])
        tx = optax.chain(
            optax.add_decayed_weights(weight_decay, mask=decay_mask),
            optax.adam(sched),
        )
        variables = self.variables
        params, batch_stats = variables["params"], variables.get("batch_stats", {})
        opt_state = tx.init(params)
        run = self._train_fn(n, batch_size, n_batches, num_epochs, tx,
                             (initial_lr, weight_decay))

        self._key, k = jax.random.split(self._key)
        params, batch_stats, losses = run(params, batch_stats, opt_state, k,
                                          wts, pts, self.x_train, self.y_train)
        self.variables = {"params": params, "batch_stats": batch_stats}
        return np.asarray(losses)

    def _train_fn(self, n, batch_size, n_batches, num_epochs, tx, opt_cfg):
        """Jitted training loop, cached per static config: a fresh jit
        closure per optimize() call would retrace AND bake the coreset into
        the program as constants (the anti-pattern incremental._bind
        documents). Data flows in as arguments."""
        cache_key = (n, batch_size, n_batches, num_epochs, opt_cfg,
                     self.x_train.shape[0])
        if getattr(self, "_train_cache_key", None) == cache_key:
            return self._train_cached
        module, sigsq, s, student_t = self.module, self.sigmasq, self.s, self.student_t

        def loss_fn(params, batch_stats, w, z, x_train, y_train):
            x, y = z[:, :-1], z[:, -1:]
            # the Bayesian last layer conditions on the FULL current train
            # batch (reference forward(), neural.py:143-158) — a
            # batch-local posterior changes the objective
            feats_tr, mutated = module.apply(
                {"params": params, "batch_stats": batch_stats}, x_train,
                train=True, mutable=["batch_stats"])
            feats_b, _ = module.apply(
                {"params": params, "batch_stats": mutated["batch_stats"]}, x,
                train=True, mutable=["batch_stats"])
            if student_t:
                layer = full_bayesian_regression_posterior(feats_tr, y_train, s=s)
                mean, var = predictive(layer, feats_b, sigsq)
                ll = students_t_log_density(y, mean, var, layer.nu)
            else:
                layer = bayesian_regression_posterior(feats_tr, y_train, sigsq=sigsq, s=s)
                mean, var = predictive(layer, feats_b, sigsq)
                ll = gaussian_log_density(y, mean, var)
            return -jnp.sum(w[:, None] * ll), mutated["batch_stats"]

        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

        @jax.jit
        def run(params, batch_stats, opt_state, key, wts, pts, x_train, y_train):
            def epoch(carry, k):
                params, batch_stats, opt_state = carry
                perm = jax.random.permutation(k, n)

                def batch_step(carry, b):
                    params, batch_stats, opt_state = carry
                    idx = jax.lax.dynamic_slice_in_dim(perm, b * batch_size, batch_size)
                    (loss, batch_stats), grads = grad_fn(params, batch_stats,
                                                         wts[idx], pts[idx],
                                                         x_train, y_train)
                    updates, opt_state = tx.update(grads, opt_state, params)
                    params = optax.apply_updates(params, updates)
                    return (params, batch_stats, opt_state), loss

                (params, batch_stats, opt_state), losses = jax.lax.scan(
                    batch_step, (params, batch_stats, opt_state), jnp.arange(n_batches))
                return (params, batch_stats, opt_state), losses.mean()

            keys = jax.random.split(key, num_epochs)
            (params, batch_stats, opt_state), losses = jax.lax.scan(
                epoch, (params, batch_stats, opt_state), keys)
            return params, batch_stats, losses

        self._train_cache_key = cache_key
        self._train_cached = run
        return run

    def test(self, Z_test) -> Tuple[float, float]:
        """(predictive NLL, unnormalized RMSE) — reference neural.py:205-250."""
        Z_test = jnp.asarray(Z_test)
        x, y = Z_test[:, :-1], Z_test[:, -1:]
        mean, var = self.forward(x)
        if self.student_t:
            feats_train = self.encode(self.x_train)
            layer = self._posterior(feats_train)
            nll = -jnp.mean(students_t_log_density(y, mean, var, layer.nu))
        else:
            nll = -jnp.mean(gaussian_log_density(y, mean, var))
        unnorm = lambda v: v * self.output_std + self.output_mean
        rmse = jnp.sqrt(jnp.mean((unnorm(mean) - unnorm(y)) ** 2))
        return float(nll), float(rmse)


def _batch_size_pow2(n: int) -> int:
    """Closest power of two <= n/2 (reference neural.py:199-203)."""
    sizes = 2 ** np.arange(10)
    if n in sizes:
        return max(int(n // 2), 1)
    return int(sizes[max(int(np.sum((n / 2) > sizes)) - 1, 0)])


def _mask_kernels(params):
    """True for weight leaves that the reference decays: torch's
    named_parameters().endswith('weight') matches Linear weights AND
    BatchNorm scales (neural.py:170-175) — the encoder names them 'kernel'
    and 'scale'; biases are undecayed."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: (walk(v) if isinstance(v, dict) else k in ("kernel", "scale"))
                    for k, v in tree.items()}
        return False

    return walk(params)


# --- ctx factories for the coreset builders --------------------------------


def encoded_z_fn(module: Encoder) -> Callable:
    """ctx -> (z -> [encode(x), y]) in eval mode (running BatchNorm stats),
    the jittable equivalent of the reference's ``deep_encoder`` bridge."""

    def enc(ctx, z):
        feats = module.apply(ctx, z[:, :-1], train=False)
        return jnp.concatenate([feats, z[:, -1:]], axis=1)

    return enc


def neural_linear_model_factory(module: Encoder, sigsq: float) -> Callable:
    """ctx -> ModelFns over encoded features (for contextual builders)."""
    enc = encoded_z_fn(module)

    def factory(ctx):
        def blik(pts, th, beta):
            return linreg.beta_likelihood(enc(ctx, pts), th, beta, sigsq)

        return ModelFns(
            log_likelihood=lambda pts, th: linreg.log_likelihood(enc(ctx, pts), th, sigsq),
            beta_likelihood=blik,
            beta_gradient=beta_gradient_from_autodiff(blik),
            grad_z_log_likelihood=None,
        )

    return factory


def neural_linear_sampler_factory(module: Encoder, mu0, Sig0inv, sigsq: float) -> Callable:
    """ctx -> conjugate weighted-posterior sampler over encoded features
    (reference zellner_neural_linear/main.py:121-130 sampler_w)."""
    from .gaussian import sample_gaussian_prec

    enc = encoded_z_fn(module)

    def factory(ctx):
        def sampler(key, n, wts, pts, aux):
            z = enc(ctx, pts)
            post = linreg.weighted_post(mu0, Sig0inv, sigsq, z, wts)
            return sample_gaussian_prec(key, post, n), aux

        return sampler

    return factory
