"""Tests that need a GPU. They skip elsewhere through the ``gpu_device``
fixture; `python chip_smoke.py` runs them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from betacores_tpu.coresets import IncrementalConfig, init_state, make_incremental_builder
from betacores_tpu.inference import logreg_laplace_sampler
from betacores_tpu.models import logreg

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("use_beta", [False, True], ids=["ll", "beta"])
def test_build_on_card_matches_host_cpu(gpu_device, use_beta):
    """The headline build program (pre-drawn Laplace refinement, joint
    projection, Newton refits on cuSOLVER) at a small size — N=4000, d=10,
    S=100, M=16, opt_itrs=50, subsampled select and refinement — run on the
    card and on the host CPU of the same process from the same key, in
    float64: the selections match exactly and the weights to 1e-9
    relative (only the order of float64 sums differs)."""
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        pytest.skip("this process has no CPU backend to compare with")
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 1.0, size=(4000, 10))
    y = np.where(rng.uniform(size=4000) < 1 / (1 + np.exp(-x.sum(axis=1))), 1.0, -1.0)
    y[:400] *= -1.0                                    # 10% flipped labels
    cfg = IncrementalConfig(projection_dim=100, n_subsample_select=500,
                            n_subsample_opt=100, opt_itrs=50, i0=1.0,
                            use_beta=use_beta)

    def run(device):
        with jax.enable_x64(True), jax.default_device(device):
            Z = jax.device_put(jnp.asarray(y[:, None] * x), device)
            b = make_incremental_builder(Z, logreg.bundle(),
                                         logreg_laplace_sampler(), cfg)
            st = b.build(jax.random.key(3),
                         init_state(32, 10, beta=0.3, dtype=jnp.float64), 16)
            assert st.wts.devices() == {device}
            return np.asarray(st.idcs), np.asarray(st.wts), int(st.m)

    i_g, w_g, m_g = run(gpu_device)
    i_c, w_c, m_c = run(cpu)
    assert m_g == m_c >= 8
    np.testing.assert_array_equal(i_g, i_c)
    np.testing.assert_allclose(w_g, w_c, rtol=1e-9, atol=1e-9 * np.abs(w_c).max())
