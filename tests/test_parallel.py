"""Sharded-build tests on the virtual 8-device CPU mesh (SURVEY.md section 4:
single-device vs sharded equivalence without a real cluster)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from betacores_tpu.coresets import IncrementalConfig, init_state, make_incremental_builder
from betacores_tpu.inference import gaussian_conjugate_sampler
from betacores_tpu.models import gaussian as gmod
from betacores_tpu.parallel import make_mesh, make_sharded_incremental_builder, shard_data
from oracle import models as om


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    N, d = 600, 4
    Sig = 3.0 * np.eye(d)
    Siginv = np.linalg.inv(Sig)
    logdetSig = np.linalg.slogdet(Sig)[1]
    X = rng.multivariate_normal(np.zeros(d), Sig, N)
    model = gmod.bundle(jnp.asarray(Siginv), logdetSig)
    sampler = gaussian_conjugate_sampler(jnp.zeros(d), jnp.eye(d), jnp.asarray(Siginv))
    mup, Sigp = om.gauss_weighted_post(np.zeros(d), np.eye(d), Siginv, X, np.ones(N))
    return X, model, sampler, (np.zeros(d), np.eye(d), Siginv, mup, Sigp)


def _rkl(w, p, aux):
    mu0, Sig0inv, Siginv, mup, Sigp = aux
    muw, Sigw = om.gauss_weighted_post(mu0, Sig0inv, Siginv, np.atleast_2d(p), np.atleast_1d(w))
    return om.gaussian_KL(muw, Sigw, mup, np.linalg.inv(Sigp))


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_build_quality(problem, mesh_shape):
    """The sharded build must reach the same posterior quality as the
    single-device build, for every mesh factorization."""
    X, model, sampler, aux = problem
    cfg = IncrementalConfig(projection_dim=32, n_subsample_select=128,
                            n_subsample_opt=64, opt_itrs=40, i0=1.0, use_beta=False)
    mesh = make_mesh(*mesh_shape)
    data_sharded, n_true = shard_data(jnp.asarray(X), mesh)
    build = make_sharded_incremental_builder(data_sharded, n_true, model, sampler, cfg, mesh)
    st = init_state(64, X.shape[1], dtype=data_sharded.dtype)
    st = build(jax.random.key(0), st, 8)
    w = np.asarray(st.wts)
    p = np.asarray(st.pts)
    keep = w > 0
    assert keep.sum() >= 4
    assert int(st.m) <= 8
    # all selected indices are real (unpadded) rows, matching their points
    idcs = np.asarray(st.idcs)[: int(st.m)]
    assert (idcs >= 0).all() and (idcs < X.shape[0]).all()
    np.testing.assert_allclose(np.asarray(data_sharded)[idcs], p[: int(st.m)], rtol=1e-6)

    kl = _rkl(w[keep], p[keep], aux)
    kl_prior = _rkl(np.zeros(1), np.zeros((1, X.shape[1])), aux)
    assert kl < 0.3 * kl_prior, (kl, kl_prior)


def test_sharded_matches_single_device_quality(problem):
    X, model, sampler, aux = problem
    cfg = IncrementalConfig(projection_dim=32, n_subsample_select=128,
                            n_subsample_opt=64, opt_itrs=40, i0=1.0)
    # single device
    b1 = make_incremental_builder(jnp.asarray(X), model, sampler, cfg)
    st1 = b1.build(jax.random.key(1), init_state(64, X.shape[1], dtype=jnp.float64), 8)
    w1, p1 = np.asarray(st1.wts), np.asarray(st1.pts)
    kl1 = _rkl(w1[w1 > 0], p1[w1 > 0], aux)
    # sharded
    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(jnp.asarray(X), mesh)
    b2 = make_sharded_incremental_builder(ds, n_true, model, sampler, cfg, mesh)
    st2 = b2(jax.random.key(1), init_state(64, X.shape[1], dtype=ds.dtype), 8)
    w2, p2 = np.asarray(st2.wts), np.asarray(st2.pts)
    kl2 = _rkl(w2[w2 > 0], p2[w2 > 0], aux)
    # statistical equivalence: same quality ballpark (different subsample streams)
    assert kl2 < 3.0 * kl1 + 1e-3, (kl1, kl2)


def test_sharded_trace_matches_build(problem):
    X, model, sampler, aux = problem
    cfg = IncrementalConfig(projection_dim=32, n_subsample_select=128,
                            n_subsample_opt=64, opt_itrs=20, i0=1.0)
    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(jnp.asarray(X), mesh)
    b = make_sharded_incremental_builder(ds, n_true, model, sampler, cfg, mesh)
    st0 = init_state(32, X.shape[1], dtype=ds.dtype)
    st_final, (W, I, B) = b.trace(jax.random.key(5), st0, 6)
    st_build = b(jax.random.key(5), st0, 6)
    np.testing.assert_allclose(np.asarray(W[-1]), np.asarray(st_build.wts), rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(I[-1]), np.asarray(st_build.idcs))
    assert W.shape[0] == 6


def test_sharded_hilbert_matches_single_device_exactly(problem):
    """Distributed GIGA over a row-sharded projection must reproduce the
    single-device GIGA solve exactly (same floats in f64): local scoring is
    row-identical, the gathered argmax ties break toward the lower shard,
    and the geodesic reweight is replicated scalar math."""
    from betacores_tpu.ops.projection import project_ll
    from betacores_tpu.parallel import ShardedHilbertCoreset
    from betacores_tpu.snnls import GIGA

    X, model, sampler, aux = problem
    X = jnp.asarray(X[:611])  # deliberately non-divisible by the data axis
    samples, _ = sampler(jax.random.key(7), 32, jnp.zeros(1),
                         jnp.zeros((1, X.shape[1])), None)
    vecs = project_ll(model, X, samples)
    g = GIGA(vecs.T, vecs.sum(axis=0))
    g.build(30)

    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(X, mesh)
    sh = ShardedHilbertCoreset(ds, n_true, model, samples, mesh)
    sh.build(30)

    np.testing.assert_allclose(sh.weights(), g.weights(), atol=1e-10)
    assert abs(sh.error() - g.error()) < 1e-6
    w, p, idcs = sh.get()
    assert (w > 0).all() and (idcs < n_true).all()
    np.testing.assert_allclose(p, np.asarray(X)[idcs], rtol=1e-12)


def test_sharded_hilbert_trace_matches_build(problem):
    from betacores_tpu.ops.projection import project_beta
    from betacores_tpu.parallel import ShardedHilbertCoreset
    from betacores_tpu.snnls import GIGA

    X, model, sampler, aux = problem
    X = jnp.asarray(X[:256])
    samples, _ = sampler(jax.random.key(9), 16, jnp.zeros(1),
                         jnp.zeros((1, X.shape[1])), None)
    mesh = make_mesh(8, 1)
    ds, n_true = shard_data(X, mesh)
    # beta-projection tangent space (reference BetaBlackBoxProjector route)
    sh = ShardedHilbertCoreset(ds, n_true, model, samples, mesh, beta=0.3)
    ws = sh.build_trace(10)
    assert ws.shape == (10, ds.shape[0])
    np.testing.assert_allclose(np.asarray(ws[-1])[:n_true], sh.weights(), atol=1e-12)
    # weights after the trace equal a fresh one-shot build of the same length
    sh2 = ShardedHilbertCoreset(ds, n_true, model, samples, mesh, beta=0.3)
    sh2.build(10)
    np.testing.assert_allclose(sh.weights(), sh2.weights(), atol=1e-12)
    # and the beta tangent space matches the single-device GIGA on it
    vecs = project_beta(model, X, samples, jnp.asarray(0.3, dtype=X.dtype))
    g = GIGA(vecs.T, vecs.sum(axis=0))
    g.build(10)
    np.testing.assert_allclose(sh.weights(), g.weights(), atol=1e-10)


def test_sharded_learn_beta(problem):
    """Sharded learn-beta: beta moves by gradient and respects the positive
    floor; with beta_grad_scale=0 the weight trajectory is exactly the
    fixed-beta one (per-coordinate Adam => the extra beta coordinate cannot
    perturb the weight coordinates)."""
    X, model, sampler, aux = problem
    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(jnp.asarray(X), mesh)
    kw = dict(projection_dim=16, n_subsample_select=64, n_subsample_opt=32,
              opt_itrs=20, i0=1.0, use_beta=True)
    b = make_sharded_incremental_builder(
        ds, n_true, model, sampler,
        IncrementalConfig(learn_beta=True, beta_grad_scale=1e-2, **kw), mesh)
    st = b(jax.random.key(0), init_state(16, X.shape[1], beta=0.5, dtype=ds.dtype), 6)
    assert int(st.m) >= 3
    assert float(st.beta) >= 1e-3
    assert float(st.beta) != 0.5  # it actually moved

    b0 = make_sharded_incremental_builder(
        ds, n_true, model, sampler,
        IncrementalConfig(learn_beta=True, beta_grad_scale=0.0, **kw), mesh)
    bF = make_sharded_incremental_builder(
        ds, n_true, model, sampler, IncrementalConfig(**kw), mesh)
    st0 = b0(jax.random.key(1), init_state(16, X.shape[1], beta=0.5, dtype=ds.dtype), 4)
    stF = bF(jax.random.key(1), init_state(16, X.shape[1], beta=0.5, dtype=ds.dtype), 4)
    assert float(st0.beta) == 0.5
    np.testing.assert_allclose(np.asarray(st0.wts), np.asarray(stF.wts), atol=1e-12)

    with pytest.raises(ValueError, match="use_beta"):
        make_sharded_incremental_builder(
            ds, n_true, model, sampler,
            IncrementalConfig(projection_dim=16, n_subsample_select=8,
                              n_subsample_opt=8, learn_beta=True), mesh)


def test_sharded_bpsvi_batch_matches_single_device(problem):
    """Lane-sharding the vmapped BPSVI batch (the reference's Pool(100) axis)
    must not change any lane's result: exact equality, including when the
    lane count needs dummy padding to reach a device multiple."""
    from betacores_tpu.coresets import BPSVIConfig, bpsvi_build_batch, make_bpsvi_builder
    from betacores_tpu.parallel import make_sharded_bpsvi_batch

    X, model, sampler, aux = problem
    X = jnp.asarray(X[:120])
    cfg = BPSVIConfig(projection_dim=8, n_subsample_opt=32, opt_itrs=15, i0=0.3)
    aux0 = jnp.zeros(X.shape[1])
    key = jax.random.key(7)
    sizes = list(range(1, 11))  # 10 lanes -> padded to 16 on 8 devices

    builder = make_bpsvi_builder(X, model, sampler, cfg)
    w1, p1, i1 = bpsvi_build_batch(builder, key, sizes, 10, aux0)
    batch = make_sharded_bpsvi_batch(X, model, sampler, cfg, make_mesh(4, 2))
    w2, p2, i2 = batch(key, sizes, 10, aux0)

    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_distributed_argmax_tie_breaks_to_lower_shard(problem):
    """SURVEY hard part 5: exact ties in the gathered per-shard best scores
    must resolve to the lower shard index (matching the single-device
    first-argmax rule)."""
    scores = jnp.asarray([2.0, 7.0, 7.0, 1.0])  # shards 1 and 2 tie
    assert int(jnp.argmax(scores)) == 1  # the rule the sharded code relies on
    # end-to-end: duplicated dataset across shards -> every shard proposes
    # the same point; the selected global index must come from shard 0
    X, model, sampler, aux = problem
    row = np.asarray(X[:1])
    Xdup = jnp.asarray(np.tile(row, (64, 1)))   # all rows identical
    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(Xdup, mesh)
    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=16,
                            n_subsample_opt=8, opt_itrs=2, i0=0.5)
    b = make_sharded_incremental_builder(ds, n_true, model, sampler, cfg, mesh)
    st = b(jax.random.key(0), init_state(8, Xdup.shape[1], dtype=ds.dtype), 1)
    f = int(np.asarray(st.idcs)[0])
    rows_per_shard = Xdup.shape[0] // 4
    assert 0 <= f < rows_per_shard, f  # winner came from shard 0


def test_sharded_full_data_matches_single_device_same_key(problem):
    """with n_subsample_select/opt = None the sharded
    POINT builder scores all N candidates and psums the exact Sigma-over-N
    residual — same key stream as the single-device full-data builder
    (reference sparsevi.py:14-15 semantics): identical selections, weights
    equal up to float summation order."""
    X, model, sampler, aux = problem
    X = np.asarray(X[:200])
    cfg = IncrementalConfig(projection_dim=16, opt_itrs=15, i0=0.5)
    b1 = make_incremental_builder(jnp.asarray(X), model, sampler, cfg)
    st1 = b1.build(jax.random.key(5), init_state(16, X.shape[1], dtype=jnp.float64), 6)

    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(jnp.asarray(X), mesh)
    b2 = make_sharded_incremental_builder(ds, n_true, model, sampler, cfg, mesh)
    st2 = b2(jax.random.key(5), init_state(16, X.shape[1], dtype=ds.dtype), 6)

    assert int(st1.m) == int(st2.m) > 0
    np.testing.assert_array_equal(np.asarray(st1.idcs), np.asarray(st2.idcs))
    np.testing.assert_allclose(np.asarray(st1.wts), np.asarray(st2.wts),
                               rtol=1e-6, atol=1e-9)

    # mixed mode compiles + runs: exact full-data select, stratified optimize
    cfg_mix = IncrementalConfig(projection_dim=16, n_subsample_opt=32,
                                opt_itrs=5, i0=0.5)
    b3 = make_sharded_incremental_builder(ds, n_true, model, sampler, cfg_mix, mesh)
    st3 = b3(jax.random.key(5), init_state(16, X.shape[1], dtype=ds.dtype), 3)
    assert int(st3.m) > 0
    idcs3 = np.asarray(st3.idcs)[: int(st3.m)]
    assert (idcs3 >= 0).all() and (idcs3 < X.shape[0]).all()


class TestShardedGroups:
    def _setup(self, problem):
        from betacores_tpu.ops.projection import Groups

        X, model, sampler, aux = problem
        X = np.asarray(X[:120])
        sizes = [5, 12, 3, 20, 10, 10, 25, 15, 8, 12]
        groups, i = [], 0
        for s in sizes:
            groups.append(list(range(i, i + s)))
            i += s
        return X, model, sampler, aux, Groups.from_lists(groups), groups

    def test_matches_single_device_same_key_full_mode(self, problem):
        """With n_subsample_select/opt = None the sharded program computes
        the single-device group builder's quantities with the SAME key
        stream: selected groups identical, weights equal up to float
        summation order."""
        from betacores_tpu.coresets import init_state
        from betacores_tpu.coresets.groups import (group_ids_from_groups,
                                                   init_group_state,
                                                   make_group_incremental_builder)
        from betacores_tpu.parallel import (make_sharded_group_builder,
                                            shard_group_ids)

        X, model, sampler, aux, gp, groups = self._setup(problem)
        cfg = IncrementalConfig(projection_dim=16, opt_itrs=15, i0=0.5)
        cap = 80
        b1 = make_group_incremental_builder(jnp.asarray(X), gp, model, sampler, cfg)
        g1 = b1(jax.random.key(3),
                init_group_state(init_state(cap, X.shape[1], dtype=jnp.float64),
                                 gp.n_groups), 5)

        mesh = make_mesh(4, 2)
        ds, n_true = shard_data(jnp.asarray(X), mesh)
        gid = shard_group_ids(group_ids_from_groups(gp, X.shape[0]), mesh, gp.n_groups)
        b2 = make_sharded_group_builder(ds, gid, n_true, gp, model, sampler, cfg, mesh)
        g2 = b2(jax.random.key(3),
                init_group_state(init_state(cap, X.shape[1], dtype=ds.dtype),
                                 gp.n_groups), 5)

        np.testing.assert_array_equal(np.asarray(g1.selected), np.asarray(g2.selected))
        np.testing.assert_array_equal(np.asarray(g1.core.idcs), np.asarray(g2.core.idcs))
        assert int(g1.core.m) == int(g2.core.m) > 0
        np.testing.assert_allclose(np.asarray(g1.core.wts), np.asarray(g2.core.wts),
                                   rtol=1e-6, atol=1e-9)

    @pytest.mark.parametrize("mesh_shape", [(8, 1), (2, 4)])
    def test_subsampled_build_selects_whole_groups(self, problem, mesh_shape):
        from betacores_tpu.coresets import init_state
        from betacores_tpu.coresets.groups import (group_ids_from_groups,
                                                   init_group_state)
        from betacores_tpu.parallel import (make_sharded_group_builder,
                                            shard_group_ids)

        X, model, sampler, aux, gp, groups = self._setup(problem)
        cfg = IncrementalConfig(projection_dim=16, n_subsample_select=12,
                                n_subsample_opt=64, opt_itrs=15, i0=0.5)
        mesh = make_mesh(*mesh_shape)
        ds, n_true = shard_data(jnp.asarray(X), mesh)
        gid = shard_group_ids(group_ids_from_groups(gp, X.shape[0]), mesh, gp.n_groups)
        b = make_sharded_group_builder(ds, gid, n_true, gp, model, sampler, cfg, mesh)
        gst = b(jax.random.key(1),
                init_group_state(init_state(80, X.shape[1], dtype=ds.dtype),
                                 gp.n_groups), 6)
        st = gst.core
        m = int(st.m)
        assert m > 0
        sel = np.flatnonzero(np.asarray(gst.selected))
        assert m == sum(len(groups[g]) for g in sel)  # whole groups only
        idcs = np.asarray(st.idcs)[:m]
        expect = np.concatenate([groups[g] for g in sel]) if len(sel) else []
        assert set(idcs) == set(expect)
        # gathered points match their global rows
        np.testing.assert_allclose(np.asarray(st.pts)[:m], X[idcs], rtol=1e-12)
        assert (np.asarray(st.wts) >= 0).all()


def test_sharded_build_mvn_family(problem):
    """The sharded incremental builder composes with the unknown-covariance
    (NIW) model family: packed (mu, chol-precision) samples slice cleanly
    along the samp axis and the robust build completes on the mesh."""
    from betacores_tpu.models import mvn

    rng = np.random.default_rng(4)
    d, N = 3, 240
    Xc = jnp.asarray(np.vstack([rng.normal(size=(N, d)) + 1.0,
                                rng.normal(size=(N // 10, d)) * 0.5 + 9.0]))
    model = mvn.bundle(d)
    sampler = mvn.mvn_niw_sampler(jnp.zeros(d), 1.0, jnp.eye(d), d + 4.0)
    cfg = IncrementalConfig(projection_dim=16, n_subsample_select=64,
                            n_subsample_opt=32, opt_itrs=15, i0=0.5,
                            use_beta=True)
    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(Xc, mesh)
    b = make_sharded_incremental_builder(ds, n_true, model, sampler, cfg, mesh)
    st = b(jax.random.key(1), init_state(20, d, beta=0.5, dtype=ds.dtype), 10)
    m = int(st.m)
    assert m > 0 and (np.asarray(st.wts) >= 0).all()
    # robust selection: the coreset's NIW posterior mean is near the clean
    # cluster, not the outlier cluster
    w, p = np.asarray(st.wts), np.asarray(st.pts)
    post = mvn.weighted_post(jnp.zeros(d), 1.0, jnp.eye(d), d + 4.0,
                             jnp.asarray(p[w > 0]), jnp.asarray(w[w > 0]))
    assert np.linalg.norm(np.asarray(post.mu) - 1.0) < 2.0, post.mu


def test_sharded_group_trace_matches_build(problem):
    from betacores_tpu.coresets import init_state
    from betacores_tpu.coresets.groups import (group_ids_from_groups,
                                               init_group_state)
    from betacores_tpu.ops.projection import Groups
    from betacores_tpu.parallel import (make_sharded_group_builder,
                                        shard_group_ids)

    X, model, sampler, aux = problem
    X = np.asarray(X[:120])
    groups = [list(range(i, i + 10)) for i in range(0, 120, 10)]
    gp = Groups.from_lists(groups)
    cfg = IncrementalConfig(projection_dim=16, n_subsample_select=12,
                            n_subsample_opt=64, opt_itrs=10, i0=0.5)
    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(jnp.asarray(X), mesh)
    gid = shard_group_ids(group_ids_from_groups(gp, X.shape[0]), mesh, gp.n_groups)
    b = make_sharded_group_builder(ds, gid, n_true, gp, model, sampler, cfg, mesh)
    gst0 = init_group_state(init_state(60, X.shape[1], dtype=ds.dtype), gp.n_groups)
    gfin, (W, I, SEL) = b.trace(jax.random.key(5), gst0, 5)
    gbuild = b(jax.random.key(5), gst0, 5)
    np.testing.assert_allclose(np.asarray(W[-1]), np.asarray(gbuild.core.wts),
                               rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(I[-1]), np.asarray(gbuild.core.idcs))
    np.testing.assert_array_equal(np.asarray(SEL[-1]), np.asarray(gbuild.selected))
    assert W.shape[0] == 5


def test_aot_lowering_for_4gpu_cuda(problem):
    """Multi-GPU dress rehearsal: the full sharded build step must AOT-lower
    for CUDA on the four-card mesh shape (2 data x 2 samp per
    parallel.auto_mesh_shape(4)) — jax.export cross-platform lowering needs
    no GPU — and its StableHLO must contain the expected collectives
    (psum-reduced residuals / distributed argmax gathers), and no host
    callbacks."""
    from betacores_tpu.parallel import auto_mesh_shape

    X, model, sampler, aux = problem
    cfg = IncrementalConfig(projection_dim=16, n_subsample_select=64,
                            n_subsample_opt=32, opt_itrs=5, i0=1.0, use_beta=True)
    assert auto_mesh_shape(4) == (2, 2)
    mesh = make_mesh(*auto_mesh_shape(4))
    ds, n_true = shard_data(jnp.asarray(X), mesh)
    build = make_sharded_incremental_builder(ds, n_true, model, sampler, cfg, mesh)
    st0 = init_state(32, X.shape[1], dtype=ds.dtype)
    key = jax.random.key(0)

    exp = jax.export.export(
        jax.jit(lambda k, st: build(k, st, 1)), platforms=["cuda"]
    )(key, st0)
    txt = exp.mlir_module()
    counts = {k: txt.count(f"stablehlo.{k}") for k in
              ("all_reduce", "all_gather", "collective_permute", "reduce_scatter")}
    # the residual psums and the distributed argmax must be present
    assert counts["all_reduce"] > 0, counts
    # nothing in the step may fall back to the host
    assert "stablehlo.custom_call @xla_python_cpu_callback" not in txt
    print("4-GPU AOT collectives per build step:", counts)


def test_sharded_weighted_build(problem):
    """data_weights in the sharded builder: u=ones matches the unweighted
    sharded build bit-for-bit on selections; zero-weight rows are never
    selected; integer weights pull the build toward the WEIGHTED posterior."""
    from betacores_tpu.parallel import shard_weights

    X, model, sampler, aux = problem
    mu0, Sig0inv, Siginv, _, _ = aux
    cfg = IncrementalConfig(projection_dim=32, n_subsample_select=128,
                            n_subsample_opt=64, opt_itrs=40, i0=1.0)
    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(jnp.asarray(X), mesh)
    st0 = init_state(64, X.shape[1], dtype=ds.dtype)
    key = jax.random.key(7)

    b_plain = make_sharded_incremental_builder(ds, n_true, model, sampler, cfg, mesh)
    u1 = shard_weights(jnp.ones(X.shape[0], dtype=ds.dtype), mesh)
    b_ones = make_sharded_incremental_builder(ds, n_true, model, sampler, cfg,
                                              mesh, data_weights=u1)
    st_p = b_plain(key, st0, 8)
    st_o = b_ones(key, st0, 8)
    np.testing.assert_array_equal(np.asarray(st_p.idcs), np.asarray(st_o.idcs))
    np.testing.assert_allclose(np.asarray(st_p.wts), np.asarray(st_o.wts),
                               rtol=1e-9, atol=1e-12)

    # zero-weight rows (the last 200) must never be selected
    uz = np.ones(X.shape[0])
    uz[400:] = 0.0
    bz = make_sharded_incremental_builder(
        ds, n_true, model, sampler, cfg, mesh,
        data_weights=shard_weights(jnp.asarray(uz, dtype=ds.dtype), mesh))
    st_z = bz(key, st0, 8)
    idcs = np.asarray(st_z.idcs)[: int(st_z.m)]
    assert (idcs < 400).all(), idcs
    # trace entry point works weighted too
    st_t, (W, I, B) = bz.trace(key, st0, 4)
    assert W.shape[0] == 4
    np.testing.assert_array_equal(
        np.asarray(I[-1]), np.asarray(bz(key, st0, 4).idcs))

    # weighted build tracks the WEIGHTED posterior better than uniform wts
    # do (u doubles rows 0..149 and zeroes the rest, so the weighted and
    # uniform posteriors differ sharply in effective mass)
    uw = np.zeros(X.shape[0])
    uw[:150] = 2.0
    bw = make_sharded_incremental_builder(
        ds, n_true, model, sampler, cfg, mesh,
        data_weights=shard_weights(jnp.asarray(uw, dtype=ds.dtype), mesh))
    st_w = bw(key, st0, 10)
    w, p = np.asarray(st_w.wts), np.asarray(st_w.pts)
    muT, SigT = om.gauss_weighted_post(mu0, Sig0inv, Siginv, X, uw)
    muU, SigU = om.gauss_weighted_post(mu0, Sig0inv, Siginv, X, np.ones(X.shape[0]))
    muw, Sigw = om.gauss_weighted_post(mu0, Sig0inv, Siginv,
                                       np.atleast_2d(p[w > 0]), w[w > 0])
    klT = om.gaussian_KL(muw, Sigw, muT, np.linalg.inv(SigT))
    klU = om.gaussian_KL(muw, Sigw, muU, np.linalg.inv(SigU))
    assert klT < klU, (klT, klU)

    with pytest.raises(ValueError):
        make_sharded_incremental_builder(
            ds, n_true, model, sampler, cfg, mesh,
            data_weights=jnp.ones(7, dtype=ds.dtype))


def test_sharded_weighted_group_build(problem):
    """data_weights in the sharded group builder: u=ones matches the
    unweighted sharded build bit-for-bit; zero-mass groups are never
    selected and u==0 members never enter the coreset; trace agrees with
    build on the same stream."""
    from betacores_tpu.coresets import init_state
    from betacores_tpu.coresets.groups import (group_ids_from_groups,
                                               init_group_state)
    from betacores_tpu.ops.projection import Groups
    from betacores_tpu.parallel import (make_sharded_group_builder,
                                        shard_group_ids, shard_weights)

    X, model, sampler, aux = problem
    X = np.asarray(X[:120])
    groups = [list(range(i, i + 10)) for i in range(0, 120, 10)]
    gp = Groups.from_lists(groups)
    cfg = IncrementalConfig(projection_dim=16, n_subsample_select=12,
                            n_subsample_opt=64, opt_itrs=10, i0=0.5)
    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(jnp.asarray(X), mesh)
    gid = shard_group_ids(group_ids_from_groups(gp, X.shape[0]), mesh, gp.n_groups)
    gst0 = init_group_state(init_state(60, X.shape[1], dtype=ds.dtype), gp.n_groups)
    key = jax.random.key(3)

    b_plain = make_sharded_group_builder(ds, gid, n_true, gp, model, sampler,
                                         cfg, mesh)
    b_ones = make_sharded_group_builder(
        ds, gid, n_true, gp, model, sampler, cfg, mesh,
        data_weights=shard_weights(jnp.ones(X.shape[0], dtype=ds.dtype), mesh))
    g_p = b_plain(key, gst0, 4)
    g_o = b_ones(key, gst0, 4)
    np.testing.assert_array_equal(np.asarray(g_p.core.idcs), np.asarray(g_o.core.idcs))
    np.testing.assert_allclose(np.asarray(g_p.core.wts), np.asarray(g_o.core.wts),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(g_p.selected), np.asarray(g_o.selected))

    # zero out groups 0-3 entirely and half of group 4's members
    u = np.ones(X.shape[0])
    for g in range(4):
        u[groups[g]] = 0.0
    u[groups[4][:5]] = 0.0
    bz = make_sharded_group_builder(
        ds, gid, n_true, gp, model, sampler, cfg, mesh,
        data_weights=shard_weights(jnp.asarray(u, dtype=ds.dtype), mesh))
    g_z = bz(key, gst0, 5)
    sel = np.where(np.asarray(g_z.selected))[0]
    assert len(sel) >= 1 and (sel >= 4).all(), sel
    m = int(g_z.core.m)
    idcs = np.asarray(g_z.core.idcs)[:m]
    dead = set(int(i) for i in np.where(u == 0)[0])
    assert not set(idcs.tolist()) & dead
    # appended points match their indices after the member partition
    np.testing.assert_allclose(np.asarray(g_z.core.pts)[:m], X[idcs], rtol=1e-9)
    # trace entry point agrees on the same stream
    g_t, (W, I, SEL) = bz.trace(key, gst0, 5)
    np.testing.assert_array_equal(np.asarray(SEL[-1]), np.asarray(g_z.selected))
    np.testing.assert_array_equal(np.asarray(I[-1]), np.asarray(g_z.core.idcs))
    with pytest.raises(ValueError):
        make_sharded_group_builder(ds, gid, n_true, gp, model, sampler, cfg,
                                   mesh, data_weights=jnp.ones(3, dtype=ds.dtype))


def test_sharded_lagged_refit(problem):
    """refit_every in the sharded builder: deterministic, same selection
    count, quality near the every-step build (logreg Laplace sampler — the
    Gaussian fixture's conjugate sampler has no fit split, so build a small
    logreg problem here)."""
    from betacores_tpu.data import gen_synthetic_logreg
    from betacores_tpu.inference import logreg_laplace_sampler
    from betacores_tpu.models import logreg

    _, _, Z = gen_synthetic_logreg(jax.random.key(0), 300, d=4, dtype=jnp.float32)
    model, sampler = logreg.bundle(), logreg_laplace_sampler()
    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(Z, mesh)
    st0 = init_state(16, Z.shape[1], beta=0.4, dtype=ds.dtype)
    key = jax.random.key(6)
    res = {}
    for k in (1, 4):
        cfg = IncrementalConfig(projection_dim=16, n_subsample_select=64,
                                n_subsample_opt=32, opt_itrs=20, i0=1.0,
                                use_beta=True, refit_every=k)
        b = make_sharded_incremental_builder(ds, n_true, model, sampler, cfg, mesh)
        st = b(key, st0, 6)
        st2 = b(key, st0, 6)
        np.testing.assert_array_equal(np.asarray(st.wts), np.asarray(st2.wts))
        res[k] = st
    assert int(res[4].m) == int(res[1].m)
    # weight vectors land close (same key stream, slightly stale tangent)
    w1, w4 = np.asarray(res[1].wts), np.asarray(res[4].wts)
    assert np.linalg.norm(w4 - w1) < 0.5 * np.linalg.norm(w1) + 1e-6


def test_sharded_predrawn_fast_path_matches_per_step(problem):
    """The sharded refinement loop's pre-drawn fast path (batched noise +
    per-shard subsample draws + pre-gathered rows, single-chip fast-path
    parity) replays nn_adam's exact key stream through the same sampler
    functions, so every random draw is bit-identical to the per-step
    fallback; the joint [subsample; coreset] projection merges the two
    centering psums into one (a collective saved per step) at the cost of
    matmul-blocking low bits at large shapes (measured 2.5e-4 rel after a
    30x80-step f32 trajectory at n_opt=256). At THIS f64 config the values
    are byte-equal — pin that, plus exact selections."""
    X, model, sampler, aux = problem
    slow = lambda key, n, w, pts, a: sampler(key, n, w, pts, a)
    assert getattr(slow, "from_noise", None) is None
    cfg = IncrementalConfig(projection_dim=16, n_subsample_select=64,
                            n_subsample_opt=32, opt_itrs=12, i0=1.0)
    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(jnp.asarray(X), mesh)
    st0 = init_state(16, X.shape[1], dtype=ds.dtype)
    key = jax.random.key(3)
    out = []
    for smp in (sampler, slow):
        b = make_sharded_incremental_builder(ds, n_true, model, smp, cfg, mesh)
        out.append(b(key, st0, 5))
    np.testing.assert_array_equal(np.asarray(out[0].idcs), np.asarray(out[1].idcs))
    np.testing.assert_array_equal(np.asarray(out[0].wts), np.asarray(out[1].wts))
    assert int(out[0].m) == int(out[1].m) and int(out[0].m) >= 2


def test_sharded_dedup_select_fills_budget(problem):
    """dedup_select on the mesh: already-selected global indices are masked
    out of every shard's candidates before the distributed argmax, so the
    build installs M distinct rows (the single-device dedup contract,
    coresets/incremental.py)."""
    X, model, sampler, aux = problem
    cfg = IncrementalConfig(projection_dim=32, n_subsample_select=128,
                            n_subsample_opt=64, opt_itrs=20, i0=1.0,
                            use_beta=False, dedup_select=True)
    mesh = make_mesh(4, 2)
    data_sharded, n_true = shard_data(jnp.asarray(X), mesh)
    build = make_sharded_incremental_builder(data_sharded, n_true, model,
                                             sampler, cfg, mesh)
    st = init_state(64, X.shape[1], dtype=data_sharded.dtype)
    M = 12
    st = build(jax.random.key(0), st, M)
    m_got = int(st.m)
    idcs = np.asarray(st.idcs)[:m_got]
    assert m_got == M == len(set(idcs.tolist()))
    assert (idcs >= 0).all() and (idcs < X.shape[0]).all()
    # posterior quality is not sacrificed by forcing adds
    w = np.asarray(st.wts)
    keep = w > 0
    kl = _rkl(w[keep], np.asarray(st.pts)[keep], aux)
    kl_prior = _rkl(np.zeros(1), np.zeros((1, X.shape[1])), aux)
    assert kl < 0.3 * kl_prior, (kl, kl_prior)


def test_sharded_group_dedup_matches_single_device(problem):
    """Group-mode dedup on the mesh: same-key full-candidate builds must
    match the single-device group dedup build exactly (the membership test
    is replicated-state-local, no new collectives)."""
    from betacores_tpu.coresets.groups import (group_ids_from_groups,
                                               init_group_state,
                                               make_group_incremental_builder)
    from betacores_tpu.ops.projection import Groups
    from betacores_tpu.parallel import make_sharded_group_builder, shard_group_ids

    X, model, sampler, aux = problem
    N = X.shape[0]
    groups = [list(range(i, min(i + 25, N))) for i in range(0, N, 25)]
    gp = Groups.from_lists(groups)
    cfg = IncrementalConfig(projection_dim=16, n_subsample_select=None,
                            n_subsample_opt=None, opt_itrs=10, i0=1.0,
                            use_beta=False, dedup_select=True)
    key = jax.random.key(3)
    M_buf, itrs = 128, 4

    b1 = make_group_incremental_builder(jnp.asarray(X), gp, model, sampler, cfg)
    g1 = b1(key, init_group_state(
        init_state(M_buf, X.shape[1], dtype=jnp.float64), gp.n_groups), itrs)

    mesh = make_mesh(4, 2)
    ds, n_true = shard_data(jnp.asarray(X), mesh)
    gid = shard_group_ids(group_ids_from_groups(gp, N), mesh, gp.n_groups)
    b2 = make_sharded_group_builder(ds, gid, n_true, gp, model, sampler, cfg, mesh)
    g2 = b2(key, init_group_state(
        init_state(M_buf, X.shape[1], dtype=ds.dtype), gp.n_groups), itrs)

    # dedup adds one distinct group per iteration
    assert int(g1.core.m) == int(g2.core.m) == itrs * 25
    np.testing.assert_array_equal(np.asarray(g1.selected), np.asarray(g2.selected))
    np.testing.assert_array_equal(np.asarray(g1.core.idcs), np.asarray(g2.core.idcs))
    np.testing.assert_allclose(np.asarray(g1.core.wts), np.asarray(g2.core.wts),
                               rtol=1e-6, atol=1e-9)
