"""Weighted-base-data builds and merge-reduce streaming (beyond reference).

Correctness anchors:
  * data_weights=ones reproduces the unweighted build (same selections,
    weights equal to reduction-order tolerance);
  * integer weights on the full-data path are EXACTLY row duplication;
  * merge-reduce (chunked leaves -> weighted final build) matches the
    single-shot coreset's posterior quality on the contaminated-Gaussian
    flow, and the vmapped-leaves variant matches the streamed variant.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from betacores_tpu.coresets import (IncrementalConfig, init_state,
                                    make_incremental_builder,
                                    merge_reduce_build)
from betacores_tpu.inference import gaussian_conjugate_sampler
from betacores_tpu.models import gaussian as gmod


def _gauss_problem(rng, N=60, d=3):
    Sig = np.eye(d) * 2.0
    Siginv = np.linalg.inv(Sig)
    logdetSig = np.linalg.slogdet(Sig)[1]
    X = rng.normal(size=(N, d))
    model = gmod.bundle(jnp.asarray(Siginv), logdetSig)
    smp = gaussian_conjugate_sampler(jnp.zeros(d), jnp.eye(d), jnp.asarray(Siginv))
    return jnp.asarray(X), model, smp, Siginv


def test_unit_weights_match_unweighted(rng):
    X, model, smp, _ = _gauss_problem(rng)
    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=20,
                            n_subsample_opt=16, opt_itrs=10, i0=0.5,
                            use_beta=True)
    st0 = init_state(10, 3, beta=0.4, dtype=jnp.float64)
    key = jax.random.key(5)
    b_plain = make_incremental_builder(X, model, smp, cfg)
    b_ones = make_incremental_builder(X, model, smp, cfg,
                                      data_weights=jnp.ones(X.shape[0]))
    st_p = b_plain.build(key, st0, 6)
    st_w = b_ones.build(key, st0, 6)
    # same key stream, same subsamples; the only numeric difference is the
    # reduction order of the target sum (sum vs ones-matvec)
    np.testing.assert_array_equal(np.asarray(st_p.idcs), np.asarray(st_w.idcs))
    np.testing.assert_allclose(np.asarray(st_p.wts), np.asarray(st_w.wts),
                               rtol=1e-9, atol=1e-12)


def test_integer_weights_equal_row_duplication(rng):
    """Full-data path: u_n = 2 on the first k rows must build the same
    coreset as physically duplicating those rows (duplicates appended, so
    argmax tie-breaking picks the original occurrence)."""
    X, model, smp, _ = _gauss_problem(rng, N=40)
    k_dup = 7
    u = jnp.asarray(np.concatenate([2.0 * np.ones(k_dup),
                                    np.ones(40 - k_dup)]))
    Xdup = jnp.concatenate([X, X[:k_dup]])

    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=None,
                            n_subsample_opt=None, opt_itrs=8, i0=0.5,
                            use_beta=True)
    st0 = init_state(8, 3, beta=0.4, dtype=jnp.float64)
    key = jax.random.key(9)
    st_w = make_incremental_builder(X, model, smp, cfg,
                                    data_weights=u).build(key, st0, 5)
    st_d = make_incremental_builder(Xdup, model, smp, cfg).build(key, st0, 5)
    np.testing.assert_array_equal(np.asarray(st_w.idcs), np.asarray(st_d.idcs))
    np.testing.assert_allclose(np.asarray(st_w.wts), np.asarray(st_d.wts),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_w.pts), np.asarray(st_d.pts),
                               rtol=0, atol=0)


def _contaminated(rng, N=1200, d=3, f=0.1):
    X = rng.normal(size=(N, d)) + 1.0
    Xout = rng.normal(size=(int(N * f), d)) * 2.0 + 9.0
    return np.concatenate([X, Xout]), X


def _rkl(w, p, Xclean, Siginv, d):
    mu0, Sig0inv = jnp.zeros(d), jnp.eye(d)
    post_w = gmod.weighted_post(mu0, Sig0inv, jnp.asarray(Siginv),
                                jnp.asarray(p), jnp.asarray(w))
    post_c = gmod.weighted_post(mu0, Sig0inv, jnp.asarray(Siginv),
                                jnp.asarray(Xclean),
                                jnp.ones(Xclean.shape[0]))
    return float(gmod.gaussian_KL(post_w.mu, post_w.cov, post_c.mu,
                                  jnp.linalg.inv(post_c.cov)))


def test_merge_reduce_quality_and_parallel_equivalence(rng):
    """4-chunk merge-reduce must track the clean posterior like the
    single-shot build does on contaminated data (robust beta-build), and
    vmapped leaves must match streamed leaves."""
    d = 3
    Xall_np, Xclean = _contaminated(rng, N=1200, d=d)
    X = jnp.asarray(Xall_np)
    _, model, smp, Siginv = _gauss_problem(rng, N=4)  # model/sampler only
    leaf_cfg = IncrementalConfig(projection_dim=16, n_subsample_select=100,
                                 n_subsample_opt=60, opt_itrs=30, i0=1.0,
                                 use_beta=True)
    final_cfg = IncrementalConfig(projection_dim=16, n_subsample_select=None,
                                  n_subsample_opt=None, opt_itrs=30, i0=1.0,
                                  use_beta=True)
    st_leaf = init_state(10, d, beta=0.4, dtype=jnp.float64)
    key = jax.random.key(2)

    st_f, leaf_pts, leaf_wts = merge_reduce_build(
        key, X, model, smp, leaf_cfg, final_cfg, chunk_size=350,
        m_leaf=8, m_final=12, st_leaf=st_leaf)
    assert leaf_pts.shape == (4 * 10, d) and leaf_wts.shape == (40,)
    # greedy selection saturates when no candidate beats the coreset —
    # quality (below), not count, is the contract
    assert int(st_f.m) >= 2
    w = np.asarray(st_f.wts)
    assert np.isfinite(w).all() and (w >= 0).all()

    # quality: merged coreset stays near the clean posterior, far below the
    # naive uniform-weight summary of the corrupted data
    mask = np.asarray(st_f.slot_mask)
    rkl_merged = _rkl(w[mask], np.asarray(st_f.pts)[mask], Xclean, Siginv, d)
    rkl_corrupt = _rkl(np.ones(X.shape[0]), Xall_np, Xclean, Siginv, d)
    assert rkl_merged < rkl_corrupt, (rkl_merged, rkl_corrupt)

    # single-shot reference build at the same final size
    b = make_incremental_builder(X, model, smp, leaf_cfg)
    st_s = b.build(jax.random.key(3), init_state(12, d, beta=0.4,
                                                 dtype=jnp.float64), 12)
    sm = np.asarray(st_s.slot_mask)
    rkl_single = _rkl(np.asarray(st_s.wts)[sm], np.asarray(st_s.pts)[sm],
                      Xclean, Siginv, d)
    assert rkl_merged < 10 * max(rkl_single, 1e-3), (rkl_merged, rkl_single)

    # vmapped leaves == streamed leaves (same keys, same padding)
    st_f2, leaf_pts2, leaf_wts2 = merge_reduce_build(
        key, X, model, smp, leaf_cfg, final_cfg, chunk_size=350,
        m_leaf=8, m_final=12, st_leaf=st_leaf, parallel_leaves=True)
    np.testing.assert_allclose(np.asarray(leaf_wts), np.asarray(leaf_wts2),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(st_f.idcs), np.asarray(st_f2.idcs))
    np.testing.assert_allclose(np.asarray(st_f.wts), np.asarray(st_f2.wts),
                               rtol=1e-7, atol=1e-10)


def test_mesh_sharded_leaves_match_plain(rng):
    """mesh= shards the leaf axis over the mesh's data axis (independent
    leaf builds -> zero collectives). K=4 chunks round up to 8 lanes with
    zero-weight pad chunks; real leaf results and the final coreset must
    match the unsharded vmapped build."""
    from betacores_tpu.parallel import make_mesh

    d = 3
    Xall_np, _ = _contaminated(rng, N=1200, d=d)
    X = jnp.asarray(Xall_np)
    _, model, smp, _ = _gauss_problem(rng, N=4)
    leaf_cfg = IncrementalConfig(projection_dim=16, n_subsample_select=100,
                                 n_subsample_opt=60, opt_itrs=20, i0=1.0,
                                 use_beta=True)
    final_cfg = IncrementalConfig(projection_dim=16, n_subsample_select=None,
                                  n_subsample_opt=None, opt_itrs=20, i0=1.0,
                                  use_beta=True)
    st_leaf = init_state(10, d, beta=0.4, dtype=jnp.float64)
    key = jax.random.key(4)

    st_p, lp_p, lw_p = merge_reduce_build(
        key, X, model, smp, leaf_cfg, final_cfg, chunk_size=350,
        m_leaf=6, m_final=10, st_leaf=st_leaf, parallel_leaves=True)
    mesh = make_mesh(8, 1)
    st_m, lp_m, lw_m = merge_reduce_build(
        key, X, model, smp, leaf_cfg, final_cfg, chunk_size=350,
        m_leaf=6, m_final=10, st_leaf=st_leaf, mesh=mesh)

    # pad lanes are sliced off: the union contract is mesh-shape independent
    assert lw_m.shape == (4 * 10,) and lw_p.shape == (4 * 10,)
    np.testing.assert_allclose(np.asarray(lw_m), np.asarray(lw_p),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(st_m.idcs), np.asarray(st_p.idcs))
    np.testing.assert_allclose(np.asarray(st_m.wts), np.asarray(st_p.wts),
                               rtol=1e-7, atol=1e-10)


def test_zero_weight_rows_never_selected(rng):
    """A u==0 row must never enter the coreset — including via take_new's
    m==0 arm when an iteration-0 subsample happens to contain only masked
    rows (confirmed bug: 9/12 seeds installed a phantom first point whose
    corecorr then blocked all further selection)."""
    X, model, smp, _ = _gauss_problem(rng, N=50)
    u = np.zeros(50)
    u[17] = 1.0
    u[31] = 1.0
    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=4,
                            n_subsample_opt=8, opt_itrs=5, i0=0.5,
                            use_beta=True)
    b = make_incremental_builder(X, model, smp, cfg,
                                 data_weights=jnp.asarray(u))
    for seed in range(8):
        st = b.build(jax.random.key(seed),
                     init_state(6, 3, beta=0.4, dtype=jnp.float64), 4)
        sel = np.asarray(st.idcs)[np.asarray(st.slot_mask)]
        assert set(sel.tolist()).issubset({17, 31}), (seed, sel)


def test_hilbert_weighted_base_data(rng):
    """HilbertCoreset(data_weights=u): u=ones matches the unweighted build;
    zero-weight rows leave the candidate pool; the weighted target makes a
    Hilbert build over a merge-reduce leaf union approximate the full-data
    Hilbert summary."""
    import betacores_tpu as bc
    from betacores_tpu.inference import fixed_sampler

    X, model, smp, Siginv = _gauss_problem(rng, N=80)
    samples = jnp.asarray(rng.normal(size=(12, 3)))
    prj = bc.BlackBoxProjector(fixed_sampler(samples), 12,
                               model.log_likelihood)

    a1 = bc.HilbertCoreset(X, prj, seed=3)
    a1.build(10, 10)
    a2 = bc.HilbertCoreset(X, prj, seed=3,
                           data_weights=jnp.ones(X.shape[0]))
    a2.build(10, 10)
    w1, p1, i1 = a1.get()
    w2, p2, i2 = a2.get()
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(w1), np.asarray(w2),
                               rtol=1e-8, atol=1e-10)

    # u==0 rows never selected
    u = np.ones(80)
    u[:70] = 0.0
    a3 = bc.HilbertCoreset(X, prj, seed=3, data_weights=jnp.asarray(u))
    a3.build(6, 6)
    _, _, i3 = a3.get()
    assert set(np.asarray(i3).tolist()).issubset(set(range(70, 80)))


def test_bpsvi_weighted_base_data(rng):
    """BPSVI with data_weights: init draws only from u>0 rows; the weighted
    target makes the pseudo-coreset match the WEIGHTED posterior, not the
    uniform one (u doubles rows 0..11 and zeroes the rest; the optimized
    pseudo-coreset's exact conjugate posterior must sit near the
    weighted-data posterior and beat the uniform-data posterior fit)."""
    from betacores_tpu.coresets import BPSVIConfig, make_bpsvi_builder

    d = 3
    X, model, smp, Siginv = _gauss_problem(rng, N=60, d=d)
    u = np.zeros(60)
    u[:12] = 2.0
    cfg = BPSVIConfig(projection_dim=32, n_subsample_opt=None,
                      opt_itrs=150, i0=0.3)
    b = make_bpsvi_builder(X, model, smp, cfg, data_weights=jnp.asarray(u))
    wts, pts, idcs = b(jax.random.key(0), 6, jnp.zeros(d))
    assert set(np.asarray(idcs).tolist()).issubset(set(range(12)))
    assert np.isfinite(np.asarray(wts)).all()

    mu0, Sig0inv = jnp.zeros(d), jnp.eye(d)
    post_c = gmod.weighted_post(mu0, Sig0inv, jnp.asarray(Siginv), pts, wts)

    def rkl_vs(Xref, wref):
        post_t = gmod.weighted_post(mu0, Sig0inv, jnp.asarray(Siginv),
                                    jnp.asarray(Xref), jnp.asarray(wref))
        return float(gmod.gaussian_KL(post_c.mu, post_c.cov, post_t.mu,
                                      jnp.linalg.inv(post_t.cov)))

    rkl_weighted = rkl_vs(X, u)              # the target posterior
    rkl_uniform = rkl_vs(X, np.ones(60))     # NOT the target
    assert rkl_weighted < 0.5, rkl_weighted
    assert rkl_weighted < rkl_uniform, (rkl_weighted, rkl_uniform)


def test_eager_api_data_weights_passthrough(rng):
    """The eager classes expose data_weights: a BetaCoreset over a weighted
    union matches the functional builder and refine() polishes toward the
    WEIGHTED target (group-mode weights are covered in test_groups.py)."""
    import betacores_tpu as bc
    from betacores_tpu.inference import gaussian_conjugate_sampler

    X, model, smp, _ = _gauss_problem(rng, N=50)
    u = np.ones(50)
    u[40:] = 0.0
    prj = bc.BetaBlackBoxProjector(smp, 8, model.beta_likelihood,
                                   model.log_likelihood, model.beta_gradient)
    alg = bc.BetaCoreset(X, prj, beta=0.4, opt_itrs=8, n_subsample_opt=16,
                         n_subsample_select=20, seed=7,
                         data_weights=jnp.asarray(u))
    alg.build(5, 5)
    w, p, i, _ = alg.get()
    assert set(np.asarray(i).tolist()).issubset(set(range(40)))
    # refine() threads the weights through to the frozen target
    alg.refine(n_samples=64)
    w2, _, i2, _ = alg.get()
    assert np.all(np.asarray(w2) >= 0)
    assert set(np.asarray(i2).tolist()).issubset(set(np.asarray(i).tolist()))


def test_refine_weighted_equals_row_duplication(rng):
    """refine_weights(data_weights=u) with integer u must equal refining on
    the physically duplicated dataset (same key => same frozen sample draw;
    only the target-sum reduction differs), and u=ones must match the
    unweighted call."""
    from betacores_tpu.coresets.refine import refine_weights

    X, model, smp, _ = _gauss_problem(rng, N=40)
    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=None,
                            n_subsample_opt=None, opt_itrs=8, i0=0.5,
                            use_beta=False)
    st0 = init_state(8, 3, beta=0.4, dtype=jnp.float64)
    st = make_incremental_builder(X, model, smp, cfg).build(
        jax.random.key(3), st0, 5)

    key = jax.random.key(11)
    kw = dict(n_samples=64, use_beta=False)
    st_plain = refine_weights(key, X, model, smp, st, **kw)
    st_ones = refine_weights(key, X, model, smp, st,
                             data_weights=jnp.ones(40), **kw)
    np.testing.assert_allclose(np.asarray(st_plain.wts),
                               np.asarray(st_ones.wts), rtol=1e-9, atol=1e-12)

    k_dup = 6
    u = jnp.asarray(np.concatenate([2.0 * np.ones(k_dup), np.ones(40 - k_dup)]))
    Xdup = jnp.concatenate([X, X[:k_dup]])
    st_w = refine_weights(key, X, model, smp, st, data_weights=u, **kw)
    st_d = refine_weights(key, Xdup, model, smp, st, **kw)
    np.testing.assert_allclose(np.asarray(st_w.wts), np.asarray(st_d.wts),
                               rtol=1e-8, atol=1e-11)
    with pytest.raises(ValueError):
        refine_weights(key, X, model, smp, st, data_weights=jnp.ones(7), **kw)


def test_uniform_sampling_weighted(rng):
    """UniformSamplingCoreset(data_weights=u): draws ~ u (u==0 never drawn),
    weights scale by total mass sum(u)."""
    import betacores_tpu as bc

    X, _, _, _ = _gauss_problem(rng, N=50)
    u = np.zeros(50)
    u[10:20] = 3.0
    alg = bc.UniformSamplingCoreset(X, seed=2, data_weights=jnp.asarray(u))
    alg.build(12, 12)
    w, p, i = alg.get()
    assert set(np.asarray(i).tolist()).issubset(set(range(10, 20)))
    np.testing.assert_allclose(float(np.sum(w)), 30.0, rtol=1e-9)
    # group mode: draws ~ group mass, u==0 members dropped
    groups = [list(range(5 * g, 5 * g + 5)) for g in range(10)]
    ag = bc.UniformSamplingCoreset(X, seed=4, groups=groups,
                                   data_weights=jnp.asarray(u))
    ag.build(8, X.shape[0])
    wg, pg, ig = ag.get()
    # only groups 2 and 3 have mass (rows 10..19), and every appended
    # member has u>0
    assert set(ag.selected_groups).issubset({2, 3})
    assert set(np.asarray(ig).tolist()).issubset(set(range(10, 20)))
    with pytest.raises(ValueError):
        bc.UniformSamplingCoreset(X, groups=[[0, 1]], data_weights=jnp.asarray(u))


def test_review_regressions_weighted_edges(rng):
    """Round-2 high-effort review regressions: custom-length step_sizes with
    the pre-drawn fast path; BPSVI weighted init with too few positive rows;
    zero-total-mass / wrong-length uniform weights; NaN-proof select_beta."""
    import jax

    from betacores_tpu.coresets import (BPSVIConfig, IncrementalConfig,
                                        init_state, make_bpsvi_builder,
                                        make_incremental_builder)
    from betacores_tpu.coresets.select_beta import select_beta
    from betacores_tpu.data import gen_synthetic_logreg
    from betacores_tpu.inference import logreg_laplace_sampler
    from betacores_tpu.models import logreg

    _, _, Z = gen_synthetic_logreg(jax.random.key(0), 120, d=3, dtype=jnp.float32)
    model, smp = logreg.bundle(), logreg_laplace_sampler()

    # 1) step_sizes shorter than opt_itrs must run len(step_sizes) steps
    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=30,
                            n_subsample_opt=20, opt_itrs=50, i0=0.5)
    b = make_incremental_builder(Z, model, smp, cfg,
                                 step_sizes=jnp.full(10, 0.3, dtype=Z.dtype))
    st = b.build(jax.random.key(1), init_state(8, 3, dtype=Z.dtype), 4)
    assert int(st.m) >= 1

    # 2) weighted BPSVI init: sz > #positive rows is a clear error
    u = np.zeros(120)
    u[:3] = 1.0
    bp = make_bpsvi_builder(Z, model, smp,
                            BPSVIConfig(projection_dim=8, n_subsample_opt=20,
                                        opt_itrs=5, i0=0.3),
                            data_weights=jnp.asarray(u, dtype=Z.dtype))
    with pytest.raises(ValueError, match="positive"):
        bp(jax.random.key(2), 6, jnp.zeros(3, dtype=Z.dtype))
    wts, pts, idcs = bp(jax.random.key(2), 3, jnp.zeros(3, dtype=Z.dtype))
    assert set(np.asarray(idcs).tolist()).issubset({0, 1, 2})

    # 3) uniform sampler: zero total mass / wrong length rejected up front
    import betacores_tpu as bc
    with pytest.raises(ValueError, match="mass"):
        bc.UniformSamplingCoreset(Z, data_weights=np.zeros(120))
    with pytest.raises(ValueError, match="data_weights"):
        bc.UniformSamplingCoreset(Z, data_weights=np.ones(7))

    # 4) select_beta never returns a NaN-scoring beta
    def build_fn(beta):
        return np.ones(2), np.asarray(Z[:2])

    calls = iter([np.full(5, np.nan), np.ones(5)])
    def score_fn(w, p):
        return jnp.asarray(next(calls))

    best, scores = select_beta(build_fn, (0.1, 0.5), score_fn, trim=0.2)
    assert best == 0.5 and np.isnan(scores[0])
    with pytest.raises(ValueError, match="NaN"):
        select_beta(build_fn, (0.1,), lambda w, p: jnp.full(5, jnp.nan),
                    trim=0.2)


def test_weighted_target_matches_oracle(rng):
    """the data_weights tangent target golden-checked
    against an independent NumPy oracle (deterministic sampler, full-data)
    — the internal equivalences above (u=ones == unweighted, integer u ==
    row duplication) would both pass a shared weighted-math bug."""
    from betacores_tpu.inference import fixed_sampler
    from oracle import coresets as ocs
    from oracle import models as om

    X, model, _, Siginv = _gauss_problem(rng, N=50)
    d = X.shape[1]
    logdetSig = np.linalg.slogdet(2.0 * np.eye(d))[1]
    S = 8
    samples = np.asarray(rng.normal(size=(S, d)))
    u = np.ones(50)
    u[:10] = 0.0       # non-data rows: never selectable
    u[10:20] = 3.0
    u[20:30] = 0.5
    itrs, opt_itrs, i0 = 6, 15, 0.5
    cfg = IncrementalConfig(projection_dim=S, opt_itrs=opt_itrs, i0=i0)
    b = make_incremental_builder(X, model,
                                 fixed_sampler(jnp.asarray(samples)), cfg,
                                 data_weights=jnp.asarray(u))
    st = b.build(jax.random.key(0), init_state(16, d, dtype=jnp.float64), itrs)

    w_o, i_o, p_o = ocs.incremental_build_weighted_deterministic(
        X, u, itrs, opt_itrs, lambda i: i0 / (1.0 + i),
        lambda w, p: samples,
        lambda pts, s: om.gauss_log_likelihood(pts, s, Siginv, logdetSig))
    m = int(st.m)
    assert m == len(i_o) > 0
    np.testing.assert_array_equal(np.asarray(st.idcs)[:m], i_o)
    np.testing.assert_allclose(np.asarray(st.wts)[:m], w_o,
                               rtol=1e-6, atol=1e-9)
    assert not np.isin(i_o, np.arange(10)).any()


def test_checkpoint_resume_bit_identical(rng, tmp_path):
    """Streaming fault tolerance (round 3): crash after 2 of 4 leaves, rerun
    with the same args + checkpoint_path -> bit-identical to an
    uninterrupted run; the checkpoint is removed on success; resuming under
    a different key refuses."""
    import betacores_tpu.coresets.streaming as streaming_mod

    d = 3
    Xall, _ = _contaminated(rng, N=800, d=d)
    X = jnp.asarray(Xall)
    _, model, smp, _ = _gauss_problem(rng, N=4)
    cfg = IncrementalConfig(projection_dim=12, n_subsample_select=80,
                            n_subsample_opt=40, opt_itrs=12, i0=1.0,
                            use_beta=True)
    st_leaf = init_state(6, d, beta=0.4, dtype=jnp.float64)
    key = jax.random.key(3)
    args = dict(model=model, sampler=smp, leaf_config=cfg, final_config=cfg,
                chunk_size=220, m_leaf=5, m_final=8, st_leaf=st_leaf)

    st_ref, lp_ref, lw_ref = merge_reduce_build(key, X, **args)

    ck = str(tmp_path / "mr.npz")
    orig_make = streaming_mod.make_incremental_builder
    calls = {"n": 0}

    def crashing_make(*a, **k):
        b = orig_make(*a, **k)
        orig_bwd = b.build_with_data

        def bwd(*aa, **kk):
            if calls["n"] == 2:
                raise RuntimeError("simulated crash")
            calls["n"] += 1
            return orig_bwd(*aa, **kk)

        b.build_with_data = bwd
        return b

    streaming_mod.make_incremental_builder = crashing_make
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            merge_reduce_build(key, X, checkpoint_path=ck, **args)
    finally:
        streaming_mod.make_incremental_builder = orig_make

    import os
    assert os.path.exists(ck)
    with np.load(ck) as z:
        assert int(z["n_done"]) == 2

    # wrong key refuses to resume
    with pytest.raises(ValueError, match="different"):
        merge_reduce_build(jax.random.key(99), X, checkpoint_path=ck, **args)

    st_r, lp_r, lw_r = merge_reduce_build(key, X, checkpoint_path=ck, **args)
    np.testing.assert_array_equal(np.asarray(st_r.idcs), np.asarray(st_ref.idcs))
    np.testing.assert_allclose(np.asarray(st_r.wts), np.asarray(st_ref.wts),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(lw_r), np.asarray(lw_ref),
                               rtol=0, atol=0)
    assert not os.path.exists(ck)  # removed after success


def test_hierarchical_reduction_caps_union_and_keeps_quality(rng):
    """max_union_rows (round 3): the union fed to the final build never
    exceeds the cap (multi-level tree actually engaged), and the merged
    coreset still tracks the clean posterior far below the corrupted
    summary."""
    d = 3
    Xall, Xclean = _contaminated(rng, N=1200, d=d)
    X = jnp.asarray(Xall)
    _, model, smp, Siginv = _gauss_problem(rng, N=4)
    cfg = IncrementalConfig(projection_dim=12, n_subsample_select=80,
                            n_subsample_opt=40, opt_itrs=15, i0=1.0,
                            use_beta=True)
    st_leaf = init_state(6, d, beta=0.4, dtype=jnp.float64)
    # 12 chunks x 6 slots = 72 union rows; cap at 24 -> needs >= 2 levels
    st_f, lp, lw = merge_reduce_build(
        jax.random.key(7), X, model, smp, cfg, cfg, chunk_size=100,
        m_leaf=5, m_final=8, st_leaf=st_leaf, max_union_rows=24)
    assert lp.shape[0] <= 24 and lw.shape[0] <= 24
    assert int(st_f.m) >= 2
    w = np.asarray(st_f.wts)
    mask = np.asarray(st_f.slot_mask)
    rkl_h = _rkl(w[mask], np.asarray(st_f.pts)[mask], Xclean, Siginv, d)
    rkl_corrupt = _rkl(np.ones(X.shape[0]), Xall, Xclean, Siginv, d)
    assert np.isfinite(rkl_h) and rkl_h < rkl_corrupt

    # cap below 2x the leaf buffer cannot shrink: explicit error
    with pytest.raises(ValueError, match="max_union_rows"):
        merge_reduce_build(jax.random.key(7), X, model, smp, cfg, cfg,
                           chunk_size=100, m_leaf=5, m_final=8,
                           st_leaf=st_leaf, max_union_rows=8)


def test_reduction_checkpoint_resume_bit_identical(rng, tmp_path):
    """Round-4 (verdict item 7): crash DURING the hierarchical reduction
    (leaf pass complete), rerun with the same args + checkpoint_path ->
    bit-identical to an uninterrupted run; the same file carries leaf AND
    (level, group) reduction progress; removed on success."""
    import os

    import betacores_tpu.coresets.streaming as streaming_mod

    d = 3
    Xall, _ = _contaminated(rng, N=1200, d=d)
    X = jnp.asarray(Xall)
    _, model, smp, _ = _gauss_problem(rng, N=4)
    cfg = IncrementalConfig(projection_dim=12, n_subsample_select=80,
                            n_subsample_opt=40, opt_itrs=15, i0=1.0,
                            use_beta=True)
    st_leaf = init_state(6, d, beta=0.4, dtype=jnp.float64)
    key = jax.random.key(7)
    # same shapes as test_hierarchical_reduction_caps_union_and_keeps_quality
    # (compile-cache reuse): 12 leaves, union 72 rows, cap 24 -> >= 2 levels
    args = dict(model=model, sampler=smp, leaf_config=cfg, final_config=cfg,
                chunk_size=100, m_leaf=5, m_final=8, st_leaf=st_leaf,
                max_union_rows=24)

    st_ref, lp_ref, lw_ref = merge_reduce_build(key, X, **args)

    ck = str(tmp_path / "mr_red.npz")
    orig_make = streaming_mod.make_incremental_builder
    calls = {"n": 0}
    n_leaves = -(-X.shape[0] // 100)  # _contaminated appends outlier rows

    def crashing_make(*a, **k):
        b = orig_make(*a, **k)
        orig_bwd = b.build_with_data

        def bwd(*aa, **kk):
            # crash on the SECOND reduction-group build (after all leaves)
            if calls["n"] == n_leaves + 1:
                raise RuntimeError("simulated crash")
            calls["n"] += 1
            return orig_bwd(*aa, **kk)

        b.build_with_data = bwd
        return b

    streaming_mod.make_incremental_builder = crashing_make
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            merge_reduce_build(key, X, checkpoint_path=ck, **args)
    finally:
        streaming_mod.make_incremental_builder = orig_make

    assert os.path.exists(ck)
    with np.load(ck) as z:
        assert int(z["n_done"]) == n_leaves          # leaf pass complete
        assert int(z["red_level"]) == 0 and int(z["red_g_done"]) == 1

    st_r, lp_r, lw_r = merge_reduce_build(key, X, checkpoint_path=ck, **args)
    np.testing.assert_array_equal(np.asarray(st_r.idcs), np.asarray(st_ref.idcs))
    np.testing.assert_allclose(np.asarray(st_r.wts), np.asarray(st_ref.wts),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(lw_r), np.asarray(lw_ref),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(lp_r), np.asarray(lp_ref),
                               rtol=0, atol=0)
    assert not os.path.exists(ck)


def test_mesh_streamed_rounds_match_plain(rng):
    """K > n_lanes exercises the round-5 per-chip host-streamed chunk
    lanes: the mesh leaf pass runs in R = K/n_lanes rounds (peak host copy
    = one round's batch) and every leaf's result must still match the
    unsharded one-shot vmapped build bit-for-bit — leaf (rows, u, key)
    triples are identical and the per-lane program is elementwise in the
    lane axis."""
    from betacores_tpu.parallel import make_mesh

    d = 3
    Xall_np, _ = _contaminated(rng, N=1200, d=d)
    X = jnp.asarray(Xall_np)
    _, model, smp, _ = _gauss_problem(rng, N=4)
    leaf_cfg = IncrementalConfig(projection_dim=16, n_subsample_select=100,
                                 n_subsample_opt=60, opt_itrs=20, i0=1.0,
                                 use_beta=True)
    final_cfg = IncrementalConfig(projection_dim=16, n_subsample_select=None,
                                  n_subsample_opt=None, opt_itrs=20, i0=1.0,
                                  use_beta=True)
    st_leaf = init_state(10, d, beta=0.4, dtype=jnp.float64)
    key = jax.random.key(4)

    # chunk=150 -> K = ceil(N/150) > 4 chunks; data axis 4 lanes -> the
    # mesh leaf pass streams in multiple rounds
    import math
    K = math.ceil(X.shape[0] / 150)
    assert K > 4  # multi-round regime
    st_p, lp_p, lw_p = merge_reduce_build(
        key, X, model, smp, leaf_cfg, final_cfg, chunk_size=150,
        m_leaf=6, m_final=10, st_leaf=st_leaf, parallel_leaves=True)
    mesh = make_mesh(4, 2)
    st_m, lp_m, lw_m = merge_reduce_build(
        key, X, model, smp, leaf_cfg, final_cfg, chunk_size=150,
        m_leaf=6, m_final=10, st_leaf=st_leaf, mesh=mesh)

    assert lw_m.shape == (K * 10,) and lw_p.shape == (K * 10,)
    np.testing.assert_allclose(np.asarray(lw_m), np.asarray(lw_p),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(lp_m), np.asarray(lp_p),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(st_m.idcs), np.asarray(st_p.idcs))
    np.testing.assert_allclose(np.asarray(st_m.wts), np.asarray(st_p.wts),
                               rtol=1e-7, atol=1e-10)


def test_zero_weight_rows_never_selected_dedup(rng):
    """dedup_select + weighted base data: the u-mask is applied BEFORE the
    dedup candidate mask, so u==0 rows stay unselectable (dedup's
    always-add rule must not override them) while the budget fills among
    the real rows without duplicates."""
    X, model, smp, _ = _gauss_problem(rng, N=50)
    u = np.zeros(50)
    live = [3, 17, 24, 31, 42]
    u[live] = 1.0
    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=25,
                            n_subsample_opt=8, opt_itrs=5, i0=0.5,
                            use_beta=True, dedup_select=True)
    b = make_incremental_builder(X, model, smp, cfg,
                                 data_weights=jnp.asarray(u))
    st = b.build(jax.random.key(0),
                 init_state(8, 3, beta=0.4, dtype=jnp.float64), 6)
    m = int(st.m)
    sel = np.asarray(st.idcs)[:m].tolist()
    assert set(sel).issubset(set(live)), sel
    # distinct picks only; with 25-row subsamples over 50 rows, all 5 live
    # rows are seen with overwhelming probability across 6 iterations
    assert len(sel) == len(set(sel)) == 5
