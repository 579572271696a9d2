"""Group-mode (batch selection) tests: segment-sum group projections match
per-group sums, group builds select whole groups, warm-start slot locking,
and the uniform group baseline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import betacores_tpu as bc
from betacores_tpu.coresets import init_state
from betacores_tpu.coresets.groups import (
    group_ids_from_groups,
    init_group_state,
    make_group_incremental_builder,
)
from betacores_tpu.coresets.incremental import IncrementalConfig
from betacores_tpu.inference import fixed_sampler, gaussian_conjugate_sampler
from betacores_tpu.models import gaussian as gmod
from betacores_tpu.ops.projection import Groups, project_groups, project_ll


@pytest.fixture
def setup(rng):
    N, d, S = 60, 3, 8
    Sig = np.eye(d) * 2.0
    Siginv = np.linalg.inv(Sig)
    logdetSig = np.linalg.slogdet(Sig)[1]
    X = rng.normal(size=(N, d))
    samples = rng.normal(size=(S, d))
    model = gmod.bundle(jnp.asarray(Siginv), logdetSig)
    # uneven groups covering all points
    sizes = [5, 12, 3, 20, 10, 10]
    groups, i = [], 0
    for s in sizes:
        groups.append(list(range(i, i + s)))
        i += s
    return X, samples, model, groups, Siginv


def test_group_projection_matches_member_sums(setup):
    X, samples, model, groups, _ = setup
    gp = Groups.from_lists(groups)
    proj = lambda pts: project_ll(model, pts, jnp.asarray(samples))
    gvecs = np.asarray(project_groups(proj, jnp.asarray(X), gp))
    full = np.asarray(proj(jnp.asarray(X)))
    for g, mem in enumerate(groups):
        np.testing.assert_allclose(gvecs[g], full[mem].sum(axis=0), rtol=1e-9)
    # segment-sum path agrees too
    gid = group_ids_from_groups(gp, X.shape[0])
    seg = jax.ops.segment_sum(jnp.asarray(full), gid, num_segments=len(groups) + 1)[: len(groups)]
    np.testing.assert_allclose(np.asarray(seg), gvecs, rtol=1e-9)


def test_group_build_selects_whole_groups(setup):
    X, samples, model, groups, _ = setup
    gp = Groups.from_lists(groups)
    cfg = IncrementalConfig(projection_dim=samples.shape[0], opt_itrs=10, i0=0.5, use_beta=False)
    builder = make_group_incremental_builder(
        jnp.asarray(X), gp, model, fixed_sampler(jnp.asarray(samples)), cfg)
    gst = init_group_state(init_state(60, X.shape[1], dtype=jnp.float64), len(groups))
    gst = builder(jax.random.key(0), gst, 3)
    st = gst.core
    m = int(st.m)
    sel = np.where(np.asarray(gst.selected))[0]
    assert len(sel) >= 1
    # appended slots = exact union of the selected groups' members
    assert m == sum(len(groups[g]) for g in sel)
    got_idcs = set(np.asarray(st.idcs)[:m].tolist())
    want_idcs = set(i for g in sel for i in groups[g])
    assert got_idcs == want_idcs
    # each slot's point matches its index
    np.testing.assert_allclose(
        np.asarray(st.pts)[:m], X[np.asarray(st.idcs)[:m]], rtol=1e-9)


def test_eager_group_api_sparsevi_and_bcores(setup):
    X, samples, model, groups, _ = setup
    prj = bc.BlackBoxProjector(fixed_sampler(jnp.asarray(samples)), samples.shape[0],
                               model.log_likelihood)
    alg = bc.SparseVICoreset(jnp.asarray(X), prj, opt_itrs=8, groups=groups, seed=0)
    alg.build(2, X.shape[0])
    assert len(alg.selected_groups) >= 1
    w, p, i = alg.get()
    assert (w >= 0).all()

    bprj = bc.BetaBlackBoxProjector(fixed_sampler(jnp.asarray(samples)), samples.shape[0],
                                    model.beta_likelihood, model.log_likelihood,
                                    model.beta_gradient)
    balg = bc.BetaCoreset(jnp.asarray(X), bprj, beta=0.3, learn_beta=False,
                          opt_itrs=8, groups=groups, seed=1)
    balg.build(2, X.shape[0])
    assert len(balg.selected_groups) >= 1


def test_initialized_slots_locked(setup):
    """Warm-start slots must not suppress new-group selection (reference
    initialized logic at bcores.py:105-109)."""
    X, samples, model, groups, _ = setup
    prj = bc.BlackBoxProjector(fixed_sampler(jnp.asarray(samples)), samples.shape[0],
                               model.log_likelihood)
    seed_pts = X[:3] + 100.0  # dominant fake coreset points
    alg = bc.SparseVICoreset(jnp.asarray(X), prj, opt_itrs=5, groups=groups, seed=2,
                             wts=np.ones(3), idcs=np.array([10_000_000, 10_000_001, 10_000_002]),
                             pts=seed_pts, initialized=True)
    alg.build(2, 10_000)
    # with the seeds locked out of the comparison, real groups still get added
    assert len(alg.selected_groups) >= 1


def test_uniform_sampling_group_mode(setup):
    X, _, _, groups, _ = setup
    alg = bc.UniformSamplingCoreset(jnp.asarray(X), seed=3, groups=groups)
    alg.build(4, X.shape[0])
    w, p, i = alg.get()
    assert len(alg.selected_groups) >= 1
    got = set(i.tolist())
    want = set(x for g in alg.selected_groups for x in groups[g])
    assert got == want
    np.testing.assert_allclose(w.sum(), X.shape[0], rtol=1e-9)


def test_group_build_trace_matches_build(setup):
    """Group-mode build_trace: one device program == build(itrs) with the
    same key-stream position; the selected trace is monotone and its final
    row matches selected_groups; per-iteration compact coresets stay
    whole-group unions."""
    X, samples, model, groups, _ = setup
    prj = bc.BlackBoxProjector(fixed_sampler(jnp.asarray(samples)), samples.shape[0],
                               model.log_likelihood)
    a1 = bc.SparseVICoreset(jnp.asarray(X), prj, opt_itrs=8, groups=groups, seed=4)
    a2 = bc.SparseVICoreset(jnp.asarray(X), prj, opt_itrs=8, groups=groups, seed=4)
    trace, sel = a1.build_trace(3, return_selected=True)
    a2.build(3, X.shape[0])  # same KeySequence position: identical key stream
    w2, p2, i2 = a2.get()
    wl, pl, il, _ = trace[-1]
    np.testing.assert_allclose(wl, w2, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(il, i2)
    assert sel.shape == (3, len(groups))
    # monotone: once selected, always selected
    assert ((sel[1:] >= sel[:-1]).all())
    np.testing.assert_array_equal(np.where(sel[-1])[0], a1.selected_groups)
    np.testing.assert_array_equal(np.where(sel[-1])[0], a2.selected_groups)
    # point mode rejects return_selected explicitly
    a3 = bc.SparseVICoreset(jnp.asarray(X), prj, opt_itrs=8, seed=4, max_size=8)
    with pytest.raises(ValueError):
        a3.build_trace(2, return_selected=True)


def test_weighted_group_build(setup):
    """data_weights in group mode: u=ones is bit-identical to the unweighted
    build; zero-mass groups are never selected and u==0 members never enter
    the coreset."""
    X, samples, model, groups, _ = setup
    prj = bc.BlackBoxProjector(fixed_sampler(jnp.asarray(samples)), samples.shape[0],
                               model.log_likelihood)
    a1 = bc.SparseVICoreset(jnp.asarray(X), prj, opt_itrs=8, groups=groups, seed=5)
    a2 = bc.SparseVICoreset(jnp.asarray(X), prj, opt_itrs=8, groups=groups, seed=5,
                            data_weights=jnp.ones(X.shape[0]))
    a1.build(3, X.shape[0])
    a2.build(3, X.shape[0])
    w1, _, i1 = a1.get()
    w2, _, i2 = a2.get()
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(w1, w2, rtol=1e-9, atol=1e-12)
    assert a1.selected_groups == a2.selected_groups

    # zero out groups 1 and 3 entirely, and half of group 4's members
    u = np.ones(X.shape[0])
    u[groups[1]] = 0.0
    u[groups[3]] = 0.0
    half4 = groups[4][: len(groups[4]) // 2]
    u[half4] = 0.0
    a3 = bc.SparseVICoreset(jnp.asarray(X), prj, opt_itrs=8, groups=groups, seed=6,
                            data_weights=jnp.asarray(u))
    a3.build(4, X.shape[0])
    _, _, i3 = a3.get()
    sel = set(a3.selected_groups)
    assert sel, "weighted group build selected nothing"
    assert not sel & {1, 3}, sel
    dead = set(int(i) for i in np.where(u == 0)[0])
    assert not set(np.asarray(i3).tolist()) & dead
    # group trace works weighted too, and matches build on the same stream
    a4 = bc.SparseVICoreset(jnp.asarray(X), prj, opt_itrs=8, groups=groups, seed=6,
                            data_weights=jnp.asarray(u))
    trace, selmask = a4.build_trace(4, return_selected=True)
    np.testing.assert_array_equal(np.where(selmask[-1])[0],
                                  sorted(a3.selected_groups))


def test_group_refine_and_uniform_group_trace(setup):
    """Group-mode refine(): point-level FISTA polish on the appended members
    tightens the frozen tangent objective without changing the support;
    UniformSamplingCoreset.build_trace works in group mode (same host RNG
    stream as the build loop)."""
    X, samples, model, groups, _ = setup
    prj = bc.BlackBoxProjector(fixed_sampler(jnp.asarray(samples)), samples.shape[0],
                               model.log_likelihood)
    alg = bc.SparseVICoreset(jnp.asarray(X), prj, opt_itrs=8, groups=groups, seed=9)
    alg.build(3, X.shape[0])
    # support = ALL appended group members (zero-weight slots included:
    # the polish may redistribute onto them), not just w>0 rows
    support = set(np.asarray(alg.state.idcs)[: int(alg.state.m)].tolist())
    alg.refine(n_samples=32)
    w_after, _, i_after = alg.get()
    assert (w_after >= 0).all()
    assert set(np.asarray(i_after).tolist()).issubset(support)

    a1 = bc.UniformSamplingCoreset(jnp.asarray(X), seed=11, groups=groups)
    a2 = bc.UniformSamplingCoreset(jnp.asarray(X), seed=11, groups=groups)
    trace = a1.build_trace(4)
    for m in range(1, 5):
        a2.build(1, X.shape[0])
    w2, p2, i2 = a2.get()
    wl, pl, il = trace[-1]
    np.testing.assert_array_equal(sorted(il.tolist()), sorted(i2.tolist()))
    np.testing.assert_allclose(sorted(wl.tolist()), sorted(w2.tolist()), rtol=1e-9)
    assert a1.selected_groups == a2.selected_groups


def test_group_build_matches_oracle(setup):
    """the group-append trajectory (reference
    bcores.py:91-123) golden-checked against an independent NumPy oracle
    (deterministic sampler, no subsampling) — the existing equivalence
    tests (group build == sharded group build) would pass a shared bug in
    the group tangent math."""
    from oracle import coresets as ocs
    from oracle import models as om

    X, samples, model, groups, Siginv = setup
    d = X.shape[1]
    logdetSig = np.linalg.slogdet(2.0 * np.eye(d))[1]
    gp = Groups.from_lists(groups)
    itrs, opt_itrs, i0 = 4, 20, 0.5
    cfg = IncrementalConfig(projection_dim=samples.shape[0],
                            opt_itrs=opt_itrs, i0=i0)
    builder = make_group_incremental_builder(
        jnp.asarray(X), gp, model, fixed_sampler(jnp.asarray(samples)), cfg)
    gst = builder(jax.random.key(0),
                  init_group_state(init_state(60, d, dtype=jnp.float64),
                                   gp.n_groups), itrs)

    w_o, i_o, p_o, sel_o = ocs.group_incremental_build_deterministic(
        X, groups, itrs, opt_itrs, lambda i: i0 / (1.0 + i),
        lambda w, p: samples,
        lambda pts, s: om.gauss_log_likelihood(pts, s, Siginv, logdetSig))

    np.testing.assert_array_equal(np.asarray(gst.selected), sel_o)
    m = int(gst.core.m)
    assert m == len(i_o) > 0
    np.testing.assert_array_equal(np.asarray(gst.core.idcs)[:m], i_o)
    np.testing.assert_allclose(np.asarray(gst.core.wts)[:m], w_o,
                               rtol=1e-6, atol=1e-9)


def test_group_mode_learn_beta_refuses(setup):
    """Regression (round-3 review): group builders do not implement
    learn_beta — silently keeping beta fixed would be a wrong-result trap,
    so they must refuse loudly."""
    X, samples, model, groups, _ = setup
    prj = bc.BetaBlackBoxProjector(fixed_sampler(jnp.asarray(samples)),
                                   samples.shape[0], model.beta_likelihood,
                                   model.log_likelihood, model.beta_gradient)
    with pytest.raises(NotImplementedError, match="learn_beta"):
        alg = bc.BetaCoreset(jnp.asarray(X), prj, beta=0.3, learn_beta=True,
                             opt_itrs=5, groups=groups, seed=1)
        alg.build(1, 100)  # whichever of construction/build makes the builder


def test_group_reduce_fallback_matches_onehot(setup, monkeypatch):
    """The scatter (segment_sum) fallback above the one-hot HBM gate must
    build the same trajectory as the one-hot matmul path (round 4: the
    group reduction became an MXU matmul below ONEHOT_MAX_BYTES, so nothing
    else exercises the fallback)."""
    from betacores_tpu.coresets import groups as grp_mod
    from betacores_tpu.coresets.groups import (init_group_state,
                                               make_group_incremental_builder)
    from betacores_tpu.coresets.incremental import IncrementalConfig
    from betacores_tpu.coresets.state import init_state

    X, samples, model, groups, _ = setup
    gp = Groups.from_lists(groups)
    cfg = IncrementalConfig(projection_dim=samples.shape[0], opt_itrs=10, i0=0.5)
    smp = fixed_sampler(jnp.asarray(samples))

    def build_with_gate(gate):
        monkeypatch.setattr(grp_mod, "ONEHOT_MAX_BYTES", gate)
        b = make_group_incremental_builder(jnp.asarray(X), gp, model, smp, cfg)
        return b(jax.random.key(3),
                 init_group_state(init_state(60, X.shape[1], dtype=jnp.float64),
                                  gp.n_groups), 3)

    g_onehot = build_with_gate(256 * 1024 * 1024)
    g_scatter = build_with_gate(0)
    np.testing.assert_array_equal(np.asarray(g_onehot.selected),
                                  np.asarray(g_scatter.selected))
    np.testing.assert_array_equal(np.asarray(g_onehot.core.idcs),
                                  np.asarray(g_scatter.core.idcs))
    np.testing.assert_allclose(np.asarray(g_onehot.core.wts),
                               np.asarray(g_scatter.core.wts),
                               rtol=1e-12, atol=1e-12)


def test_group_dedup_select_fills_budget(rng):
    """dedup_select in group mode: selected groups are masked out of the
    candidate argmax and every step installs the best remaining FITTING
    group, so the build keeps growing until no group fits the remaining
    capacity (parity semantics can stall a step whenever a selected group
    out-scores the candidates)."""
    import betacores_tpu as bc
    from betacores_tpu.inference import fixed_sampler
    from betacores_tpu.models import gaussian as gmod

    N, d, S = 48, 3, 8
    Sig = np.eye(d) * 2.0
    X = rng.normal(size=(N, d))
    samples = rng.normal(size=(S, d))
    model = gmod.bundle(jnp.asarray(np.linalg.inv(Sig)),
                        np.linalg.slogdet(Sig)[1])
    groups = [list(range(i, i + 4)) for i in range(0, N, 4)]  # 12 groups of 4
    prj = bc.BetaBlackBoxProjector(fixed_sampler(jnp.asarray(samples)), S,
                                   model.beta_likelihood, model.log_likelihood,
                                   model.beta_gradient)
    alg = bc.BetaCoreset(jnp.asarray(X), prj, beta=0.4, opt_itrs=8,
                         groups=groups, seed=0, dedup_select=True,
                         max_size=32)  # buffer capacity: 8 groups of 4
    for _ in range(8):
        alg.build(1, alg.size() + 4)
    assert int(alg.state.m) == 32      # every step added: 8 distinct groups
    sel = alg.selected_groups
    assert len(sel) == 8 == len(set(sel))
    # installed indices are exactly the union of the selected groups
    got = sorted(np.asarray(alg.state.idcs)[:32].tolist())
    want = sorted(i for g in sel for i in groups[g])
    assert got == want


def test_group_dedup_build_matches_oracle(setup):
    """Golden trajectory for group-mode dedup_select: selected groups
    masked from the argmax, best remaining group always added — JAX build
    vs the independent NumPy oracle's dedup mode (buffer sized so the
    capacity mask never binds, matching the oracle's unbounded growth)."""
    from oracle import coresets as ocs
    from oracle import models as om

    X, samples, model, groups, Siginv = setup
    d = X.shape[1]
    logdetSig = np.linalg.slogdet(2.0 * np.eye(d))[1]
    gp = Groups.from_lists(groups)
    itrs, opt_itrs, i0 = 4, 20, 0.5
    cfg = IncrementalConfig(projection_dim=samples.shape[0],
                            opt_itrs=opt_itrs, i0=i0, dedup_select=True)
    builder = make_group_incremental_builder(
        jnp.asarray(X), gp, model, fixed_sampler(jnp.asarray(samples)), cfg)
    gst = builder(jax.random.key(0),
                  init_group_state(init_state(60, d, dtype=jnp.float64),
                                   gp.n_groups), itrs)

    w_o, i_o, p_o, sel_o = ocs.group_incremental_build_deterministic(
        X, groups, itrs, opt_itrs, lambda i: i0 / (1.0 + i),
        lambda w, p: samples,
        lambda pts, s: om.gauss_log_likelihood(pts, s, Siginv, logdetSig),
        dedup=True)

    # dedup adds one distinct group per iteration
    assert int(sel_o.sum()) == min(itrs, gp.n_groups)
    np.testing.assert_array_equal(np.asarray(gst.selected), sel_o)
    m = int(gst.core.m)
    assert m == len(i_o) > 0
    np.testing.assert_array_equal(np.asarray(gst.core.idcs)[:m], i_o)
    np.testing.assert_allclose(np.asarray(gst.core.wts)[:m], w_o,
                               rtol=1e-6, atol=1e-9)
