#!/usr/bin/env python3
"""Bring-up check of the beta-Cores headline build on one NVIDIA GPU.

Runs in ONE process that holds the card, phase by phase, and fails (non-zero
exit, no ok line) on the first phase that fails or when JAX finds no GPU:

  (a) device   the platform is "gpu"; prints the device kind and count and
               the card's name and power limit from nvidia-smi.
  (b) kernels  no hand-written kernel is left on the main path (the fused
               Adam-step kernel lost to plain XLA on the card and was
               removed); runs the repo's gpu-marked tests
               (tests/test_gpu.py).
  (c) golden   a deterministic-sampler build on the card against the float64
               NumPy oracle (oracle/coresets.py), N=20,000, d=10, S=100,
               M=10, opt_itrs=50, with dedup selection (every iteration
               adds a point).
  (d) main     the README flow at full size: BetaCoreset over N=1,000,000
               contaminated logistic-regression rows, d=10, M=100, S=100,
               opt_itrs=500, n_subsample_select=1000, n_subsample_opt=200,
               beta=0.1; compile and build time, fill, sum(w), held-out
               accuracy, peak device memory; the same build under "highest"
               matmul precision must agree; then both timed, alternating.
  (e) finding  the plain XLA multiclass beta-projection at N=2^20, S=100,
               K=5 against a large copy on the same card.

``--four-gpus`` runs only (a) and the sharded build (parallel/sharded.py,
mesh auto_mesh_shape(4) = 2 data x 2 samp) at the (d) configuration,
compared with the single-card build.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Usage:  python chip_smoke.py [--four-gpus]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

from betacores_tpu import headline as H

N, D, M, S, BETA = H.N, H.D, H.M, H.S, H.BETA
N_TEST = 100_000
N_MC, K_MC = 2 ** 20, 5        # (e) multiclass projection
COPY_ELEMS = 2 ** 28           # (e) 1 GiB of float32


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync(x):
    import jax

    return jax.block_until_ready(x)


def _timed(fn):
    t0 = time.perf_counter()
    out = _sync(fn())
    return out, time.perf_counter() - t0


def check(ok, what) -> None:
    """Fail the run (an exception, so a non-zero exit) unless ``ok``."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _err(got, ref):
    """(max abs error, max abs error over the largest |ref|)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    a = float(np.max(np.abs(got - ref)))
    return a, a / max(float(np.max(np.abs(ref))), 1e-30)


# ---------------------------------------------------------------------------
# (a) device
# ---------------------------------------------------------------------------

def phase_device():
    import jax

    from betacores_tpu.utils.device import require_gpu

    dev = require_gpu()
    log(f"[a] device kind: {dev.device_kind}; count: {len(jax.devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log("[a] nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    log(f"[a] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"JAX_COMPILATION_CACHE_DIR={os.environ.get('JAX_COMPILATION_CACHE_DIR', '')!r}")
    return dev


# ---------------------------------------------------------------------------
# (b) kernels
# ---------------------------------------------------------------------------

def phase_kernels():
    """No hand-written kernel is left on the main path: the fused Adam-step
    kernel (Pallas, Triton route) lost to the plain XLA step end to end on
    the H100 and was removed (PERF.md). What remains here are the repo's
    gpu-marked tests."""
    import pytest

    class Outcomes:
        """Counts collected tests and their outcomes: pytest exits 0 when
        every test skips, so the exit code alone proves nothing."""

        def __init__(self):
            self.collected, self.seen = 0, collections.Counter()

        def pytest_collection_finish(self, session):
            self.collected = len(session.items)

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.seen[report.outcome] += 1

    log("[b] hand-written kernels on the main path: none (every step is "
        "plain XLA); running the gpu-marked tests")
    os.environ["BETACORES_GPU_TESTS"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    got = Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(here, "tests", "test_gpu.py")],
                     plugins=[got])
    log(f"[b] pytest -m gpu tests/test_gpu.py: exit code {int(rc)}; "
        f"collected {got.collected}; outcomes {dict(got.seen)}")
    check(int(rc) == 0 and got.collected > 0
          and got.seen == {"passed": got.collected},
          f"gpu tests: every collected test must pass, none skip "
          f"(exit code {int(rc)}, collected {got.collected}, {dict(got.seen)})")


# ---------------------------------------------------------------------------
# (c) golden
# ---------------------------------------------------------------------------

def phase_golden():
    import jax
    import jax.numpy as jnp

    import betacores_tpu as bc
    import oracle.coresets as ocs
    import oracle.models as om
    from betacores_tpu.inference import fixed_sampler
    from betacores_tpu.models import logreg

    n, m, itrs = 20_000, 10, 50
    sched = lambda i: 1.0 / (1.0 + i)
    rng = np.random.default_rng(1)
    samples = 1.0 + 0.3 * rng.normal(size=(S, D))
    with jax.enable_x64(True):
        Z = H.data(jax.random.key(11), n, dtype=jnp.float64)
        prj = bc.BetaBlackBoxProjector(fixed_sampler(jnp.asarray(samples)), S,
                                       model=logreg.bundle())
        alg = bc.BetaCoreset(Z, prj, beta=BETA, opt_itrs=itrs,
                             step_sched=sched, seed=1, dedup_select=True)
        t0 = time.perf_counter()
        alg.build(m, m)
        w_g, _, i_g, _ = alg.get()
        t_gpu = time.perf_counter() - t0
        Z_np = np.asarray(Z)
    t0 = time.perf_counter()
    w_o, i_o, _ = ocs.incremental_build_deterministic(
        Z_np, m, itrs, sched, lambda w, p: samples,
        lambda pts, s: om.lr_beta_likelihood(pts, s, BETA), dedup=True)
    t_oracle = time.perf_counter() - t0
    keep = w_o > 0
    same = np.array_equal(np.sort(i_g), np.sort(i_o[keep]))
    log(f"[c] golden: float64 build on the card ({t_gpu:.1f}s incl. compile) "
        f"vs float64 NumPy oracle ({t_oracle:.1f}s); N={n}, d={D}, S={S}, "
        f"M={m}, opt_itrs={itrs}; selections must match exactly: "
        f"{'match' if same else 'DIFFER'} ({len(i_g)} points)")
    check(same, (np.sort(i_g), np.sort(i_o[keep])))
    order_g, order_o = np.argsort(i_g), np.argsort(i_o[keep])
    a, rel = _err(w_g[order_g], w_o[keep][order_o])
    tol = 1e-6
    log(f"[c] golden weights: max abs err {a:.3e}, rel to max|w| {rel:.3e} "
        f"(tolerance {tol:.0e}: float64 on both sides, sums reordered)")
    check(rel <= tol, (a, rel))


# ---------------------------------------------------------------------------
# (d) main path, (f) four cards
# ---------------------------------------------------------------------------

def headline_data():
    import jax
    import jax.numpy as jnp

    from betacores_tpu.data import gen_synthetic_logreg

    k_data, k_test = jax.random.split(jax.random.key(0))
    Xt, yt, _ = gen_synthetic_logreg(k_test, N_TEST, d=D, dtype=jnp.float32)
    return _sync(H.data(k_data)), _sync(Xt), _sync(yt)


def heldout_accuracy(state, Xt, yt) -> float:
    """Accuracy on clean held-out rows of the coreset's Laplace posterior
    (1000 samples, fitted from the build's last mode)."""
    import jax

    from betacores_tpu.inference import logreg_laplace_sampler
    from betacores_tpu.models import logreg

    smp = logreg_laplace_sampler(n_newton=30)
    th, _ = jax.jit(smp, static_argnums=1)(jax.random.key(5), 1000, state.wts,
                                           state.pts, state.sampler_aux)
    return float(logreg.compute_accuracy(Xt, yt, th))


def readme_coreset(Z, **kw):
    """The README flow's coreset object (build(100, 100) runs it)."""
    import betacores_tpu as bc
    from betacores_tpu.inference import logreg_laplace_sampler
    from betacores_tpu.models import logreg

    prj = bc.BetaBlackBoxProjector(logreg_laplace_sampler(), S,
                                   model=logreg.bundle())
    return bc.BetaCoreset(Z, prj, beta=BETA, opt_itrs=H.OPT_ITRS,
                          n_subsample_select=H.N_SEL, n_subsample_opt=H.N_OPT,
                          seed=0, **kw)


def _build(alg):
    """One README build from an empty coreset with the object's first key,
    so every call (and both refinement paths) does the same work."""
    import jax

    from betacores_tpu.utils.prng import KeySequence

    alg.reset()
    alg.keys = KeySequence(0)
    alg.build(M, M)
    jax.block_until_ready(alg.state.wts)
    return alg.state


def _summary(st):
    w = np.asarray(st.wts)
    return int(np.asarray(st.m)), float(w.sum()), np.asarray(st.idcs)[:int(np.asarray(st.m))]


def phase_main(dev):
    import jax

    Z, Xt, yt = headline_data()
    log(f"[d] data: N={N} d={D} contaminated (f_rate=0.1); clean held-out "
        f"rows {N_TEST}")

    alg = readme_coreset(Z)            # default precision (TF32 may apply)
    st_1, t_compile = _timed(lambda: _build(alg))
    st_2, t_build = _timed(lambda: _build(alg))
    peak = dev.memory_stats()["peak_bytes_in_use"]
    m_d, sw_d, i_d = _summary(st_1)
    acc_d = heldout_accuracy(st_1, Xt, yt)
    same = np.array_equal(np.asarray(st_1.idcs), np.asarray(st_2.idcs))
    log(f"[d] README build: first call incl. compile {t_compile:.2f}s; "
        f"second call (same key) {t_build:.3f}s; fill {m_d}/{M} = "
        f"{m_d / M:.2f}; sum(w) {sw_d:.1f}; held-out accuracy {acc_d:.4f}; "
        f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB); second "
        f"call selected the same points: {same}")
    check(m_d >= M // 2 and np.isfinite(sw_d), (m_d, sw_d))

    alg_h = readme_coreset(Z)
    with jax.default_matmul_precision("highest"):
        st_h, t_compile_h = _timed(lambda: _build(alg_h))
    m_h, sw_h, i_h = _summary(st_h)
    acc_h = heldout_accuracy(st_h, Xt, yt)
    overlap = len(set(i_d.tolist()) & set(i_h.tolist()))
    sw_rel = abs(sw_d - sw_h) / abs(sw_h)
    log(f"[d] same build under 'highest' (first call {t_compile_h:.2f}s): "
        f"fill {m_h}/{M} vs {m_d}/{M}; shared points {overlap}; sum(w) "
        f"{sw_h:.1f} vs {sw_d:.1f} (rel diff {sw_rel:.2e}, tolerance 5e-2); "
        f"held-out accuracy {acc_h:.4f} vs {acc_d:.4f} (margin 0.01)")
    log("[d] tolerance reasons: the default run may compute float32 "
        "products in TF32 (10-bit mantissa), 'highest' in IEEE float32; "
        "same key stream, so a near-tied argmax may pick another point and "
        "the trajectories part: fill within 3 points, sum(w) within 5%, "
        "accuracy within one point")
    check(abs(m_h - m_d) <= 3, (m_h, m_d))
    check(sw_rel <= 5e-2, (sw_d, sw_h))
    check(abs(acc_h - acc_d) <= 0.01, (acc_h, acc_d))

    times = {"default": [], "highest": []}
    for name in ("default", "highest", "highest", "default") * 2:
        if name == "default":
            _, dt = _timed(lambda: _build(alg))
        else:
            with jax.default_matmul_precision("highest"):
                _, dt = _timed(lambda: _build(alg_h))
        times[name].append(dt)
    log(f"[d] build times, same key, alternating (s): default "
        f"{['%.3f' % t for t in times['default']]} median "
        f"{np.median(times['default']):.3f}; highest "
        f"{['%.3f' % t for t in times['highest']]} median "
        f"{np.median(times['highest']):.3f}")


def phase_multiclass():
    import jax
    import jax.numpy as jnp

    from betacores_tpu.models import multiclass as mc
    from betacores_tpu.ops.projection import project_beta

    K, n = K_MC, N_MC
    kx, ky, kt = jax.random.split(jax.random.key(3), 3)
    x = jax.random.normal(kx, (n, D), jnp.float32)
    y = jax.random.randint(ky, (n, 1), 0, K).astype(jnp.float32)
    Z = _sync(jnp.concatenate([x, y], axis=1))
    TH = 0.5 * jax.random.normal(kt, (S, K * D), jnp.float32)
    proj = jax.jit(lambda Z, TH: project_beta(mc.bundle(K), Z, TH, jnp.float32(BETA)))
    out = _sync(proj(Z, TH))
    check(out.shape == (n, S) and bool(jnp.isfinite(out).all()), out.shape)
    t_proj = float(np.median([_timed(lambda: proj(Z, TH))[1] for _ in range(10)]))
    big = _sync(jnp.ones((COPY_ELEMS,), jnp.float32))
    copy = jax.jit(lambda a: a + 1.0)
    _sync(copy(big))
    t_copy = float(np.median([_timed(lambda: copy(big))[1] for _ in range(10)]))
    copy_rate = 2 * big.nbytes / t_copy
    need = Z.nbytes + out.nbytes             # read the rows, write (N, S)
    log(f"[e] multiclass beta-projection, plain XLA, N={n} S={S} K={K} "
        f"d={D}: {1e3 * t_proj:.2f} ms (median of 10); large copy "
        f"{copy_rate / 1e9:.1f} GB/s; the projection's own bytes "
        f"({need / 1e6:.0f} MB) at that rate take {1e3 * need / copy_rate:.2f} "
        f"ms, so XLA runs at {need / copy_rate / t_proj:.2f} of the copy rate")


def phase_four_gpus():
    import jax
    import jax.numpy as jnp

    from betacores_tpu.coresets import init_state, make_incremental_builder
    from betacores_tpu.inference import logreg_laplace_sampler
    from betacores_tpu.models import logreg
    from betacores_tpu.parallel import (auto_mesh_shape, make_mesh,
                                        make_sharded_incremental_builder,
                                        shard_data)

    check(len(jax.devices()) == 4, jax.devices())
    Z, Xt, yt = headline_data()
    cfg = H.config()
    model, smp = logreg.bundle(), logreg_laplace_sampler()
    st0 = init_state(H.M_BUF, D, beta=BETA, dtype=jnp.float32)
    key = jax.random.key(2)

    mesh = make_mesh(*auto_mesh_shape(4))
    Zs, n_true = shard_data(Z, mesh)
    sharded = make_sharded_incremental_builder(Zs, n_true, model, smp, cfg, mesh)
    st_s, t_c_s = _timed(lambda: sharded(key, st0, M))
    _, t_b_s = _timed(lambda: sharded(key, st0, M))
    single = make_incremental_builder(Z, model, smp, cfg).build
    st_1, t_c_1 = _timed(lambda: single(key, st0, M))
    _, t_b_1 = _timed(lambda: single(key, st0, M))
    m_s, sw_s, _ = _summary(st_s)
    m_1, sw_1, _ = _summary(st_1)
    acc_s = heldout_accuracy(jax.device_get(st_s), Xt, yt)
    acc_1 = heldout_accuracy(st_1, Xt, yt)
    log(f"[f] sharded build on mesh {dict(mesh.shape)}: first call "
        f"{t_c_s:.2f}s, build {t_b_s:.3f}s, fill {m_s}/{M}, sum(w) {sw_s:.1f}, "
        f"held-out accuracy {acc_s:.4f}")
    log(f"[f] single-card build: first call {t_c_1:.2f}s, build {t_b_1:.3f}s, "
        f"fill {m_1}/{M}, sum(w) {sw_1:.1f}, held-out accuracy {acc_1:.4f}")
    log("[f] tolerance: the mesh draws stratified per-shard subsamples, so "
        "the two builds follow different random streams, and the "
        "reference-parity fill moves between 0.91 and 0.96 with the key on "
        "one card; fill within 0.08 and held-out accuracy within 0.01")
    check(abs(m_s - m_1) / M <= 0.08, (m_s, m_1))
    check(abs(acc_s - acc_1) <= 0.01, (acc_s, acc_1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded build on four cards")
    args = ap.parse_args()

    import jax

    dev = phase_device()
    if args.four_gpus:
        phase_four_gpus()
    else:
        phase_kernels()
        phase_golden()
        phase_main(dev)
        phase_multiclass()
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
