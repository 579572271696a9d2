"""Entry-point contracts.

``dryrun_multichip`` must self-bootstrap an n-device virtual CPU mesh when
a CPU process has fewer devices; ``bench.py`` must print exactly one
parsable JSON line even when the build fails or there is no GPU;
``chip_smoke.py`` must fail without a GPU; and ``import betacores_tpu``
must need nothing beyond JAX, numpy, scipy and optax.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh_env(**extra):
    """Environment for a fresh child that sees exactly ONE cpu device (no
    virtual-mesh XLA flag)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH", "JAX_PLATFORMS",
                        "_BETACORES_DRYRUN_CHILD")}
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    # fresh children don't run conftest: hand them the suite's persistent
    # compilation cache (compile-bound tests; see tests/conftest.py)
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(ROOT, ".cache", "jax_test_compile"))
    env.update(extra)
    return env


def test_dryrun_multichip_self_bootstraps():
    """Fresh process with 1 visible device calling dryrun_multichip(8) must
    re-exec itself onto an 8-device virtual CPU mesh and pass. Smoke mode
    (flagship sharded build + weighted build only): the bootstrap mechanics
    are what this test owns; each subsystem of the full dryrun has its own
    tests in test_parallel.py."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax, __graft_entry__ as g; "
         "assert len(jax.devices()) == 1, jax.devices(); "
         "g.dryrun_multichip(8); print('BOOTSTRAP_OK')"],
        env=_fresh_env(_BETACORES_DRYRUN_SMOKE="1"), cwd=ROOT,
        capture_output=True, text=True, timeout=1800)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BOOTSTRAP_OK" in r.stdout


def test_bench_failure_still_prints_json():
    """bench.py must emit one parsable JSON record even when the run fails.
    Force failure fast: pretend the device check passed, then make the run
    raise."""
    code = (
        "import bench, sys, types\n"
        "bench.require_gpu = lambda: types.SimpleNamespace(platform='gpu', device_kind='x')\n"
        "def boom():\n"
        "    raise RuntimeError('injected failure')\n"
        "bench.run = boom\n"
        "sys.exit(bench.main())\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_fresh_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, r.stdout
    rec = json.loads(lines[0])
    assert rec["metric"] == "bcores_build_n1m_m100_logreg_seconds"
    assert rec["value"] == -1.0 and "injected failure" in rec["error"]


def test_bench_without_gpu_prints_one_failure_line():
    """On a CPU-only process bench.main() measures nothing: it prints one
    JSON failure record that names the missing GPU and exits 1."""
    r = subprocess.run([sys.executable, "-c", "import bench, sys; sys.exit(bench.main())"],
                       env=_fresh_env(), cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 1
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, r.stdout
    rec = json.loads(lines[0])
    assert rec["value"] == -1.0 and "no GPU" in rec["error"], rec
    assert "device" not in rec


def test_chip_smoke_fails_without_gpu():
    """chip_smoke.py on a CPU-only process exits non-zero before any phase
    and never prints its ok line."""
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=_fresh_env(),
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


BLOCKED = ("flax", "orbax", "matplotlib", "pandas", "torch", "sklearn")


def test_import_needs_only_core_packages():
    """import betacores_tpu (and the neural-linear model, whose encoder is
    plain JAX) works with the optional packages blocked from import."""
    code = (
        "import sys\n"
        f"BLOCKED = {BLOCKED!r}\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import betacores_tpu, betacores_tpu.models.neural_linear\n"
        "import betacores_tpu.parallel, betacores_tpu.utils.export\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "print('IMPORT_OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_fresh_env(),
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORT_OK" in r.stdout


def test_peaks_table_refuses_unknown_device():
    """The peaks table is keyed by device kind and has no default: an
    unknown card is an error, the H100 SXM has its data-sheet rates."""
    import pytest

    from betacores_tpu.utils.device import peaks

    h100 = peaks("NVIDIA H100 80GB HBM3")
    assert h100["bf16_flops"] == 989e12 and h100["hbm_bytes_per_s"] == 3.35e12
    assert h100["tf32_flops"] == 495e12 and h100["f32_flops"] == 67e12
    for kind in ("cpu", "Tesla V100-SXM2-16GB", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(KeyError, match="no published peaks"):
            peaks(kind)


def test_require_gpu_refuses_cpu():
    """A measurement path on a CPU-only process raises, naming the device
    it found; it never falls back to measuring the CPU."""
    import pytest

    from betacores_tpu.utils.device import require_gpu

    with pytest.raises(RuntimeError, match="no GPU: JAX's first device is cpu"):
        require_gpu()


def test_dryrun_on_gpu_with_too_few_devices_raises(monkeypatch):
    """dryrun_multichip re-execs onto a virtual CPU mesh only from a CPU
    process; a GPU process with fewer cards than asked for raises instead
    of falling back."""
    import types

    import jax
    import pytest

    sys.path.insert(0, ROOT)
    import __graft_entry__ as g

    fake = [types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")]
    monkeypatch.setattr(jax, "devices", lambda *a: fake)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail("re-exec"))
    with pytest.raises(RuntimeError, match="needs 4 devices, have 1 on platform gpu"):
        g.dryrun_multichip(4)


def test_headline_is_defined_once():
    """bench.py, chip_smoke.py and examples/trace_build.py read the headline
    build from one module: the reference's hyperparameters, overrides that
    replace single fields, and float32 contaminated rows of width d."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from betacores_tpu import headline as H

    cfg = H.config()
    assert (cfg.projection_dim, cfg.n_subsample_select, cfg.n_subsample_opt,
            cfg.opt_itrs) == (H.S, H.N_SEL, H.N_OPT, H.OPT_ITRS) == (100, 1000, 200, 500)
    assert cfg.use_beta and cfg.i0 == 1.0 and not cfg.dedup_select
    full = H.config(n_subsample_select=None, dedup_select=True)
    assert full.n_subsample_select is None and full.dedup_select
    assert full.opt_itrs == cfg.opt_itrs and full.n_subsample_opt == cfg.n_subsample_opt
    Z = H.data(jax.random.key(0), n=2000)
    assert Z.shape == (2000, H.D) and Z.dtype == jnp.float32
    np.testing.assert_array_equal(Z, H.data(jax.random.key(0), n=2000))
    for script in ("bench.py", "chip_smoke.py", os.path.join("examples", "trace_build.py")):
        with open(os.path.join(ROOT, script)) as fh:
            src = fh.read()
        assert "from betacores_tpu import headline as H" in src, script
        assert "1_000_000" not in src, script
