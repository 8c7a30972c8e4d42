"""The pieces around the engines: timer, peak table, compile-cache placement,
``backend=`` validation, and chip_smoke.py's checks and device gate."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import blocksparse as bst
from blocksparse.utils.compile_cache import CACHE_DIRNAME, use_checkout_cache
from blocksparse.utils.testmatrices import random_block_sparse
from blocksparse.utils.timing import time_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


# -- timer ----------------------------------------------------------------------


def test_time_fn_stats():
    f = jax.jit(lambda v: v * 2.0)
    t = time_fn(f, jnp.ones(8), warmup=1, samples=7)
    assert t["n"] == 7
    assert 0 < t["min"] <= t["p10"] <= t["median"] <= t["p90"] <= t["max"]


def test_time_fn_keeps_short_samples():
    """No floor: every sample counts, however short."""
    t = time_fn(lambda: 1.0, warmup=0, samples=5)
    assert t["n"] == 5 and t["median"] < 1e-3


def test_time_fn_waits_for_result():
    calls = []

    def f():
        calls.append(1)
        return jnp.zeros(4)

    time_fn(f, warmup=2, samples=3)
    assert len(calls) == 5
    with pytest.raises(ValueError, match="samples"):
        time_fn(f, samples=0)


# -- peak table -----------------------------------------------------------------


def test_peak_table_has_h200():
    p = bench.peaks("NVIDIA H200")
    assert p["hbm_bytes_per_s"] == 4.8e12
    assert p["f32_flops_per_s"] == 67e12
    assert p["tf32_flops_per_s"] == 495e12
    assert p["bf16_flops_per_s"] == 989e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 80GB HBM3", ""])
def test_peak_table_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks(kind)


# -- compile cache --------------------------------------------------------------


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_env_is_honoured(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert use_checkout_cache(tmp_path) == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_fixed_path_in_checkout(monkeypatch, tmp_path,
                                         cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = use_checkout_cache(tmp_path)
    assert CACHE_DIRNAME == ".jax_cache"
    assert path == str(tmp_path / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


# -- backend= -------------------------------------------------------------------


def _small(**kw):
    blocks, rows, cols, shape = random_block_sparse(
        3, shape=(60, 50), nblocks=6, max_block=12, dtype=np.float32)
    return bst.BlockSparseMatrix(blocks, rows, cols, shape, **kw)


@pytest.mark.parametrize("bad", ["cuda", "mosaic", "Pallas", ""])
def test_backend_validation_names_choices(bad):
    with pytest.raises(ValueError, match="auto, xla"):
        _small(backend=bad)


@pytest.mark.parametrize("backend", ["pallas", "pallas-interpret"])
def test_pallas_backend_never_falls_back(backend):
    """The removed kernel's backends raise in every format; they never
    fall back to another engine."""
    from blocksparse.utils.testmatrices import random_symmetric

    with pytest.raises(ValueError, match="auto, xla"):
        _small(backend=backend)
    d, di, o, ri, ci, shape = random_symmetric(2, n=60, ngroups=4,
                                               noffdiag=3)
    with pytest.raises(ValueError, match="auto, xla"):
        bst.SymmetricBlockMatrix(d, di, o, ri, ci, shape, backend=backend)
    with pytest.raises(ValueError, match="auto, xla"):
        bst.VariableBlockCompressedRowStorage(
            [np.ones((2, 2))], [0], [0], (4, 4), backend=backend)
    for b in ("auto", "xla"):
        assert _small(backend=b)._backend == b


# -- chip_smoke.py --------------------------------------------------------------


def test_smoke_check_flags_wrong_result():
    ref = np.arange(1.0, 7.0)
    assert chip_smoke.check("same", ref + 1e-9, ref, 1e-5) < 1e-5
    with pytest.raises(chip_smoke.SmokeFailure, match="rel err"):
        chip_smoke.check("off", ref * (1 + 1e-3), ref, 1e-5)


@pytest.mark.parametrize("y", [np.ones(5), np.array([1.0, np.nan, 1, 1, 1,
                                                     1])])
def test_smoke_rel_err_rejects_shape_and_nonfinite(y):
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.rel_err(y, np.ones(6))


def test_smoke_near_field_and_oracle(tmp_path):
    """Tiny run of the smoke's builders: leaves are sorted, non-contiguous
    id lists; (b) is the leaf-sorted (contiguous) copy of (c); the split
    oracle product matches scipy's."""
    ops, _ = chip_smoke.build_operators(600, 32, 6, seed=1)
    a, b, c = ops["a"], ops["b"], ops["c"]
    assert a.shape == b.shape == c.shape == (600, 600)
    lists = [c.blockrowindices(i) for i in range(c.nblocks)]
    assert all(np.all(np.diff(r) > 0) for r in lists)
    assert any(r[-1] - r[0] + 1 != len(r) for r in lists)
    assert all(b.blockrowindices(i)[-1] - b.blockrowindices(i)[0] + 1
               == len(b.blockrowindices(i)) for i in range(b.nblocks))
    Sc, Sb = chip_smoke.oracle_of(c), chip_smoke.oracle_of(b)
    assert Sc.nnz == Sb.nnz and np.isclose(abs(Sc).sum(), abs(Sb).sum())
    Sa = chip_smoke.oracle_of(a)
    assert abs(Sa - Sa.T).max() == 0          # complex symmetric
    X = np.random.default_rng(0).standard_normal((600, 20))
    assert np.allclose(chip_smoke.oracle_mm(Sc, X), Sc @ X)
    y = np.asarray(c @ X.astype(np.float32))
    assert chip_smoke.rel_err(y, Sc @ X) < chip_smoke.TOL32


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _ok_line(stdout):
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]).get("ok") is True
    except (IndexError, ValueError, AttributeError):
        return False


def test_smoke_refuses_cpu():
    p = _run_smoke(ROOT)
    assert p.returncode != 0
    assert not _ok_line(p.stdout)
    assert "needs a GPU" in p.stderr


def test_smoke_fails_without_the_library(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run_smoke(tmp_path, {"PYTHONPATH": ""})
    assert p.returncode != 0
    assert not _ok_line(p.stdout)
