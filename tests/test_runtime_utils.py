"""Runtime plumbing: the compile-cache helper, platform selection and the
device check, the runners' platform default, the device peak table, and
the native map-ops library loader."""
import numpy as np
import pytest

import jax

from orbslam2_tpu import native
from orbslam2_tpu import utils as U


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_environment(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    jax.config.update("jax_compilation_cache_dir", "/elsewhere/cache")
    assert U.setup_compile_cache() == "/elsewhere/cache"
    # the helper sets nothing: JAX keeps what the environment gave it
    assert jax.config.jax_compilation_cache_dir == "/elsewhere/cache"


def test_cache_dir_default_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    got = U.setup_compile_cache()
    assert got == str(U.REPO_ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert (U.REPO_ROOT / "chip_smoke.py").exists()   # REPO_ROOT is the root


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="GPU is required"):
        U.require_gpu()


def test_require_gpu_reports_device():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"
    assert U.require_gpu([Dev(), Dev(), Dev(), Dev()]) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}


def test_require_gpu_when_jax_finds_no_backend(monkeypatch):
    def broken():
        raise AssertionError("no backend")
    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError, match="no accelerator"):
        U.require_gpu()


def test_select_platform_rejects_unknown():
    with pytest.raises(ValueError, match="--platform"):
        U.select_platform("rocm")


def test_device_peaks_unknown_device_is_an_error():
    assert U.device_peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        U.device_peaks("Some Other Card")


class _Chosen(Exception):
    pass


@pytest.mark.parametrize("runner,argv,expected", [
    ("run_synth", [], "gpu"),
    ("run_synth", ["3", "--platform", "cpu"], "cpu"),
    ("run_dataset", ["mono_tum", "s.yaml", "seq"], "gpu"),
    ("run_dataset", ["mono_tum", "s.yaml", "seq", "--platform", "cpu"], "cpu"),
], ids=["synth-default", "synth-cpu", "dataset-default", "dataset-cpu"])
def test_runner_platform(monkeypatch, runner, argv, expected):
    """The runners default to the GPU; --platform cpu is the opt-in."""
    import importlib
    chosen = []

    def record(platform):
        chosen.append(platform)
        raise _Chosen
    monkeypatch.setattr(U, "select_platform", record)
    mod = importlib.import_module(f"orbslam2_tpu.{runner}")
    with pytest.raises(_Chosen):
        mod.main(argv)
    assert chosen == [expected]


# ------------------------------------------------------------------ native
def test_native_library_path_keyed_by_source_and_machine(monkeypatch):
    p = native.library_path()
    assert p.parent == native._BUILD and p.name.startswith("libmapops-")
    assert native.library_path() == p          # deterministic
    monkeypatch.setattr(native.platform, "machine", lambda: "other-arch")
    assert native.library_path() != p


def test_native_fallback_reported_once(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)

    def no_compiler(*a, **kw):
        raise FileNotFoundError("g++")
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert not native.available()
    assert native.covis_matrix(np.zeros((2, 3), np.int32),
                               np.ones((2, 3), bool), 4) is None
    err = capsys.readouterr().err
    assert err.count("numpy fallback") == 1


def test_native_library_builds_and_matches_numpy(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available(), "g++ build of mapops.cpp failed"
    assert native.library_path().exists()
    rng = np.random.default_rng(0)
    K, N, P = 6, 40, 50
    kf_pt = np.stack([rng.choice(P, N, replace=False) for _ in range(K)]
                     ).astype(np.int32)
    kf_pt[rng.random((K, N)) < 0.2] = -1          # unbound slots
    kf_valid = np.array([True, True, False, True, True, True])
    got = native.covis_matrix(kf_pt, kf_valid, P)
    sets = [set(r[r >= 0]) if v else set() for r, v in zip(kf_pt, kf_valid)]
    want = np.array([[len(sets[i] & sets[j]) if i != j else 0
                      for j in range(K)] for i in range(K)])
    np.testing.assert_array_equal(got, want)
