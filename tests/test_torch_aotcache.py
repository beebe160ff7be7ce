"""The port's persistent kernel-build cache (`utils.aotcache`,
`utils.cache`) against the JAX package's, on the CPU.

`prune_dir` removes the same files as the JAX helper from one tree.  The
provenance key is stable and changes with each of its coordinates (torch,
CUDA, card, nvcc flags).  There is no nvcc here, so the warm/cold story
runs on an injected build that writes the libraries where `ops._cuda`
would: a cold enable builds both, a warm one finds both (``cache_hits``
2, nothing built), a second process shares the directory, and a failed
build leaves the kernels to build in the default directory, recorded.
"""

import os

import pytest

pytest.importorskip("jax")

from ai_crypto_trader_tpu.utils import aotcache as jaotcache  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import _cuda  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import aotcache as taotcache  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import cache as tcache  # noqa: E402

# (name, bytes, mtime)
TREE = [("a.so", 300, 100.0), ("b.so", 200, 50.0), ("c.so", 500, 300.0),
        ("d.so", 100, 10.0), (".writer.pid", 10, 1.0), ("meta.json", 20, 2.0)]


def _tree(root):
    root.mkdir()
    for name, size, mtime in TREE:
        path = root / name
        path.write_bytes(b"x" * size)
        os.utime(path, (mtime, mtime))
    (root / "sub").mkdir()
    return root


@pytest.mark.parametrize("max_bytes", [10_000, 1_100, 800, 450, 0])
def test_prune_dir_removes_what_jax_removes(tmp_path, max_bytes):
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert taotcache.prune_dir(str(port), max_bytes) == jaotcache.prune_dir(str(ref), max_bytes)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    assert {".writer.pid", "meta.json", "sub"} <= set(os.listdir(port))


BASE = {"torch_version": "2.9.0", "cuda_version": "12.8",
        "device_kind": "NVIDIA H100 80GB HBM3", "backend": "cuda"}


@pytest.mark.parametrize("field", ["torch_version", "cuda_version", "device_kind"])
def test_provenance_key_is_stable_and_moves_with_each_field(field):
    key = taotcache.provenance_key(BASE)
    assert key == taotcache.provenance_key(dict(BASE)) and len(key) == 16
    assert taotcache.provenance_key({**BASE, field: "other"}) != key


def test_provenance_key_moves_with_the_nvcc_flags(monkeypatch):
    key = taotcache.provenance_key(BASE)
    monkeypatch.setattr(_cuda, "NVCC_FLAGS", _cuda.NVCC_FLAGS + ("-lineinfo",))
    assert taotcache.provenance_key(BASE) != key


def test_provenance_key_reads_the_running_process():
    import torch

    coords = taotcache.build_coordinates({})
    assert coords["torch_version"] == torch.__version__
    assert coords["cuda_version"] == torch.version.cuda
    assert coords["device_kind"] == "cpu"                 # no card on this host
    assert taotcache.provenance_key({}) == taotcache.provenance_key(
        {"torch_version": torch.__version__, "device_kind": "cpu"})


def _stub_build(calls):
    """`ops._cuda.build` without nvcc: writes each missing library where
    `library_path` puts it (the directory the cache points at)."""
    def build(names):
        calls.append(str(_cuda.BUILD_DIR))
        report = {}
        for name in names:
            path = _cuda.library_path(name)
            cached = path.exists()
            if not cached:
                path.write_bytes(b"\x7fELF" + name.encode())
            report[name] = {"seconds": 0.0 if cached else 1.0, "cached": cached}
        return report
    return build


@pytest.fixture
def default_dir():
    yield
    assert _cuda.BUILD_DIR == _cuda.DEFAULT_BUILD_DIR      # every test restored it


def test_cold_then_warm_from_an_injected_build(tmp_path, default_dir):
    calls = []
    cold = taotcache.AOTCache(str(tmp_path), build=_stub_build(calls))
    assert cold.enable(BASE)
    st = cold.status()
    assert st["enabled"] and not st["warm"] and st["lock"] == "held"
    assert st["built"] == sorted(_cuda.SOURCES) and st["cache_hits"] == 0
    assert st["entries"] == len(_cuda.SOURCES) and st["error"] is None
    assert calls == [st["dir"]] and st["dir"].endswith(taotcache.provenance_key(BASE))
    cold.close()
    warm = taotcache.AOTCache(str(tmp_path), build=_stub_build(calls))
    assert warm.enable(BASE)
    st = warm.status()
    assert st["warm"] and st["built"] == [] and st["cache_hits"] == len(_cuda.SOURCES)
    assert st["entries_at_enable"] == len(_cuda.SOURCES)
    warm.close()


def test_second_process_shares_the_directory(tmp_path, default_dir):
    first = taotcache.AOTCache(str(tmp_path), build=_stub_build([]))
    second = taotcache.AOTCache(str(tmp_path), build=_stub_build([]))
    assert first.enable(BASE)
    try:
        assert second.enable(BASE)                 # the lock is held: shared, no prune
        assert second.status()["lock"] == "shared" and second.status()["warm"]
        second.close()
    finally:
        first.close()


def test_a_failed_build_falls_back_to_the_default_directory(tmp_path, default_dir):
    def broken(names):
        raise RuntimeError("nvcc failed for fused_ewma.cu (exit 1)")

    cache = taotcache.AOTCache(str(tmp_path), build=broken)
    assert not cache.enable(BASE)
    st = cache.status()
    assert not st["enabled"] and st["dir"] is None and "nvcc failed" in st["error"]
    assert _cuda.BUILD_DIR == _cuda.DEFAULT_BUILD_DIR
    cache.close()


def test_an_unwritable_root_is_recorded(tmp_path, default_dir):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    cache = taotcache.AOTCache(str(blocker), build=_stub_build([]))
    assert not cache.enable(BASE)
    assert cache.status()["error"] and not cache.status()["enabled"]


def test_no_prebuild_on_a_cpu_system_and_loaded_libraries_named(tmp_path, monkeypatch,
                                                                   default_dir):
    calls = []
    monkeypatch.setitem(_cuda._LIBS, "fused_ewma", object())
    cache = taotcache.AOTCache(str(tmp_path), build=_stub_build(calls))
    assert cache.enable({**BASE, "backend": "cpu"})
    assert calls == [] and cache.status()["loaded_before"] == ["fused_ewma"]
    cache.close()
    # a CUDA system builds only what this process has not loaded
    cache = taotcache.AOTCache(str(tmp_path / "cuda"), build=_stub_build(calls))
    assert cache.enable(BASE)
    assert cache.status()["built"] == ["replay_sweep"]
    cache.close()


def test_cli_cache_points_the_build_at_the_keyed_dir(tmp_path, default_dir):
    """The CLI's cache is one call: later builds and loads go to
    ``<dir>/<provenance key>``; nothing is built or written by it."""
    try:
        assert tcache.enable_compilation_cache(str(tmp_path)) is True
        assert _cuda.BUILD_DIR == tmp_path / taotcache.provenance_key()
        assert tcache.enable_compilation_cache(str(tmp_path)) is True   # idempotent
        assert _cuda.BUILD_DIR == tmp_path / taotcache.provenance_key()
        assert os.listdir(tmp_path) == []
    finally:
        _cuda.set_build_dir(_cuda.DEFAULT_BUILD_DIR)
