"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by nvcc into its own shared
library with a plain C interface, ``.torch_kernels/<name>-<hash>.so`` at the
root of the checkout (listed in ``.gitignore``), and loaded with ctypes.
Nothing is built or loaded when a module is imported: a library is built at
its first use, or by ``build()`` for all of them at once (one nvcc process
per source, all started together).  The hash covers the source and the
flags, so an edited source is rebuilt.  `set_build_dir` points later builds
and loads at another directory (the persistent cache of `utils.aotcache`);
a library already loaded stays loaded from where it was.

``--fmad=false`` keeps nvcc from contracting ``a*b + c`` into a fused
multiply-add: the plain PyTorch versions round the product and the sum
separately, and a one-ulp shift in a P&L percentage can flip a stop-loss
comparison and change a whole trade path.  ``--use_fast_math`` is never
used, for the same reason.

Every C entry returns ``cudaGetLastError()`` after its launches; ``check``
raises on anything but 0.  Kernels run on the caller's current stream,
allocate nothing and do not synchronise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / ".torch_kernels"
DEFAULT_BUILD_DIR = BUILD_DIR
SOURCES = ("fused_ewma", "replay_sweep")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}

# Called as ``listener(name, seconds, cached)`` for every library that
# `build` finds built (cached, 0 s) or compiles: the build monitor of
# `utils.tracing` (KernelBuildMonitor) registers here.
BUILD_LISTENERS: list = []


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from csrc/ at first use")


def set_build_dir(path) -> Path:
    """Build and load later libraries in ``path``; returns the directory
    used until now."""
    global BUILD_DIR
    prev, BUILD_DIR = BUILD_DIR, Path(path)
    return prev


def loaded() -> list:
    """The names of the libraries this process has loaded."""
    return sorted(_LIBS)


def library_path(name: str) -> Path:
    src = (SOURCE_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all running at once.  Returns ``{name: {"seconds",
    "cached"}}``.  Raises ``RuntimeError`` with nvcc's output when a build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, running = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            report[name] = {"seconds": 0.0, "cached": True}
            for listener in BUILD_LISTENERS:
                listener(name, 0.0, True)
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(SOURCE_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path, time.perf_counter())
    failures = []
    for name, (proc, tmp, path, t0) in running.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, path)
        report[name] = {"seconds": seconds, "cached": False}
        for listener in BUILD_LISTENERS:
            listener(name, seconds, False)
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with
    ``signatures`` ({symbol: (restype, [argtypes])}) declared on it."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for symbol, (restype, argtypes) in signatures.items():
            fn = getattr(lib, symbol)
            fn.restype = restype
            fn.argtypes = argtypes
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and ``torch.cuda.synchronize()`` would not report it)."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {rc} ({msg})")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
