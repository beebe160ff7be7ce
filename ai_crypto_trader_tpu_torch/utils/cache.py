"""Persistent kernel-build cache of the CLI's card commands.

Port of `ai_crypto_trader_tpu/utils/cache.py`: where the JAX CLI switches
on XLA's persistent compilation cache, the port's card commands build and
load their nvcc libraries in ``<dir>/<provenance key>`` (the key of
`utils.aotcache.provenance_key`; ``dir`` defaults to ``.torch_kernels/`` at
the root of the checkout), so every command run by the same torch, CUDA,
card and flags finds the libraries the first one built, and none built by
another toolchain or for another card is loaded.
"""

from __future__ import annotations

from pathlib import Path


def enable_compilation_cache(cache_dir: str | None = None) -> bool:
    """Point the kernel build at the provenance-keyed directory; True when
    active.  A library this process loaded already stays loaded from where
    it was."""
    from ai_crypto_trader_tpu_torch.ops import _cuda
    from ai_crypto_trader_tpu_torch.utils.aotcache import provenance_key

    try:
        key = provenance_key()
    except Exception:                     # noqa: BLE001 — best effort
        return False
    _cuda.set_build_dir(Path(cache_dir or _cuda.DEFAULT_BUILD_DIR) / key)
    return True
