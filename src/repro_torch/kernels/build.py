"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into its own shared library, loaded with ``ctypes``. Nothing is
built when a module is imported: :func:`load` builds a library at its first
use, and :func:`build_all` starts one ``nvcc`` per source at once (what
``chip_smoke.py`` calls up front). Libraries go to ``build/repro_torch`` at
the repository root (listed in ``.gitignore``), or to
``$REPRO_TORCH_BUILD_DIR``; a library older than its source or than a
shared header in ``csrc`` (``*.cuh``) is rebuilt.
No fast-math flag is passed: the kernels' quantization must round exactly
like the reference's.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "build_dir", "build_all", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {
    "fused_qmatmul": "fused_qmatmul.cu",
    "paged_attention": "paged_attention.cu",
    "dynamic_quant": "dynamic_quant.cu",
    "quant_matmul": "quant_matmul.cu",
    "ocs_matmul": "ocs_matmul.cu",
    "w4a8_qmatmul": "w4a8_qmatmul.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the repro_torch CUDA "
        "kernels are built from source on the machine with the card"
    )


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / SOURCES[name], *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: all stale ones), one ``nvcc``
    process per source, all started together. Returns each source's
    compiler log (``-Xptxas -v``: registers, shared memory, spills); raises
    with the log if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(_lib_path(n)), str(CSRC / SOURCES[n])]
        procs[n] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
    logs, failed = {}, []
    for n, p in procs.items():
        logs[n] = p.communicate()[0]
        (out / f"{n}.log").write_text(logs[n])
        if p.returncode != 0:
            failed.append(n)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
