"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` (Hopper)
into a shared library with a plain C interface, loaded with ``ctypes``.
Libraries are named by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one is reused. They land in
``$REPRO_TORCH_BUILD_DIR`` when it is set; else, when the package runs from
a source checkout (``src/repro_torch``), in the checkout's
``build/repro_torch_kernels/``; else (an installed package) in
``repro_torch_kernels/`` of the user's cache directory. ``build_all()`` starts one ``nvcc`` per source,
all at once; ``load(name)`` builds on first use. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points per source, with their argument types (pointers and the
# stream as c_void_p: a plain int would be cut to 32 bits). All return int.
SIGNATURES = {
    "hier_aggregate": {
        "hier_grouped_mean": (_P, _P, _P, _I, _I, _I, _I, _P),
        "hier_segment_mean": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        "hier_segment_dequant_mean": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "quantize": {
        "quant_quantize": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
        "quant_dequantize": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
}
SOURCES = tuple(SIGNATURES)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME or /usr/local/cuda); "
            "the CUDA kernels build only where the CUDA toolkit is installed"
        )
    return found


def build_dir() -> Path:
    """Where the libraries go (see the module docstring)."""
    if os.environ.get("REPRO_TORCH_BUILD_DIR"):
        return Path(os.environ["REPRO_TORCH_BUILD_DIR"])
    package = CSRC.parents[1]
    checkout = package.parents[1]
    if package.parent.name == "src" and (checkout / "pyproject.toml").exists():
        return checkout / "build" / "repro_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch_kernels"


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns {name: library path}; the
    compiler's output (``-Xptxas -v``: registers, spills) is kept beside
    each library as ``<library>.log``. Raises if any build fails."""
    paths = {name: library_path(name) for name in names}
    for path in paths.values():
        path.parent.mkdir(parents=True, exist_ok=True)
    jobs: List = []
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in jobs:
        log, _ = proc.communicate()
        path.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def raise_on_error(err: int, what: str) -> None:
    """Raise for the cudaError_t a kernel's C entry point returned."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with cudaError {err}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
