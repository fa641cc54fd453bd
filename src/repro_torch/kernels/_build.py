"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` (Hopper)
into a shared library with a plain C interface, loaded with ``ctypes``.
Libraries are named by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one is reused. They land in
``$REPRO_TORCH_BUILD_DIR`` when it is set; else, when the package runs from
a source checkout (``src/repro_torch``), in the checkout's
``build/repro_torch_kernels/``; else (an installed package) in
``repro_torch_kernels/`` of the user's cache directory. ``build_all()`` starts one ``nvcc`` per source,
all at once; ``load(name)`` builds on first use. A file lock in the build
directory serialises builds across processes, so ranks that share one
directory (``dist.launch.spawn``, ``torchrun``) run ``nvcc`` on a source
once and load what the first built. Nothing here runs at import time.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points per source, with their argument types (pointers and the
# stream as c_void_p: a plain int would be cut to 32 bits).
SIGNATURES = {
    "hier_aggregate": {
        "hier_grouped_mean": (_P,) * 4 + (_I,) * 10 + (_P,),
        "hier_segment_mean": (_P,) * 5 + (_I,) * 11 + (_P,),
        "hier_segment_dequant_mean": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "hier_error_name": (_I,),
        "hier_error_string": (_I,),
    },
    "quantize": {
        "quant_quantize": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
        "quant_dequantize": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "megakernel": {
        "mk_edge_interval": (_P,) * 12 + (_I,) * 6 + (_F, _F, _F, _I, _P),
        "mk_edge_interval_smem": (_I,) * 5,
        "mk_edge_interval_uses_tma": (_P, _P) + (_I,) * 6 + (_F, _I),
    },
    "flash_attention": {
        "fa_forward": (_P,) * 4 + (_I,) * 6 + (_F, _I, _I, _I, _P),
    },
    "rglru_scan": {
        "rg_scan": (_P,) * 6 + (_I,) * 4 + (_P,),
        "rg_scan_header_bytes": (_I,) * 4,
        "rg_scan_aggregate_bytes": (_I,) * 3,
    },
}
RESTYPES = {  # every other entry point returns int
    "hier_error_name": ctypes.c_char_p,
    "hier_error_string": ctypes.c_char_p,
    "mk_edge_interval_smem": ctypes.c_longlong,
    "rg_scan_header_bytes": ctypes.c_longlong,
    "rg_scan_aggregate_bytes": ctypes.c_longlong,
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
    if all(path.exists() for path in paths.values()):
        return paths
    with _file_lock(build_dir() / ".build.lock"):
        return _build_missing(paths)


@contextlib.contextmanager
def _file_lock(path: Path):
    """An exclusive ``flock`` on ``path`` for the block (across processes)."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build_missing(paths: Dict[str, Path]) -> Dict[str, Path]:
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


def error_text(err: int) -> str:
    """The CUDA runtime's name and description of a cudaError_t, e.g.
    ``cudaErrorInvalidValue (1): invalid argument`` (every library links the
    same runtime; ``hier_aggregate`` exports the lookup)."""
    lib = load("hier_aggregate")
    return f"{lib.hier_error_name(err).decode()} ({err}): {lib.hier_error_string(err).decode()}"


def raise_on_error(err: int, what: str, given: str = "") -> None:
    """Raise for the cudaError_t a kernel's C entry point returned, naming
    the error, the kernel and what it was given (``given``: its shapes)."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with {error_text(err)}" + (f"; given {given}" if given else ""))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
            _libs[name] = lib
        return lib
