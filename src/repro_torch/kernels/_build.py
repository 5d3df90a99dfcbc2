"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``.cu`` source in this package has a plain C interface (no PyTorch
headers) and exports ``error_string`` for the CUDA error codes its entry
points return, so one ``nvcc`` call per source takes seconds.  Sources are
compiled at first use for ``sm_90a`` under a name that carries a digest of
the source, the package's shared headers (``*.cuh`` here, found through
``-I``) and the flags, so an edited source or header is never served a
stale library.  The libraries go to ``$REPRO_TORCH_BUILD_DIR`` when it is
set, else to ``build/torch_ext/`` at the root of the checkout the package
runs from, else (an installed package) to ``repro_torch/torch_ext`` in
the user's cache directory (``$XDG_CACHE_HOME``, by default
``~/.cache``).  A build that fails raises :class:`KernelBuildError` with
the compiler's output; nothing falls back to another implementation.

:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them, so a fresh checkout pays the longest build, not the sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent


def _build_dir() -> Path:
    explicit = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if explicit:
        return Path(explicit)
    checkout = _PKG.parents[2]                  # <checkout>/src/repro_torch
    if _PKG.parents[1].name == "src" \
            and (checkout / "pyproject.toml").is_file():
        return checkout / "build" / "torch_ext"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch" / "torch_ext"


BUILD_DIR = _build_dir()

SOURCES = {
    "hop_dist": _PKG / "hop_dist" / "hop_dist.cu",
    "swap_gain": _PKG / "swap_gain" / "swap_select.cu",
    "flash_attention": _PKG / "flash_attention" / "flash_attention.cu",
    "flash_attention_bwd": _PKG / "flash_attention" / "flash_attention_bwd.cu",
    "rmsnorm": _PKG / "rmsnorm" / "rmsnorm.cu",
    "ssd_scan": _PKG / "ssd_scan" / "ssd_scan.cu",
    "ssd_scan_bwd": _PKG / "ssd_scan" / "ssd_scan_bwd.cu",
}

# --split-compile=0 optimises a source's kernels in parallel on every
# core (flash_attention_bwd.cu's 32 kernels: 50 s alone, 21 s with it, on
# an 8-core host)
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "--split-compile=0", "-Xptxas", "-v")

# where the sources find the headers they share (sm_count.cuh)
INCLUDE_FLAGS = ("-I", str(_PKG))

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas resource report (registers, shared memory, spills) per source
BUILD_LOGS: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built on the machine with the "
            "GPU")
    return found


def _so_path(name: str) -> Path:
    src = SOURCES[name]
    headers = b"".join(h.read_bytes() for h in sorted(_PKG.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """(process, tmp output, final output), or None when already built."""
    out = _so_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *INCLUDE_FLAGS, "-o", str(tmp),
           str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {SOURCES[name]} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, Path]:
    """Compile every source that has no current library, all at once."""
    with _LOCK:
        started = {name: _start(name) for name in SOURCES}
        errors = []
        for name, st in started.items():
            if st is None:
                continue
            try:
                _finish(name, st)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))
    return {name: _so_path(name) for name in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            st = _start(name)
            if st is not None:
                _finish(name, st)
            lib = ctypes.CDLL(str(_so_path(name)))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib
