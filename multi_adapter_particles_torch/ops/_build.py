"""Build and load the hand-written CUDA kernels (`csrc/*.cu`) and the
native host init (`native/fastinit.cpp`).

Each CUDA source compiles on its own with `nvcc` into a shared library
with a plain C interface, loaded with `ctypes` (no PyTorch headers, so a
build takes seconds, not minutes); the host source compiles with `g++`
the same way. Libraries land in the build directory, by default
`build/torch_kernels/` at the repository root (ignored by git through
`build/`), named by a hash of the source and the compile flags: an edited
source rebuilds, an unchanged one loads the library already built. Builds
happen at first use — never when a module is imported — so `python3
chip_smoke.py` on a fresh checkout builds everything itself. The CLI's
`-compilecache` picks the directory (`set_build_dir`).

C entry points take device pointers (`tensor.data_ptr()`) and the stream
(`torch.cuda.current_stream().cuda_stream`) as `c_void_p`, and return
`cudaGetLastError()` after the launch; `check` raises when it is not 0.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
DEFAULT_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
                     / "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# The JAX package's native/Makefile flags. -ffp-contract=off keeps every
# float32 rounding the NumPy oracle's: FMA contraction changes last bits.
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-ffp-contract=off", "-shared",
              "-pthread")

_build_dir = DEFAULT_BUILD_DIR


def build_dir() -> Path:
    """Where libraries are built and loaded from."""
    return _build_dir


def set_build_dir(spec: str) -> Path:
    """`-compilecache`: "auto" = `build/torch_kernels/` (the default),
    "off" = a fresh temporary directory for this process (removed at
    exit), else that directory (created if need be). Libraries already
    loaded stay loaded. Raises when the directory cannot be made."""
    global _build_dir
    if spec == "auto":
        path = DEFAULT_BUILD_DIR
    elif spec == "off":
        path = Path(tempfile.mkdtemp(prefix="map-torch-kernels-"))
        atexit.register(shutil.rmtree, path, True)
    else:
        path = Path(spec).expanduser()
        path.mkdir(parents=True, exist_ok=True)
    _build_dir = path
    return path


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under $CUDA_HOME (default
    /usr/local/cuda). Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "multi_adapter_particles_torch build on a machine with the CUDA "
        "toolkit"
    )


def gxx_path() -> str:
    """The host C++ compiler (g++ on PATH). Raises when there is none."""
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH: the native host init of "
                       "multi_adapter_particles_torch builds with g++")


def _compile(source: Path, compiler: Callable[[], str],
             flags: Sequence[str]) -> Path:
    """The library of `source` built with `flags`, compiled unless one of
    that source and those flags exists. Raises with the compiler's output
    when it fails."""
    h = hashlib.sha256(source.read_bytes())
    h.update("\0".join(flags).encode())
    out = _build_dir / f"{source.stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [compiler(), *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed for {source.name} "
            f"({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}"
            f"{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build(name: str, extra_flags: Sequence[str] = ()) -> Path:
    """Compile `csrc/<name>.cu` unless its library (named by a hash of the
    source and the flags) already exists."""
    return _compile(CSRC_DIR / f"{name}.cu", nvcc_path,
                    NVCC_FLAGS + tuple(extra_flags))


def build_host(source: Path) -> Path:
    """Compile the host C++ `source` with g++ and `HOST_FLAGS` unless its
    library already exists."""
    return _compile(source, gxx_path, HOST_FLAGS)


@functools.cache
def load(name: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`'s library, once per
    process."""
    return ctypes.CDLL(str(build(name, extra_flags)))


def check_arg(t, dtype, shape, device, what: str,
              contiguous: bool = True) -> None:
    """Raise unless tensor `t` is what a kernel takes: on `device`, of
    `dtype` and `shape`, and contiguous unless told otherwise."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {list(shape)}, got "
                         f"{list(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def check(rc: int, what: str) -> None:
    """Raise on a nonzero `cudaError_t` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
