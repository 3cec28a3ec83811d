"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles on its own with `nvcc` into a shared library with a
plain C interface, loaded with `ctypes` (no PyTorch headers, so a build
takes seconds, not minutes). Libraries land in `build/torch_kernels/` at
the repository root (ignored by git through `build/`), named by a hash of
the source and the compile flags: an edited source rebuilds, an unchanged
one loads the library already built. Builds happen at first use — never
when a module is imported — so `python3 chip_smoke.py` on a fresh checkout
builds everything itself.

C entry points take device pointers (`tensor.data_ptr()`) and the stream
(`torch.cuda.current_stream().cuda_stream`) as `c_void_p`, and return
`cudaGetLastError()` after the launch; `check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


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


def build(name: str, extra_flags: Sequence[str] = ()) -> Path:
    """Compile `csrc/<name>.cu` unless its library (named by a hash of the
    source and the flags) already exists."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    h.update("\0".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags,
           "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def load(name: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`'s library, once per
    process."""
    return ctypes.CDLL(str(build(name, extra_flags)))


def check_arg(t, dtype, shape, device, what: str) -> None:
    """Raise unless tensor `t` is what a kernel takes: on `device`, of
    `dtype` and `shape`, contiguous."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {list(shape)}, got "
                         f"{list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def check(rc: int, what: str) -> None:
    """Raise on a nonzero `cudaError_t` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
