"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared ...

The libraries go to ``build/i2pnet_tpu_torch/`` beside the package, keyed
by a hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused. Only the sources in the checkout are compiled.

Every exported launch function returns ``cudaGetLastError()`` as an int;
``check`` raises if it is not 0 (a refused launch never runs, and a later
``torch.cuda.synchronize()`` would not report it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "i2pnet_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest(CSRC / f'{name}.cu')}.so"


def build_all(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one nvcc process per source, all started together; raise with the
    compiler's output if any fails. The register/shared-memory report is
    kept beside each library as ``.log``."""
    jobs = []
    for name in names:
        lib_path = _lib_path(name)
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, lib_path, tmp, proc))
    failures = []
    for name, lib_path, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu:\n{out}\n{err}")
            continue
        lib_path.with_suffix(".log").write_text(out + err)
        os.replace(tmp, lib_path)
    if failures:
        raise RuntimeError("\n".join(failures))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    lib.i2p_error_string.argtypes = [ctypes.c_int]
    lib.i2p_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.i2p_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(t, dtype, what: str) -> None:
    """Validate a tensor handed to a kernel: on the card, of the kernel's
    dtype, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
