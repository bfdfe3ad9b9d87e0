"""Build a kernel package's CUDA source with nvcc and load it with ctypes.

Each kernel package keeps one ``csrc/<name>.cu`` with a plain C interface.
At first use it is compiled with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into ``build/lib<name>_<tag>.so`` beside
``csrc/``, where ``<tag>`` hashes the source and the flags, so an edited
source is rebuilt; the library is then loaded once per process.  A
build holds an exclusive ``flock`` on ``build/<name>.lock``, so ranks
started at once build a library once and load it (the kernel frees the
lock if its holder dies).  Nothing here runs at import: the CPU tests
import every kernel module.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Callable

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit to build")


_LIBRARIES: list = []   # every CudaLibrary made, in order


def loaded_libraries() -> int:
    """How many kernel libraries this process has loaded: what the port
    builds at run time, so a run that adds none built nothing new."""
    return sum(lib._lib is not None for lib in _LIBRARIES)


class CudaLibrary:
    """One kernel package's shared library: ``build()`` compiles it if
    needed and returns its path; ``lib()`` loads it once and lets
    ``declare`` set each entry point's ``argtypes``/``restype``."""

    def __init__(self, src: pathlib.Path, name: str,
                 declare: Callable[[ctypes.CDLL], None]):
        self.src = src
        self.name = name
        self.build_dir = src.parent.parent / "build"
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()
        _LIBRARIES.append(self)

    def build(self) -> pathlib.Path:
        src = self.src.read_bytes()
        tag = hashlib.sha256(
            src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = self.build_dir / f"lib{self.name}_{tag}.so"
        if out.exists():
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        with open(self.build_dir / f"{self.name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.exists():            # another process built it meanwhile
                return out
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
            os.close(fd)
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed on {self.src.name} "
                                   f"({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        return out

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
        return self._lib
