"""Build a kernel package's CUDA source with nvcc and load it with ctypes.

Each kernel library is one ``csrc/<name>.cu`` with a plain C interface
(the headers it includes with ``#include "..."`` beside it).  At first
use it is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into ``build/lib<name>_<tag>.so`` beside ``csrc/``, where ``<tag>``
hashes the source, those headers and the flags, so an edited source or
header is rebuilt; the library is then loaded once per process.  A
build holds an exclusive ``flock`` on ``build/<name>.lock``, so ranks
started at once build a library once and load it (the kernel frees the
lock if its holder dies).  Nothing here runs at import: the CPU tests
import every kernel module.

``refuse_grad`` is the kernels' autograd guard: a kernel launched through
``ctypes`` writes into a tensor with no ``grad_fn``, so a wrapper handed
an input that requires grad under grad mode raises rather than return an
output that silently drops the gradient (the reference's ``jax.grad``
cannot transpose a ``pallas_call`` either).  The one way into a kernel
under grad is an ``autograd.Function`` whose backward is a kernel too
(``flash_attention/ops.py::ChunkedAttention``).  ``refuse_dtensor`` is
the wrappers' mesh guard: a kernel reads one device's memory, so a
wrapper handed a DTensor raises rather than take its local shard; a
caller on a mesh runs the kernel on the shards itself, with the
placements stated (``flash_attention/ops.py::mha``).

``note_kernel`` is how a wrapper handed ``meta`` tensors (a dry-run's
stand-ins: shapes, no data) reports the work its kernel would do: it
hands ``(name, flops, bytes)`` to the sink in ``WORK_SINK``, if a caller
set one (``roofline/analysis.py::StepCounter`` does), and else does
nothing.
"""
from __future__ import annotations

import contextvars
import ctypes
import fcntl
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

# -Xptxas -v: ptxas reports each kernel's registers and spills
# (``CudaLibrary.ptxas``)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def refuse_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and this kernel has no "
            "backward (nor has the reference's pallas_call): call it under "
            "torch.no_grad(), or train through impl='chunked'")


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise if any of ``tensors`` is a DTensor."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{name}: a DTensor input; the kernel reads one device's "
            "tensors, so run it on the local shards with their placements "
            "stated (torch.distributed.tensor.experimental.local_map)")


WORK_SINK: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_kernel_work", default=None)


def note_kernel(name: str, flops: float, nbytes: float) -> None:
    """A kernel's work from a wrapper handed ``meta`` tensors, where it
    runs no plain version: passed to the active sink, if any."""
    sink = WORK_SINK.get()
    if sink is not None:
        sink(name, flops, nbytes)


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
_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
# "Potential Performance Loss: wgmma.mma_async instructions are serialized"
_PTXAS_SERIAL = re.compile(r"C7512.*function '(\w+)'")


def _template_args(s: str) -> list:
    """The arguments of a mangled template argument list ``I...E``:
    integer literals (``Li64E``), ``float``, ``int`` and named types."""
    args, i = [], 1
    while i < len(s) and s[i] != "E":
        if s[i] == "L":                     # a literal: L<type><value>E
            j = s.index("E", i)
            args.append(s[i + 2:j])
            i = j + 1
        elif s[i] in "fi":
            args.append({"f": "float", "i": "int"}[s[i]])
            i += 1
        elif (found := re.match(r"\d+", s[i:])):
            j = i + found.end()
            args.append(s[j:j + int(found.group())])
            i = j + int(found.group())
        else:
            break
    return args


def kernel_name(mangled: str) -> str:
    """A mangled kernel name (``_Z[N]<len><name>...[I<args>E]...``)
    shortened to ``name<args>``."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (found := re.match(r"\d+", mangled[i:])):
        n, i = int(found.group()), i + found.end()
        name, i = mangled[i:i + n], i + n
    args = _template_args(mangled[i:]) if mangled[i:i + 1] == "I" else []
    return name + (f"<{', '.join(args)}>" if args else "")


def ptxas_usage(log: str) -> dict:
    """``{kernel: {"registers": n, "spill_stores": bytes, "spill_loads":
    bytes, "wgmma_serialized": bool}}`` from nvcc's ``-Xptxas -v``
    output (serialized: ptxas made a kernel's asynchronous products wait
    one by one, advisory C7512)."""
    usage, name, serialized = {}, None, set()
    for line in log.splitlines():
        if (found := _PTXAS_SERIAL.search(line)):
            serialized.add(kernel_name(found.group(1)))
        elif (found := _PTXAS_ENTRY.search(line)):
            name = kernel_name(found.group(1))
            usage[name] = {"registers": None, "spill_stores": 0,
                           "spill_loads": 0, "wgmma_serialized": False}
        elif name and (found := _PTXAS_SPILLS.search(line)):
            usage[name]["spill_stores"] = int(found.group(1))
            usage[name]["spill_loads"] = int(found.group(2))
        elif name and (found := _PTXAS_REGS.search(line)):
            usage[name]["registers"] = int(found.group(1))
    for name in serialized & usage.keys():
        usage[name]["wgmma_serialized"] = True
    return usage
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_bytes(src: pathlib.Path) -> bytes:
    """``src`` followed by every header it includes with ``#include
    "..."``, each once, recursively, in the order first included."""
    seen, out = set(), []

    def add(path: pathlib.Path) -> None:
        path = path.resolve()
        if path in seen:
            return
        seen.add(path)
        text = path.read_bytes()
        out.append(text)
        for name in _LOCAL_INCLUDE.findall(text):
            add(path.parent / name.decode())
    add(src)
    return b"".join(out)


def ptxas_report() -> dict:
    """``{library: ptxas_usage}`` of every library this process
    compiled."""
    return {lib.name: lib.ptxas for lib in _LIBRARIES if lib.ptxas}


def loaded_libraries() -> int:
    """How many kernel libraries this process has loaded: what the port
    builds at run time, so a run that adds none built nothing new."""
    return sum(lib._lib is not None for lib in _LIBRARIES)


class CudaLibrary:
    """One kernel package's shared library: ``build()`` compiles it if
    needed and returns its path; ``lib()`` loads it once and lets
    ``declare`` set each entry point's ``argtypes``/``restype``;
    ``ptxas``: each kernel's registers and spills (``ptxas_usage``) when
    this process compiled it, else empty."""

    def __init__(self, src: pathlib.Path, name: str,
                 declare: Callable[[ctypes.CDLL], None]):
        self.src = src
        self.name = name
        self.build_dir = src.parent.parent / "build"
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()
        self.ptxas: dict = {}
        _LIBRARIES.append(self)

    def path(self) -> pathlib.Path:
        """Where ``build`` puts the library: its tag hashes the source,
        its local headers and the flags."""
        tag = hashlib.sha256(source_bytes(self.src)
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return self.build_dir / f"lib{self.name}_{tag}.so"

    def build(self) -> pathlib.Path:
        out = self.path()
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
            self.ptxas = ptxas_usage(proc.stdout + proc.stderr)
        return out

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
        return self._lib
