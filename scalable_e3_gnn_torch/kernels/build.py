"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``_build/lib<name>-<source hash>.so`` at first use, then
loaded with ``ctypes``.  The hash covers the source and every header of
``csrc/`` that it includes (``#include "x.cuh"``, and theirs), so a library
is never stale.  Nothing is built or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["CudaKernel", "build_libraries"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(str(Path(CUDA_HOME) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and the headers of ``csrc/`` it includes, directly
    or through another, each once, in the order first met."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())
                 if (CSRC / inc.decode()).is_file()]
    return out


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for path in _sources(name):
        h.update(path.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_libraries(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named source not built yet, all ``nvcc`` runs at once.

    Returns per name: ``path``, ``seconds`` (0 when already built) and
    ``log`` (nvcc's ``-Xptxas -v`` report of registers and shared memory).
    """
    BUILD.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = dict(path=path, seconds=0.0, log="")
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), path, tmp, time.perf_counter())
    for name, (proc, path, tmp, t0) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{stdout}{stderr}")
        os.replace(tmp, path)
        out[name] = dict(path=path, seconds=time.perf_counter() - t0, log=stdout + stderr)
    return out


class CudaKernel:
    """One CUDA kernel: its source's library, loaded at first use, and its
    launch count.  Two kernels of one source share the library.

    ``launches`` is incremented by the kernel's wrapper each time it launches
    the kernel, and nowhere else.
    """

    def __init__(self, name: str, signatures: Dict[str, tuple],
                 source_name: Optional[str] = None) -> None:
        self.name = name
        self.source_name = source_name or name  # csrc/<source_name>.cu
        self.signatures = signatures  # C function -> (restype, argtypes)
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.source_name}.cu"

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            path = build_libraries([self.source_name])[self.source_name]["path"]
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in self.signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            self._lib = lib
        return self._lib
