"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``_build/lib<name>-<source hash>.so`` at first use, then
loaded with ``ctypes``.  The hash covers the source and every header of
``csrc/`` that it includes (``#include "x.cuh"``, and theirs), so a library
is never stale.  A library may be a variant of its source, built with
preprocessor defines (``library_name("src", ["GENERIC_ACT=1"])`` is
``"src+GENERIC_ACT=1"``, built with ``-DGENERIC_ACT=1`` into
``_build/libsrc-GENERIC_ACT1-<hash>.so``, the defines in the hash): one
source gives one library per compile-time choice, and the variants build
in parallel like any other libraries.  Nothing is built or loaded when a
module is imported.
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
from typing import Dict, Iterable, Optional, Sequence

__all__ = ["CudaKernel", "build_libraries", "library_name"]

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


def library_name(source: str, defines: Sequence[str] = ()) -> str:
    """The name of ``csrc/<source>.cu``'s library built with ``-D`` of each
    define: the source, then each define after a ``+``."""
    return "+".join((source, *defines))


def _split(name: str):
    source, *defines = name.split("+")
    return source, defines


def _lib_path(name: str) -> Path:
    source, defines = _split(name)
    h = hashlib.sha1()
    for path in _sources(source):
        h.update(path.read_bytes())
    for d in defines:
        h.update(b"\0-D" + d.encode())
    tag = "".join("-" + re.sub(r"[^A-Za-z0-9_]", "", d) for d in defines)
    return BUILD / f"lib{source}{tag}-{h.hexdigest()[:12]}.so"


def build_libraries(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named library (a source, or a variant of one:
    ``library_name``) not built yet, all ``nvcc`` runs at once.

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
        source, defines = _split(name)
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
               str(CSRC / f"{source}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), path, tmp, time.perf_counter())
    for name, (proc, path, tmp, t0) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{stdout}{stderr}")
        os.replace(tmp, path)
        out[name] = dict(path=path, seconds=time.perf_counter() - t0, log=stdout + stderr)
    return out


class CudaKernel:
    """One CUDA kernel: its source's library, loaded at first use, and its
    launch count.  Two kernels of one source share the library.

    ``variants``: the define lists the kernel's library may be built with
    (``()`` the plain build); ``lib(defines)`` loads one of them, and
    ``library_names`` names them all, to build them at once.

    ``launches`` is incremented by the kernel's wrapper each time it launches
    the kernel (any variant), and nowhere else.
    """

    def __init__(self, name: str, signatures: Dict[str, tuple],
                 source_name: Optional[str] = None,
                 variants: Sequence[Sequence[str]] = ((),)) -> None:
        self.name = name
        self.source_name = source_name or name  # csrc/<source_name>.cu
        self.signatures = signatures  # C function -> (restype, argtypes)
        self.variants = tuple(tuple(v) for v in variants)
        self.launches = 0
        self._libs: Dict[tuple, ctypes.CDLL] = {}

    @property
    def source(self) -> Path:
        return CSRC / f"{self.source_name}.cu"

    @property
    def library_names(self) -> list:
        return [library_name(self.source_name, v) for v in self.variants]

    def lib(self, defines: Sequence[str] = ()) -> ctypes.CDLL:
        defines = tuple(defines)
        if defines not in self.variants:
            raise ValueError(f"{self.name} has no variant {defines}; it has {self.variants}")
        if defines not in self._libs:
            name = library_name(self.source_name, defines)
            lib = ctypes.CDLL(str(build_libraries([name])[name]["path"]))
            for fn, (restype, argtypes) in self.signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            self._libs[defines] = lib
        return self._libs[defines]
