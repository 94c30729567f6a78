"""Build and bind the hand-written CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own by
``nvcc`` into ``build/kernels/<stem>-<hash>.so`` at the repository root, the
first time a kernel of that file is launched. The hash covers the source and
the flags, so an edited source rebuilds and an unchanged one is reused. All
sources are compiled together, one ``nvcc`` process each, started at once.

Flags, per source (:func:`nvcc_flags`): every source gets ``sm_90a``
(Hopper), ``-O3`` and no ``--use_fast_math``. ``quant.cu``, ``spmm.cu``,
``gat.cu`` and ``seg.cu`` also get ``-fmad=false``: they promise the same
bits as their plain PyTorch versions (``gat.cu`` wherever ``exp`` agrees),
so a multiply followed by an add must stay two IEEE roundings.
``flash.cu`` and ``flash_bwd.cu`` do not: they are held to a tolerance,
not to bits, and let the compiler contract to FMA.

Nothing here runs at import time; a CPU-only machine imports this module and
never calls it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("quant.cu", "spmm.cu", "flash.cu", "flash_bwd.cu", "gat.cu",
           "seg.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# the sources whose kernels are bit-equal to their plain versions
BIT_EXACT = ("quant.cu", "spmm.cu", "gat.cu", "seg.cu")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def nvcc_flags(source: str) -> tuple[str, ...]:
    """The flags ``source`` is compiled with."""
    return NVCC_FLAGS + (("-fmad=false",) if source in BIT_EXACT else ())


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(nvcc_flags(source)).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all(sources: Sequence[str] = SOURCES) -> float:
    """Compile every source whose library is missing, in parallel. Returns
    the seconds spent; raises with nvcc's output if any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *nvcc_flags(src), "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        build_all()
        lib = _LIBS[source] = ctypes.CDLL(str(library_path(source)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One C entry point of a CUDA source, and the count of its launches.

    Calling it launches the kernel on the given stream, raises if the C side
    reports a CUDA error, and adds one to :attr:`launches`. A C entry point
    returns ``cudaGetLastError()`` right after its launch."""

    def __init__(self, name: str, source: str, argtypes: Sequence):
        self.name = name
        self.source = source
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = load(self.source).repro_error_string(err).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed: {msg} ({err})")
        self.launches += 1
