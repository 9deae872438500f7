"""Build and load the port's native libraries.

Every ``csrc/<name>.cu`` (a CUDA kernel) and ``csrc/<name>.cpp`` (host
code: the threaded row gather of ``data/native_gather.py``) has a plain C
interface. On first use a ``.cu`` source is compiled with ``nvcc`` for
``sm_90a`` into ``build/kernels/``, a ``.cpp`` source with ``g++`` into
``build/native/``, at the root of the checkout (the file name carries a
hash of the source, so an edited source is rebuilt), and loaded with
``ctypes``. ``build()`` compiles all sources at once, one compiler process
per source. ``mixture_bf16.cu`` includes ``mixture.cu`` (its instances
for bfloat16 elements) beside its own bf16 kernels, so its hash covers both
files. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
HOST_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ("mixture", "mixture_bf16")
HOST_SOURCES = ("gather",)
# the sources another source includes (its build depends on them)
INCLUDES = {"mixture_bf16": ("mixture.cu",)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_FALLBACK
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc was not found on PATH or at {NVCC_FALLBACK}; the CUDA "
            "kernels cannot be built.")
    return path


def _gxx() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError("g++ was not found on PATH; the native gather cannot "
                           "be built.")
    return path


def _source(name: str) -> Path:
    return CSRC_DIR / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def library_path(name: str) -> Path:
    h = hashlib.sha1(_source(name).read_bytes())
    for inc in INCLUDES.get(name, ()):
        h.update((CSRC_DIR / inc).read_bytes())
    digest = h.hexdigest()
    out_dir = HOST_BUILD_DIR if name in HOST_SOURCES else BUILD_DIR
    return out_dir / f"lib{name}_{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES + HOST_SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, all in parallel.

    Returns name -> the compiler's report (for a kernel ``-Xptxas -v``:
    registers, shared memory, spills) for each source compiled by this
    call. Raises RuntimeError with the compiler's output if a build fails.
    """
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        if name in HOST_SOURCES:
            cmd = [_gxx(), *GXX_FLAGS, "-o", str(tmp), str(_source(name))]
        else:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    reports, failures = {}, []
    for name, proc, tmp, out in running:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{_source(name).name} (exit {proc.returncode}):\n{report}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
        reports[name] = report
    if failures:
        raise RuntimeError("build failed:\n" + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built if
    needed."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return _LIBS[name]
