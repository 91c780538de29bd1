"""Build and load the CUDA sources of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``<build dir>/<name>-<hash>.so``, where the hash
covers the source, the compiler flags and every ``*.cuh`` header beside it, so
an edited source is rebuilt and an unchanged one is reused.  The library is
loaded with ``ctypes``.  Nothing happens at import time: the first launch of a
kernel builds it, which takes a few seconds; ``compile_all`` builds every
source at once.

The build directory is ``build/`` beside the package (the repository root in
a checkout).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source; the message carries its output."""


def build_dir() -> str:
    return os.path.join(os.path.dirname(_PKG_DIR), "build")


def kernel_names() -> List[str]:
    """Every kernel source of the package, by name."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelCompileError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels of domain_transfer_gan_torch "
        "are compiled from csrc/*.cu at first use and need the CUDA toolkit")


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, f)
                                       for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(), "%s-%s.so" % (name, h.hexdigest()[:16]))


def compile_kernel(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is there already;
    returns the library's path.  Safe to call from several threads at once:
    each call writes a file of its own and renames it into place."""
    lib = _library_path(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(build_dir(), exist_ok=True)
    tmp = "%s.tmp%d.%d" % (lib, os.getpid(), threading.get_ident())
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
           source_path(name)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelCompileError("nvcc failed:\n%s\n%s"
                                 % (" ".join(cmd), proc.stdout))
    os.replace(tmp, lib)  # atomic: a reader never sees half a file
    return lib


def compile_all() -> List[str]:
    """Compile every source of ``csrc/``, one ``nvcc`` per source, all started
    together; returns the libraries' paths in ``kernel_names()`` order."""
    names = kernel_names()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(compile_kernel, names))


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    lib = _loaded.get(name)
    if lib is None:
        path = compile_kernel(name)
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = _loaded[name] = ctypes.CDLL(path)
    return lib
