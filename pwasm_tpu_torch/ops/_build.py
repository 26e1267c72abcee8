"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C entry point, loaded with ``ctypes``.  Libraries land in
``pwasm_tpu_torch/_build/``, keyed by a hash of the source and the
flags, so an unchanged source is compiled once per checkout.

Nothing here runs at import: the first CUDA tensor that reaches a
kernel wrapper builds its library (or ``build_all`` builds every source
at once, one nvcc process per source, all started together).  A missing
nvcc raises; there is no download and no prebuilt package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}     # name -> nvcc's report (ptxas -v)


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc_path() -> str:
    """The nvcc binary: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "pwasm_tpu_torch cannot be built")


def lib_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named source (default: all) that has no library yet,
    one nvcc process per source, all running at once.  Returns seconds
    per name (0.0 for a library that was already built).  Raises with
    nvcc's output when a build fails."""
    names = sources() if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    secs = {n: 0.0 for n in names}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out,
                       time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(lib_path(name))
    return lib


def bind(name: str, sigs: dict, cache: dict) -> dict:
    """``cache`` filled, on first use, with the C entry points of
    ``csrc/<name>.cu`` that ``sigs`` maps to their (argtypes, restype);
    returns ``cache``.  Each kernel module keeps its own cache, so a
    module whose kernels were never called has built nothing."""
    if not cache:
        lib = load(name)
        for fn_name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
            cache[fn_name] = fn
    return cache
