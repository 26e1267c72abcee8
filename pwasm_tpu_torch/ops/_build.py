"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C entry point, loaded with ``ctypes``.  Libraries land in
the build directory, keyed by a hash of the source and the flags, so an
unchanged source is compiled once per directory.  The build directory
is ``pwasm_tpu_torch/_build/`` unless :func:`use_build_dir` names
another (``--compile-cache-dir`` of a run, or of the serve daemon,
for every job it serves: :func:`job_build_dir`): it is one
directory for nvcc's libraries and for the C++ engine's g++ builds
(``native.BUILD_DIR``).  A library a process has loaded stays loaded;
the directory decides only where a first build goes and what a later
process finds there.

Nothing here runs at import: the first CUDA tensor that reaches a
kernel wrapper builds its library (or ``build_all`` builds every source
at once, one nvcc process per source, all started together).  A missing
nvcc raises; there is no download and no prebuilt package.

A library's first build runs under its own lock, so the serve daemon's
worker threads reaching a wrapper together build it once, while two
jobs that first need two different kernels build them at once; binding
publishes a module's entry points whole under the module lock, so each
thread sees every entry point of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
DEFAULT_BUILD_DIR = os.path.join(_PKG, "_build")
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()          # _LIBS, the bound caches, BUILD_DIR
_FIRST: dict[str, threading.Lock] = {}   # name -> its first build's lock
BUILD_LOG: dict[str, str] = {}     # name -> nvcc's report (ptxas -v)
BUILD_S: dict[str, float] = {}     # name -> seconds of this process's
#                                    nvcc build of it


def use_build_dir(path: str | None) -> str:
    """Make ``path`` (None or empty: ``pwasm_tpu_torch/_build/``) the
    build directory of every later first build, nvcc's and the C++
    engine's (``native.BUILD_DIR``).  A named directory is created
    here; the default one when a build first needs it.  Returns the
    resolved directory.  Raises PwasmError (exit 1) when a named
    directory cannot be created or written: a build never moves back
    to the package directory."""
    from pwasm_tpu_torch import native
    from pwasm_tpu_torch.core.errors import PwasmError

    global BUILD_DIR
    if path:
        path = os.path.abspath(path)
        try:
            os.makedirs(path, exist_ok=True)
            if not os.access(path, os.W_OK | os.X_OK):
                raise PermissionError(f"[Errno 13] Permission denied: "
                                      f"'{path}'")
        except OSError as e:
            raise PwasmError(f"Error: --compile-cache-dir {path} "
                             f"unusable ({e})\n")
    else:
        path = DEFAULT_BUILD_DIR
    with _LOCK, native._lock:
        BUILD_DIR = native.BUILD_DIR = path
    return path


def job_build_dir(flag: str | None, warm, stderr) -> None:
    """Where a job's first builds go.  A run in a process of its own (no
    ``warm`` context) makes its ``--compile-cache-dir`` (or the
    package's directory) the process's.  A served job builds where its
    daemon does, set once when the daemon starts, and never moves the
    directory under the daemon's other jobs: a job's own flag is left
    unused, with a warning."""
    if warm is None:
        use_build_dir(flag)
    elif flag and os.path.abspath(flag) != BUILD_DIR:
        print(f"Warning: --compile-cache-dir={flag} not used: a served "
              f"job builds in its daemon's directory ({BUILD_DIR})",
              file=stderr)


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
        # process- and thread-unique: two threads building one source
        # must not write one file
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out,
                       time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = BUILD_S[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use:
    once, under that source's own lock, so threads needing one library
    build it once and libraries of different sources build at once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        first = _FIRST.setdefault(name, threading.Lock())
    with first:
        with _LOCK:
            lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(lib_path(name))
            with _LOCK:
                lib = _LIBS.setdefault(name, lib)
        return lib


def bind(name: str, sigs: dict, cache: dict) -> dict:
    """``cache`` filled, on first use, with the C entry points of
    ``csrc/<name>.cu`` that ``sigs`` maps to their (argtypes, restype);
    returns ``cache``.  Each kernel module keeps its own cache, so a
    module whose kernels were never called has built nothing.  The
    cache is published whole, under the module lock: no thread sees it
    with an entry point missing."""
    with _LOCK:
        if cache:
            return cache
    lib = load(name)
    with _LOCK:
        if not cache:
            fns = {}
            for fn_name, (argtypes, restype) in sigs.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
                fns[fn_name] = fn
            cache.update(fns)
        return cache
