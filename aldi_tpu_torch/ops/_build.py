"""Build the port's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>-<hash>.so`` at
the repository root (``build/`` is git-ignored), then loaded with ``ctypes``.
The hash of the source and of the shared headers names the
library, so an edited source is rebuilt
and an unchanged one is built once per checkout. Nothing is built when a
module is imported: the first launch builds, or ``build`` does it for
several sources at once, with one ``nvcc`` process each, all started
together. A host source ``csrc/<name>.cpp`` is compiled by the system C++
compiler (``load_host``). Builds and loads hold one lock, so threads that
reach a first launch together build once; each build writes a temporary
file of its own process and thread and renames it into place.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# the host sources' flags: no -march=native, -ffast-math or FMA
# contraction, which would round the float32 arithmetic otherwise
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

_loaded = {}
_lock = threading.RLock()


def _tmp(out: Path) -> Path:
    return out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by the hash of the source
    and of the shared headers (``csrc/*.cuh``) it may include."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names) -> dict:
    """Compile every named source that has no library yet, in parallel.
    Returns ``{name: compiler log}`` (``-Xptxas=-v`` register and spill
    report) for the sources compiled now. Raises if any build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = _tmp(out)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name}:\n{logs[name]}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Every source exports ``aldi_cuda_error_string(int)``."""
    with _lock:
        if name not in _loaded:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.aldi_cuda_error_string.argtypes = [ctypes.c_int]
            lib.aldi_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return _loaded[name]


def cxx() -> str:
    """The system C++ compiler."""
    found = shutil.which("c++") or shutil.which("g++")
    if found is None:
        raise RuntimeError("no C++ compiler (c++ or g++) found")
    return found


def load_host(name: str, flags=()) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cpp``, compiled
    first with ``CXX_FLAGS`` and ``flags`` (defines and libraries) unless
    the library of that source and those flags exists. ``ctypes.CDLL``
    releases the interpreter lock during each call into it. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    with _lock:
        h = hashlib.sha1((CSRC / f"{name}.cpp").read_bytes())
        h.update(" ".join([*CXX_FLAGS, *flags]).encode())
        out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"
        if out not in _loaded:
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = _tmp(out)
                proc = subprocess.run(
                    [cxx(), *CXX_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cpp"), *flags],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"{cxx()} failed for {name}.cpp:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
            _loaded[out] = ctypes.CDLL(str(out))
        return _loaded[out]


class Kernel:
    """Base of the kernels' wrappers. A subclass names its ``library``
    (``csrc/<library>.cu``) and the argument types of its C entry point
    ``aldi_<name>``; ``launch`` builds and loads the library on first use,
    calls the entry point (which returns a CUDA error code), raises on an
    error and counts the launch in ``launches``. Nothing else counts. The
    entry point is looked up and typed once per loaded library, not on
    every launch."""

    name: str
    library: str
    argtypes: list

    def __init__(self):
        self.launches = 0
        self._entry = (None, None)  # (library, its typed entry point)

    def lib(self) -> ctypes.CDLL:
        return load(self.library)

    def launch(self, *args) -> None:
        lib = self.lib()
        held, fn = self._entry
        if held is not lib:
            fn = getattr(lib, f"aldi_{self.name}")
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._entry = (lib, fn)
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name} launch failed: CUDA error {rc} "
                f"({lib.aldi_cuda_error_string(rc).decode()})")
        self.launches += 1
