"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>-<hash>.so`` at
the repository root (``build/`` is git-ignored), then loaded with ``ctypes``.
The hash of the source and of the shared headers names the
library, so an edited source is rebuilt
and an unchanged one is built once per checkout. Nothing is built when a
module is imported: the first launch builds, or ``build`` does it for
several sources at once, with one ``nvcc`` process each, all started
together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_loaded = {}


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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
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
    if name not in _loaded:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.aldi_cuda_error_string.argtypes = [ctypes.c_int]
        lib.aldi_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


class Kernel:
    """Base of the kernels' wrappers. A subclass names its ``library``
    (``csrc/<library>.cu``) and the argument types of its C entry point
    ``aldi_<name>``; ``launch`` builds and loads the library on first use,
    calls the entry point (which returns a CUDA error code), raises on an
    error and counts the launch in ``launches``. Nothing else counts."""

    name: str
    library: str
    argtypes: list

    def __init__(self):
        self.launches = 0

    def lib(self) -> ctypes.CDLL:
        return load(self.library)

    def launch(self, *args) -> None:
        lib = self.lib()
        fn = getattr(lib, f"aldi_{self.name}")
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name} launch failed: CUDA error {rc} "
                f"({lib.aldi_cuda_error_string(rc).decode()})")
        self.launches += 1
