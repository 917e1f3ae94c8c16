"""Build the port's CUDA kernels and load them with ``ctypes``.

Every ``src/repro_torch/csrc/<name>.cu`` compiles with its own ``nvcc``
into a shared library with a plain C interface, for Hopper
(``-gencode arch=compute_90a,code=sm_90a``).  Libraries land in
``build/kernels/`` at the root of the checkout, named by a hash of their
sources and flags, so a changed source rebuilds and an unchanged one is
reused.  ``build_all`` starts one ``nvcc`` per source, all at once;
``load`` builds on first use.  Nothing here runs when a module is imported:
the CPU-only tests import every module of the port.

    python -m repro_torch.kernels.build      # build every kernel now
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("cache_lookup", "gather", "segment_agg")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH); "
                       "the port's CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: path}``; raises with the compiler's output on any failure.
    ``-Xptxas -v`` reports (registers, shared memory, spills) are kept
    beside each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: lib_path(n) for n in names}
    procs = {}
    for n, p in paths.items():
        if p.exists():
            continue
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"nvcc {n}.cu exited {proc.returncode}:\n{log}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_all((name,))[name]))
            lib.helios_cuda_error_string.restype = ctypes.c_char_p
            lib.helios_cuda_error_string.argtypes = [ctypes.c_int]
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc:
        msg = lib.helios_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


if __name__ == "__main__":
    for n, p in build_all().items():
        print(n, p)
