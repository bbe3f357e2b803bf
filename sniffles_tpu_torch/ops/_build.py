"""Build and load the port's hand-written CUDA kernels.

Each source csrc/<name>.cu exports a plain C function; it is compiled by
nvcc for sm_90a into build/torch_kernels/lib<name>-<hash>.so at first use
and loaded with ctypes. The hash of the source and the flags names the
library, so an edited source is rebuilt and a stale build is never
loaded. Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
KERNEL_SOURCES = ("edit_distance", "merge_sweep")


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, or the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def start_build(name: str, ptxas_verbose: bool = False):
    """Start nvcc on csrc/<name>.cu; returns (process, temp path, final
    path), or None when the library is already built."""
    out = library_path(name)
    if os.path.exists(out) and not ptxas_verbose:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
           "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def finish_build(started) -> str:
    """Wait for a build from start_build; returns nvcc's output. The
    library is moved into place only when nvcc succeeded."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {os.path.basename(out)}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(ptxas_verbose: bool = False) -> dict[str, str]:
    """Build every kernel source at once (one nvcc per source, started
    together); returns nvcc's output per source."""
    started = {name: start_build(name, ptxas_verbose) for name in KERNEL_SOURCES}
    return {name: finish_build(s) for name, s in started.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building it when missing."""
    path = library_path(name)
    if not os.path.exists(path):
        finish_build(start_build(name))
    return ctypes.CDLL(path)
