"""Build and load the port's hand-written CUDA kernels and its native
host library.

Each source csrc/<name>.cu exports a plain C function (shared device code
lives in csrc/*.cuh); it is compiled by nvcc for sm_90a into
build/torch_kernels/lib<name>-<hash>.so at first use and loaded with
ctypes. The hash of the source, the headers and the flags names the
library, so an edited source is rebuilt and a stale build is never
loaded. A source may take -D flags: call_stats.cu's and cluster_sorts.cu's
tier thresholds come from ops/call_stats.py and ops/cluster_sorts.py
(`default_defines`), and a variant built with
other flags is a library of its own. Nothing here runs at import: the CPU
tests import every module.

The native host library (csrc/host/bamcore.cc and poacore.cc: the BGZF
inflate, the BAM record and split scans, the CRAM codecs' ITF8 and rANS,
the INS consensus and the graph POA) is built the same way by the host
C++ compiler into build/torch_kernels/libbamcore-<hash>.so (build_host).
A build goes to a temporary file that is renamed into place, so processes
that ask for the library at once never load a half-written one.
"""
from __future__ import annotations

import ctypes
import functools
import glob
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
KERNEL_SOURCES = ("edit_distance", "merge_sweep", "merge_relax", "candidate_tail",
                  "call_stats", "combine_greedy", "cluster_sorts")
HOST_SOURCES = ("bamcore.cc", "poacore.cc")
# -ffp-contract=off: bamcore.cc's split filter computes base + kb * (qlen /
# 1000.0) in double precision as Python does, two roundings; a fused
# multiply-add (which -march=native allows) rounds once and can move the
# comparison with the split count at the boundary
HOST_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-std=c++17",
              "-Wall", "-shared")


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


def default_defines(name: str) -> tuple:
    """The -D flags csrc/<name>.cu is built with unless asked for others:
    call_stats.cu's and cluster_sorts.cu's tier thresholds
    (ops/call_stats.nvcc_defines, ops/cluster_sorts.nvcc_defines)."""
    if name == "call_stats":
        from sniffles_tpu_torch.ops.call_stats import nvcc_defines
        return nvcc_defines()
    if name == "cluster_sorts":
        from sniffles_tpu_torch.ops.cluster_sorts import nvcc_defines
        return nvcc_defines()
    return ()


def library_path(name: str, defines: tuple | None = None) -> str:
    """The build of csrc/<name>.cu with `defines` (default_defines when
    None), named by a hash of the source, the shared headers (csrc/*.cuh)
    and the flags."""
    defines = default_defines(name) if defines is None else tuple(defines)
    digest = hashlib.sha1(" ".join(NVCC_FLAGS + defines).encode())
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in [os.path.join(CSRC, f"{name}.cu")] + headers:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def start_build(name: str, ptxas_verbose: bool = False, defines: tuple | None = None):
    """Start nvcc on csrc/<name>.cu with `defines` (as library_path);
    returns (process, temp path, final path), or None when the library is
    already built."""
    defines = default_defines(name) if defines is None else tuple(defines)
    out = library_path(name, defines)
    if os.path.exists(out) and not ptxas_verbose:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *defines, *(["-Xptxas", "-v"] if ptxas_verbose else []),
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
def load(name: str, defines: tuple | None = None) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu with `defines` (as
    library_path), building it when missing."""
    path = library_path(name, defines)
    if not os.path.exists(path):
        finish_build(start_build(name, defines=defines))
    return ctypes.CDLL(path)


def host_cxx() -> str:
    """The host C++ compiler: $CXX, else c++ or g++ on the PATH."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found (set CXX): the native host library "
                       "is built from csrc/host/ at first use")


def _host_link_flags() -> tuple:
    """zlib linked statically where libz.a exists, its symbols kept out of
    the library's dynamic table (another library in the process that
    exports zlib globally would otherwise take over inflate), as the JAX
    package's native/Makefile links it; -lz where it does not."""
    if glob.glob("/usr/lib/*/libz.a") + glob.glob("/usr/lib/libz.a") + glob.glob(
            "/usr/local/lib/libz.a"):
        return ("-Wl,-Bstatic", "-lz", "-Wl,-Bdynamic", "-Wl,--exclude-libs,libz.a",
                "-lpthread", "-ldl")
    return ("-lz", "-lpthread", "-ldl")


def _cpu_signature() -> bytes:
    """The CPU's model and flags: -march=native code built on one machine
    must not be loaded on another from a copied build directory."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    return b"\n".join(next((ln for ln in lines if ln.startswith(key)), b"")
                      for key in (b"model name", b"flags", b"Features"))


def host_library_path() -> str:
    digest = hashlib.sha1(" ".join(HOST_FLAGS + _host_link_flags()).encode()
                          + _cpu_signature())
    for name in HOST_SOURCES:
        with open(os.path.join(CSRC, "host", name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libbamcore-{digest.hexdigest()[:12]}.so")


def build_host() -> str:
    """Build the native host library unless it is built; returns its path.
    Raises when the compiler fails."""
    out = host_library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [host_cxx(), *HOST_FLAGS,
           *(os.path.join(CSRC, "host", name) for name in HOST_SOURCES),
           "-o", tmp, *_host_link_flags()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"the native host library failed to build:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
