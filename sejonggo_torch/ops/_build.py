"""Build the CUDA kernels with one plain ``nvcc`` call and load them with
``ctypes``.

The sources (``sejonggo_torch/csrc/*.cu``) have a plain C interface and
include no PyTorch header, so the build takes seconds and needs no
PyTorch extension machinery (no lock files).  Every process builds the
library at its first use, so no stale product of an earlier run is ever
loaded.  Processes that start together (the ranks of a multi-card run)
must not break each other's build: each one compiles into a directory of
its own under ``sejonggo_torch/build/`` and moves the finished library
into place with ``os.replace``, which is atomic, so ``build/`` only ever
holds complete libraries and no process deletes another's output.  (The
other design, rank 0 building while the others wait at a barrier, would
tie the build to the process group, and the GTP and duel subprocesses
build outside any group.)
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_NAME = "libsejonggo_kernels.so"
# the kernels hold a board in ceil(N*N/64) registers of 64 bits, N <= 19
MAX_SIZE = 19

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the card")


def nvcc_command(out_path: str) -> list:
    sources = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith(".cu"))
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "--threads", "0", "-Xptxas", "-v", "-shared",
            "-Xcompiler", "-fPIC", "-o", out_path] + sources


def _sweep_dead_builds() -> None:
    """Remove the private build directories of processes that are gone
    (a build killed half-way leaves its directory behind)."""
    for name in os.listdir(BUILD_DIR):
        pid = name.split("-")[1] if name.startswith("tmp-") else ""
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            os.kill(int(pid), 0)
        except ProcessLookupError:
            shutil.rmtree(os.path.join(BUILD_DIR, name), ignore_errors=True)
        except PermissionError:
            pass                  # alive, another user's


def _build() -> str:
    """Compile the library into a private directory, move it to
    ``BUILD_DIR/LIB_NAME`` and return that path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    _sweep_dead_builds()
    private = tempfile.mkdtemp(prefix=f"tmp-{os.getpid()}-", dir=BUILD_DIR)
    out = os.path.join(BUILD_DIR, LIB_NAME)
    cmd = nvcc_command(os.path.join(private, LIB_NAME))
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        seconds = time.perf_counter() - t0
        log = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        # atomic: a process loading ``out`` maps a whole library, its own
        # or that of a process that built from the same sources meanwhile
        os.replace(os.path.join(private, LIB_NAME), out)
    finally:
        shutil.rmtree(private, ignore_errors=True)
    build_info.update(command=" ".join(cmd), seconds=seconds, log=log)
    # stderr: a GTP engine's stdout carries only protocol responses
    print(f"[sejonggo_torch] built {out} in {seconds:.2f} s", file=sys.stderr,
          flush=True)
    for line in log.splitlines():
        print(f"[nvcc] {line}", file=sys.stderr, flush=True)
    return out


def load_library() -> ctypes.CDLL:
    """Build (once per process) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sejonggo_flood.argtypes = [p, p, p, p, i, i, p]
    lib.sejonggo_flood.restype = i
    lib.sejonggo_step_legal.argtypes = [p, p, p, p, p, p, i, i, p]
    lib.sejonggo_step_legal.restype = i
    lib.sejonggo_flood_block.argtypes = [i]
    lib.sejonggo_flood_block.restype = i
    lib.sejonggo_step_legal_block.argtypes = [i]
    lib.sejonggo_step_legal_block.restype = i
    _lib = lib
    return lib
