"""Build and load the port's CPU summation server at first use.

``csrc/host/bps_server.cc`` (the parameter-server engine, a plain C ABI)
is compiled by ``g++`` with the flags of the JAX package's
``server/csrc/Makefile`` into ``_build/libbps_server-<hash>.so`` and
loaded through ``ctypes``. Where the toolchain cannot link OpenMP (a g++
without libgomp), the engine is built without ``-fopenmp``: its OpenMP
use is pragmas over independent elements and segments only, so it sums
the same values, on one thread. The hash covers the source and the flags,
the OpenMP choice included, so an edit or another toolchain is never
served a stale build; the library is written to a temporary
name and renamed into place, so two processes building at once (the tests
run in parallel workers) each load a whole file. Nothing runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from ..common.logging import get_logger
from ._build import BUILD_DIR, CSRC

SOURCE = CSRC / "host" / "bps_server.cc"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _lib_path(flags: list) -> Path:
    h = hashlib.sha1(" ".join(flags).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbps_server-{h.hexdigest()[:12]}.so"


def openmp_flags(cxx: str) -> list:
    """``-fopenmp`` when ``cxx`` can compile and link an OpenMP library,
    else the flag that keeps its pragmas from warning."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe = BUILD_DIR / f"openmp-probe.{os.getpid()}.{threading.get_ident()}"
    try:
        r = subprocess.run([cxx, "-fopenmp", "-fPIC", "-shared", "-x", "c++",
                            "-o", str(probe), "-"],
                           input="int bps_probe() { return 0; }\n",
                           capture_output=True, text=True)
    finally:
        probe.unlink(missing_ok=True)
    return ["-fopenmp"] if r.returncode == 0 else ["-Wno-unknown-pragmas"]


def build() -> Path:
    """Compile the server library unless a current build exists; returns
    its path. Raises with the compiler's output if the build fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the parameter-server engine of "
                           "byteps_tpu_torch is built from source at first "
                           "use (set CXX or put g++ on PATH)")
    omp = openmp_flags(cxx)
    out = _lib_path(CXX_FLAGS + omp)
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, *omp, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    get_logger().info("built csrc/host/%s with %s %s in %.1f s", SOURCE.name,
                      cxx, " ".join(omp), time.perf_counter() - t0)
    return out


def load() -> ctypes.CDLL:
    """The server library with every binding the port calls declared,
    building it on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        P, U64, I = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
        sigs = {
            "bps_server_create": (P, [I] * 4),
            "bps_server_destroy": (None, [P]),
            "bps_server_begin_shutdown": (None, [P]),
            "bps_server_init_key": (I, [P, U64, U64, I, P]),
            "bps_server_push": (I, [P, U64, P, U64]),
            "bps_server_pull": (I, [P, U64, P, U64, U64, I]),
            "bps_server_round": (U64, [P, U64]),
            "bps_server_engine_load": (U64, [P, I]),
            "bps_server_engine_backlog": (U64, [P, I]),
            "bps_server_push_onebit": (I, [P, U64, P, U64]),
            "bps_server_pull_onebit": (I, [P, U64, P, U64, U64, I, I]),
            "bps_server_push_topk": (I, [P, U64, P, U64]),
            "bps_server_pull_topk": (I, [P, U64, P, U64, U64, I]),
            "bps_codec_onebit_decompress": (None, [P, U64, P]),
            "bps_codec_topk_select": (I, [P, U64, U64, P, P]),
            "bps_codec_scatter_f32": (I, [P, P, U64, U64, P]),
            "bps_codec_xorshift_indices": (None, [U64, U64, P, P]),
            "bps_codec_dithering_compress": (
                None, [P, U64, ctypes.c_float, I, I, I, P, P]),
            "bps_reduce_sum": (None, [P, P, U64, I]),
            "bps_pack_segments": (None, [P, P, P, U64, P]),
            "bps_unpack_segments": (None, [P, P, P, P, U64]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib
