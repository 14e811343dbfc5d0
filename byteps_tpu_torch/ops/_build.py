"""Build and load the port's hand-written CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``.
All sources compile in parallel (one ``nvcc`` per source, started
together). The library's file name carries a hash of the sources and
headers, so an edit is never served a stale build. Nothing here runs at
import time: this module imports on a machine with no CUDA toolkit.
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
from typing import Dict

from ..common.logging import get_logger

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# argtypes of each C entry point, by source stem
SIGNATURES = {
    "flash_fwd": ("bps_flash_fwd",
                  [_P] * 5 + [_I] * 5 + [_L] * 8 + [_F, _I, _P]),
    "flash_bwd": ("bps_flash_bwd",
                  [_P] * 9 + [_I] * 5 + [_L] * 8 + [_F, _I, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of byteps_tpu_torch "
                       "are built from source at first use and need the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(stem: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def _lib_path(stem: str) -> Path:
    return BUILD_DIR / f"lib{stem}-{_digest(stem)}.so"


def build_all(verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no current build, all at once, and
    load every library. Raises with nvcc's output if a build fails."""
    with _lock:
        stems = sorted(SIGNATURES)
        todo = [s for s in stems if s not in _libs
                and not _lib_path(s).exists()]
        if todo:
            nvcc = nvcc_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            procs = []
            for stem in todo:
                out = _lib_path(stem)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                       "-o", str(tmp), str(CSRC / f"{stem}.cu")]
                procs.append((stem, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            errors = []
            for stem, out, tmp, proc in procs:
                log, _ = proc.communicate()
                if verbose and log:
                    print(f"[nvcc {stem}]\n{log}", flush=True)
                if proc.returncode != 0:
                    errors.append(f"nvcc failed on csrc/{stem}.cu "
                                  f"(exit {proc.returncode}):\n{log}")
                else:
                    os.replace(tmp, out)   # atomic: two processes building at once both load a whole file
            if errors:
                raise RuntimeError("\n".join(errors))
            get_logger().info("built %s with nvcc in %.1f s",
                              ", ".join(f"csrc/{s}.cu" for s in todo),
                              time.perf_counter() - t0)
        for stem in stems:
            if stem not in _libs:
                lib = ctypes.CDLL(str(_lib_path(stem)))
                name, argtypes = SIGNATURES[stem]
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _libs[stem] = lib
        return dict(_libs)


def entry(stem: str):
    """The C entry point of ``csrc/<stem>.cu``, building on first use."""
    lib = _libs.get(stem) or build_all()[stem]
    return getattr(lib, SIGNATURES[stem][0])
