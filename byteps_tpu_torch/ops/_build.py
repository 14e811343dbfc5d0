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
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..common.logging import get_logger

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -Xptxas -v: ptxas reports each kernel's registers, stack and spills,
# kept beside the library (ptxas_report reads them)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# the attention kernels' bias source: form, dense bias, bucket vector,
# table, bucket count (csrc/flash_bias.cuh)
_BIAS = [_I, _P, _P, _P, _I]
# argtypes of each C entry point, by source stem
SIGNATURES = {
    "flash_fwd": ("bps_flash_fwd",
                  [_P] * 5 + [_I] * 5 + [_L] * 8 + [_F, _I] + _BIAS
                  + [_I, _P]),
    "flash_bwd": ("bps_flash_bwd",
                  [_P] * 10 + [_I] * 5 + [_L] * 8 + [_F, _I, _P]),
    "flash_dq": ("bps_flash_dq",
                 [_P] * 7 + [_I] * 5 + [_L] * 8 + [_F, _I] + _BIAS
                 + [_P, _P]),
    "flash_dkv": ("bps_flash_dkv",
                  [_P] * 8 + [_I] * 5 + [_L] * 8 + [_F, _I] + _BIAS + [_P]),
    # the five take a launch plan (ops/compression/kernels.py::stream_plan):
    # head (not unpack and dequantize: their vectors are the output's),
    # vectors and grid (dequantize then its instance, 1 for word loads);
    # before it, bps_onebit_pack (x, words, n, stream),
    # bps_onebit_unpack (words, out, n, stream), bps_int8_quantize (x, q,
    # n, scale, stream), bps_int8_dequantize (q, out, n, scale, stream) and
    # bps_fp8_sr_quantize (x, q, n, scale, seed, kind, stream)
    "onebit_pack": ("bps_onebit_pack_planned", [_P, _P, _L, _I, _L, _I, _P]),
    "onebit_unpack": ("bps_onebit_unpack_planned", [_P, _P, _L, _L, _I, _P]),
    "int8_quantize": ("bps_int8_quantize_planned",
                      [_P, _P, _L, _I, _L, _I, _F, _P]),
    "int8_dequantize": ("bps_int8_dequantize_planned",
                        [_P, _P, _L, _L, _I, _I, _F, _P]),
    "fp8_sr_quantize": ("bps_fp8_sr_quantize_planned",
                        [_P, _P, _L, _I, _L, _I, _F, ctypes.c_uint, _I, _P]),
}

# every flash library also answers the dynamic shared memory of the kernel
# instantiations it holds: bps_flash_smem(kernel, d, form), kernel 0 the
# forward, 1 dq, 2 dk/dv (-1 for one it does not hold)
SMEM_QUERY = "bps_flash_smem"
SMEM_KERNELS = {"flash_fwd_kernel": 0, "flash_bwd_dq_kernel": 1,
                "flash_bwd_dkv_kernel": 2}

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


def _log_path(stem: str) -> Path:
    """nvcc's output of the current build of ``stem``, beside its library."""
    return _lib_path(stem).with_suffix(".log")


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no current build, all at once, and
    load every library. Raises with nvcc's output if a build fails; keeps
    it beside each library it builds."""
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
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{stem}.cu")]
                procs.append((stem, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            errors = []
            for stem, out, tmp, proc in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed on csrc/{stem}.cu "
                                  f"(exit {proc.returncode}):\n{log}")
                else:
                    # the log first: every library has its log beside it
                    _log_path(stem).write_text(log)
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


_ENTRY = re.compile(r"(?:Compiling entry function '|Function properties "
                    r"for )(\S+?)'?(?: for '\w+')?$")
_TEMPLATE = re.compile(r"I((?:L[ib]\d+E)+)E")


def _kernel_of(mangled: str) -> Optional[Tuple[str, List[int]]]:
    """The kernel name and template arguments (in order, as ints) of a
    mangled name, None for a function whose name does not end in _kernel.
    The name is the identifier whose length prefix, the digits just before
    it, gives its length: nvcc's anonymous namespaces carry hashes of
    letters and digits, so no pattern alone finds where the name starts."""
    for m in re.finditer(r"_kernel", mangled):
        end = m.end()
        for start in range(m.start(), 0, -1):
            if (mangled[start].isalpha()
                    and mangled[:start].endswith(str(end - start))):
                t = _TEMPLATE.match(mangled, end)
                args = re.findall(r"L[ib](\d+)E", t.group(1)) if t else []
                return mangled[start:end], [int(a) for a in args]
    return None


def ptxas_report(stems=None) -> List[dict]:
    """The ptxas -v output of the current builds of ``stems`` (default:
    every source), one row per kernel template instance: its source,
    kernel name, template arguments (in order, as ints), registers, stack
    frame and spill bytes. Reads the logs ``build_all`` keeps beside the
    libraries, so a cached build reports as a fresh one does."""
    rows: Dict[str, dict] = {}
    for stem in stems or sorted(SIGNATURES):
        cur = None
        for line in _log_path(stem).read_text().splitlines():
            m = _ENTRY.search(line.strip())
            if m:
                cur = rows.setdefault(m.group(1), {"source": stem,
                                                   "mangled": m.group(1)})
                continue
            if cur is None:
                continue
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                f = re.search(pat, line)
                if f:
                    cur[key] = int(f.group(1))
    out = []
    for row in rows.values():
        kernel = _kernel_of(row.pop("mangled"))
        if kernel and "registers" in row:
            row["kernel"], row["args"] = kernel
            out.append(row)
    return sorted(out, key=lambda r: (r["source"], r["kernel"], r["args"]))


def smem_bytes(stem: str, kernel: str, d: int, form: int) -> int:
    """The dynamic shared memory (bytes) a launch of ``kernel`` (a key of
    ``SMEM_KERNELS``) from ``csrc/<stem>.cu`` asks for at head dim ``d``
    in bias form ``form``."""
    lib = _libs.get(stem) or build_all()[stem]
    fn = getattr(lib, SMEM_QUERY)
    fn.argtypes = [_I, _I, _I]
    fn.restype = _I
    return fn(SMEM_KERNELS[kernel], d, form)


def tensor_map_us(base: int, n: int = 10000) -> float:
    """Host microseconds per tensor map encode (cuTensorMapEncodeTiled, as
    every flash launch encodes one per operand), over ``n`` encodes of a
    BERT-large operand's map at the device address ``base`` (16-byte
    aligned; nothing is read) by ``csrc/flash_fwd.cu``'s
    ``bps_tensor_map_us``."""
    lib = _libs.get("flash_fwd") or build_all()["flash_fwd"]
    fn = lib.bps_tensor_map_us
    fn.argtypes = [_P, _I]
    fn.restype = ctypes.c_double
    return fn(base, n)


# SASS instructions counted per kernel, by the pattern of their opcode:
# the Hopper products (wgmma), TMA tensor loads, bulk copies, and 128-bit
# global loads and stores (any modifiers)
SASS_OPS = {"HGMMA": r"\bHGMMA\b", "UTMALDG": r"\bUTMALDG\b",
            "UBLKCP": r"\bUBLKCP\b",
            "LDG.E.128": r"\bLDG\.E(?:\.\w+)*\.128\b",
            "STG.E.128": r"\bSTG\.E(?:\.\w+)*\.128\b"}


def _sass_path(stem: str) -> Path:
    """The SASS listing of the current build of ``stem``, beside it."""
    return _lib_path(stem).with_suffix(".sass")


def sass_listing(lib) -> str:
    """``cuobjdump -sass`` of the library ``lib`` (the toolkit's, beside
    nvcc)."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def sass_of(stem: str) -> str:
    """The SASS listing of the current build of ``stem``, kept beside it
    on first use, so a cached build reports as a fresh one does."""
    path = _sass_path(stem)
    if not path.exists():
        path.write_text(sass_listing(_lib_path(stem)))
    return path.read_text()


def sass_counts(stems=None) -> List[dict]:
    """Per kernel template instance of the current builds of ``stems``
    (default: every source): its source, kernel name, template arguments
    and how many of each ``SASS_OPS`` instruction its machine code holds
    (``sass_of``)."""
    out = []
    for stem in stems or sorted(SIGNATURES):
        sass = sass_of(stem)
        row = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                kernel = _kernel_of(m.group(1))
                row = None
                if kernel:
                    row = {"source": stem, "kernel": kernel[0],
                           "args": kernel[1],
                           **dict.fromkeys(SASS_OPS, 0)}
                    out.append(row)
            elif row is not None:
                for op, pattern in SASS_OPS.items():
                    if re.search(pattern, line):
                        row[op] += 1
    return sorted(out, key=lambda r: (r["source"], r["kernel"], r["args"]))


def device_type(t, what: str) -> str:
    """"cpu" (a wrapper then takes its plain version) or "cuda" (it
    launches its kernel); any other device has no path."""
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no {what} path for {t.device}")
    return t.device.type


# an entry point's code for a tensor map it could not encode: MAP_ERROR +
# the driver's CUresult, MAP_ERROR - 1 without the driver entry point
# (csrc/hopper.cuh::kMapError)
MAP_ERROR = 100000


def raise_on_error(code: int, what: str) -> None:
    """Raise when an entry point returned a CUDA error (a refused launch
    never runs, and no later synchronize would report it)."""
    if code == MAP_ERROR - 1:
        raise RuntimeError(f"{what}: the driver has no "
                           "cuTensorMapEncodeTiled entry point")
    if code >= MAP_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a TMA "
                           f"tensor map (CUresult {code - MAP_ERROR})")
    if code != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {code}")
