"""The compression kernels of the port: hand-written Hopper kernels and
their plain PyTorch versions (counterpart of
``byteps_tpu/ops/compression/pallas_kernels.py``).

  - ``onebit_pack`` launches ``csrc/onebit_pack.cu``, the port of the
    Pallas ``_pack_kernel`` (pallas_kernels.py:39, wrapper ``onebit_pack``
    :58): bit = (x < 0), 32 elements per word, element 0 in the most
    significant bit, the tail zero-padded. -0.0 and NaN pack as 0, and so
    does a negative denormal: the TPU and XLA's CPU backend flush
    denormals to zero before they compare, so the bit is x <= -FLT_MIN.
  - ``onebit_unpack`` launches ``csrc/onebit_unpack.cu``, the port of
    ``_unpack_kernel`` (:48, wrapper ``onebit_unpack`` :86): element i is
    1 - 2·bit as f32, unscaled.

Both are bounded by device memory. The words live in an ``int32`` tensor
(the bits of the JAX package's ``uint32`` words, bit-cast): ``uint32``
tensors have too few operations in PyTorch for the plain versions and the
all-gather.

The parameter-server path's device encode (``compress/device.py``) runs
the other three, each byte-identical to the numpy codec of
``compress/wire.py`` for the same inputs:

  - ``int8_quantize`` launches ``csrc/int8_quantize.cu``, the port of
    ``_int8_q_kernel`` (pallas_kernels.py:120, wrapper ``int8_quantize``
    :139): q = clip(round-half-even(x / s), ±127) as int8, a correctly
    rounded division, s <= 0 taken as 1.0;
  - ``int8_dequantize`` launches ``csrc/int8_dequantize.cu``, the port of
    ``_int8_dq_kernel`` (:130, wrapper ``int8_dequantize`` :249):
    (float) q · s, one multiply;
  - ``fp8_sr_quantize`` launches ``csrc/fp8_sr_quantize.cu``, the port of
    ``_fp8_sr_kernel`` (:176, wrapper ``fp8_sr_quantize`` :219):
    ``fp8sr.sr_quantize_bits`` (stochastic rounding to fp8 E4M3 or E5M2
    bytes in uint32 bit math, the noise keyed by the element's flat index
    and the seed).

All five are bounded by device memory (fp8 SR's integer operations come
close). A wrapper takes its plain version only for a tensor on the CPU.
A CUDA tensor launches the kernel or raises. Each wrapper counts its
launches in a plain int attribute, ``launches``.

All five launch one wave of 16-byte accesses; ``stream_plan`` computes
where their vectors start and how many CTAs they take, here in Python,
where the CPU tests reach it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._build import device_type, entry, raise_on_error
from . import fp8sr

PACK = 32          # bits per word
# x < 0 with denormals flushed to zero, as the TPU and XLA's CPU compare
NEG_BOUND = -torch.finfo(torch.float32).tiny


def words_for(n: int) -> int:
    return (n + PACK - 1) // PACK


# ---------------------------------------------------------- launch plan

VEC_BYTES = 16          # one vector access: a float4
CTA_THREADS = 256       # kThreads of the one-wave codec kernels (csrc/)
CTAS_PER_SM = 4         # their kMinBlocks: resident CTAs a SM, one wave
QUANT_VECS = 4          # float4 loads an int8 quantize thread holds in flight
UNPACK_VECS = 8         # float4 stores an unpack thread issues (32 words a warp)
PACK_VECS = 8           # float4 loads a pack thread holds (32 words a warp)
DEQUANT_VECS = 8        # float4 stores a dequantize thread issues
PACK_SCALARS = 8        # 4-byte loads a thread of pack's view instance
FP8_VECS = 2            # float4 loads an fp8 SR thread holds in flight


class StreamPlan(NamedTuple):
    """How a streaming kernel covers [0, n): ``head`` elements one by one,
    then ``vecs`` 16-byte vectors from element ``head`` on, then ``tail``
    elements one by one; ``grid`` CTAs."""
    head: int
    vecs: int
    tail: int
    grid: int


def stream_plan(n: int, addr_mod_16: int, sms: int, elems_per_vec: int,
                vecs_per_thread: int) -> StreamPlan:
    """The launch plan of a kernel that streams ``n`` elements of
    ``VEC_BYTES // elems_per_vec`` bytes from an address ``addr_mod_16``
    past a 16-byte boundary: the head reaches the first boundary, every
    vector is aligned, the tail is what is left (each shorter than a
    vector). A CTA of ``CTA_THREADS`` takes ``CTA_THREADS ·
    vecs_per_thread`` vectors a pass; the grid is one wave at most
    (``sms · CTAS_PER_SM``), fewer when ``n`` needs fewer, and a larger
    ``n`` strides over it."""
    size = VEC_BYTES // elems_per_vec
    if n < 1 or addr_mod_16 % size or not 0 <= addr_mod_16 < VEC_BYTES:
        raise ValueError(f"no plan for {n} elements of {size} bytes at "
                         f"{addr_mod_16} past a 16-byte boundary")
    head = min(n, (VEC_BYTES - addr_mod_16) % VEC_BYTES // size)
    vecs = (n - head) // elems_per_vec
    chunk = CTA_THREADS * vecs_per_thread
    grid = max(1, min(sms * CTAS_PER_SM, -(-vecs // chunk)))
    return StreamPlan(head, vecs, n - head - vecs * elems_per_vec, grid)


def pack_plan(n: int, addr_mod_16: int, sms: int) -> StreamPlan:
    """The pack kernel's plan: ``stream_plan``'s head, vectors and tail,
    with a grid sized to the instance that runs. An aligned x takes the
    float4 instance, ``CTA_THREADS · 4 · PACK_VECS`` floats a CTA a pass
    (the n % 4 floats past the vectors in one more float4 slot); a view at
    a 4-byte offset takes the 4-byte-load instance, ``CTA_THREADS ·
    PACK_SCALARS`` floats a CTA a pass. One wave at most either way."""
    plan = stream_plan(n, addr_mod_16, sms, 4, PACK_VECS)
    per_cta = CTA_THREADS * (PACK_SCALARS if addr_mod_16 else 4 * PACK_VECS)
    return plan._replace(grid=max(1, min(sms * CTAS_PER_SM, -(-n // per_cta))))


def dequantize_reads_words(q_addr: int) -> bool:
    """Which instance of the dequantize kernel reads codes at the address
    ``q_addr``: True, the word instance (the four codes of a float4 in one
    4-byte load), where q is 4-byte aligned, as every q the device encode
    makes is; False, the byte instance (four 1-byte loads a float4), for
    a view ``q[k:]`` at any other offset. Both store float4s on the same
    plan. The wrapper passes the choice to the C entry, which refuses the
    word instance on a q that is not 4-byte aligned."""
    return q_addr % 4 == 0


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ------------------------------------------------------- plain versions

def onebit_pack_plain(x: torch.Tensor) -> torch.Tensor:
    """f32 [n] -> int32 [ceil(n / 32)], the pack kernel's function in
    plain PyTorch."""
    n = x.shape[0]
    pad = words_for(n) * PACK - n
    neg = torch.nn.functional.pad((x <= NEG_BOUND).to(torch.int64),
                                  (0, pad)).view(-1, PACK)
    shifts = torch.arange(PACK - 1, -1, -1, device=x.device)
    # disjoint bits: the sum is the bitwise OR, in [0, 2^32) as int64
    words = (neg << shifts).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def onebit_unpack_plain(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [m] -> f32 [n] of ±1.0 (bit 1 -> -1.0), the unpack kernel's
    function in plain PyTorch."""
    shifts = torch.arange(PACK - 1, -1, -1, dtype=torch.int32,
                          device=words.device)
    # arithmetic >> then & 1 extracts the bit whatever the sign bit
    bits = (words[:, None] >> shifts) & 1
    return (1.0 - 2.0 * bits.to(torch.float32)).reshape(-1)[:n]


# ------------------------------------------------------------- wrappers

def onebit_pack(x: torch.Tensor) -> torch.Tensor:
    """f32 [n] -> int32 words [ceil(n / 32)]. CUDA tensors launch
    ``csrc/onebit_pack.cu``; CPU tensors take ``onebit_pack_plain``."""
    if device_type(x, "onebit") == "cpu":
        return onebit_pack_plain(x)
    if x.dtype != torch.float32 or x.dim() != 1 or x.numel() == 0:
        raise TypeError(f"the onebit pack kernel takes a non-empty 1-D "
                        f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    words = torch.empty(words_for(x.numel()), dtype=torch.int32,
                        device=x.device)
    # a view at any 4-byte offset takes the kernel's 4-byte-load instance,
    # never a copy
    plan = pack_plan(x.numel(), x.data_ptr() % VEC_BYTES, _sms(x.device))
    with torch.cuda.device(x.device):
        code = entry("onebit_pack")(
            x.data_ptr(), words.data_ptr(), x.numel(), plan.head, plan.vecs,
            plan.grid, torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(code, "onebit pack kernel")
    onebit_pack.launches += 1
    return words


onebit_pack.launches = 0


def onebit_unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32 words [m] -> f32 [n] of ±1.0, n <= 32·m. CUDA tensors launch
    ``csrc/onebit_unpack.cu``; CPU tensors take ``onebit_unpack_plain``."""
    if device_type(words, "onebit") == "cpu":
        return onebit_unpack_plain(words, n)
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError(f"the onebit unpack kernel takes 1-D int32 words, "
                        f"got {words.dtype} {tuple(words.shape)}")
    if not 0 < n <= words.numel() * PACK:
        raise ValueError(f"{n} elements do not fit {words.numel()} words")
    words = words.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=words.device)
    if out.data_ptr() % VEC_BYTES:
        raise RuntimeError("the onebit unpack kernel writes 16-byte vectors "
                           "and torch.empty gave a misaligned output")
    plan = stream_plan(n, 0, _sms(out.device), 4, UNPACK_VECS)
    with torch.cuda.device(words.device):
        code = entry("onebit_unpack")(
            words.data_ptr(), out.data_ptr(), n, plan.vecs, plan.grid,
            torch.cuda.current_stream(words.device).cuda_stream)
    raise_on_error(code, "onebit unpack kernel")
    onebit_unpack.launches += 1
    return out


onebit_unpack.launches = 0


# ----------------------------------------------- int8 and fp8 quantizers

def check_quant_input(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    """Raise on what the quantize kernels do not take: they read one
    non-empty, contiguous 1-D tensor of ``dtype``."""
    if t.dtype != dtype or t.dim() != 1 or t.numel() == 0:
        raise TypeError(f"the {what} kernel takes a non-empty 1-D {dtype} "
                        f"tensor, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"the {what} kernel takes a contiguous tensor")


def _positive_scale(scale) -> np.float32:
    """The codec's zero-amax rule: a scale that is not > 0 is 1.0."""
    s = np.float32(scale)
    return s if s > 0 else np.float32(1.0)


def _scale_on(s, device) -> torch.Tensor:
    # a 0-dim tensor on x's device: dividing a CUDA tensor by a CPU scalar
    # takes a reciprocal multiply, which is not the codec's division
    return torch.tensor(np.float32(s), dtype=torch.float32, device=device)


def int8_quantize_plain(x: torch.Tensor, scale) -> torch.Tensor:
    """f32 [n] -> int8 [n] = clip(round-half-even(x / s), ±127), s <= 0
    taken as 1.0; true division."""
    y = torch.div(x, _scale_on(_positive_scale(scale), x.device),
                  rounding_mode=None)
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def int8_dequantize_plain(q: torch.Tensor, scale) -> torch.Tensor:
    """int8 [n] -> f32 [n] = q · s."""
    return q.to(torch.float32) * _scale_on(scale, q.device)


_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a · c mod 2^32 for int64 a in [0, 2^32) and c < 2^32, split in
    16-bit halves so that no int64 product overflows."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32_plain(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """``fp8sr.mix32`` on int64 tensors holding uint32 values."""
    h = _mul32(idx, 0x9E3779B9) ^ (int(seed) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fp8_sr_quantize_plain(x: torch.Tensor, scale, seed: int,
                          kind: int) -> torch.Tensor:
    """f32 [n] -> uint8 [n] fp8 bytes, ``fp8sr.sr_quantize_bits`` in plain
    PyTorch: uint32 arithmetic in int64 tensors, masked to 32 bits."""
    mx, _, base, emin, e_sub, qbits = fp8sr.fmt_params(kind)
    y = torch.div(x, _scale_on(_positive_scale(scale), x.device),
                  rounding_mode=None)
    y = torch.clamp(y, -mx, mx)
    bits = y.view(torch.int32).to(torch.int64) & _M32
    sign = bits >> 31
    mag = bits & 0x7FFFFFFF
    e = mag >> 23
    h = _mix32_plain(torch.arange(x.numel(), dtype=torch.int64,
                                  device=x.device), seed)
    d = torch.clamp((emin + base) - e, base, 23)
    mask = (torch.ones_like(d) << d) - 1
    mag_grid = (mag + (h & mask)) & ~mask
    tiny = e < e_sub
    u24 = (h >> 8).to(torch.float32) * (2.0 ** -24)
    t = torch.abs(y) * float(2.0 ** (127 - e_sub))
    zero = torch.zeros_like(mag)
    mag_tiny = torch.where(u24 < t, torch.full_like(mag, int(qbits)), zero)
    mag2 = torch.where(tiny, mag_tiny, mag_grid)
    mag2 = torch.where(mag == 0, zero, mag2)
    e2 = mag2 >> 23
    f2 = mag2 & 0x7FFFFF
    norm = ((e2 - (emin - 1)) << (23 - base)) | (f2 >> base)
    sub = ((1 << 23) | f2) >> torch.clamp((emin + base) - e2, 0, 31)
    out = torch.where(e2 >= emin, norm, sub)
    out = torch.where(mag2 == 0, zero, out)
    return ((sign << 7) | out).to(torch.uint8)


def int8_quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """f32 [n] -> int8 [n] at ``scale``. CUDA tensors launch
    ``csrc/int8_quantize.cu``; CPU tensors take ``int8_quantize_plain``."""
    if device_type(x, "int8 quantize") == "cpu":
        return int8_quantize_plain(x, scale)
    check_quant_input(x, torch.float32, "int8 quantize")
    q = torch.empty(x.numel(), dtype=torch.int8, device=x.device)
    # x may be a view at any 4-byte offset: the plan peels a head
    plan = stream_plan(x.numel(), x.data_ptr() % VEC_BYTES, _sms(x.device),
                       4, QUANT_VECS)
    with torch.cuda.device(x.device):
        code = entry("int8_quantize")(
            x.data_ptr(), q.data_ptr(), x.numel(), plan.head, plan.vecs,
            plan.grid, float(_positive_scale(scale)),
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(code, "int8 quantize kernel")
    int8_quantize.launches += 1
    return q


int8_quantize.launches = 0


def int8_dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """int8 [n] -> f32 [n] = q · scale. CUDA tensors launch
    ``csrc/int8_dequantize.cu``; CPU tensors take
    ``int8_dequantize_plain``."""
    if device_type(q, "int8 dequantize") == "cpu":
        return int8_dequantize_plain(q, scale)
    check_quant_input(q, torch.int8, "int8 dequantize")
    out = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
    if out.data_ptr() % VEC_BYTES:
        raise RuntimeError("the int8 dequantize kernel writes 16-byte "
                           "vectors and torch.empty gave a misaligned output")
    # the float4s are the output's; q may be a view at any byte offset,
    # never copied
    plan = stream_plan(q.numel(), 0, _sms(out.device), 4, DEQUANT_VECS)
    with torch.cuda.device(q.device):
        code = entry("int8_dequantize")(
            q.data_ptr(), out.data_ptr(), q.numel(), plan.vecs, plan.grid,
            int(dequantize_reads_words(q.data_ptr())),
            float(np.float32(scale)),
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(code, "int8 dequantize kernel")
    int8_dequantize.launches += 1
    return out


int8_dequantize.launches = 0


def fp8_sr_quantize(x: torch.Tensor, scale, seed: int,
                    kind: int) -> torch.Tensor:
    """f32 [n] -> uint8 [n] fp8 ``kind`` bytes (``fp8sr.E4M3`` or
    ``E5M2``) at ``scale``, noise seeded by ``seed``. CUDA tensors launch
    ``csrc/fp8_sr_quantize.cu``; CPU tensors take
    ``fp8_sr_quantize_plain``."""
    if kind not in (fp8sr.E4M3, fp8sr.E5M2):
        raise ValueError(f"unknown fp8 kind {kind}")
    if device_type(x, "fp8 quantize") == "cpu":
        return fp8_sr_quantize_plain(x, scale, seed, kind)
    check_quant_input(x, torch.float32, "fp8 quantize")
    q = torch.empty(x.numel(), dtype=torch.uint8, device=x.device)
    # x may be a view at any 4-byte offset: the plan peels a head
    plan = stream_plan(x.numel(), x.data_ptr() % VEC_BYTES, _sms(x.device),
                       4, FP8_VECS)
    with torch.cuda.device(x.device):
        code = entry("fp8_sr_quantize")(
            x.data_ptr(), q.data_ptr(), x.numel(), plan.head, plan.vecs,
            plan.grid, float(_positive_scale(scale)), int(seed) & _M32,
            kind, torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(code, "fp8 quantize kernel")
    fp8_sr_quantize.launches += 1
    return q


fp8_sr_quantize.launches = 0
