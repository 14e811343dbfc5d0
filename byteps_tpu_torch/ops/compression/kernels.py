"""Onebit pack and unpack for the port: hand-written Hopper kernels and
their plain PyTorch versions (counterpart of
``byteps_tpu/ops/compression/pallas_kernels.py``, its onebit half).

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

A wrapper takes its plain version only for a tensor on the CPU. A CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
a plain int attribute, ``launches``. The int8 and fp8 kernels of the same
Pallas module serve the parameter-server path and are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import torch

from .._build import device_type, entry, raise_on_error

PACK = 32          # bits per word
# x < 0 with denormals flushed to zero, as the TPU and XLA's CPU compare
NEG_BOUND = -torch.finfo(torch.float32).tiny


def words_for(n: int) -> int:
    return (n + PACK - 1) // PACK


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
    with torch.cuda.device(x.device):
        code = entry("onebit_pack")(
            x.data_ptr(), words.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
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
    with torch.cuda.device(words.device):
        code = entry("onebit_unpack")(
            words.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(words.device).cuda_stream)
    raise_on_error(code, "onebit unpack kernel")
    onebit_unpack.launches += 1
    return out


onebit_unpack.launches = 0
