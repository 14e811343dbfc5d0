"""Flash attention for the port: hand-written Hopper kernels (forward,
fused backward, split backward) behind a ``torch.autograd.Function``.

Counterpart of ``byteps_tpu/ops/flash_attention.py``. Layout contract as
there: [batch, seq, heads, head_dim] in, same out, lse [batch, heads, seq]
in fp32.

Kernels (CUDA C++ for sm_90a, ``csrc/``, built at first use by
``ops/_build.py``):

  - ``flash_fwd`` launches ``csrc/flash_fwd.cu``, the port of the Pallas
    ``_fwd_kernel`` (flash_attention.py:172, wrapper ``_flash_fwd`` :248):
    online-softmax forward, S and P never leave the chip. Bounded by
    memory on an H100 at the flagship's seq 512 / d 64.
  - ``flash_bwd_fused`` launches ``csrc/flash_bwd.cu``, the port of the
    Pallas ``_dqkv_fused_kernel`` (:489, wrapper ``_flash_bwd_fused``
    :548): (q, k, v, dO, lse) -> (dq, dk, dv) with delta computed from
    P∘dP, so ``out`` is no input. Bounded by tensor-core throughput. Two
    launches behind the one wrapper, because delta and dk/dv reduce
    across tiles that Hopper CTAs cannot share (see the source).
  - ``flash_bwd_dq`` launches ``csrc/flash_dq.cu`` and ``flash_bwd_dkv``
    ``csrc/flash_dkv.cu``, the ports of the Pallas ``_dq_kernel`` (:335)
    and ``_dkv_kernel`` (:421), the split backward of ``_flash_bwd``
    (:579): delta = rowsum(dO∘out) is an input, taken by the caller from
    the forward's bf16 output. Both bounded by tensor-core throughput.

Which backward runs follows the JAX package exactly (``backward_route``):
the fused one when the whole sequence is one block each way (blocks of
512 shrunk to the sequence, ``BPS_FLASH_BQ`` / ``BPS_FLASH_BK``
overriding), unless ``BPS_FLASH_FUSED_BWD=0``; the split one otherwise.
The two are different functions in bf16 (the fused delta is rowsum(P∘dP),
the split one rowsum(dO∘out) with ``out`` already rounded), so parity with
the JAX package needs the same route at the same shapes. The Hopper
kernels themselves walk 64-row tiles whatever the block.

Each wrapper keeps its plain PyTorch version beside it, with the same
inputs and outputs, and takes it only for tensors on the CPU. A CUDA
tensor launches the kernel or raises: inputs the kernels do not take
(fp32, a bias, a rel table, d other than 64, a sequence not a multiple of
64) are refused by ``check_kernel_inputs`` with the name of the Pallas
kernel still to port. Each wrapper counts its launches in a plain int
attribute, ``launches``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..parallel.ring import local_attention
from ._build import device_type, entry, raise_on_error

_NEG_INF = -1e30
KERNEL_D = 64          # head dim the kernels are built for
KERNEL_TILE = 64       # sequence tile of the kernels
BLOCK = 512            # the JAX package's default block each way


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril()


# ------------------------------------------------- route (the JAX blocks)

def pick_block(s: int, want: int) -> int:
    """The JAX package's ``_pick_block``: the first of (want, 512, 256,
    128) that is at most ``want`` and divides ``s``, else ``s``."""
    for b in (want, 512, 256, 128):
        if b <= want and s % b == 0:
            return b
    return s


def resolve_blocks(sq: int, sk: int, block_q: int = BLOCK,
                   block_k: int = BLOCK) -> Tuple[int, int]:
    """The JAX package's ``_resolve``: ``BPS_FLASH_BQ`` / ``BPS_FLASH_BK``
    override the requested blocks, which then shrink to the sequence."""
    env_q = int(os.environ.get("BPS_FLASH_BQ", "0"))
    env_k = int(os.environ.get("BPS_FLASH_BK", "0"))
    if env_q:
        block_q = env_q
    if env_k:
        block_k = env_k
    return pick_block(sq, min(block_q, sq)), pick_block(sk, min(block_k, sk))


def backward_route(sq: int, sk: int, block_q: int = BLOCK,
                   block_k: int = BLOCK) -> str:
    """"fused" where the JAX ``_flash_bwd`` takes ``_dqkv_fused_kernel``
    (one block each way, no bias, ``BPS_FLASH_FUSED_BWD`` not "0"), else
    "split" (``_dq_kernel`` then ``_dkv_kernel``)."""
    bq, bk = resolve_blocks(sq, sk, block_q, block_k)
    if (sq // bq == 1 and sk // bk == 1
            and os.environ.get("BPS_FLASH_FUSED_BWD", "1") != "0"):
        return "fused"
    return "split"


# ------------------------------------------------------- plain versions

def flash_fwd_plain(q, k, v, causal: bool = False,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: (out, lse).

    Products in fp32 from the inputs' values; P cast to v's dtype before
    P·V; out = acc / max(l, 1e-30), lse = m + log(l)."""
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device),
                          _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)          # [b, h, q, 1]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l.transpose(1, 2)
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_dp(q, k, v, do, lse, causal, scale):
    """P = exp(S - lse) (0 where causally masked) and dP = dO·Vᵀ, fp32,
    [b, h, sq, sk]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device),
                          0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, dp


def flash_bwd_fused_plain(q, k, v, do, lse, causal: bool = False,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward kernel's function in plain PyTorch:
    (q, k, v, dO, lse) -> (dq, dk, dv), no ``out`` input."""
    scale = _scale(q, scale)
    p, dp = _probs_and_dp(q, k, v, do, lse, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_delta(do, out) -> torch.Tensor:
    """The split backward's delta, rowsum(dO∘out) in fp32 from the
    forward's output as stored: [b, s, h, d] -> [b, h, s]. A plain
    expression outside any kernel, as ``_flash_bwd`` takes it."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = False,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The dq kernel's function in plain PyTorch: dS = P∘(dP - delta)
    rounded to q's dtype, dq = dS·K·scale."""
    scale = _scale(q, scale)
    p, dp = _probs_and_dp(q, k, v, do, lse, causal, scale)
    ds = (p * (dp - delta.float()[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain PyTorch: dv = P̂ᵀ·dO with P
    rounded to dO's dtype, dk = dSᵀ·Q·scale."""
    scale = _scale(q, scale)
    p, dp = _probs_and_dp(q, k, v, do, lse, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    ds = (p * (dp - delta.float()[..., None])).to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------- input contract

def check_kernel_inputs(q, k, v, causal: bool = False, bias=None,
                        rel_table=None) -> None:
    """Refuse what the Hopper kernels do not take; called by the CUDA
    branch of each wrapper before it launches. Never a fallback."""
    if bias is not None:
        raise NotImplementedError(
            "flash attention with an additive bias needs the bias forms of "
            "_fwd_kernel and of the split backward (_dq_kernel, "
            "_dkv_kernel), not ported yet (ROADMAP.md); use impl='naive'")
    if rel_table is not None:
        raise NotImplementedError(
            "flash attention with a T5 rel_table needs the in-kernel "
            "rel-bias forms of _fwd_kernel / _dq_kernel / _dkv_kernel, not "
            "ported yet (ROADMAP.md)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"the Hopper flash kernels take bfloat16; {name} is "
                f"{t.dtype} (the fp32 forms of _fwd_kernel / "
                "_dqkv_fused_kernel / _dq_kernel / _dkv_kernel are not "
                "ported)")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [b, s, h, d], got {tuple(t.shape)}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not agree")
    if d != KERNEL_D:
        raise NotImplementedError(
            f"head_dim {d}: the Hopper flash kernels are built for "
            f"d = {KERNEL_D}; other widths of _fwd_kernel / "
            "_dqkv_fused_kernel are not ported (ROADMAP.md)")
    if sq % KERNEL_TILE or sk % KERNEL_TILE:
        raise ValueError(f"sequence lengths {sq}, {sk} must be multiples of "
                         f"{KERNEL_TILE} for the Hopper flash kernels")
    if causal and sq != sk:
        raise ValueError(
            "causal masking requires equal q/kv lengths (got "
            f"{sq} vs {sk}); cross-attention is bidirectional")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"q, k, v on different devices: {devs}")


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it in place (head stride d,
    unit last stride, 16-byte aligned rows), else a contiguous copy."""
    d = t.shape[-1]
    if (t.stride(3) == 1 and t.stride(2) == d and t.stride(1) % 8 == 0
            and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


# ------------------------------------------------------------- wrappers

def flash_fwd(q, k, v, causal: bool = False, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b,sq,h,d], k/v [b,sk,h,d] -> (out [b,sq,h,d], lse [b,h,sq] fp32).
    CUDA tensors launch ``csrc/flash_fwd.cu``; CPU tensors take
    ``flash_fwd_plain``."""
    if device_type(q, "flash attention") == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    check_kernel_inputs(q, k, v, causal)
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = entry("flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            _scale(q, scale), int(causal), stream)
    raise_on_error(code, "flash forward kernel")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _check_bwd_inputs(q, k, v, do, lse, delta=None) -> None:
    """What every backward kernel takes besides ``check_kernel_inputs``:
    dO like q, lse (and delta) fp32 [b, h, sq]."""
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    b, sq, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32
                              or t.shape != (b, h, sq)):
            raise ValueError(f"{name} must be fp32 [b, h, sq] = "
                             f"{(b, h, sq)}, got {t.dtype} {tuple(t.shape)}")


def _empty(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of ``t``'s shape: the kernels write outputs
    densely (``empty_like`` would copy a view's gaps)."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _bwd_args(q, k, v, do, scale, causal):
    """The trailing arguments every backward entry point shares."""
    b, sq, h, d = q.shape
    return (b, h, sq, k.shape[1], d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), do.stride(0), do.stride(1),
            _scale(q, scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_bwd_fused(q, k, v, do, lse, causal: bool = False,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v, dO, lse) -> (dq, dk, dv). CUDA tensors launch
    ``csrc/flash_bwd.cu``; CPU tensors take ``flash_bwd_fused_plain``."""
    if device_type(q, "flash attention") == "cpu":
        return flash_bwd_fused_plain(q, k, v, do, lse, causal, scale)
    check_kernel_inputs(q, k, v, causal)
    _check_bwd_inputs(q, k, v, do, lse)
    q, k, v, do = (_kernel_layout(t) for t in (q, k, v, do))
    lse = lse.contiguous()
    dq, dk, dv = _empty(q), _empty(k), _empty(v)
    delta = _empty(lse)
    with torch.cuda.device(q.device):
        code = entry("flash_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_bwd_args(q, k, v, do, scale, causal))
    raise_on_error(code, "flash fused backward kernel")
    flash_bwd_fused.launches += 1
    return dq, dk, dv


flash_bwd_fused.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                 scale: Optional[float] = None) -> torch.Tensor:
    """The split backward's dq: (q, k, v, dO, lse, delta) -> dq. CUDA
    tensors launch ``csrc/flash_dq.cu``; CPU tensors take
    ``flash_bwd_dq_plain``."""
    if device_type(q, "flash attention") == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    check_kernel_inputs(q, k, v, causal)
    _check_bwd_inputs(q, k, v, do, lse, delta)
    q, k, v, do = (_kernel_layout(t) for t in (q, k, v, do))
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = _empty(q)
    with torch.cuda.device(q.device):
        code = entry("flash_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_bwd_args(q, k, v, do, scale, causal))
    raise_on_error(code, "flash dq kernel")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split backward's dk and dv: (q, k, v, dO, lse, delta) ->
    (dk, dv). CUDA tensors launch ``csrc/flash_dkv.cu``; CPU tensors take
    ``flash_bwd_dkv_plain``."""
    if device_type(q, "flash attention") == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    check_kernel_inputs(q, k, v, causal)
    _check_bwd_inputs(q, k, v, do, lse, delta)
    q, k, v, do = (_kernel_layout(t) for t in (q, k, v, do))
    lse, delta = lse.contiguous(), delta.contiguous()
    dk, dv = _empty(k), _empty(v)
    with torch.cuda.device(q.device):
        code = entry("flash_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_args(q, k, v, do, scale, causal))
    raise_on_error(code, "flash dk/dv kernel")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


# ------------------------------------------------------------ public API

class _FlashAttention(torch.autograd.Function):
    """On the fused route the forward saves (q, k, v, lse) — not ``out``:
    the fused backward computes delta from P∘dP, so under remat the
    recompute's output is needed only by the layers after attention. On
    the split route it also saves ``out``, whose rowsum with dO is the
    delta the split kernels read."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, fused):
        out, lse = flash_fwd(q, k, v, causal, scale)
        if fused:
            ctx.save_for_backward(q, k, v, lse)
        else:
            ctx.save_for_backward(q, k, v, lse, out)
        ctx.causal, ctx.scale, ctx.fused = causal, scale, fused
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, *out = ctx.saved_tensors
        do = dout.to(q.dtype)
        if ctx.fused:
            dq, dk, dv = flash_bwd_fused(q, k, v, do, lse, ctx.causal,
                                         ctx.scale)
        else:
            delta = bwd_delta(do, out[0])
            dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                                   ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, bias=None,
                    rel_table=None, block_q: int = BLOCK,
                    block_k: int = BLOCK):
    """Differentiable flash attention: q [b, sq, h, d], k/v [b, sk, h, d]
    -> [b, sq, h, d]. ``block_q`` / ``block_k`` are the JAX package's
    blocks: they choose the backward route (``backward_route``), as
    there. The bias and rel-table forms are not ported."""
    if bias is not None or rel_table is not None:
        check_kernel_inputs(q, k, v, causal, bias, rel_table)
    fused = backward_route(q.shape[1], k.shape[1], block_q,
                           block_k) == "fused"
    return _FlashAttention.apply(q, k, v, causal, scale, fused)


def attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
              impl: str = "auto", bias=None, rel_table=None):
    """Dispatcher the models call.

    impl: "auto" | "flash" -> ``flash_attention`` (the Hopper kernels on
    the card, their plain versions on the CPU; refused inputs raise);
    "naive" -> ``parallel.ring.local_attention``, the plain O(s²) oracle,
    only when asked for; "hybrid" is not ported."""
    if impl not in ("auto", "flash", "hybrid", "naive"):
        raise ValueError(
            f"attn impl must be auto|flash|hybrid|naive, got {impl!r}")
    if impl == "hybrid":
        raise NotImplementedError(
            "impl='hybrid' (library forward + flash backward) is not "
            "ported (ROADMAP.md)")
    if impl == "naive":
        if rel_table is not None:
            raise NotImplementedError(
                "the T5 rel-table bias (ops/relpos.py) is not ported "
                "(ROADMAP.md)")
        return local_attention(q, k, v, causal=causal, scale=scale,
                               bias=bias)
    return flash_attention(q, k, v, causal=causal, scale=scale, bias=bias,
                           rel_table=rel_table)
