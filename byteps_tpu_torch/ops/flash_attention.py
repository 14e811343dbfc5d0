"""Flash attention for the port: hand-written Hopper kernels (forward +
fused backward) behind a ``torch.autograd.Function``.

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

Each wrapper keeps its plain PyTorch version beside it, with the same
inputs and outputs, and takes it only for tensors on the CPU. A CUDA
tensor launches the kernel or raises: inputs the kernels do not take
(fp32, a bias, a rel table, a sequence longer than one 512 block, d other
than 64) are refused by ``check_kernel_inputs`` with the name of the
Pallas kernel still to port. Each wrapper counts its launches in a plain
int attribute, ``launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.ring import local_attention

_NEG_INF = -1e30
KERNEL_D = 64          # head dim the kernels are built for
KERNEL_TILE = 64       # sequence tile of the kernels
MAX_SEQ = 512          # one block: longer needs the split backward


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril()


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


def flash_bwd_fused_plain(q, k, v, do, lse, causal: bool = False,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward kernel's function in plain PyTorch:
    (q, k, v, dO, lse) -> (dq, dk, dv), no ``out`` input."""
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device),
                          0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
                "_dqkv_fused_kernel are not ported)")
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
    if sq > MAX_SEQ or sk > MAX_SEQ:
        raise NotImplementedError(
            f"sequence {sq}x{sk} spans more than one {MAX_SEQ} block: that "
            "needs the split backward (_dq_kernel, _dkv_kernel), not ported "
            "yet (ROADMAP.md)")
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


def _on_device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no flash attention path for {t.device}")
    return t.device.type


def _raise_on_error(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {code}")


# ------------------------------------------------------------- wrappers

def flash_fwd(q, k, v, causal: bool = False, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b,sq,h,d], k/v [b,sk,h,d] -> (out [b,sq,h,d], lse [b,h,sq] fp32).
    CUDA tensors launch ``csrc/flash_fwd.cu``; CPU tensors take
    ``flash_fwd_plain``."""
    if _on_device(q) == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    check_kernel_inputs(q, k, v, causal)
    from ._build import entry
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
    _raise_on_error(code, "flash forward kernel")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd_fused(q, k, v, do, lse, causal: bool = False,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v, dO, lse) -> (dq, dk, dv). CUDA tensors launch
    ``csrc/flash_bwd.cu``; CPU tensors take ``flash_bwd_fused_plain``."""
    if _on_device(q) == "cpu":
        return flash_bwd_fused_plain(q, k, v, do, lse, causal, scale)
    check_kernel_inputs(q, k, v, causal)
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq):
        raise ValueError(f"lse must be fp32 [b, h, sq] = {(b, h, sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    from ._build import entry
    q, k, v, do = (_kernel_layout(t) for t in (q, k, v, do))
    lse = lse.contiguous()
    dq = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    dk = torch.empty(b, sk, h, d, dtype=k.dtype, device=q.device)
    dv = torch.empty(b, sk, h, d, dtype=v.dtype, device=q.device)
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = entry("flash_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, sq, sk, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), do.stride(0), do.stride(1),
            _scale(q, scale), int(causal), stream)
    _raise_on_error(code, "flash fused backward kernel")
    flash_bwd_fused.launches += 1
    return dq, dk, dv


flash_bwd_fused.launches = 0


# ------------------------------------------------------------ public API

class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, lse) — not ``out``: the fused backward
    computes delta from P∘dP, so under remat the recompute's output is
    needed only by the layers after attention."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_fused(q, k, v, dout.to(q.dtype), lse,
                                     ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, bias=None,
                    rel_table=None):
    """Differentiable flash attention: q [b, sq, h, d], k/v [b, sk, h, d]
    -> [b, sq, h, d]. The bias and rel-table forms are not ported."""
    if bias is not None or rel_table is not None:
        check_kernel_inputs(q, k, v, causal, bias, rel_table)
    return _FlashAttention.apply(q, k, v, causal, scale)


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
