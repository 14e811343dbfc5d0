"""Ring attention: sequence parallelism over a ``torch.distributed`` ring
(the port's counterpart of ``byteps_tpu/parallel/ring.py``).

Each rank of the ``seq`` mesh axis holds one contiguous shard of the
sequence (rank i: positions [i·s, (i+1)·s)). It computes attention for its
query shard while the k/v shards travel round the ring: at step t it holds
the shard of rank (i - t) mod sp, sent on to rank i + 1 while it computes
(the JAX ``_ring_perm``; ``dist.batch_isend_irecv`` over the axis group).
A ring of one does no communication.

Two implementations behind ``ring_attention``:

  - **flash ring** (CUDA tensors by default): each step runs the flash
    forward on (local q, k/v block) with an fp32 partial output (the
    kernel's ``out_dtype=float32`` form), and the partials are merged by
    log-sum-exp in fp32 (``_combine``). The backward, a
    ``torch.autograd.Function``, hoists one global delta = rowsum(dO∘out)
    and rotates k, v and their fp32 dk/dv accumulators round the ring
    again, running each block's flash backward with the FINAL lse: p =
    exp(s - lse) is then the exact global softmax probability, so the
    per-block (dq, dk, dv) just sum. A block takes the fused backward with
    delta given when a shard is one 512-block, split dq + dk/dv with delta
    beyond (the JAX ``_flash_bwd`` route at the ring's blocks). On the CPU
    the kernels' plain versions run.
  - **naive ring** (the CPU default): the same online softmax with
    materialized [b, h, s, s] score blocks, differentiated by autograd
    through a rotation whose backward rotates the other way.

Under causal masking, a block above the diagonal (kv rank > rank) is
hidden: the flash ring skips its launch and its combine (combining zeros
at lse -1e30 would leave ``o`` and ``lse`` bit-identical), so a rank
launches (rank + 1) forwards and backwards per call, sp on the last rank.

Layout: q/k/v and the output are [b, s, h, d] as in the JAX ring; the
kernels read them as such, and lse is [b, h, s] (broadcast against ``o``
as [b, s, h, 1]).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Ring, axis_ring

_NEG = -1e30
HIDDEN, DIAGONAL, VISIBLE = 0, 1, 2     # a block's case under causal masking


# ------------------------------------------------------------- exchange

class _Pending:
    """Receives in flight; ``wait`` returns the received tensors."""

    def __init__(self, works, outs, keep):
        self._works, self._outs, self._keep = works, outs, keep

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._keep = None
        return self._outs


def start_rotate(tensors: Sequence[torch.Tensor], ring: Ring,
                 shift: int = 1) -> _Pending:
    """Send each tensor to the rank ``shift`` ahead on the ring and
    receive the same shapes from the rank ``shift`` behind; ``wait()``
    the result. Every rank of the ring must call it alike."""
    if ring.size == 1:
        return _Pending((), list(tensors), None)
    dst = dist.get_global_rank(ring.group, (ring.index + shift) % ring.size)
    src = dist.get_global_rank(ring.group, (ring.index - shift) % ring.size)
    sends = [t.contiguous() for t in tensors]     # P2P needs dense buffers
    outs = [torch.empty_like(t) for t in sends]
    ops = []
    for tag, (t, o) in enumerate(zip(sends, outs)):
        ops.append(dist.P2POp(dist.isend, t, dst, ring.group, tag))
        ops.append(dist.P2POp(dist.irecv, o, src, ring.group, tag))
    return _Pending(dist.batch_isend_irecv(ops), outs, sends)


def rotate(tensors: Sequence[torch.Tensor], ring: Ring,
           shift: int = 1) -> List[torch.Tensor]:
    return start_rotate(tensors, ring, shift).wait()


class _Rotate(torch.autograd.Function):
    """``rotate`` with a gradient: the backward rotates the other way
    (the transpose of the JAX ``ppermute``)."""

    @staticmethod
    def forward(ctx, ring, shift, *xs):
        ctx.ring, ctx.shift = ring, shift
        return tuple(rotate(xs, ring, shift))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *rotate(gs, ctx.ring, -ctx.shift))


class _SeqSum(torch.autograd.Function):
    """Sum over the ring's ranks. Every rank then holds the same global
    value, and the backward is the identity: d(global)/d(local part) is 1.
    The parameter gradients of each rank are its share of the global
    loss's, and ``ShardedTrainer`` sums them over the ring. (The JAX
    psum transposes to a psum, which makes every gradient sp times too
    large, and its trainer divides by sp; the two give the same
    update.)"""

    @staticmethod
    def forward(ctx, ring, x):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=ring.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return None, g


def seq_sum(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    return x if ring.size == 1 else _SeqSum.apply(ring, x)


# ---------------------------------------------------------- naive ring

def _block_attn(q, k, v, mask, scale):
    """One block: (unnormalized out [b, s, h, d], row max and row sum
    [b, h, s, 1]), all fp32; P cast to v's dtype before P·V."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    # the max only shifts the exponent: out is invariant to it
    m = s.amax(-1, keepdim=True).clamp_min(_NEG).detach()
    p = torch.exp(s - m)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m, p.sum(-1, keepdim=True)


def _ring_naive(q, k, v, ring: Ring, causal: bool, scale: float):
    sp, idx = ring.size, ring.index
    b, s, h, d = q.shape
    o = torch.zeros(b, s, h, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s, 1), float("-inf"), device=q.device)
    l = torch.zeros(b, h, s, 1, device=q.device)
    pos = torch.arange(s, device=q.device)
    k_blk, v_blk = k, v
    for step in range(sp):
        kv_rank = (idx - step) % sp
        mask = None
        if causal:      # global positions of the q and k shards
            mask = (idx * s + pos[:, None]) >= (kv_rank * s + pos[None, :])
        o_b, m_b, l_b = _block_attn(q, k_blk, v_blk, mask, scale)
        new_m = torch.maximum(m, m_b)
        alpha, beta = torch.exp(m - new_m), torch.exp(m_b - new_m)
        l = l * alpha + l_b * beta
        o = o * alpha.transpose(1, 2) + o_b * beta.transpose(1, 2)
        m = new_m
        if step < sp - 1:
            k_blk, v_blk = _Rotate.apply(ring, 1, k_blk, v_blk)
    return (o / l.transpose(1, 2).clamp_min(1e-30)).to(q.dtype)


# ---------------------------------------------------------- flash ring

def blk_case(causal: bool, idx: int, kv_rank: int) -> int:
    """The JAX ``_blk_cases``: HIDDEN (a future shard), DIAGONAL or
    VISIBLE; every block is VISIBLE without causal masking."""
    if not causal:
        return VISIBLE
    return HIDDEN if kv_rank > idx else (DIAGONAL if kv_rank == idx
                                         else VISIBLE)


def flash_blk_fwd(q, k, v, case: int, scale: float):
    """One ring step's flash forward on [b, s, h, d] blocks: the
    normalized partial out in fp32 (one bf16 rounding per ring step
    would pile up in the merge) and lse [b, h, s]. Not for HIDDEN."""
    from ..ops import flash_attention as fa
    return fa.flash_fwd(q, k, v, case == DIAGONAL, scale,
                        out_dtype=torch.float32)


def combine(o, lse, o_b, lse_b):
    """Merge two normalized partials (o [b, s, h, d] fp32, lse [b, h, s]
    fp32) by log-sum-exp. Against the start (0, -1e30) the weight of the
    start underflows to exactly 0 and the block's partial comes back
    unchanged."""
    m = torch.maximum(lse, lse_b)
    new = m + torch.log(torch.exp(lse - m) + torch.exp(lse_b - m))

    def w(x):                               # [b, h, s] -> [b, s, h, 1]
        return torch.exp(x - new).transpose(1, 2)[..., None]
    return o * w(lse) + o_b * w(lse_b), new


def blk_route(s: int) -> str:
    """The backward a ring block takes: "fused" (delta given) when the
    shard is one block at the JAX ring's ``_pick_block(s, 512)``, else
    "split" (``_flash_bwd`` with delta, at blocks the ring passes
    explicitly: no ``BPS_FLASH_BQ/BK`` override)."""
    from ..ops.flash_attention import BLOCK, pick_block
    if (pick_block(s, BLOCK) == s
            and os.environ.get("BPS_FLASH_FUSED_BWD", "1") != "0"):
        return "fused"
    return "split"


def flash_blk_bwd(q, k, v, do, lse, delta, case: int, scale: float):
    """One ring step's flash backward with the final lse and the global
    delta: (dq, dk, dv) in the inputs' dtype. Not for HIDDEN."""
    from ..ops import flash_attention as fa
    causal = case == DIAGONAL
    if blk_route(q.shape[1]) == "fused":
        return fa.flash_bwd_fused(q, k, v, do, lse, causal, scale,
                                  delta=delta)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    return (dq, *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale))


def _ring_flash_fwd(q, k, v, ring: Ring, causal: bool, scale: float):
    """(o [b, s, h, d] fp32, lse [b, h, s]); the next k/v shard is in
    flight while a block computes."""
    sp, idx = ring.size, ring.index
    b, s, h, d = q.shape
    o = torch.zeros(b, s, h, d, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s), _NEG, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for step in range(sp):
        nxt = start_rotate((k_blk, v_blk), ring) if step < sp - 1 else None
        case = blk_case(causal, idx, (idx - step) % sp)
        if case != HIDDEN:
            o, lse = combine(o, lse, *flash_blk_fwd(q, k_blk, v_blk, case,
                                                    scale))
        if nxt is not None:
            k_blk, v_blk = nxt.wait()
    return o, lse


class _RingFlash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale):
        o, lse = _ring_flash_fwd(q, k, v, ring, causal, scale)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        from ..ops.flash_attention import bwd_delta
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.ring
        sp, idx = ring.size, ring.index
        do = g.to(q.dtype)
        delta = bwd_delta(do, out)          # hoisted: one for every block
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        k_blk, v_blk = k, v
        for step in range(sp):
            case = blk_case(ctx.causal, idx, (idx - step) % sp)
            if case != HIDDEN:
                dq_b, dk_b, dv_b = flash_blk_bwd(q, k_blk, v_blk, do, lse,
                                                 delta, case, ctx.scale)
                dq += dq_b.float()
                dk += dk_b.float()
                dv += dv_b.float()
            # the accumulators travel with their k/v shard; the last
            # rotation brings each rank's dk/dv home
            if step < sp - 1:
                k_blk, v_blk, dk, dv = rotate((k_blk, v_blk, dk, dv), ring)
            else:
                dk, dv = rotate((dk, dv), ring)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


# ------------------------------------------------------------- public API

def ring_attention(q, k, v, axis: str, causal: bool = False,
                   scale: Optional[float] = None, impl: str = "auto"):
    """Attention over sequence shards: q, k, v [b, s_local, h, d] on each
    rank of the current mesh's ``axis``; causal masking follows the
    global order. impl: "auto" (the flash ring for CUDA tensors, the
    naive ring on the CPU) | "flash" | "naive". On the card the flash
    ring launches the kernels or raises (``check_kernel_inputs``).
    Returns the local output shard [b, s_local, h, d]."""
    if impl not in ("auto", "flash", "naive"):
        raise ValueError(f"impl must be auto|flash|naive, got {impl!r}")
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"ring shards must agree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    ring = axis_ring(axis)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "flash" or (impl == "auto" and q.device.type == "cuda"):
        return _RingFlash.apply(q, k, v, ring, causal, float(scale))
    return _ring_naive(q, k, v, ring, causal, scale)


def ring_schedule(q, k, v, do, sp: int, causal: bool = False,
                  scale: Optional[float] = None):
    """The flash ring's schedule for all ``sp`` ranks in one process, for
    checking it on one device: q, k, v, dO are the WHOLE sequence, and
    rank r's shard is slice r. Each rank runs ``flash_blk_fwd`` and
    ``combine`` in the ring's order (kv rank (r - t) mod sp at step t),
    then ``flash_blk_bwd`` with the final lse and the global delta; each
    dk/dv accumulator takes its contributions in the order the travelling
    accumulator does. Returns (out, lse, dq, dk, dv) of the whole
    sequence."""
    from ..ops.flash_attention import bwd_delta
    b, n, h, d = q.shape
    s = n // sp
    scale = d ** -0.5 if scale is None else float(scale)

    def shard(t, r):
        return t[:, r * s:(r + 1) * s]

    outs, lses = [], []
    for r in range(sp):
        o = torch.zeros(b, s, h, d, dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, s), _NEG, dtype=torch.float32,
                         device=q.device)
        for step in range(sp):
            j = (r - step) % sp
            case = blk_case(causal, r, j)
            if case != HIDDEN:
                o, lse = combine(o, lse, *flash_blk_fwd(
                    shard(q, r), shard(k, j), shard(v, j), case, scale))
        outs.append(o.to(q.dtype))
        lses.append(lse)
    out = torch.cat(outs, 1)
    delta = bwd_delta(do, out)
    dq = [torch.zeros(b, s, h, d, device=q.device) for _ in range(sp)]
    dk = [torch.zeros(b, s, h, d, device=q.device) for _ in range(sp)]
    dv = [torch.zeros(b, s, h, d, device=q.device) for _ in range(sp)]
    for step in range(sp):
        for r in range(sp):
            j = (r - step) % sp
            case = blk_case(causal, r, j)
            if case == HIDDEN:
                continue
            g = flash_blk_bwd(shard(q, r), shard(k, j), shard(v, j),
                              shard(do, r), lses[r],
                              delta[:, :, r * s:(r + 1) * s], case, scale)
            dq[r] += g[0].float()
            dk[j] += g[1].float()
            dv[j] += g[2].float()
    return (out, torch.cat(lses, 2), torch.cat(dq, 1).to(q.dtype),
            torch.cat(dk, 1).to(k.dtype), torch.cat(dv, 1).to(v.dtype))


def local_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, bias=None):
    """Single-device reference attention, layout [b, s, h, d] (q and kv
    lengths may differ; ``bias`` [h, sq, sk] adds to the scores).

    Products are taken in fp32 from the inputs' values, which is what the
    JAX reference's ``preferred_element_type=float32`` einsum computes for
    bf16 inputs; P is cast to v's dtype before P·V as there."""
    b, s, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        sc = sc + bias[None].float()
    if causal:
        if k.shape[1] != s:
            raise ValueError(
                "causal masking requires equal q/kv lengths (got "
                f"{s} vs {k.shape[1]}); cross-attention is "
                "bidirectional")
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~mask, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
