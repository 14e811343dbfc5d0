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
    memory on an H100 at the flagship's seq 512, at d 64 and d 128.
    ``out_dtype=torch.float32`` (no bias) writes the output unrounded,
    the Pallas ``out_dtype`` that only ring attention asks for
    (``parallel/ring.py``): 10·s·d bytes per (batch, head) moved where
    the bf16 out moves 8·s·d, still bounded by memory at seq 512.
  - ``flash_bwd_fused`` launches ``csrc/flash_bwd.cu``, the port of the
    Pallas ``_dqkv_fused_kernel`` (:489, wrapper ``_flash_bwd_fused``
    :548): (q, k, v, dO, lse) -> (dq, dk, dv) with delta computed from
    P∘dP, so ``out`` is no input. Bounded by tensor-core throughput. Two
    launches behind the one wrapper, because delta and dk/dv reduce
    across tiles that Hopper CTAs cannot share (see the source). With
    ``delta`` given (the Pallas ``has_delta``, ring attention's hoisted
    global rowsum(dO∘out)) the first launch skips its delta walk: 7
    recomputed products instead of 9, still bounded by tensor-core
    throughput, and the outputs are the split route's with that delta,
    bit for bit.
  - ``flash_bwd_dq`` launches ``csrc/flash_dq.cu`` and ``flash_bwd_dkv``
    ``csrc/flash_dkv.cu``, the ports of the Pallas ``_dq_kernel`` (:335)
    and ``_dkv_kernel`` (:421), the split backward of ``_flash_bwd``
    (:579): delta = rowsum(dO∘out) is an input, taken by the caller from
    the forward's bf16 output. Both bounded by tensor-core throughput.

The forward, dq and dk/dv kernels each come in three forms, chosen at
compile time, as the Pallas kernels' ``has_bias`` / ``rel``:

  - no bias (BERT, GPT-2, T5's cross-attention);
  - ``bias`` [h, sq, sk], an additive score bias read from device memory:
    S = q·kᵀ·scale + B, before the causal mask and the softmax. The dq
    kernel also writes dS for every (b, h, q, k), skipped tiles as 0,
    and the wrapper sums it over the batch: dbias [h, sq, sk] fp32;
  - ``rel_table`` [h, nb], T5's relative-position table (nb <= 128): each
    score adds the table entry of the bucket of key - query, the bucket
    read from an O(s) per-offset vector (``relpos.bucket_vector``, built
    on the CPU) and the table from shared memory, so no [h, sq, sk] bias
    exists anywhere. The dq kernel reduces dS by bucket into per-CTA
    partials in a fixed order (no atomics) and the wrapper sums them:
    dtable [h, nb] fp32, the same bits on every run.

Each kernel is built for head dims 64 and 128 (``KERNEL_DS``), a
compile-time parameter of the CUDA sources; the Pallas kernels take any
d <= 256, and the other widths are still to port (ROADMAP.md queue 2).
The kernels bring q, k, v and dO into shared memory by TMA, through
tensor maps over [b, s, h, d] that the C entry points encode at every
call: ``reads_in_place`` is the layout rule those maps need, and
``kernel_layout`` copies an operand that breaks it (``vector_layout`` does
the same for lse and delta).

The Pallas helpers ``_head_tile``, ``_clamp_ht`` and ``_DT_PAD`` have no
counterpart: they fit the TPU's block rules (several heads per program,
the dtable output padded to an (8, 128) tile). The Hopper kernels run one
head per CTA, and the dtable partials are [b, h, sq / 64, nb].

Which backward runs follows the JAX package exactly (``backward_route``):
the fused one when the whole sequence is one block each way (blocks of
512 shrunk to the sequence, ``BPS_FLASH_BQ`` / ``BPS_FLASH_BK``
overriding) and no bias or table is given, unless
``BPS_FLASH_FUSED_BWD=0``; the split one otherwise. The two are different
functions in bf16 (the fused delta is rowsum(P∘dP), the split one
rowsum(dO∘out) with ``out`` already rounded), so parity with the JAX
package needs the same route at the same shapes. The Hopper kernels
themselves walk 64-row tiles whatever the block.

``attention`` is the dispatcher the models call (JAX ``attention``,
:853): ``route`` picks the path. "auto" takes the kernels on the card
wherever ``check_kernel_inputs`` accepts the input and raises where it
refuses it; the plain O(s²) attention runs only when asked for by name
("naive"). The JAX package's ``supported()`` predicate is kept for
parity, but routes nothing: the kernels take sequences in tiles of 64,
finer than its 128, so a shape it rejects still has a kernel here. On
CPU tensors "auto" takes the kernels' plain versions. "hybrid" is the
JAX package's ``fwd_xla`` form: a forward of plain products
(``hybrid_fwd``, the port of ``_xla_fwd``) that gives the (out, lse)
residuals the flash backward kernels read, with those kernels behind it.

Each wrapper keeps its plain PyTorch version beside it, with the same
inputs and outputs, and takes it only for tensors on the CPU. A CUDA
tensor launches the kernel or raises: inputs the kernels do not take
(fp32 or fp16 q/k/v, a head dim other than 64 and 128, a sequence not a
multiple of 64, a bias or table of the wrong shape) are refused by
``check_kernel_inputs``. Each wrapper counts its launches in plain
attributes: ``launches`` (every form and width), ``launches_bias`` and
``launches_rel`` (the bias and table forms), and by head dim
``launches_d``, ``launches_bias_d`` and ``launches_rel_d`` (dicts from
head dim to launches); ``flash_fwd`` also counts its fp32-out launches
(``launches_f32``, ``launches_f32_d``) and ``flash_bwd_fused`` its
delta-given ones (``launches_delta``, ``launches_delta_d``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch

from ..parallel.ring import local_attention
from . import relpos
from ._build import device_type, entry, raise_on_error

_NEG_INF = -1e30
KERNEL_DS = (64, 128)  # head dims the kernels are built for
KERNEL_TILE = 64       # sequence tile of the kernels
BLOCK = 512            # the JAX package's default block each way
MAX_BUCKETS = 128      # rel-table buckets the kernels take (JAX: one lane tile)
FORM_NONE, FORM_BIAS, FORM_REL = 0, 1, 2   # the kernels' bias sources


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
                   block_k: int = BLOCK, biased: bool = False) -> str:
    """"fused" where the JAX ``_flash_bwd`` takes ``_dqkv_fused_kernel``
    (one block each way, no bias or table, ``BPS_FLASH_FUSED_BWD`` not
    "0"), else "split" (``_dq_kernel`` then ``_dkv_kernel``)."""
    bq, bk = resolve_blocks(sq, sk, block_q, block_k)
    if (not biased and sq // bq == 1 and sk // bk == 1
            and os.environ.get("BPS_FLASH_FUSED_BWD", "1") != "0"):
        return "fused"
    return "split"


# ----------------------------------------------------------- bias forms

def _form(bias, rel_table) -> int:
    if bias is not None:
        return FORM_BIAS
    return FORM_NONE if rel_table is None else FORM_REL


def score_bias(sq: int, sk: int, bias=None, rel_table=None,
               rel_bidirectional: bool = True, rel_max_distance: int = 128
               ) -> Optional[torch.Tensor]:
    """The fp32 [h, sq, sk] addend of the scores, or None: ``bias`` itself,
    or the table entry of each (query, key)'s bucket."""
    if bias is not None:
        return bias.float()
    if rel_table is None:
        return None
    bucket = relpos.bucket_map(sq, sk, rel_bidirectional, rel_table.shape[1],
                               rel_max_distance, rel_table.device)
    return rel_table.float()[:, bucket]


def _scores(q, k, scale, addend):
    """S = q·kᵀ·scale (+ B), fp32 [b, h, sq, sk]: the product rounded
    before the addend is added, as the kernels and the Pallas kernels add
    it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return s if addend is None else s + addend[None]


def _table_grad(ds: torch.Tensor, sq: int, sk: int, rel_table,
                rel_bidirectional: bool, rel_max_distance: int
                ) -> torch.Tensor:
    """dtable [h, nb]: dS [b, h, sq, sk] summed over the batch and over the
    positions of each bucket."""
    h, nb = rel_table.shape
    bucket = relpos.bucket_map(sq, sk, rel_bidirectional, nb,
                               rel_max_distance, ds.device)
    return torch.zeros(h, nb, dtype=torch.float32, device=ds.device
                       ).index_add_(1, bucket.reshape(-1),
                                    ds.sum(0).reshape(h, -1))


# ------------------------------------------------------- plain versions

def flash_fwd_plain(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, bias=None, rel_table=None,
                    rel_bidirectional: bool = True,
                    rel_max_distance: int = 128, out_dtype=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: (out, lse).

    Products in fp32 from the inputs' values, the bias added before the
    mask; P cast to v's dtype before P·V; out = acc / max(l, 1e-30) in
    ``out_dtype`` (default q's), lse = m + log(l)."""
    scale = _scale(q, scale)
    sq, sk = q.shape[1], k.shape[1]
    s = _scores(q, k, scale, score_bias(sq, sk, bias, rel_table,
                                        rel_bidirectional, rel_max_distance))
    if causal:
        s = s.masked_fill(~_causal_keep(sq, sk, q.device), _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)          # [b, h, q, 1]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l.transpose(1, 2)
    return out.to(out_dtype or q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_dp(q, k, v, do, lse, causal, scale, addend=None):
    """P = exp(S - lse) (0 where causally masked) and dP = dO·Vᵀ, fp32,
    [b, h, sq, sk]."""
    s = _scores(q, k, scale, addend)
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device),
                          0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, dp


def flash_bwd_fused_plain(q, k, v, do, lse, causal: bool = False,
                          scale: Optional[float] = None, delta=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward kernel's function in plain PyTorch:
    (q, k, v, dO, lse) -> (dq, dk, dv), no ``out`` input; delta =
    rowsum(P∘dP) unless the caller gives it ([b, h, sq] fp32)."""
    scale = _scale(q, scale)
    p, dp = _probs_and_dp(q, k, v, do, lse, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    delta = ((p * dp).sum(-1, keepdim=True) if delta is None
             else delta.float()[..., None])
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
                       scale: Optional[float] = None, bias=None,
                       rel_table=None, rel_bidirectional: bool = True,
                       rel_max_distance: int = 128):
    """The dq kernel's function in plain PyTorch: dS = P∘(dP - delta)
    rounded to q's dtype, dq = dS·K·scale. With ``bias`` it returns
    (dq, dbias = Σ_batch dS), with ``rel_table`` (dq, dtable = Σ dS over
    the batch and each bucket's positions), both fp32 from dS before its
    rounding."""
    scale = _scale(q, scale)
    sq, sk = q.shape[1], k.shape[1]
    p, dp = _probs_and_dp(q, k, v, do, lse, causal, scale, score_bias(
        sq, sk, bias, rel_table, rel_bidirectional, rel_max_distance))
    ds32 = p * (dp - delta.float()[..., None])
    ds = ds32.to(q.dtype).float()
    dq = (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype)
    if bias is not None:
        return dq, ds32.sum(0)
    if rel_table is not None:
        return dq, _table_grad(ds32, sq, sk, rel_table, rel_bidirectional,
                               rel_max_distance)
    return dq


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = False,
                        scale: Optional[float] = None, bias=None,
                        rel_table=None, rel_bidirectional: bool = True,
                        rel_max_distance: int = 128
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain PyTorch: dv = P̂ᵀ·dO with P
    rounded to dO's dtype, dk = dSᵀ·Q·scale."""
    scale = _scale(q, scale)
    p, dp = _probs_and_dp(q, k, v, do, lse, causal, scale, score_bias(
        q.shape[1], k.shape[1], bias, rel_table, rel_bidirectional,
        rel_max_distance))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    ds = (p * (dp - delta.float()[..., None])).to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


@contextlib.contextmanager
def _full_fp32():
    """fp32 products in full fp32 on the card (TF32 off) for the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def hybrid_fwd(q, k, v, causal: bool = False, scale: Optional[float] = None,
               bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hybrid route's forward, the port of the JAX ``_xla_fwd``
    (:307): (out [b, sq, h, d] in q's dtype, lse [b, h, sq] fp32) from
    plain products, on any device. S = q·kᵀ·scale in fp32 (bf16 operands
    are upcast, which is exact, and TF32 stays off: the JAX product's
    ``preferred_element_type=float32``), plus ``bias`` [h, sq, sk], the
    causal mask, then P = exp(S - m), l = rowsum(P), (P / l) cast to v's
    dtype before the fp32 product with V, lse = m + log(l). Not a kernel:
    the library's products and elementwise ops."""
    scale = _scale(q, scale)
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    with _full_fp32():
        s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias[None].float()
        if causal:
            s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1],
                                            q.device), _NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        out = torch.matmul((p / l).to(v.dtype).float(), vt)
    return (out.to(q.dtype).transpose(1, 2).contiguous(),
            (m + torch.log(l))[..., 0])


# ------------------------------------------------------- input contract

def check_forms(q, k, causal: bool = False, bias=None,
                rel_table=None) -> None:
    """The JAX package's rules (``_fwd_rule``), on every device: causal
    masking needs sq == sk; the bias forms are mutually exclusive, with at
    most ``MAX_BUCKETS`` buckets; a bias is [h, sq, sk], a table fp32
    [h, nb]."""
    b, sq, h = q.shape[:3]
    sk = k.shape[1]
    if causal and sq != sk:
        raise ValueError(
            "causal masking requires equal q/kv lengths (got "
            f"{sq} vs {sk}); cross-attention is bidirectional")
    if bias is not None and rel_table is not None:
        raise ValueError("bias and rel_table are mutually exclusive")
    if bias is not None and tuple(bias.shape) != (h, sq, sk):
        raise ValueError(f"bias must be [h, sq, sk] = {(h, sq, sk)}, got "
                         f"{tuple(bias.shape)}")
    if rel_table is not None:
        if rel_table.dim() != 2 or rel_table.shape[0] != h:
            raise ValueError(f"rel_table must be [h, nb] with h = {h} (q's "
                             f"heads), got {tuple(rel_table.shape)}")
        if rel_table.shape[1] > MAX_BUCKETS:
            raise ValueError(
                f"rel_table has {rel_table.shape[1]} buckets; the in-kernel "
                f"path supports at most {MAX_BUCKETS}")
        if rel_table.dtype != torch.float32:
            raise TypeError(f"rel_table must be float32, got "
                            f"{rel_table.dtype}")


def check_out_dtype(out_dtype, bias=None, rel_table=None) -> None:
    """The forward's ``out_dtype``: None (q's dtype) or float32, the
    latter only without a bias or table (the ring passes none, and the
    kernel's fp32 store is instantiated for the no-bias form only)."""
    if out_dtype not in (None, torch.float32):
        raise ValueError(f"out_dtype must be None or torch.float32, got "
                         f"{out_dtype}")
    if out_dtype is not None and (bias is not None or rel_table is not None):
        raise ValueError("out_dtype=float32 is the ring's no-bias form; a "
                         "bias or rel_table takes q's dtype")


def check_kernel_inputs(q, k, v, causal: bool = False, bias=None,
                        rel_table=None) -> None:
    """Refuse what the Hopper kernels do not take; called by the CUDA
    branch of each wrapper before it launches. Never a fallback."""
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
    if d not in KERNEL_DS:
        raise NotImplementedError(
            f"head_dim {d}: the Hopper flash kernels are built for d in "
            f"{KERNEL_DS}; other widths of _fwd_kernel / _dqkv_fused_kernel "
            "/ _dq_kernel / _dkv_kernel are not ported (ROADMAP.md queue 2, "
            "row '1-4 d')")
    if sq % KERNEL_TILE or sk % KERNEL_TILE:
        raise ValueError(f"sequence lengths {sq}, {sk} must be multiples of "
                         f"{KERNEL_TILE} for the Hopper flash kernels")
    check_forms(q, k, causal, bias, rel_table)
    devs = {t.device for t in (q, k, v, bias, rel_table) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"q, k, v, bias, rel_table on different devices: "
                         f"{devs}")


def reads_in_place(t: torch.Tensor) -> bool:
    """Whether the Hopper kernels read the [b, s, h, d] operand ``t`` as
    it is. Each kernel reads its q, k, v and dO through a TMA tensor map
    over [b, s, h, d] whose boxes are [64 rows][64 columns] of one head:
    the last stride must be 1 and the head stride d, and TMA takes a base
    address and row and batch strides that are positive multiples of 16
    bytes. The model's ``qkv.unbind(2)`` views pass (row stride 3·h·d)."""
    if t.dim() != 4:
        return False
    d = t.shape[3]
    row, batch = (t.stride(i) * t.element_size() for i in (1, 0))
    return (t.stride(3) == 1 and t.stride(2) == d
            and row > 0 and row % 16 == 0 and batch > 0 and batch % 16 == 0
            and t.data_ptr() % 16 == 0)


def kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels read it in place
    (``reads_in_place``), else a fresh contiguous copy, which they do
    (``contiguous()`` would return a misaligned contiguous view as it
    is)."""
    return t if reads_in_place(t) else t.clone(
        memory_format=torch.contiguous_format)


def vector_layout(t: torch.Tensor) -> torch.Tensor:
    """An lse or delta vector ([b, h, sq] fp32) as the kernels read it:
    contiguous on a 16-byte boundary (dk/dv brings each query tile's 64
    values in by one bulk copy), else a fresh copy, which is."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _bias_args(q, k, bias, rel_table, rel_bidirectional, rel_max_distance):
    """(form, tensors, pointer arguments) of a kernel's bias source: the
    dense fp32 bias, or the offset bucket vector and the fp32 table, with
    the bucket count. The caller holds ``tensors`` until it has launched:
    the pointers are only valid while they live."""
    form = _form(bias, rel_table)
    if form == FORM_BIAS:
        dense = bias.float().contiguous()
        return form, (dense,), (dense.data_ptr(), None, None, 0)
    if form == FORM_REL:
        nb = rel_table.shape[1]
        table = rel_table.contiguous()
        vec = relpos.bucket_vector(q.shape[1], k.shape[1],
                                   bool(rel_bidirectional), nb,
                                   int(rel_max_distance), str(q.device))
        return form, (table, vec), (None, vec.data_ptr(), table.data_ptr(),
                                    nb)
    return form, (), (None, None, None, 0)


def _count(fn, form: int, d: int, variant: Optional[str] = None) -> None:
    """One launch of ``fn`` in bias ``form`` at head dim ``d``;
    ``variant`` ("f32", "delta") also counts the ring's form."""
    fn.launches += 1
    fn.launches_d[d] += 1
    kind = {FORM_BIAS: "bias", FORM_REL: "rel"}.get(form)
    for k in (kind, variant):
        if k is not None:
            setattr(fn, f"launches_{k}", getattr(fn, f"launches_{k}") + 1)
            getattr(fn, f"launches_{k}_d")[d] += 1


def zero_counts(fn) -> None:
    """Set every launch count of the wrapper ``fn`` to 0."""
    fn.launches = 0
    fn.launches_d = dict.fromkeys(KERNEL_DS, 0)
    for k in ("bias", "rel") + fn.variants:
        setattr(fn, f"launches_{k}", 0)
        setattr(fn, f"launches_{k}_d", dict.fromkeys(KERNEL_DS, 0))


def _counted(*variants):
    """Give a wrapper its launch counts; ``variants`` names the ring
    forms it also counts on their own."""
    def wrap(fn):
        fn.variants = variants
        zero_counts(fn)
        return fn
    return wrap


# ------------------------------------------------------------- wrappers

@_counted("f32")
def flash_fwd(q, k, v, causal: bool = False, scale: Optional[float] = None,
              bias=None, rel_table=None, rel_bidirectional: bool = True,
              rel_max_distance: int = 128, out_dtype=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b,sq,h,d], k/v [b,sk,h,d] -> (out [b,sq,h,d], lse [b,h,sq] fp32),
    out in ``out_dtype`` (None: q's; float32 only without a bias). CUDA
    tensors launch ``csrc/flash_fwd.cu``; CPU tensors take
    ``flash_fwd_plain``."""
    check_out_dtype(out_dtype, bias, rel_table)
    if device_type(q, "flash attention") == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale, bias, rel_table,
                               rel_bidirectional, rel_max_distance, out_dtype)
    check_kernel_inputs(q, k, v, causal, bias, rel_table)
    q, k, v = (kernel_layout(t) for t in (q, k, v))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    form, keep, bargs = _bias_args(q, k, bias, rel_table, rel_bidirectional,
                                   rel_max_distance)
    f32 = out_dtype is not None
    out = torch.empty(b, sq, h, d, dtype=out_dtype or q.dtype,
                      device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = entry("flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            _scale(q, scale), int(causal), form, *bargs, int(f32), stream)
    raise_on_error(code, "flash forward kernel")
    _count(flash_fwd, form, d, "f32" if f32 else None)
    return out, lse


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
            _scale(q, scale), int(causal))


@_counted("delta")
def flash_bwd_fused(q, k, v, do, lse, causal: bool = False,
                    scale: Optional[float] = None, delta=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v, dO, lse) -> (dq, dk, dv), delta computed in the kernel
    unless given ([b, h, sq] fp32). CUDA tensors launch
    ``csrc/flash_bwd.cu``; CPU tensors take ``flash_bwd_fused_plain``."""
    if device_type(q, "flash attention") == "cpu":
        return flash_bwd_fused_plain(q, k, v, do, lse, causal, scale, delta)
    check_kernel_inputs(q, k, v, causal)
    _check_bwd_inputs(q, k, v, do, lse, delta)
    q, k, v, do = (kernel_layout(t) for t in (q, k, v, do))
    lse = vector_layout(lse)
    dq, dk, dv = _empty(q), _empty(k), _empty(v)
    if delta is None:       # the kernel's scratch: it writes delta there
        scratch, given = _empty(lse), None
    else:
        scratch, given = None, vector_layout(delta)
    with torch.cuda.device(q.device):
        code = entry("flash_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), None if scratch is None else scratch.data_ptr(),
            None if given is None else given.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            *_bwd_args(q, k, v, do, scale, causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(code, "flash fused backward kernel")
    _count(flash_bwd_fused, FORM_NONE, q.shape[3],
           None if given is None else "delta")
    return dq, dk, dv


@_counted()
def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                 scale: Optional[float] = None, bias=None, rel_table=None,
                 rel_bidirectional: bool = True, rel_max_distance: int = 128):
    """The split backward's dq: (q, k, v, dO, lse, delta) -> dq, or
    (dq, dbias [h, sq, sk]) with ``bias``, (dq, dtable [h, nb]) with
    ``rel_table``, both fp32. CUDA tensors launch ``csrc/flash_dq.cu``;
    CPU tensors take ``flash_bwd_dq_plain``."""
    if device_type(q, "flash attention") == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale,
                                  bias, rel_table, rel_bidirectional,
                                  rel_max_distance)
    check_kernel_inputs(q, k, v, causal, bias, rel_table)
    _check_bwd_inputs(q, k, v, do, lse, delta)
    q, k, v, do = (kernel_layout(t) for t in (q, k, v, do))
    lse, delta = vector_layout(lse), vector_layout(delta)
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    form, keep, bargs = _bias_args(q, k, bias, rel_table, rel_bidirectional,
                                   rel_max_distance)
    dq = _empty(q)
    grad = None
    if form == FORM_BIAS:       # dS of every (b, h, q, k); skipped tiles 0
        grad = torch.empty(b, h, sq, sk, dtype=torch.float32, device=q.device)
    elif form == FORM_REL:      # one dtable row per (b, h, query tile)
        grad = torch.empty(b, h, sq // KERNEL_TILE, bargs[3],
                           dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = entry("flash_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_bwd_args(q, k, v, do, scale, causal), form, *bargs,
            None if grad is None else grad.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(code, "flash dq kernel")
    _count(flash_bwd_dq, form, q.shape[3])
    if form == FORM_BIAS:
        return dq, grad.sum(0)
    if form == FORM_REL:
        return dq, grad.sum((0, 2))
    return dq


@_counted()
def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                  scale: Optional[float] = None, bias=None, rel_table=None,
                  rel_bidirectional: bool = True, rel_max_distance: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split backward's dk and dv: (q, k, v, dO, lse, delta) ->
    (dk, dv). CUDA tensors launch ``csrc/flash_dkv.cu``; CPU tensors take
    ``flash_bwd_dkv_plain``."""
    if device_type(q, "flash attention") == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale,
                                   bias, rel_table, rel_bidirectional,
                                   rel_max_distance)
    check_kernel_inputs(q, k, v, causal, bias, rel_table)
    _check_bwd_inputs(q, k, v, do, lse, delta)
    q, k, v, do = (kernel_layout(t) for t in (q, k, v, do))
    lse, delta = vector_layout(lse), vector_layout(delta)
    form, keep, bargs = _bias_args(q, k, bias, rel_table, rel_bidirectional,
                                   rel_max_distance)
    dk, dv = _empty(k), _empty(v)
    with torch.cuda.device(q.device):
        code = entry("flash_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_args(q, k, v, do, scale, causal), form, *bargs,
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(code, "flash dk/dv kernel")
    _count(flash_bwd_dkv, form, q.shape[3])
    return dk, dv


# ------------------------------------------------------------ public API

def _attention_fwd(q, k, v, bias, rel_table, causal, scale, rel, hybrid):
    """(out, lse) of the forward: ``flash_fwd`` or, with ``hybrid``,
    ``hybrid_fwd`` (a table materialized as ``relpos.relative_bias``)."""
    if not hybrid:
        return flash_fwd(q, k, v, causal, scale, bias, rel_table, *rel)
    with torch.profiler.record_function("bps::hybrid_fwd"):
        dense = bias
        if rel_table is not None:
            dense = relpos.relative_bias(rel_table.T, q.shape[1], k.shape[1],
                                         rel[0], rel_table.shape[1], rel[1])
        return hybrid_fwd(q, k, v, causal, scale, dense)


class _FlashAttention(torch.autograd.Function):
    """On the fused route the forward saves (q, k, v, lse) — not ``out``:
    the fused backward computes delta from P∘dP, so under remat the
    recompute's output is needed only by the layers after attention. On
    the split route it also saves ``out``, whose rowsum with dO is the
    delta the split kernels read, and the bias or table when given. The
    backward returns the gradient of the bias (dbias) or of the table
    (dtable), as the JAX custom VJP returns ``dbias, drel``.

    ``hybrid`` (the JAX ``fwd_xla``) takes the forward from ``hybrid_fwd``
    instead of the forward kernel, a table materialized as
    ``relpos.relative_bias`` for it; the saved residuals and the backward
    are the same (the table, not the bias, is saved).

    ``keep`` (a dict, or None) holds the forward's (out, lse) across a
    checkpoint (``remat_policy="save_attn"``): the first forward records
    them, a recompute returns them and launches nothing."""

    @staticmethod
    def forward(ctx, q, k, v, bias, rel_table, causal, scale, fused, rel,
                hybrid, keep):
        kept = None if keep is None else keep.get("attention")
        if kept is None:
            out, lse = _attention_fwd(q, k, v, bias, rel_table, causal,
                                      scale, rel, hybrid)
            if keep is not None:
                keep["attention"] = out.detach(), lse
        else:
            out, lse = kept[0].detach(), kept[1]
        form = _form(bias, rel_table)
        extra = {FORM_NONE: (), FORM_BIAS: (bias,), FORM_REL: (rel_table,)}
        if fused:
            ctx.save_for_backward(q, k, v, lse)
        else:
            ctx.save_for_backward(q, k, v, lse, out, *extra[form])
        ctx.causal, ctx.scale, ctx.fused = causal, scale, fused
        ctx.form, ctx.rel = form, rel
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, *rest = ctx.saved_tensors
        do = dout.to(q.dtype)
        dbias = drel = None
        if ctx.fused:
            dq, dk, dv = flash_bwd_fused(q, k, v, do, lse, ctx.causal,
                                         ctx.scale)
        else:
            out, *given = rest
            bias = given[0] if ctx.form == FORM_BIAS else None
            table = given[0] if ctx.form == FORM_REL else None
            delta = bwd_delta(do, out)
            dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale,
                              bias, table, *ctx.rel)
            if ctx.form == FORM_BIAS:
                dq, dbias = dq
                dbias = dbias.to(bias.dtype)
            elif ctx.form == FORM_REL:
                dq, drel = dq
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                                   ctx.scale, bias, table, *ctx.rel)
        return (dq, dk, dv, dbias, drel) + (None,) * 6


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, bias=None,
                    rel_table=None, block_q: int = BLOCK,
                    block_k: int = BLOCK, rel_bidirectional: bool = True,
                    rel_max_distance: int = 128, hybrid: bool = False,
                    keep: Optional[dict] = None):
    """Differentiable flash attention: q [b, sq, h, d], k/v [b, sk, h, d]
    -> [b, sq, h, d]. ``block_q`` / ``block_k`` are the JAX package's
    blocks: they choose the backward route (``backward_route``), as
    there. ``bias`` [h, sq, sk] or ``rel_table`` [h, nb] (T5's table, with
    ``rel_bidirectional`` and ``rel_max_distance``) add to the scores;
    both are differentiable and take the split backward. ``hybrid``: the
    forward from ``hybrid_fwd`` (the JAX ``fwd_xla``), the backward the
    same kernels. ``keep``: a dict that keeps the forward's (out, lse)
    for a checkpoint's recompute (``remat_policy="save_attn"``)."""
    check_forms(q, k, causal, bias, rel_table)
    biased = bias is not None or rel_table is not None
    fused = backward_route(q.shape[1], k.shape[1], block_q, block_k,
                           biased) == "fused"
    return _FlashAttention.apply(q, k, v, bias, rel_table, causal, scale,
                                 fused, (bool(rel_bidirectional),
                                         int(rel_max_distance)), hybrid,
                                 keep)


def supported(q_shape, k_shape=None) -> bool:
    """The JAX package's predicate (``supported``, :828): each sequence a
    multiple of 128 and head_dim <= 256. It is not the Hopper kernels'
    own test (``check_kernel_inputs``: bf16, d in ``KERNEL_DS``, sequences
    a multiple of ``KERNEL_TILE``), and ``route`` does not read it: a
    shape it accepts that the kernels refuse raises, and one it rejects
    that the kernels take (a sequence of 192) runs them."""
    _, sq, _, d = q_shape
    sk = sq if k_shape is None else k_shape[1]
    return sq % 128 == 0 and sk % 128 == 0 and d <= 256


def route(q, k, v, impl: str = "auto", causal: bool = False, bias=None,
          rel_table=None) -> str:
    """The path ``attention`` takes: "flash", "hybrid" or "naive".

    "naive" only where asked for. On the card (any device but the CPU;
    the tests pass meta tensors for the card's) "auto", "flash" and
    "hybrid" check the kernels' inputs first, so what they refuse raises
    here and never reaches the plain attention. CPU tensors take "flash"
    (the kernels' plain versions) under "auto"."""
    if impl not in ("auto", "flash", "hybrid", "naive"):
        raise ValueError(
            f"attn impl must be auto|flash|hybrid|naive, got {impl!r}")
    if impl == "naive":
        return "naive"
    if q.device.type != "cpu":
        check_kernel_inputs(q, k, v, causal, bias, rel_table)
    return "flash" if impl == "auto" else impl


def attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
              impl: str = "auto", bias=None, rel_table=None,
              rel_bidirectional: bool = True, rel_max_distance: int = 128,
              keep: Optional[dict] = None):
    """Dispatcher the models call (``route`` picks the path).

    impl: "auto" | "flash" -> ``flash_attention`` (the Hopper kernels on
    the card, their plain versions on the CPU; refused inputs raise);
    "hybrid" -> ``flash_attention(hybrid=True)``: plain products forward,
    the kernels backward (on the CPU, their plain versions); "naive" ->
    ``parallel.ring.local_attention``, the plain O(s²) oracle, with a rel
    table materialized through ``relpos.relative_bias``, only where asked
    for. ``keep``: see ``flash_attention`` (the naive route keeps
    nothing, and recomputes)."""
    way = route(q, k, v, impl, causal, bias, rel_table)
    if way == "naive":
        if rel_table is not None:
            bias = relpos.relative_bias(rel_table.T, q.shape[1], k.shape[1],
                                        rel_bidirectional,
                                        rel_table.shape[1], rel_max_distance)
        return local_attention(q, k, v, causal=causal, scale=scale,
                               bias=bias)
    return flash_attention(q, k, v, causal=causal, scale=scale, bias=bias,
                           rel_table=rel_table,
                           rel_bidirectional=rel_bidirectional,
                           rel_max_distance=rel_max_distance,
                           hybrid=way == "hybrid", keep=keep)
