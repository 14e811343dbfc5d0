"""Transformer encoder/decoder core of the port (counterpart of
``byteps_tpu/models/transformer.py``).

Same configuration fields and the same parameter tree, leaf for leaf:
the per-layer weights are stacked on a leading layer axis (qkv is
[layers, hidden, 3, heads, head_dim]) and the module's ``state_dict`` keys
are the JAX tree's paths joined by dots ("blocks.ln1.scale"), so weights
carry across by name alone (``convert.params_from_jax``).

  - matmul blocks in the compute dtype (bf16) over fp32 params, cast at
    each use; LayerNorm and softmax statistics in fp32
  - pre-LN blocks with tanh GELU (``jax.nn.gelu``'s default form)
  - attention through ``ops.flash_attention.attention`` (the Hopper
    kernels on the card)
  - ``torch.utils.checkpoint`` (non-reentrant) on the first
    ``remat_layers`` blocks (all at -1) when ``remat``, under
    ``remat_policy``:
      None        the whole block: the backward re-runs its forward,
                  attention kernel included;
      "dots"      the block with the outputs of its four matmuls without
                  batch dimensions kept (the qkv, attn_out, mlp_in and
                  mlp_out products, JAX's
                  ``dots_with_no_batch_dims_saveable``), everything else
                  recomputed, the attention forward too;
      "mlp_only"  only the MLP half: the attention half keeps its
                  residuals, so the backward never re-runs its forward;
      "save_attn" the block with only the attention forward's (out, lse)
                  kept (JAX's names "flash_out", "flash_lse"), everything
                  else recomputed, the qkv product included; under
                  ``sp_axis`` the ring attention keeps nothing and the
                  policy is the whole block, as the JAX ring (which
                  calls its kernel past the names) makes it.
    A policy keeps its values in a dict handed to the checkpointed
    block: the forward records them, the recompute reads them back
    (``_KeptMatmul``; ``flash_attention(keep=...)``), so no dispatch mode
    watches the block's ops.
  - the LM head (``logits``): on the card one bf16 x bf16 -> fp32 GEMM
    (``torch.mm(..., out_dtype=torch.float32)``), elsewhere the same
    function as an fp32 product of the rounded operands;
    ``lm_head_chunk`` > 0 computes the loss one sequence chunk at a time
    under ``torch.utils.checkpoint``, so no [s, vocab] tensor exists
  - sequence parallelism over the ``sp_axis`` mesh axis: ``tokens`` is
    this rank's sequence shard, positions are offset by rank · s_local,
    attention is ``parallel.ring.ring_attention``, and the loss sums its
    nll and mask count over the axis before dividing. The axis resolves
    through the current mesh (``parallel.mesh.use_mesh``, entered by
    ``ShardedTrainer.step``); with none, a forward raises.

Tensor and pipeline parallelism are not ported yet (ROADMAP.md): those
config fields raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.logging import get_logger
from ..ops.flash_attention import attention
from ..parallel.mesh import axis_ring
from ..parallel.ring import ring_attention, seq_sum

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
HEAD_ALIGN = 8      # vocabulary rows the head's GEMM pads to: 16 bytes of bf16


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    max_seq: int = 512
    causal: bool = False          # False: BERT-style encoder; True: GPT
    dtype: str = "bfloat16"       # compute dtype (params stay fp32)
    remat: bool = True            # checkpoint each block
    remat_policy: Optional[str] = None
    remat_layers: int = -1        # how many of the layers to checkpoint
    attn_impl: str = "auto"       # auto | flash | hybrid | naive
    tp_axis: Optional[str] = None
    sp_axis: Optional[str] = None
    pp_axis: Optional[str] = None
    pp_microbatches: int = 0
    pp_interleave: int = 1
    pp_remat_chunk: bool = True
    scan_unroll: int = 1          # no meaning in eager PyTorch; kept so the
    #                               field set matches the JAX config
    lm_head_chunk: int = 0

    def __post_init__(self):
        if self.remat_policy not in (None, "dots", "mlp_only", "save_attn"):
            raise ValueError(f"remat_policy must be None|'dots'|'mlp_only'|"
                             f"'save_attn', got {self.remat_policy!r}")
        if self.remat_policy is not None and not self.remat:
            raise ValueError("remat_policy set but remat=False — the policy "
                             "would be silently ignored")
        if self.remat_layers != -1 and not (0 <= self.remat_layers
                                            <= self.layers):
            raise ValueError(f"remat_layers must be -1 or 0..{self.layers}, "
                             f"got {self.remat_layers}")
        if self.remat_layers != -1 and not self.remat:
            raise ValueError("remat_layers set but remat=False — the knob "
                             "would be silently ignored")
        if self.pp_interleave < 1:
            raise ValueError(f"pp_interleave must be >= 1, "
                             f"got {self.pp_interleave}")
        if self.pp_interleave > 1 and self.pp_axis is None:
            raise ValueError("pp_interleave > 1 needs pp_axis")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, "
                             f"got {self.dtype!r}")
        for field in ("tp_axis", "pp_axis"):
            if getattr(self, field) is not None:
                raise NotImplementedError(
                    f"{field}: tensor/pipeline parallelism is not ported "
                    "yet (ROADMAP.md)")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


# ----------------------------------------------------------------- params

def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None) -> dict:
    """Full parameter tree (nested dicts of fp32 CPU tensors), the layout
    of the JAX ``init_params``: normal(0, 0.02) weights, unit LN scales,
    zero biases, per-layer leaves stacked on a leading layer axis. The
    draws come from ``generator`` (default: seed 0) and differ from JAX's
    PRNG; tests carry JAX weights across with ``convert.params_from_jax``."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    h, m, n = cfg.hidden, cfg.mlp_dim, cfg.layers

    def norm(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float32) * 0.02

    def ln(*lead):
        return {"scale": torch.ones(*lead, h), "bias": torch.zeros(*lead, h)}

    return {
        "embed": {"tok": norm(cfg.vocab_size, h), "pos": norm(cfg.max_seq, h)},
        "blocks": {
            "ln1": ln(n),
            "qkv": norm(n, h, 3, cfg.heads, cfg.head_dim),
            "attn_out": norm(n, h, h),
            "ln2": ln(n),
            "mlp_in": norm(n, h, m),
            "mlp_in_b": torch.zeros(n, m),
            "mlp_out": norm(n, m, h),
            "mlp_out_b": torch.zeros(n, h),
        },
        "final_ln": ln(),
    }


def layer_views(blocks: nn.Module):
    """Per-layer dicts {dotted name: view} of a tree of leaves stacked on a
    leading layer axis. One unbind per stacked leaf: its backward stacks
    the per-layer grads in one op instead of one full-size scatter per
    layer."""
    names = [n for n, _ in blocks.named_parameters()]
    for leaves in zip(*(p.unbind(0) for p in blocks.parameters())):
        yield dict(zip(names, leaves))


class ParamTree(nn.Module):
    """A nested dict of parameters as a module: the dotted path of each
    leaf is its ``state_dict`` key."""

    def __init__(self, tree: dict):
        super().__init__()
        for name in sorted(tree):
            leaf = tree[name]
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf))
            else:
                self.register_parameter(name, nn.Parameter(leaf))


# ----------------------------------------------------------------- layers

def _layernorm(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


class _KeptMatmul(torch.autograd.Function):
    """``x [..., k] @ w [k, n]`` whose output the dict ``kept`` holds
    under ``name`` once the block's forward made it: the recompute
    returns it, bit for bit what the product would give again, and
    multiplies nothing. The backward is ``aten::mm``'s own for these
    row-major operands (grad · wᵀ, xᵀ · grad), so the gradients are
    autograd's bits."""

    @staticmethod
    def forward(ctx, x, w, kept, name):
        y = kept.get(name)
        if y is None:
            y = x.reshape(-1, x.shape[-1]).mm(w).view(*x.shape[:-1],
                                                      w.shape[1])
            kept[name] = y.detach()
        ctx.save_for_backward(x, w)
        return y.detach()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x2, g2 = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])
        return g2.mm(w.t()).view(x.shape), x2.t().mm(g2), None, None


def _dot(x, w, dots: Optional[dict], name: str):
    """``x @ w``; under the ``dots`` policy its output is kept."""
    return x @ w if dots is None else _KeptMatmul.apply(x, w, dots, name)


def _attention(x, blk: Dict[str, torch.Tensor], cfg: TransformerConfig,
               dots: Optional[dict] = None, keep: Optional[dict] = None):
    b, s, h = x.shape
    w = blk["qkv"].to(x.dtype).reshape(h, 3 * cfg.heads * cfg.head_dim)
    qkv = _dot(x, w, dots, "qkv").view(b, s, 3, cfg.heads, cfg.head_dim)
    q, k, v = qkv.unbind(2)                         # [b, s, heads, hd] views
    if cfg.sp_axis is not None:
        out = ring_attention(q, k, v, cfg.sp_axis, causal=cfg.causal,
                             impl=cfg.attn_impl)
    else:
        out = attention(q, k, v, causal=cfg.causal, impl=cfg.attn_impl,
                        keep=keep)
    out = out.reshape(b, s, cfg.heads * cfg.head_dim)
    return _dot(out, blk["attn_out"].to(x.dtype), dots, "attn_out")


def _mlp(x, blk: Dict[str, torch.Tensor], dots: Optional[dict] = None):
    hdt = x.dtype
    h = _dot(x, blk["mlp_in"].to(hdt), dots, "mlp_in") + blk["mlp_in_b"].to(hdt)
    h = F.gelu(h, approximate="tanh")
    return (_dot(h, blk["mlp_out"].to(hdt), dots, "mlp_out")
            + blk["mlp_out_b"].to(hdt))


def _mlp_half(x, blk: Dict[str, torch.Tensor], dots: Optional[dict] = None):
    return _mlp(_layernorm(x, blk["ln2.scale"], blk["ln2.bias"]), blk, dots)


def _block(x, blk: Dict[str, torch.Tensor], cfg: TransformerConfig,
           dots: Optional[dict] = None, keep: Optional[dict] = None,
           remat_mlp: bool = False):
    """Transformer block. ``dots`` keeps its four matmul outputs and
    ``keep`` its attention forward's (out, lse) across a checkpoint;
    ``remat_mlp`` checkpoints only the MLP half (``mlp_only``: attention
    residuals kept, MLP recomputed)."""
    x = x + _attention(_layernorm(x, blk["ln1.scale"], blk["ln1.bias"]),
                       blk, cfg, dots, keep)
    if remat_mlp:
        return x + checkpoint(_mlp_half, x, blk, use_reentrant=False)
    return x + _mlp_half(x, blk, dots)


def _remat_block(x, blk: Dict[str, torch.Tensor], cfg: TransformerConfig):
    """One block under ``cfg.remat_policy``. A policy's values live in a
    dict handed to the checkpointed block: its forward records them, the
    backward's recompute reads them back. ``save_attn`` under
    ``sp_axis`` keeps nothing, as the JAX ring calls its kernel past the
    checkpoint names: whole-block remat."""
    policy = cfg.remat_policy
    if policy == "mlp_only":
        return _block(x, blk, cfg, remat_mlp=True)
    dots = {} if policy == "dots" else None
    keep = {} if policy == "save_attn" and cfg.sp_axis is None else None
    return checkpoint(_block, x, blk, cfg, dots, keep, use_reentrant=False)


class Transformer(nn.Module):
    """The transformer core; ``forward(tokens)`` is the JAX ``apply``:
    token ids [b, s] -> final hidden states [b, s, hidden]."""

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        tree = init_params(cfg, generator)
        for name in sorted(tree):
            self.add_module(name, ParamTree(tree[name]))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """With ``sp_axis``, ``tokens`` is this rank's sequence shard and
        the default positions are its global ones."""
        cfg = self.cfg
        dt = DTYPES[cfg.dtype]
        s = tokens.shape[1]
        if positions is None:
            offset = (axis_ring(cfg.sp_axis).index * s
                      if cfg.sp_axis is not None else 0)
            positions = torch.arange(offset, offset + s,
                                     device=tokens.device)
        x = F.embedding(tokens, self.embed.tok).to(dt)
        x = x + self.embed.pos[positions].to(dt)
        for i, blk in enumerate(layer_views(self.blocks)):
            if cfg.remat and (cfg.remat_layers == -1 or i < cfg.remat_layers):
                x = _remat_block(x, blk, cfg)
            else:
                x = _block(x, blk, cfg)
        return _layernorm(x, self.final_ln.scale, self.final_ln.bias)


class _HeadGemm(torch.autograd.Function):
    """The LM head's product on the card: bf16 x bf16 -> fp32 with fp32
    accumulation (``aten::mm.dtype``), the JAX einsum's function with
    ``preferred_element_type=float32``; only the order of the sums
    differs.

    The vocabulary is padded with zero rows of the embedding to a
    multiple of 8, so the logits' row stride (and the cotangent's, in the
    backward) is 16-byte aligned: at an odd vocabulary (GPT-2's 50257)
    cuBLAS otherwise takes its unaligned kernels. The zero rows add exact
    zeros; the logits are the first ``vocab`` columns.

    The backward rounds the fp32 cotangent to bf16, then runs the same
    GEMM for dh and dE and rounds each to bf16, as the JAX transpose's
    results are (the reference's at default matmul precision on its own
    chip). Running those two in fp32 instead would be the CPU route's
    numbers at several times the time; the cotangent's rounding is one
    bf16 step, 2^-8 relative, of each gradient product."""

    @staticmethod
    def forward(ctx, h, emb, dt):
        vocab = emb.shape[0]
        e16 = F.pad(emb.to(dt), (0, 0, 0, -vocab % HEAD_ALIGN))
        h16 = h.to(dt).reshape(-1, h.shape[-1])
        ctx.save_for_backward(h16, e16)
        ctx.meta = h.shape, h.dtype, emb.dtype, dt
        with torch.profiler.record_function("bps::lm_head"):
            lg = torch.mm(h16, e16.t(), out_dtype=torch.float32)
        return lg[:, :vocab].view(*h.shape[:-1], vocab)

    @staticmethod
    def backward(ctx, g):
        h16, e16 = ctx.saved_tensors
        shape, h_dtype, e_dtype, dt = ctx.meta
        vocab = g.shape[-1]
        g16 = g.new_zeros((h16.shape[0], e16.shape[0]), dtype=dt)
        g16[:, :vocab] = g.reshape(-1, vocab)
        with torch.profiler.record_function("bps::lm_head"):
            dh = torch.mm(g16, e16, out_dtype=torch.float32)
            de = torch.mm(g16.t(), h16, out_dtype=torch.float32)
        return (dh.to(dt).view(shape).to(h_dtype),
                de[:vocab].to(dt).to(e_dtype), None)


def head_logits(hidden: torch.Tensor, emb: torch.Tensor,
                dt: torch.dtype) -> torch.Tensor:
    """``hidden`` [..., h] times the tied embedding ``emb`` [vocab, h]ᵀ,
    both rounded to ``dt`` -> fp32 logits [..., vocab].

    On the card at bf16 or fp16: ``_HeadGemm``, the tensor cores' GEMM
    with fp32 output. Elsewhere (the CPU, where ``aten::mm.dtype`` has no
    kernel, or an fp32 compute dtype): the rounded operands multiplied in
    fp32, which is exact products and fp32 sums, the same function."""
    if hidden.device.type == "cuda" and dt in (torch.bfloat16, torch.float16):
        return _HeadGemm.apply(hidden, emb, dt)
    return hidden.to(dt).float() @ emb.to(dt).float().t()


def logits(model: Transformer, hidden: torch.Tensor) -> torch.Tensor:
    """Tied-embedding LM head -> [..., vocab] in fp32 (``head_logits``
    over the model's embedding at its compute dtype)."""
    return head_logits(hidden, model.embed.tok, DTYPES[model.cfg.dtype])


def _nll_sum(lg, targets, mask):
    logp = F.log_softmax(lg, dim=-1)
    tgt = torch.where(mask, targets, torch.zeros_like(targets)).long()
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return (nll * mask).sum()


def _chunk_nll_sum(hb, tb, mb, emb, dt):
    return _nll_sum(head_logits(hb, emb, dt), tb, mb)


def _chunked_nll_sum(h, emb, targets, mask, chunk: int, dt) -> torch.Tensor:
    """Masked NLL sum with the LM head applied per sequence chunk
    (the JAX ``_chunked_nll_sum``).

    Each chunk's logits and log-softmax live only inside a
    ``torch.utils.checkpoint`` region: the forward keeps no [s, vocab]
    tensor and the backward recomputes one [b, chunk, vocab] block at a
    time. The chunks' sums accumulate in fp32 in chunk order, as the
    JAX scan's carry does."""
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[1], chunk):
        sl = slice(i, i + chunk)
        total = total + checkpoint(_chunk_nll_sum, h[:, sl], targets[:, sl],
                                   mask[:, sl], emb, dt, use_reentrant=False)
    return total


_warned_chunk: set = set()


def lm_loss(model: Transformer, batch) -> torch.Tensor:
    """Cross-entropy LM loss. batch = (tokens, targets); targets < 0 are
    ignored (the MLM mask convention). With ``lm_head_chunk`` dividing
    the (local) sequence and below it, the head runs per chunk
    (``_chunked_nll_sum``); otherwise the full head.

    Under sequence parallelism the nll sum and the mask count are summed
    over the ``sp_axis`` ranks before dividing, so every rank holds the
    global loss (a mean of per-shard means would weight shards with
    different mask counts unevenly)."""
    tokens, targets = batch
    cfg = model.cfg
    h = model(tokens)
    mask = targets >= 0
    s, chunk = h.shape[1], cfg.lm_head_chunk
    if chunk and s > chunk and s % chunk:
        # silent fallback would materialize the [s, vocab] logits the
        # user configured the chunking to avoid — warn once per shape
        if (s, chunk) not in _warned_chunk:
            _warned_chunk.add((s, chunk))
            get_logger().warning(
                "lm_head_chunk=%d does not divide seq %d — falling back "
                "to the FULL [s, vocab] head (O(s·vocab) memory); pick a "
                "divisor of the sequence length", chunk, s)
    if chunk and s > chunk and s % chunk == 0:
        nll_sum = _chunked_nll_sum(h, model.embed.tok, targets, mask, chunk,
                                   DTYPES[cfg.dtype])
    else:
        nll_sum = _nll_sum(logits(model, h), targets, mask)
    cnt = mask.sum().float()
    if cfg.sp_axis is not None:
        nll_sum, cnt = seq_sum(torch.stack([nll_sum, cnt]),
                               axis_ring(cfg.sp_axis)).unbind()
    return nll_sum / cnt.clamp_min(1.0)
