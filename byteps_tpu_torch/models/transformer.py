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
  - ``torch.utils.checkpoint`` (non-reentrant) on each block when
    ``remat``: the backward re-runs the block's forward, attention kernel
    included

Tensor, sequence and pipeline parallelism, the chunked LM head and the
remat policies other than None are not ported yet (ROADMAP.md): those
config fields raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import attention

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


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
    attn_impl: str = "auto"       # auto | flash | naive
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
        for field in ("tp_axis", "sp_axis", "pp_axis"):
            if getattr(self, field) is not None:
                raise NotImplementedError(
                    f"{field}: tensor/sequence/pipeline parallelism is not "
                    "ported yet (ROADMAP.md)")
        if self.lm_head_chunk:
            raise NotImplementedError(
                "lm_head_chunk: the chunked LM head is not ported yet "
                "(ROADMAP.md)")
        if self.remat_policy is not None:
            raise NotImplementedError(
                f"remat_policy={self.remat_policy!r}: only the default "
                "whole-block remat is ported (ROADMAP.md)")

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


def _attention(x, blk: Dict[str, torch.Tensor], cfg: TransformerConfig):
    b, s, h = x.shape
    w = blk["qkv"].to(x.dtype).reshape(h, 3 * cfg.heads * cfg.head_dim)
    qkv = (x @ w).view(b, s, 3, cfg.heads, cfg.head_dim)
    q, k, v = qkv.unbind(2)                         # [b, s, heads, hd] views
    out = attention(q, k, v, causal=cfg.causal, impl=cfg.attn_impl)
    out = out.reshape(b, s, cfg.heads * cfg.head_dim)
    return out @ blk["attn_out"].to(x.dtype)


def _mlp(x, blk: Dict[str, torch.Tensor]):
    hdt = x.dtype
    h = x @ blk["mlp_in"].to(hdt) + blk["mlp_in_b"].to(hdt)
    h = F.gelu(h, approximate="tanh")
    return h @ blk["mlp_out"].to(hdt) + blk["mlp_out_b"].to(hdt)


def _block(x, blk: Dict[str, torch.Tensor], cfg: TransformerConfig):
    x = x + _attention(_layernorm(x, blk["ln1.scale"], blk["ln1.bias"]),
                       blk, cfg)
    return x + _mlp(_layernorm(x, blk["ln2.scale"], blk["ln2.bias"]), blk)


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
        cfg = self.cfg
        dt = DTYPES[cfg.dtype]
        s = tokens.shape[1]
        if positions is None:
            positions = torch.arange(s, device=tokens.device)
        x = F.embedding(tokens, self.embed.tok).to(dt)
        x = x + self.embed.pos[positions].to(dt)
        names = [n for n, _ in self.blocks.named_parameters()]
        # one unbind per stacked leaf: its backward stacks the per-layer
        # grads in one op instead of one full-size scatter per layer
        per_layer = zip(*(p.unbind(0) for p in self.blocks.parameters()))
        for i, leaves in enumerate(per_layer):
            blk = dict(zip(names, leaves))
            if cfg.remat and (cfg.remat_layers == -1 or i < cfg.remat_layers):
                x = checkpoint(_block, x, blk, cfg, use_reentrant=False)
            else:
                x = _block(x, blk, cfg)
        return _layernorm(x, self.final_ln.scale, self.final_ln.bias)


def logits(model: Transformer, hidden: torch.Tensor) -> torch.Tensor:
    """Tied-embedding LM head -> [..., vocab] in fp32.

    Both operands are rounded to the compute dtype and multiplied in fp32,
    which is what the JAX einsum with ``preferred_element_type=float32``
    computes: exact products, fp32 sums, fp32 logits."""
    dt = DTYPES[model.cfg.dtype]
    return hidden.to(dt).float() @ model.embed.tok.to(dt).float().t()


def _nll_sum(lg, targets, mask):
    logp = F.log_softmax(lg, dim=-1)
    tgt = torch.where(mask, targets, torch.zeros_like(targets)).long()
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return (nll * mask).sum()


def lm_loss(model: Transformer, batch) -> torch.Tensor:
    """Cross-entropy LM loss with the full head. batch = (tokens,
    targets); targets < 0 are ignored (the MLM mask convention)."""
    tokens, targets = batch
    mask = targets >= 0
    nll_sum = _nll_sum(logits(model, model(tokens)), targets, mask)
    return nll_sum / mask.sum().float().clamp_min(1.0)
