"""Encoder-decoder (T5-style) seq2seq model of the port (counterpart of
``byteps_tpu/models/t5.py``).

The same configuration fields and defaults, and the same parameter tree
leaf for leaf, so ``convert.params_from_jax`` carries the JAX weights
across by name: ``embed.tok`` (and ``embed.pos`` in the absolute mode),
one relative-position table per stack (``enc_rel_bias`` /
``dec_rel_bias``, [num_buckets, heads], shared by the stack's layers),
``enc_blocks.*`` and ``dec_blocks.*`` stacked on a leading layer axis (the
decoder's with ``lnx``, ``xq``, ``xkv`` and ``x_out`` for
cross-attention), and ``enc_final_ln`` / ``dec_final_ln``.

  - relative mode (the default): no absolute positions and no 1/√d score
    scaling; each stack's table goes to ``attention(rel_table=table.T)``,
    bidirectional in the encoder and causal in the decoder, which on the
    card is the flash kernels' in-kernel table form (no [h, s, s] bias);
  - cross-attention: the decoder's queries over the encoder's memory,
    sq != sk, no bias;
  - matmul blocks in the compute dtype over fp32 params, LayerNorm in
    fp32, tanh GELU, pre-LN blocks (the transformer core's ``_layernorm``
    and ``_mlp``); whole-block ``torch.utils.checkpoint`` under ``remat``;
  - the tied head in fp32 (``transformer.logits``) and the mean NLL over
    every target position.

Tensor parallelism (``tp_axis``) is not ported yet (ROADMAP.md): it
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import attention
from .transformer import (DTYPES, ParamTree, _layernorm, _mlp,
                          layer_views, logits)

__all__ = ["T5Config", "t5_tiny", "t5_small", "init_t5_params", "T5",
           "encode", "decode", "seq2seq_loss", "synth_seq2seq_batch"]


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32000
    hidden: int = 512
    enc_layers: int = 6
    dec_layers: int = 6
    heads: int = 8
    mlp_dim: int = 2048
    max_seq: int = 512
    dtype: str = "bfloat16"
    remat: bool = True
    attn_impl: str = "auto"
    tp_axis: Optional[str] = None
    pos_encoding: str = "relative"    # or "absolute" (learned positions)
    rel_buckets: int = 32
    rel_max_distance: int = 128

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, "
                             f"got {self.dtype!r}")
        if self.pos_encoding not in ("relative", "absolute"):
            raise ValueError(f"pos_encoding must be 'relative' or "
                             f"'absolute', got {self.pos_encoding!r}")
        if self.tp_axis is not None:
            raise NotImplementedError(
                "tp_axis: tensor parallelism is not ported yet (ROADMAP.md)")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def relative(self) -> bool:
        return self.pos_encoding == "relative"


def t5_tiny(**kw) -> T5Config:
    return T5Config(vocab_size=128, hidden=64, enc_layers=2, dec_layers=2,
                    heads=4, mlp_dim=128, max_seq=64, **kw)


def t5_small(**kw) -> T5Config:
    return T5Config(**kw)


# ----------------------------------------------------------------- params

def init_t5_params(cfg: T5Config,
                   generator: Optional[torch.Generator] = None) -> dict:
    """Full parameter tree (nested dicts of fp32 CPU tensors), the layout
    of the JAX ``init_t5_params``: normal(0, 0.02) weights, unit LN
    scales, zero biases. The draws come from ``generator`` (default: seed
    0) and differ from JAX's PRNG; tests carry JAX weights across with
    ``convert.params_from_jax``."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    h, m, heads, hd = cfg.hidden, cfg.mlp_dim, cfg.heads, cfg.head_dim

    def norm(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float32) * 0.02

    def ln(*lead):
        return {"scale": torch.ones(*lead, h), "bias": torch.zeros(*lead, h)}

    def block(n):
        return {"ln1": ln(n), "qkv": norm(n, h, 3, heads, hd),
                "attn_out": norm(n, h, h), "ln2": ln(n),
                "mlp_in": norm(n, h, m), "mlp_in_b": torch.zeros(n, m),
                "mlp_out": norm(n, m, h), "mlp_out_b": torch.zeros(n, h)}

    dec = block(cfg.dec_layers)
    dec.update({"lnx": ln(cfg.dec_layers),
                "xq": norm(cfg.dec_layers, h, heads, hd),
                "xkv": norm(cfg.dec_layers, h, 2, heads, hd),
                "x_out": norm(cfg.dec_layers, h, h)})
    tree = {"embed": {"tok": norm(cfg.vocab_size, h)},
            "enc_blocks": block(cfg.enc_layers), "dec_blocks": dec,
            "enc_final_ln": ln(), "dec_final_ln": ln()}
    if cfg.relative:
        tree["enc_rel_bias"] = norm(cfg.rel_buckets, heads)
        tree["dec_rel_bias"] = norm(cfg.rel_buckets, heads)
    else:
        tree["embed"]["pos"] = norm(cfg.max_seq, h)
    return tree


class T5(ParamTree):
    """The model's parameters as a module (the JAX tree's paths are its
    ``state_dict`` keys); the functions below run it."""

    def __init__(self, cfg: T5Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__(init_t5_params(cfg, generator))
        self.cfg = cfg


# ----------------------------------------------------------------- layers

def _self_attention(x, blk: Dict[str, torch.Tensor], cfg: T5Config,
                    causal: bool, table):
    b, s, h = x.shape
    w = blk["qkv"].to(x.dtype).reshape(h, 3 * cfg.heads * cfg.head_dim)
    q, k, v = (x @ w).view(b, s, 3, cfg.heads, cfg.head_dim).unbind(2)
    out = attention(q, k, v, causal=causal, impl=cfg.attn_impl,
                    scale=1.0 if cfg.relative else None,
                    rel_table=None if table is None else table.T,
                    rel_bidirectional=not causal,
                    rel_max_distance=cfg.rel_max_distance)
    return out.reshape(b, s, h) @ blk["attn_out"].to(x.dtype)


def _cross_attention(x, memory, blk: Dict[str, torch.Tensor], cfg: T5Config):
    """Queries from the decoder stream [b, sq, h], keys and values from the
    encoder memory [b, sk, h]; no position bias."""
    dt, (b, sq, h), sk = x.dtype, x.shape, memory.shape[1]
    hd = cfg.heads * cfg.head_dim
    q = (x @ blk["xq"].to(dt).reshape(h, hd)).view(b, sq, cfg.heads,
                                                   cfg.head_dim)
    kv = memory.to(dt) @ blk["xkv"].to(dt).reshape(h, 2 * hd)
    k, v = kv.view(b, sk, 2, cfg.heads, cfg.head_dim).unbind(2)
    out = attention(q, k, v, causal=False, impl=cfg.attn_impl,
                    scale=1.0 if cfg.relative else None)
    return out.reshape(b, sq, h) @ blk["x_out"].to(dt)


def _ln(x, blk, name):
    return _layernorm(x, blk[f"{name}.scale"], blk[f"{name}.bias"])


def _enc_block(x, blk, cfg: T5Config, table):
    x = x + _self_attention(_ln(x, blk, "ln1"), blk, cfg, False, table)
    return x + _mlp(_ln(x, blk, "ln2"), blk)


def _dec_block(x, memory, blk, cfg: T5Config, table):
    x = x + _self_attention(_ln(x, blk, "ln1"), blk, cfg, True, table)
    x = x + _cross_attention(_ln(x, blk, "lnx"), memory, blk, cfg)
    return x + _mlp(_ln(x, blk, "ln2"), blk)


# ------------------------------------------------------------------ model

def _embed(model: T5, tokens):
    cfg = model.cfg
    x = F.embedding(tokens.long(), model.embed.tok).to(DTYPES[cfg.dtype])
    if not cfg.relative:
        x = x + model.embed.pos[:tokens.shape[1]].to(x.dtype)
    return x


def encode(model: T5, src_tokens: torch.Tensor) -> torch.Tensor:
    """Encoder memory [b, s_src, hidden]."""
    cfg = model.cfg
    x = _embed(model, src_tokens)
    table = model.enc_rel_bias if cfg.relative else None
    for blk in layer_views(model.enc_blocks):
        if cfg.remat:
            x = checkpoint(_enc_block, x, blk, cfg, table,
                           use_reentrant=False)
        else:
            x = _enc_block(x, blk, cfg, table)
    return _layernorm(x, model.enc_final_ln.scale, model.enc_final_ln.bias)


def decode(model: T5, tgt_tokens: torch.Tensor,
           memory: torch.Tensor) -> torch.Tensor:
    """Decoder hidden states [b, s_tgt, hidden] (teacher forcing)."""
    cfg = model.cfg
    x = _embed(model, tgt_tokens)
    table = model.dec_rel_bias if cfg.relative else None
    for blk in layer_views(model.dec_blocks):
        if cfg.remat:
            x = checkpoint(_dec_block, x, memory, blk, cfg, table,
                           use_reentrant=False)
        else:
            x = _dec_block(x, memory, blk, cfg, table)
    return _layernorm(x, model.dec_final_ln.scale, model.dec_final_ln.bias)


def seq2seq_loss(model: T5, batch: Tuple) -> torch.Tensor:
    """Teacher-forced next-token CE: ``batch = (src, tgt)``; the decoder
    sees tgt[:-1] and predicts tgt[1:] (position 0 acts as BOS).
    Tied-embedding head in fp32, mean over every target position."""
    src, tgt = batch
    hidden = decode(model, tgt[:, :-1], encode(model, src))
    logp = F.log_softmax(logits(model, hidden), dim=-1)
    nll = -logp.gather(-1, tgt[:, 1:].long()[..., None])
    return nll.mean()


def synth_seq2seq_batch(rng: np.random.RandomState, batch: int,
                        src_len: int, tgt_len: int, vocab: int):
    """Synthetic copy-task data: target = source prefix. numpy, so the same
    seed gives the JAX package and the port the same batch."""
    src = rng.randint(1, vocab, size=(batch, src_len)).astype(np.int32)
    tgt = np.concatenate(
        [np.zeros((batch, 1), np.int32),                 # BOS
         src[:, : tgt_len - 1]], axis=1).astype(np.int32)
    return src, tgt
