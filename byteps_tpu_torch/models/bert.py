"""BERT model family of the port (counterpart of
``byteps_tpu/models/bert.py``) — the flagship training config (reference
headline: BERT-large scaling, README.md:37-44).

MLM objective on the shared transformer core. ``bert_large()`` is the
reference benchmark's geometry (24×1024×16, seq 512, mixed precision).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .transformer import (Transformer, TransformerConfig, _nll_sum, logits,
                          lm_loss)


def bert_config(hidden=1024, layers=24, heads=16, vocab_size=30522,
                max_seq=512, dtype="bfloat16", **kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab_size, hidden=hidden,
                             layers=layers, heads=heads, mlp_dim=4 * hidden,
                             max_seq=max_seq, causal=False, dtype=dtype, **kw)


def bert_large(**kw) -> TransformerConfig:
    return bert_config(hidden=1024, layers=24, heads=16, **kw)


def bert_base(**kw) -> TransformerConfig:
    return bert_config(hidden=768, layers=12, heads=12, **kw)


def bert_tiny(**kw) -> TransformerConfig:
    """Test-sized config."""
    return bert_config(hidden=64, layers=2, heads=4, vocab_size=128,
                       max_seq=64, dtype="float32", remat=False, **kw)


def mlm_loss(model: Transformer, batch,
             max_predictions: Optional[int] = None) -> torch.Tensor:
    """batch = (masked_tokens, targets) with targets < 0 at unmasked
    positions (standard MLM convention).

    ``max_predictions``: gather up to K masked positions per sequence and
    run the LM head only on those (the standard max_predictions_per_seq
    trick). Exact as long as no sequence has more than K masked positions;
    sequences over the cap drop their latest-position extras. None =
    full-sequence head."""
    if max_predictions is None:
        return lm_loss(model, batch)
    tokens, targets = batch
    b, s = tokens.shape
    k = min(max_predictions, s)
    h = model(tokens)                                   # [b, s, hid]
    mask = targets >= 0
    # masked positions first; earlier positions win ties/cap overflow (the
    # scores are distinct, so the order matches jax.lax.top_k's)
    score = mask.float() * 2.0 - torch.arange(
        s, device=tokens.device, dtype=torch.float32) / s
    idx = torch.topk(score, k, dim=-1).indices          # [b, k]
    sel_h = h.gather(1, idx[..., None].expand(-1, -1, h.shape[-1]))
    sel_t = targets.gather(1, idx)
    w = mask.gather(1, idx)
    nll_sum = _nll_sum(logits(model, sel_h), sel_t, w)
    return nll_sum / w.sum().float().clamp_min(1.0)


def synth_mlm_batch(rng: np.random.RandomState, batch: int, seq: int,
                    vocab: int, mask_frac: float = 0.15, mask_id: int = 0):
    """Synthetic MLM data (the reference benchmarks use synthetic inputs,
    example/pytorch/benchmark_byteps.py). numpy, so the same seed gives the
    JAX package and the port the same batch."""
    tokens = rng.randint(1, vocab, size=(batch, seq)).astype(np.int32)
    mask = rng.rand(batch, seq) < mask_frac
    targets = np.where(mask, tokens, -1).astype(np.int32)
    masked = np.where(mask, mask_id, tokens).astype(np.int32)
    return masked, targets
