"""GPT-2 model family of the port (counterpart of
``byteps_tpu/models/gpt2.py``; reference benchmark config: GPT-2 medium
with DistributedDataParallel, BASELINE.json configs).

A causal LM on the shared transformer core, with the same names and
defaults as the JAX package. ``gpt2_medium()`` at its published context
of 1024 spans two 512 attention blocks, so its backward takes the split
flash kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import axis_ring
from ..parallel.ring import rotate
from .transformer import Transformer, TransformerConfig, lm_loss


def gpt2_config(hidden=1024, layers=24, heads=16, vocab_size=50257,
                max_seq=1024, dtype="bfloat16", **kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab_size, hidden=hidden,
                             layers=layers, heads=heads, mlp_dim=4 * hidden,
                             max_seq=max_seq, causal=True, dtype=dtype, **kw)


def gpt2_medium(**kw) -> TransformerConfig:
    return gpt2_config(hidden=1024, layers=24, heads=16, **kw)


def gpt2_small(**kw) -> TransformerConfig:
    return gpt2_config(hidden=768, layers=12, heads=12, **kw)


def gpt2_tiny(**kw) -> TransformerConfig:
    return gpt2_config(hidden=64, layers=2, heads=4, vocab_size=128,
                       max_seq=64, dtype="float32", remat=False, **kw)


def next_token_targets(tokens: torch.Tensor, sp_axis=None) -> torch.Tensor:
    """The targets of ``tokens`` [b, s]: each position's next token, -1
    at the globally last position. Under ``sp_axis`` each shard borrows
    the next shard's first token as its last target (rank i receives from
    rank i + 1: the JAX permutation i -> i - 1), and only the last rank
    masks its last position."""
    if sp_axis is None:
        return torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                         dim=1)
    ring = axis_ring(sp_axis)
    next_first, = rotate([tokens[:, :1]], ring, shift=-1)
    if ring.index == ring.size - 1:
        next_first = torch.full_like(next_first, -1)
    return torch.cat([tokens[:, 1:], next_first], dim=1)


def causal_lm_loss(model: Transformer, batch) -> torch.Tensor:
    """batch = tokens [b, s]; next-token prediction.

    The full sequence stays the input and the last target is masked
    (target -1), as in the JAX package: the same loss as a shift to s - 1,
    but s stays a multiple of the attention block. Under sequence
    parallelism ``tokens`` is this rank's shard (``next_token_targets``)."""
    tokens = batch
    return lm_loss(model, (tokens, next_token_targets(tokens,
                                                      model.cfg.sp_axis)))


def synth_lm_batch(rng: np.random.RandomState, batch: int, seq: int,
                   vocab: int):
    """Synthetic token ids; numpy, so the same seed gives the JAX package
    and the port the same batch."""
    return rng.randint(1, vocab, size=(batch, seq)).astype(np.int32)
