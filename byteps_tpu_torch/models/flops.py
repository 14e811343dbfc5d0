"""Analytic model-FLOP accounting for MFU reporting (the port's copy of
``byteps_tpu/models/flops.py``).

MFU (model FLOPs utilization) follows the standard convention (PaLM
appendix B): count only the FLOPs the MODEL requires — matmuls of the
forward pass, ×3 for training (backward ≈ 2× forward) — and divide by the
device's peak. Rematerialization recompute, embedding gathers, and
elementwise ops are excluded, so MFU is comparable across
implementations and honest about recompute overhead (a fully-rematted
step executes ~4/3× the counted FLOPs and its MFU shows that cost).
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def transformer_fwd_flops_per_sample(cfg, seq: int,
                                     lm_positions: Optional[int] = None
                                     ) -> float:
    """Matmul FLOPs of one forward pass of one sample.

    Per layer: QKV 6·s·h², attn-out 2·s·h², scores+AV 4·s²·h (causal
    models still count the full square — the standard convention), MLP
    2·s·h·m×2. LM head: 2·p·h·vocab over ``lm_positions`` p (MLM: only
    masked positions go through the head; LM: p = s).
    """
    h, m, s = cfg.hidden, cfg.mlp_dim, seq
    p = s if lm_positions is None else lm_positions
    per_layer = 8 * s * h * h + 4 * s * h * m + 4 * s * s * h
    return float(cfg.layers * per_layer + 2 * p * h * cfg.vocab_size)


def transformer_train_flops_per_sample(cfg, seq: int,
                                       lm_positions: Optional[int] = None
                                       ) -> float:
    """fwd + bwd ≈ 3× fwd (backward is two matmuls per forward matmul)."""
    return 3.0 * transformer_fwd_flops_per_sample(cfg, seq, lm_positions)


# dense bf16 tensor-core peak, FLOP/s, by a substring of the CUDA device
# name. Source: NVIDIA H100 data sheet (SXM part, without sparsity).
_GPU_PEAK = (
    ("H100 80GB HBM3", 989e12),
    ("H100 SXM", 989e12),
)


def chip_peak_flops(device=None) -> Optional[float]:
    """Peak bf16 FLOP/s of ``device`` (default: the current CUDA device),
    or None when unknown (CPU, unrecognized card). Override with
    BPS_PEAK_TFLOPS for new parts."""
    env = os.environ.get("BPS_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") \
            or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    for key, peak in _GPU_PEAK:
        if key in name:
            return peak
    return None


def mfu(samples_per_sec: float, flops_per_sample: float,
        device=None) -> Optional[float]:
    """Model-FLOPs utilization in [0, 1], or None when peak is unknown."""
    peak = chip_peak_flops(device)
    if not peak:
        return None
    return samples_per_sec * flops_per_sample / peak
