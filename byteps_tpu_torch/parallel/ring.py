"""Plain attention oracle (counterpart of
``byteps_tpu/parallel/ring.py::local_attention``).

Only the single-device reference is ported in this slice; ring attention
over a sequence-parallel group is queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

import torch


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
