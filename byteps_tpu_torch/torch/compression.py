"""Intra-worker gradient compression of the torch plugin (the port's copy
of ``byteps_tpu/torch/compression.py``; reference: torch/compression.py:
1-75 — the fp16 wire cast, apart from the server-side compressor
chain)."""

from __future__ import annotations

import torch


class NoneCompressor:
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor:
    """Halve the wire bytes; decompress restores the original dtype."""

    @staticmethod
    def compress(tensor):
        if tensor.dtype.is_floating_point:
            return tensor.to(torch.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class Compression:
    none = NoneCompressor
    fp16 = FP16Compressor
