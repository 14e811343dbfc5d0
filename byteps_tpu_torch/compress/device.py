"""Device-side encode of the fused compression plane: encode the bucket
BEFORE the copy to the host (the port's copy of
``byteps_tpu/compress/device.py``).

Per bucket, on the gradients' device:

    gather segments -> fold the EF residual -> amax (a 4-byte copy to the
    host) -> the host computes the scale -> quantize kernel -> one copy of
    the ENCODED bytes to the host

so the device-to-host copy, the host pack and the wire shrink together
(about 4x for int8 and fp8). The new error-feedback residual
``x - dequant(q)`` is computed on the device and never crosses to the host;
the plane's commit-on-pull protocol holds it unchanged.

Byte-identity contract: the payload is BYTE-IDENTICAL to ``wire.encode`` on
the same dense input: the scale is ``wire.scale_from_amax`` on the host
(numpy's IEEE division; the device reduces only the exact amax), and the
kernels divide with correct rounding and share the fp8 bit math of
``fp8sr.sr_quantize_bits``. ``_probe`` checks this once per process and
device on an adversarial vector. Unlike the JAX package, the port never
falls back to the host codec: a byte mismatch or a failing kernel raises.

``BPS_COMPRESS_DEVICE``: ``auto`` (default: on for CUDA gradients, off on
the CPU), ``1`` (on; on CPU tensors the kernels' plain versions run, as the
tests do), ``0`` (off: the host codec, for CPU tensors only). Gradients on
the card are always encoded there: ``0`` with CUDA gradients raises rather
than copy the dense bucket to the host and quantize it in numpy.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import List, Optional

import numpy as np
import torch

from ..ops.compression import fp8sr
from ..ops.compression import kernels as qk
from . import wire

#: codecs the device pipeline produces (topk and fp16 stay on the host)
DEVICE_CODECS = (wire.CODEC_INT8, wire.CODEC_FP8_E4M3, wire.CODEC_FP8_E5M2)

_OFF = ("0", "off", "false", "none")
_ON = ("1", "on", "true")

_probe_lock = threading.Lock()
_probed: set = set()          # devices whose probe passed, by str(device)


def _fp8_kind(level: int) -> int:
    return fp8sr.E4M3 if level == wire.CODEC_FP8_E4M3 else fp8sr.E5M2


def _fp8_decode_device(q: torch.Tensor, kind: int) -> torch.Tensor:
    """fp8 byte encodings -> f32 on the device, as int32 bit math (no fp8
    dtype); value-identical to ``fp8sr.decode_bits`` on every code an
    encode makes. Plain tensor ops: the JAX package's twin is a ``jnp``
    expression, not a Pallas kernel."""
    _, mant, base, emin, e_sub, _ = fp8sr.fmt_params(kind)
    b = q.to(torch.int32)
    sign = b >> 7
    mag8 = b & 0x7F
    e8 = mag8 >> mant
    f8 = mag8 & ((1 << mant) - 1)
    norm = (((e8 + (emin - 1)) << 23) | (f8 << base)).view(torch.float32)
    sub = f8.to(torch.float32) * float(2.0 ** (e_sub - 127))
    val = torch.where(e8 > 0, norm, sub)
    return torch.where(sign > 0, -val, val)


def _gather_amax(parts: List[tuple], residual: Optional[torch.Tensor],
                 ef: bool):
    """The bucket's flat f32 view on the device, the residual folded in,
    and its amax (a 0-dim tensor, still on the device)."""
    xs = [leaf.reshape(-1)[off:off + ln].to(torch.float32)
          for leaf, off, ln in parts]
    x = xs[0] if len(xs) == 1 else torch.cat(xs)
    if ef:
        x = x + residual
    return x, x.abs().max()


def _quantize(x: torch.Tensor, scale: np.float32, seed: int, level: int,
              ef: bool, plain: bool):
    """Quantize at the host-computed scale; the new device residual when
    ``ef``. ``plain`` runs the kernels' plain versions on any device (the
    on-card reference of ``chip_smoke.py``)."""
    if level == wire.CODEC_INT8:
        q = (qk.int8_quantize_plain if plain else qk.int8_quantize)(x, scale)
        if not ef:
            return q, None
        deq = (qk.int8_dequantize_plain if plain
               else qk.int8_dequantize)(q, scale)
    else:
        kind = _fp8_kind(level)
        q = (qk.fp8_sr_quantize_plain if plain
             else qk.fp8_sr_quantize)(x, scale, seed, kind)
        if not ef:
            return q, None
        deq = _fp8_decode_device(q, kind) * torch.tensor(
            np.float32(scale), dtype=torch.float32, device=x.device)
    return q, x - deq


def encode_bucket(parts: List[tuple], size: int, level: int, seed: int,
                  residual: Optional[torch.Tensor], ef: bool,
                  plain: bool = False) -> tuple:
    """Encode one bucket on the device of its leaves. ``parts`` =
    ``[(tensor, leaf_offset, length), ...]`` in bucket-segment order
    covering exactly ``size`` f32 elements. Returns ``(payload bytes, new
    device residual or None, d2h_bytes)``.

    Two device stages with a 4-byte amax copy between them: the copy lets
    the scale take the host division every other encode site uses, and
    the payload's copy follows at once."""
    if level not in DEVICE_CODECS:
        raise ValueError(f"codec {wire.codec_name(level)} has no device "
                         f"encode")
    if ef and residual is None:
        residual = torch.zeros(size, dtype=torch.float32,
                               device=parts[0][0].device)
    x, amax = _gather_amax(parts, residual, ef)
    denom = (127.0 if level == wire.CODEC_INT8
             else fp8sr.fmt_max(_fp8_kind(level)))
    scale = wire.scale_from_amax(np.float32(amax.item()), denom)  # 4 B
    q, new_r = _quantize(x, scale, seed & 0xFFFFFFFF, level, ef, plain)
    body = q.cpu().numpy().tobytes()        # the only bulk copy to the host
    hdr = wire._HDR.pack(wire.MAGIC, wire.VERSION, level,
                         b"float32".ljust(8, b"\0"), size)
    return hdr + struct.pack("<f", scale) + body, new_r, len(body) + 4


def probe_vector() -> np.ndarray:
    """The probe's adversarial vector: normal values, small and large
    ones, round-half-even ties, zeros of both signs, binade edges and
    values far under the fp8 subnormal range."""
    rng = np.random.RandomState(0xB5C1)
    return np.concatenate([
        rng.randn(3800).astype(np.float32),
        rng.randn(120).astype(np.float32) * 1e-4,
        rng.randn(120).astype(np.float32) * 1e3,
        np.array([0.0, -0.0, 0.5, -0.5, 1.0, 2.0 ** -10, -2.0 ** -10,
                  3.5, -3.5] * 6 + [1e-30, -1e-30], np.float32)])


def _probe(device) -> bool:
    """Bitwise probe: device payloads must equal the host codec's on the
    adversarial vector, for every device codec. Raises on a mismatch."""
    x = probe_vector()
    xd = torch.from_numpy(x).to(device)
    for cid in DEVICE_CODECS:
        host = wire.encode(cid, x, seed=1234)
        dev, _, _ = encode_bucket([(xd, 0, x.size)], x.size, cid, 1234,
                                  None, False)
        if dev != host:
            raise RuntimeError(
                f"BPS_COMPRESS_DEVICE: the {wire.codec_name(cid)} payload "
                f"encoded on {device} differs from the host codec's on the "
                f"probe vector; the device encode is not byte-identical")
    return True


def device_encode_enabled(device) -> bool:
    """Resolve ``BPS_COMPRESS_DEVICE`` for gradients on ``device``,
    probing once per process and device when on."""
    device = torch.device(device)
    v = (os.environ.get("BPS_COMPRESS_DEVICE", "auto") or "auto") \
        .strip().lower()
    if v in _OFF:
        if device.type == "cuda":
            raise ValueError(
                f"BPS_COMPRESS_DEVICE={v}: gradients on {device} are encoded "
                f"by the card's quantize kernels, never copied dense to the "
                f"host codec; unset it (auto) or set it to 1")
        return False
    if v == "auto":
        if device.type != "cuda":
            return False
    elif v not in _ON:
        raise ValueError(f"BPS_COMPRESS_DEVICE={v!r}: expected auto, 1 or 0")
    with _probe_lock:
        if str(device) not in _probed:
            _probe(device)
            _probed.add(str(device))
    return True


def reset_probe() -> None:
    """Forget the cached probe verdicts (tests flip envs)."""
    with _probe_lock:
        _probed.clear()
