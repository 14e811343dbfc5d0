"""Worker-side state of the fused compression plane (the port's copy of
``byteps_tpu/compress/plane.py``).

``CompressionPlane`` is what ``PSGradientExchange`` talks to: one per
exchange, holding

  - per-PS-key codec eligibility (size floor, fp32-only lossy math) and the
    LAYER identity the controller decides on (``<decl>.<bucket>``),
  - the controller: adaptive (``BPS_COMPRESS=auto``, the ladder capped
    by ``BPS_COMPRESS_MAX``, one decision every ``BPS_COMPRESS_INTERVAL``
    rounds) or pinned (``BPS_COMPRESS=<codec>``),
  - per-key ERROR-FEEDBACK residual state with a commit-on-pull protocol:
    ``encode`` stages the round's new residual as PENDING and ``commit``
    (called when that round's pull lands) installs it. A round that dies
    between push and pull never commits, leaving the state consistent for
    a retry. Under the sharded weight update a worker does not pull the
    buckets of groups it does not own: it commits such a bucket's residual
    when the owners' param frames for it land, the moment it knows the
    round's sum was consumed (``server/ps_mode.py::_Round.release_skipped``),
    and the owner on its pull as before.

The committed residual is a numpy array on the host-codec path and a
tensor on the device of the gradients (the card, or the CPU in tests)
while the bucket rides the device encode. Every conversion between the
two is explicit (``.cpu().numpy()``, ``torch.from_numpy(...).to(dev)``):
``np.asarray`` on a CUDA tensor raises.

Levels are PINNED PER ROUND: the exchange snapshots ``level_of`` for every
bucket when the round opens, and both the push and the pull of that round
use the snapshot, so the controller deciding again mid-round can never make
a worker pull a codec the server did not encode. A key whose level decays
back to ``none`` flushes its residual into one dense round and restarts its
fp8 sequence (``fold_residual``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..obs.metrics import MetricsRegistry, get_registry, metrics_enabled
from . import wire
from .controller import CompressController, FixedController

#: BPS_COMPRESS values that mean "plane off" (the dense path)
OFF_VALUES = ("", "0", "none", "off", "false")


def _on_host(r) -> np.ndarray:
    """A residual as a host array (a device-encode residual is a tensor)."""
    if torch.is_tensor(r):
        return r.detach().cpu().numpy()
    return np.asarray(r, np.float32)


def _on_device(r, device: torch.device) -> torch.Tensor:
    """A residual as a tensor on ``device`` (a host-codec one is numpy)."""
    if torch.is_tensor(r):
        return r.to(device)
    return torch.from_numpy(np.asarray(r, np.float32)).to(device)


class _KeyState:
    __slots__ = ("size", "dtype", "layer", "residual", "pending",
                 "m_bytes", "sr_seq")

    def __init__(self, size: int, dtype, layer: str, m_bytes) -> None:
        self.size = int(size)
        self.dtype = np.dtype(dtype)
        self.layer = layer
        self.residual = None                         # committed EF state
        self.pending: Optional[tuple] = None         # (round, residual)
        self.m_bytes = m_bytes                       # per-layer counter
        # fp8 stochastic-rounding sequence: advances per fp8 encode of this
        # key (decorrelates the noise across EF iterations beyond what the
        # round tag gives); reset by a dense round
        self.sr_seq = 0


class CompressionPlane:
    """Per-exchange fused-compression state and controller front."""

    def __init__(self, mode: str, min_bytes: int = 65536, ef: bool = True,
                 interval: int = 1, max_level: str = "int8",
                 topk_div: int = wire.TOPK_DIV,
                 registry: Optional[MetricsRegistry] = None) -> None:
        mode = (mode or "none").strip().lower()
        if mode in OFF_VALUES:
            raise ValueError("CompressionPlane constructed with mode off "
                             "— callers must skip construction instead")
        self.mode = mode
        self.min_bytes = int(min_bytes)
        self.ef = bool(ef)
        self.topk_div = int(topk_div)
        self.reg = registry if registry is not None else get_registry()
        if mode == "auto":
            self.controller = CompressController(
                registry=self.reg, max_level=max_level, interval=interval)
        else:
            self.controller = FixedController(mode, registry=self.reg)
        self._keys: Dict[int, _KeyState] = {}
        self._lock = threading.Lock()
        self._m_raw = self.reg.counter("compress/raw_bytes")
        self._m_wire = self.reg.counter("compress/wire_bytes")

    @staticmethod
    def from_config(mode: Optional[str], min_bytes: int,
                    registry: Optional[MetricsRegistry] = None
                    ) -> Optional["CompressionPlane"]:
        """The one construction recipe: env-resolved knobs
        (``BPS_COMPRESS``, ``BPS_COMPRESS_EF``, ``BPS_COMPRESS_INTERVAL``,
        ``BPS_COMPRESS_MAX``, ``BPS_COMPRESS_TOPK_DIV``), None when the
        plane is off."""
        from ..common.config import _env, _env_bool, _env_int
        mode = mode if mode is not None else _env("BPS_COMPRESS", None,
                                                  "none")
        if (mode or "none").strip().lower() in OFF_VALUES:
            return None
        if mode.strip().lower() == "auto" and not metrics_enabled():
            # BPS_STATS=0 freezes every signal the controller reads at
            # zero: auto would stay at `none` forever without a word
            from ..common.logging import get_logger
            get_logger().warning(
                "BPS_COMPRESS=auto with BPS_STATS=0: the congestion "
                "signals the controller reads are frozen, so every "
                "layer will stay at `none` — enable BPS_STATS or pin "
                "a codec (BPS_COMPRESS=int8)")
        return CompressionPlane(
            mode, min_bytes=min_bytes,
            ef=_env_bool("BPS_COMPRESS_EF", None, True),
            interval=_env_int("BPS_COMPRESS_INTERVAL", None, 1),
            max_level=_env("BPS_COMPRESS_MAX", None, "int8"),
            topk_div=_env_int("BPS_COMPRESS_TOPK_DIV", None, wire.TOPK_DIV),
            registry=registry)

    # ------------------------------------------------------ registration

    def register(self, pskey: int, size: int, dtype, layer: str) -> bool:
        """Declare a bucket to the plane; returns eligibility: fp32
        buckets at or above the compression floor."""
        dt = np.dtype(dtype)
        if dt != np.float32 or int(size) * dt.itemsize < self.min_bytes:
            return False
        with self._lock:
            if pskey not in self._keys:
                self._keys[pskey] = _KeyState(
                    size, dt, layer,
                    self.reg.counter(f"ps/push_bytes/{layer}"))
            self.controller.register_layer(layer)
        return True

    def active(self, pskey: int) -> bool:
        return pskey in self._keys

    @property
    def n_active(self) -> int:
        """How many buckets the plane compresses."""
        return len(self._keys)

    # --------------------------------------------------------- decisions

    def on_round(self) -> None:
        self.controller.on_round()

    def level_of(self, pskey: int) -> int:
        st = self._keys.get(pskey)
        if st is None:
            return wire.CODEC_NONE
        return self.controller.level_of(st.layer)

    # --------------------------------------------------------- data path

    def _sr_seed(self, pskey: int, st: _KeyState, round_tag: int,
                 level: int) -> int:
        """Worker-side fp8 seed: (key, round) folded with the key's SR
        sequence; 0 for the codecs that take no noise."""
        if level not in wire.FP8_CODECS:
            return 0
        return wire.sr_seed(pskey, round_tag) \
            ^ ((st.sr_seq * 0x9E3779B9) & 0xFFFFFFFF)

    def _account(self, st: _KeyState, nbytes: int) -> None:
        st.m_bytes.inc(nbytes)
        self._m_raw.inc(st.size * st.dtype.itemsize)
        self._m_wire.inc(nbytes)

    def encode(self, pskey: int, buf: np.ndarray, level: int,
               round_tag: int) -> bytes:
        """Compress the host bucket ``buf`` at ``level`` (> none), the
        committed residual folded in and the round's new residual staged
        as pending."""
        st = self._keys[pskey]
        x = np.asarray(buf, np.float32).reshape(-1)
        if self.ef and st.residual is not None:
            x = x + _on_host(st.residual)
        payload = wire.encode(level, x.astype(st.dtype, copy=False),
                              div=self.topk_div,
                              seed=self._sr_seed(pskey, st, round_tag, level))
        if level in wire.FP8_CODECS:
            st.sr_seq += 1
        if self.ef:
            st.pending = (round_tag,
                          x - wire.decode(payload, st.size, np.float32))
        self._account(st, len(payload))
        return payload

    def encode_on_device(self, pskey: int, parts, level: int,
                         round_tag: int) -> tuple:
        """Device-side sibling of ``encode``: the bucket is gathered,
        EF-folded and quantized on the gradients' device
        (``compress/device.py``), and only the encoded payload is copied
        to the host. ``parts`` is the bucket's segment recipe
        ``[(tensor, leaf_offset, length), ...]``. Returns ``(payload,
        d2h_bytes)``; a failure raises."""
        from . import device as cdev
        st = self._keys[pskey]
        residual = None
        if self.ef and st.residual is not None:
            residual = _on_device(st.residual, parts[0][0].device)
        payload, new_resid, d2h = cdev.encode_bucket(
            parts, st.size, level, self._sr_seed(pskey, st, round_tag, level),
            residual, self.ef)
        if level in wire.FP8_CODECS:
            st.sr_seq += 1
        if self.ef:
            st.pending = (round_tag, new_resid)
        self._account(st, len(payload))
        return payload, d2h

    def note_dense_push(self, pskey: int, nbytes: int) -> None:
        """Account a dense push of a plane-managed key into its per-layer
        ``ps/push_bytes/<layer>`` counter; a dense round resets the fp8
        sequence."""
        st = self._keys.get(pskey)
        if st is not None:
            st.m_bytes.inc(nbytes)
            st.sr_seq = 0

    def fold_residual(self, pskey: int, buf: np.ndarray,
                      round_tag: int) -> np.ndarray:
        """Dense-path sibling of ``encode`` for a key whose level is
        ``none`` while it still carries a residual: flush the residual
        into this round's push once (pending a zero state, committed like
        any round)."""
        st = self._keys.get(pskey)
        if st is None or not self.ef or st.residual is None:
            return buf
        out = (np.asarray(buf, np.float32).reshape(-1)
               + _on_host(st.residual)).astype(np.dtype(buf.dtype),
                                               copy=False)
        st.pending = (round_tag, None)      # commit clears the residual
        st.sr_seq = 0
        return out

    def decode(self, pskey: int, payload, round_tag: int) -> np.ndarray:
        """Decompress a pulled merged payload to the key's dense dtype and
        COMMIT the round's pending residual."""
        st = self._keys[pskey]
        out = wire.decode(payload, st.size, st.dtype)
        self.commit(pskey, round_tag)
        return out

    def commit(self, pskey: int, round_tag: int) -> None:
        st = self._keys.get(pskey)
        if st is None or st.pending is None:
            return
        tag, resid = st.pending
        if tag == round_tag:
            st.residual = resid
            st.pending = None
