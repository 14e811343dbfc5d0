"""TCP transport for the host reduction service (the port's copy of the
sync-PS part of ``byteps_tpu/server/transport.py``; reference: the ps-lite
TCP van, worker call sites ZPush/ZPull core_loops.cc:567-613).

Wire protocol, byte for byte the JAX package's: one persistent connection
per pooled channel, length-prefixed binary frames::

    request  := op:u8 | key:u64 | round:u64 | nbytes:u64 | timeout_ms:u64
                | plen:u64 | dtype:u8[8] | payload[plen]
    response := status:u8 | nbytes:u64 | payload[nbytes]

Ported ops: 1=INIT (``nbytes`` = store size, payload = optional initial
value, ``round`` bit 0 = the fused-plane declaration), 2=PUSH (``round`` =
the dedup token ``incarnation << 32 | per-key seq``), 3=PULL (``round`` =
the sync round, response = the merged buffer), 4=CLOSE, 5=INIT_C / 6=PUSH_C
/ 7=PULL_C (the legacy compression chains, ``server/compressed.py``),
8=PUSH_RS (a row-sparse push, ``server/rowsparse.py``: ``nbytes`` = the
dense table's size, payload = n:u32 | idx:i32[n] | rows[n·cols], ``round``
= the dedup token; the server scatters it into a dense table that the
engine sums, pinning each key's cols at its first push), 9=ROUND (the
key's latest completed round, u64), 17=PUSH_F / 18=PULL_F (the
fused compression plane: a self-describing codec payload; the pull's
payload is codec:u8 | topk div:u16le), 21=PARAM_PUT / 22=PARAM_GET /
24=PARAM_SEQ (the sharded weight update's param mailbox,
``sharded_update.py::ParamStore``: ``key`` = the param-class key, bit 41 |
decl << 16 | group, ``round`` = the step's seq; PUT is last-wins per
(key, seq), GET blocks server-side until the frame arrives and does not
consume it, SEQ answers the newest retained seq as u64, 0 = none),
26=LAG_DECL / 27=PUSH_LAG / 28=PULL_LAG (bounded staleness,
``server/admission.py::StaleStore``: DECL declares a key's bound,
``round`` = K, and is replayed after the inits on a reconnect; PUSH_LAG and
PULL_LAG carry ``round = worker << 48 | round``, which is also the push's
dedup token, and the pull's reply leads with one verdict byte, the
``admission.LAG_*`` flags, before the dense sum). Status:
0=OK, 1=error (the message
rides as payload and the connection stays usable), 2=timeout, 3=gone (the
server is shutting down: the client reconnects).

Every other op of the JAX package answers ``ST_ERR`` with a message that
names its ROADMAP.md item, and the connection stays usable.

A PUSH or PULL frame may name another dtype than the key's store: the
server casts a push to the store's dtype and a pull's reply to the
frame's, so an async worker's bf16 weight delta (``BPS_ASYNC_WIRE_DTYPE``)
lands in an fp32 store; bfloat16 goes through ``common/bf16.py``, since
the port runs without ``ml_dtypes``. With an async server (``PSServer(...,
async_mode=True)``) a PULL never waits and ``OP_ROUND`` counts the pushes
folded; ``RemotePSBackend(async_mode=True)``'s ``push_pull`` pulls the
store as it is.

``PSTransportServer`` fronts a ``PSServer`` (wrapped in ``FusedFront``, so
fused keys have their homogeneous store, or at ``BPS_FUSED_HOMOG=0`` the
engine-side route of ``server/homog.py``, and given a ``StaleStore`` of the
transport's own at the first lag declaration, whose rounds ``OP_ROUND``
then answers) or a ``HostPSBackend`` (which keeps both itself) with one
thread per connection. ``RemotePSBackend`` is the worker-side client with
``HostPSBackend``'s interface, so ``PSGradientExchange`` runs unchanged
across processes: keys placed over the servers by djb2, a pool of
``BPS_PS_CONNS`` channels per server (a round-blocked pull holds its
channel, so pushes need others), round-blocked pulls sliced into short
server-side waits under one client deadline (``BPS_PULL_TIMEOUT_MS``),
reconnect with init replay for ``BPS_RECONNECT_SECS``, and payload frames
gated by the wire credit (``BPS_SCHEDULING_CREDIT``,
``server/admission.py::SendScheduler``): gradient frames in its gradient
class, param PUT frames in its latency class. The param mailbox's ops ride
connections of their own, a pool that grows to the number of ops in flight
(dialed at first use), so a mailbox op never waits for a connection: a GET
waits (sliced like a pull) for a frame that its owner publishes only after
this worker's pushes reached it, and holding a data-plane connection, or
one a PUT needs, could keep those pushes or this worker's own frames off
the wire and wedge both workers.
"""

from __future__ import annotations

import os
import queue
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import bf16
from ..common.logging import get_logger
from ..common.naming import log_key_placement, place_key
from ..obs.metrics import get_registry

_HDR = struct.Struct("!BQQQQQ8s")   # op, key, round, nbytes, timeout, plen, dtype
_RSP = struct.Struct("!BQ")

OP_INIT, OP_PUSH, OP_PULL, OP_CLOSE = 1, 2, 3, 4
OP_INIT_C, OP_PUSH_C, OP_PULL_C = 5, 6, 7
OP_PUSH_RS = 8
OP_ROUND = 9
OP_PUSH_F, OP_PULL_F = 17, 18
OP_PARAM_PUT, OP_PARAM_GET, OP_PARAM_SEQ = 21, 22, 24
OP_LAG_DECL, OP_PUSH_LAG, OP_PULL_LAG = 26, 27, 28
ST_OK, ST_ERR, ST_TIMEOUT, ST_GONE = 0, 1, 2, 3
# a lag frame's round field: worker << 48 | round
_LAG_ROUND_MASK = (1 << 48) - 1

_NOT_PORTED = "is not ported yet (see ROADMAP.md, 'Modules still to port'"

# the JAX package's other ops: op -> (what, ROADMAP queue 1 item)
UNPORTED_OPS: Dict[int, Tuple[str, int]] = {
    10: ("shared-memory push OP_PUSH_SHM", 6),
    11: ("shared-memory pull OP_PULL_SHM", 6),
    12: ("striped push OP_PUSH_PART", 6),
    13: ("striped pull OP_PULL_PART", 6),
    14: ("replica log OP_REPL_PUT", 8),
    15: ("replica log OP_REPL_GET", 8),
    16: ("replica log OP_REPL_BASE", 8),
    19: ("activation mailbox OP_ACT_PUSH", 7),
    20: ("activation mailbox OP_ACT_PULL", 7),
    23: ("fleet stats scrape OP_STATS", 9),
    25: ("trace scrape OP_TRACE", 9),
    29: ("embedding store OP_EMBED_INIT", 8),
    30: ("embedding store OP_EMBED_PULL", 8),
    31: ("embedding store OP_EMBED_PUSH", 8),
    32: ("embedding store OP_EMBED_REPL", 8),
    33: ("embedding store OP_EMBED_FAILOVER", 8),
    34: ("embedding store OP_EMBED_SNAP", 8),
    35: ("embedding store OP_EMBED_RESTORE", 8),
}

# env knobs the JAX transport and launcher read whose features are not
# ported: env -> (legacy name, what it selects, ROADMAP queue 1 item, the
# values that keep the JAX package's default). Any other value raises
# where the role would read it.
_OFF = ("", "0", "false")
CLIENT_REFUSED = {
    "BPS_STRIPE_MIN": (None, "connection striping", 6, _OFF),
    "BPS_ENABLE_SHM": (None, "the shared-memory data plane", 6, _OFF),
    "BPS_ENABLE_IPC": ("BYTEPS_ENABLE_IPC", "the Unix-socket upgrade", 6,
                       _OFF),
    "BPS_REDUCE_ROOTS": ("BYTEPS_REDUCE_ROOTS",
                         "key placement over reduce roots", 8, ("",)),
}
SERVER_REFUSED = {
    "BPS_ENABLE_IPC": ("BYTEPS_ENABLE_IPC", "the Unix-socket listener", 6,
                       _OFF),
    "BPS_KEY_LOG": ("PS_KEY_LOG", "the per-key traffic log", 9, _OFF),
}
LAUNCHER_REFUSED = {
    "BPS_SERVER_SNAPSHOT": (None, "server snapshots", 6, ("",)),
    "BPS_NIC_RATE": (None, "the emulated NIC of a server", 8, _OFF),
}


def check_refused_env(table: Dict[str, tuple], env=None) -> None:
    """Raise ``NotImplementedError`` for a knob of ``table`` set to a
    value that selects its feature."""
    env = os.environ if env is None else env
    for name, (legacy, what, item, keep) in table.items():
        for n in (name, legacy):
            v = env.get(n) if n else None
            if v is not None and v.strip().lower() not in keep:
                raise NotImplementedError(
                    f"{n}={v!r}: {what} {_NOT_PORTED}, queue 1, item "
                    f"{item}); the port refuses the knob rather than run "
                    f"its default path")


class _ServerTimeout(TimeoutError):
    """An ST_TIMEOUT reply: an application answer on a healthy connection,
    unlike the OS's TimeoutError, which takes the reconnect path."""


# applied seqs kept as an exact set above a contiguous floor
_DEDUP_WINDOW = 256


class _DedupState:
    """Per-(key, worker-incarnation) push-dedup record."""

    __slots__ = ("floor", "applied", "claims", "ts")

    def __init__(self) -> None:
        self.floor = 0              # every seq <= floor is applied
        self.applied: set = set()   # applied seqs above the floor
        self.claims: set = set()    # seqs whose apply is in flight
        self.ts = 0.0

    def is_applied(self, seq: int) -> bool:
        return seq <= self.floor or seq in self.applied

    def record(self, seq: int) -> None:
        self.applied.add(seq)
        while (self.floor + 1) in self.applied:
            self.floor += 1
            self.applied.discard(self.floor)
        while len(self.applied) > _DEDUP_WINDOW:
            low = min(self.applied)
            self.applied.discard(low)
            self.floor = max(self.floor, low)


def _as_bytes(arr) -> memoryview:
    """Byte view of a numpy array; dtypes outside the buffer protocol
    (bfloat16) go through a uint8 reinterpret."""
    a = np.ascontiguousarray(arr)
    try:
        return memoryview(a).cast("B")
    except (ValueError, TypeError):
        return memoryview(a.view(np.uint8))


def _recv_exact(sock, n: int) -> memoryview:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf))
    return memoryview(buf)


def _recv_exact_into(sock, view: memoryview) -> None:
    """Fill ``view`` from the socket: dense pulls land in the caller's
    array."""
    n = len(view)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r


def _byteview(p) -> memoryview:
    v = p if isinstance(p, memoryview) else memoryview(p)
    if v.itemsize != 1 or v.ndim != 1:
        v = v.cast("B")
    return v


def _send_frame(sock, hdr, parts) -> None:
    """Header and payload parts in one vectored ``sendmsg``; a short write
    resumes at the first unsent byte."""
    bufs = [_byteview(hdr)] + [_byteview(p) for p in parts]
    while bufs:
        n = sock.sendmsg(bufs[:1024])       # IOV_MAX
        while bufs and n >= len(bufs[0]):
            n -= len(bufs[0])
            bufs.pop(0)
        if n:
            bufs[0] = bufs[0][n:]


def _send_req(sock, op: int, key: int, rnd: int, nbytes: int,
              timeout_ms: int, dtype: str, payload) -> None:
    """One request frame; ``payload``: None, one buffer, or a sequence of
    buffers sent back to back."""
    parts = ([] if payload is None
             else list(payload) if isinstance(payload, (tuple, list))
             else [payload])
    parts = [_byteview(p) for p in parts]
    plen = sum(len(p) for p in parts)
    hdr = _HDR.pack(op, key, rnd, nbytes, timeout_ms, plen,
                    dtype.encode()[:8].ljust(8, b"\0"))
    if not parts:
        sock.sendall(hdr)
        return
    _send_frame(sock, hdr, parts)


# ops whose handlers consume the payload before the next frame is read, so
# a large payload may land in the connection's reused buffer
_REUSE_SAFE_OPS = frozenset({OP_INIT, OP_PUSH, OP_PUSH_C, OP_PUSH_F,
                             OP_PUSH_RS,      # scattered into a new table
                             OP_PARAM_PUT,    # the store copies: bytes()
                             OP_PUSH_LAG})    # the store folds (+=)


def _recv_req(sock, rholder: Optional[list] = None):
    op, key, rnd, nbytes, timeout, plen, dt = _HDR.unpack(
        _recv_exact(sock, _HDR.size))
    if not plen:
        payload = None
    elif (rholder is not None and plen > (64 << 10)
            and op in _REUSE_SAFE_OPS):
        # grown by replacement: the caller may still hold a view of the
        # previous frame, and resizing an exported bytearray raises
        if len(rholder[0]) < plen:
            rholder[0] = bytearray(plen)
        payload = memoryview(rholder[0])[:plen]
        _recv_exact_into(sock, payload)
    else:
        payload = _recv_exact(sock, plen)
    return op, key, rnd, nbytes, timeout, dt.rstrip(b"\0").decode(), payload


# ------------------------------------------------------------------ server

class PSTransportServer:
    """Threaded TCP front for a local summation backend (``PSServer`` or
    ``HostPSBackend``): one thread per connection, one request at a time
    on each."""

    def __init__(self, backend, host: str = "0.0.0.0",
                 port: int = 0) -> None:
        check_refused_env(SERVER_REFUSED)
        self.backend = backend
        # the fused front: a backend with a fused surface of its own
        # (HostPSBackend) handles managed keys itself; a raw PSServer is
        # wrapped so the homogeneous store exists on every deployment
        if hasattr(backend, "push_fused"):
            self._fb = backend
        else:
            from .homog import FusedFront
            self._fb = FusedFront(backend,
                                  getattr(backend, "num_workers", 1))
        from .compressed import CompressedKeyStore
        self.compressed = CompressedKeyStore()
        # key -> (nbytes, dtype) from INIT/INIT_C: the wire transcode's
        # store dtype
        self._key_meta: Dict[int, Tuple[int, str]] = {}
        self._rs_cols: Dict[int, int] = {}   # row-sparse: pinned cols a key
        # (key, incarnation) -> _DedupState: a push retried after a lost
        # ACK carries its token again and is acknowledged, not re-applied;
        # a retry racing the original's apply waits for its outcome
        self._push_seen: Dict[Tuple[int, int], _DedupState] = {}
        self._push_lock = threading.Lock()
        self._push_cv = threading.Condition(self._push_lock)
        self._dedup_ttl = float(os.environ.get(
            "BPS_PUSH_DEDUP_TTL_SECS", "600"))
        self._dedup_sweep_at = 0.0
        reg = get_registry()
        self._m_requests = reg.counter("transport/requests")
        self._m_merge_wait = reg.histogram("server/merge_wait_s")
        self._m_rowsparse = reg.counter("server/rowsparse_pushes")
        self._m_rowsparse_bytes = reg.counter("server/rowsparse_push_bytes")
        # the param mailbox (the sharded weight update), made at its
        # first use: plain deployments never allocate it
        self._params = None
        self._params_lock = threading.Lock()
        # the bounded-staleness store of a raw engine, made at the first
        # lag declaration (a HostPSBackend keeps its own)
        self._stale = None
        self._stale_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="bps-ps-accept")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="bps-ps-conn").start()

    def _handle(self, conn, op, key, rnd, nbytes, timeout, dtype,
                payload) -> None:
        """One request; backend errors become ST_ERR / ST_TIMEOUT / ST_GONE
        responses and the connection stays up."""
        self._m_requests.inc()
        try:
            if op == OP_INIT:
                init = (bf16.frombuffer(payload, dtype)
                        if payload is not None else None)
                self._fb.init_key(key, nbytes, dtype, init=init,
                                  fused=bool(int(rnd) & 1))
                self._key_meta[key] = (int(nbytes), dtype)
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PUSH:
                # wire transcode: a frame dtype narrower than the store
                # lands in the store's dtype (bf16 without ml_dtypes)
                arr = bf16.frombuffer(payload, dtype)
                meta = self._key_meta.get(key)
                if meta is not None and meta[1] != dtype:
                    arr = bf16.cast(arr, meta[1])
                self._apply_push_once(key, rnd,
                                      lambda: self._fb.push(key, arr))
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PULL:
                out = self._pull_dense(key, rnd, nbytes, dtype, timeout)
                _send_frame(conn, _RSP.pack(ST_OK, out.nbytes),
                            [_as_bytes(out)])
            elif op == OP_INIT_C:
                from ..ops.compression.host import deserialize_kwargs
                kwargs = deserialize_kwargs(bytes(payload or b""))
                if hasattr(self.backend, "push_bytes"):
                    self.backend.init_key(key, nbytes, dtype,
                                          compression=kwargs)
                else:
                    self.compressed.register(
                        key, kwargs, nbytes // np.dtype(dtype).itemsize,
                        dtype)
                    self.backend.init_key(key, nbytes, dtype)
                self._key_meta[key] = (int(nbytes), dtype)
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PUSH_C:
                pay = bytes(payload or b"")
                self._apply_push_once(key, rnd,
                                      lambda: self._push_compressed(key, pay))
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PULL_C:
                if hasattr(self.backend, "pull_bytes"):
                    buf = self.backend.pull_bytes(
                        key, round=int(rnd), timeout_ms=int(timeout) or 30000)
                else:
                    from .compressed import compressed_pull
                    buf = compressed_pull(self.compressed, self.backend, key,
                                          int(rnd), int(timeout) or 30000)
                conn.sendall(_RSP.pack(ST_OK, len(buf)))
                conn.sendall(buf)
            elif op == OP_PUSH_F:
                self._no_chain(key)
                pay = bytes(payload)
                self._apply_push_once(
                    key, rnd, lambda: self._fb.push_fused(key, pay))
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PULL_F:
                from ..compress import wire
                self._no_chain(key)
                pb = bytes(payload or b"\0")
                cid = int(pb[0])
                div = (struct.unpack("<H", pb[1:3])[0] if len(pb) >= 3
                       else wire.TOPK_DIV)
                t0 = time.time()
                buf = self._fb.pull_fused(
                    key, int(nbytes), dtype, cid, round=int(rnd),
                    timeout_ms=int(timeout) or 30000,
                    div=div or wire.TOPK_DIV)
                self._m_merge_wait.observe(time.time() - t0)
                conn.sendall(_RSP.pack(ST_OK, len(buf)))
                conn.sendall(buf)
            elif op == OP_PUSH_RS:
                from .rowsparse import rowsparse_push, unpack_rows
                idx, rows = unpack_rows(payload, dtype)
                if self._apply_push_once(
                        key, rnd, lambda: rowsparse_push(
                            self.backend, key, idx, rows, int(nbytes), dtype,
                            meta=self._rs_cols)):
                    self._m_rowsparse.inc()
                    self._m_rowsparse_bytes.inc(len(payload))
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_ROUND:
                # a transport-owned lag store versions the key's rounds
                # itself: a rejoining worker must see its counter
                if self._stale is not None and self._stale.managed(key):
                    rv = struct.pack("!Q", int(self._stale.round(key)))
                else:
                    rv = struct.pack("!Q", int(self._fb.round(key)))
                conn.sendall(_RSP.pack(ST_OK, len(rv)) + rv)
            elif op == OP_PARAM_PUT:
                self.param_store().put(key, int(rnd), bytes(payload or b""))
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PARAM_GET:
                data = self.param_store().get(
                    key, int(rnd), timeout_ms=int(timeout) or 30000)
                _send_frame(conn, _RSP.pack(ST_OK, len(data)), [data])
            elif op == OP_PARAM_SEQ:
                rv = struct.pack("!Q", int(self.param_store().latest(key)))
                conn.sendall(_RSP.pack(ST_OK, len(rv)) + rv)
            elif op == OP_LAG_DECL:
                self._lag_declare(key, int(rnd))
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PUSH_LAG:
                w, r = int(rnd) >> 48, int(rnd) & _LAG_ROUND_MASK
                arr = bf16.frombuffer(payload, dtype)
                meta = self._key_meta.get(key)
                if meta is not None and meta[1] != dtype:
                    arr = bf16.cast(arr, meta[1])
                # the packed round is the dedup token: ident (key,
                # worker << 16), seq the round, so a retried (worker,
                # round) folds once
                self._apply_push_once(
                    key, rnd, lambda: self._lag_push(key, w, r, arr))
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PULL_LAG:
                w, r = int(rnd) >> 48, int(rnd) & _LAG_ROUND_MASK
                out = np.empty(int(nbytes) // bf16.np_dtype(dtype).itemsize,
                               dtype=bf16.np_dtype(dtype))
                flags = self._lag_pull(key, w, r, out,
                                       int(timeout) or 30000)
                _send_frame(conn,
                            _RSP.pack(ST_OK, 1 + out.nbytes)
                            + bytes([flags & 0xFF]),
                            [_as_bytes(out)])
            elif op in UNPORTED_OPS:
                what, item = UNPORTED_OPS[op]
                raise NotImplementedError(
                    f"op {op} ({what}) {_NOT_PORTED}, queue 1, item "
                    f"{item})")
            else:
                conn.sendall(_RSP.pack(ST_ERR, 0))
        except TimeoutError as e:
            msg = str(e).encode()
            conn.sendall(_RSP.pack(ST_TIMEOUT, len(msg)) + msg)
        except Exception as e:   # noqa: BLE001 — relayed to the client
            from .engine import ServerClosed
            if isinstance(e, ServerClosed):
                msg = str(e).encode()
                conn.sendall(_RSP.pack(ST_GONE, len(msg)) + msg)
            else:
                msg = f"{type(e).__name__}: {e}".encode()[:4096]
                conn.sendall(_RSP.pack(ST_ERR, len(msg)) + msg)

    def _no_chain(self, key: int) -> None:
        """A key with a legacy chain on a raw engine refuses fused payloads
        (a ``HostPSBackend`` checks its own chains)."""
        if self._fb is not self.backend and self.compressed.has(key):
            raise KeyError(f"key {key} carries a legacy compression chain: "
                           f"its payloads go through OP_PUSH_C/OP_PULL_C, "
                           f"never the fused plane")

    def param_store(self):
        """This server's param mailbox (``sharded_update.ParamStore``)."""
        if self._params is None:
            with self._params_lock:
                if self._params is None:
                    from ..sharded_update import ParamStore
                    self._params = ParamStore()
        return self._params

    # -- bounded staleness: a backend with a lag surface of its own
    # (HostPSBackend) serves the versioned rounds itself; a raw engine
    # gets a store of the transport's, as it gets FusedFront

    def _lag_local(self):
        if self._stale is None:
            with self._stale_lock:
                if self._stale is None:
                    from .admission import StaleStore
                    self._stale = StaleStore(
                        getattr(self.backend, "num_workers", 1))
        return self._stale

    def _lag_declare(self, key: int, max_lag: int) -> None:
        if hasattr(self.backend, "declare_lag"):
            self.backend.declare_lag(key, max_lag)
            return
        meta = self._key_meta.get(key)
        if meta is None:
            raise KeyError(f"declare_lag({key}) before init")
        nbytes, dtype = meta
        self._lag_local().declare(
            key, nbytes // np.dtype(dtype).itemsize, dtype, max_lag)

    def _lag_push(self, key: int, worker: int, rnd: int,
                  arr: np.ndarray) -> None:
        if hasattr(self.backend, "push_lag"):
            self.backend.push_lag(key, worker, rnd, arr)
            return
        self._lag_local().push(key, worker, rnd, arr)

    def _lag_pull(self, key: int, worker: int, rnd: int, out: np.ndarray,
                  timeout_ms: int) -> int:
        if hasattr(self.backend, "pull_lag"):
            return int(self.backend.pull_lag(key, worker, rnd, out,
                                             timeout_ms))
        t0 = time.time()
        flags = self._lag_local().pull(key, worker, rnd, out, timeout_ms)
        self._m_merge_wait.observe(time.time() - t0)
        return int(flags)

    def _push_compressed(self, key: int, payload: bytes) -> None:
        if hasattr(self.backend, "push_bytes"):
            self.backend.push_bytes(key, payload)
            return
        from .compressed import compressed_push
        compressed_push(self.compressed, self.backend, key, payload)

    def _pull_dense(self, key, rnd, nbytes, dtype, timeout) -> np.ndarray:
        """Round-blocked pull in the frame's dtype (a narrower one than the
        store's downcasts on the way out)."""
        t0 = time.time()
        elems = int(nbytes) // bf16.np_dtype(dtype).itemsize
        meta = self._key_meta.get(key)
        if meta is not None and meta[1] != dtype:
            store = np.empty(elems, dtype=bf16.np_dtype(meta[1]))
            self._fb.pull(key, store, round=int(rnd),
                          timeout_ms=int(timeout) or 30000)
            out = bf16.cast(store, dtype)
        else:
            out = np.empty(elems, dtype=bf16.np_dtype(dtype))
            self._fb.pull(key, out, round=int(rnd),
                          timeout_ms=int(timeout) or 30000)
        # the merge's wait: sum time plus the slowest worker's push lag
        self._m_merge_wait.observe(time.time() - t0)
        return out

    def _apply_push_once(self, key: int, rnd: int, apply_fn) -> bool:
        """Run ``apply_fn`` once per dedup token; True when this call
        applied. Tokenless pushes (``rnd`` 0) apply every time. A
        duplicate of an applied seq is acknowledged; one racing the
        original's apply waits for its outcome. The applied mark is
        recorded only after the backend took the payload."""
        if not rnd:
            apply_fn()
            return True
        ident = (key, rnd >> 32)
        seq = rnd & 0xFFFFFFFF
        now = time.time()
        with self._push_lock:
            if now >= self._dedup_sweep_at:
                self._dedup_sweep_at = now + self._dedup_ttl / 4
                dead = [k for k, st in self._push_seen.items()
                        if now - st.ts > self._dedup_ttl and not st.claims]
                for k in dead:
                    del self._push_seen[k]
            st = self._push_seen.get(ident)
            if st is None:
                st = self._push_seen[ident] = _DedupState()
            while True:
                if st.is_applied(seq):
                    st.ts = now
                    return False
                if seq not in st.claims:
                    st.claims.add(seq)
                    break
                self._push_cv.wait(1.0)
        try:
            apply_fn()
        except BaseException:
            with self._push_lock:
                st.claims.discard(seq)
                self._push_cv.notify_all()
            raise
        with self._push_lock:
            st.record(seq)
            st.ts = time.time()
            st.claims.discard(seq)
            self._push_cv.notify_all()
        return True

    def _serve_conn(self, conn) -> None:
        rholder = [bytearray()]  # reused across this connection's frames
        try:
            while True:
                op, key, rnd, nbytes, timeout, dtype, payload = \
                    _recv_req(conn, rholder)
                if op == OP_CLOSE:
                    conn.sendall(_RSP.pack(ST_OK, 0))
                    return
                self._handle(conn, op, key, rnd, nbytes, timeout, dtype,
                             payload)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def close(self) -> None:
        """Stop accepting; open connections end with their clients."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


# ------------------------------------------------------------------ client

class _Channel:
    """One pooled connection; ``sock`` is None until first use."""

    __slots__ = ("sock",)

    def __init__(self, sock) -> None:
        self.sock = sock


class RemotePSBackend:
    """Worker-side client with ``HostPSBackend``'s interface over N
    transport servers (keys placed by djb2; reference: global.cc:628-677).

    A dropped connection is redialed with backoff for ``reconnect_secs``
    (``BPS_RECONNECT_SECS``, default 30; 0 disables), the accepted
    ``init_key`` calls are replayed on the fresh connection, and the
    request is re-sent whole (``transport/resends``). A push carries the
    token ``incarnation << 32 | per-key seq``, so a push whose ACK was lost
    is applied once by a server that survived; the incarnation is fresh
    for every client, so a restarted worker's pushes are never taken for
    its predecessor's."""

    # payload frames of the gradient class under the wire credit
    _SCHED_GRAD_OPS = frozenset({OP_PUSH, OP_PUSH_C, OP_PUSH_RS, OP_PUSH_F,
                                 OP_PUSH_LAG})
    # the param mailbox's ops, on channels of their own
    _PARAM_OPS = frozenset({OP_PARAM_PUT, OP_PARAM_GET, OP_PARAM_SEQ})
    # round-blocked pulls wait on the server in slices of this length, so
    # connection churn costs at most one slice of the caller's deadline
    _PULL_SLICE_MS = 2000

    def __init__(self, addrs: Sequence[str],
                 reconnect_secs: Optional[float] = None,
                 conns_per_shard: Optional[int] = None,
                 async_mode: bool = False) -> None:
        check_refused_env(CLIENT_REFUSED)
        if not addrs:
            raise ValueError("RemotePSBackend needs at least one host:port")
        self._addrs = [a.rsplit(":", 1) for a in addrs]
        # the servers fold weight deltas (BPS_ENABLE_ASYNC): push_pull
        # reads the store as it is
        self.async_mode = async_mode
        self._dead = False      # set by close(): aborts redial loops
        self.reconnect_secs = (
            float(os.environ.get("BPS_RECONNECT_SECS", "30"))
            if reconnect_secs is None else reconnect_secs)
        # the pool of channels a server: the server serves one request a
        # connection at a time, so a round-blocked pull holds its channel
        # and pushes need the others
        self._nconns = max(1, int(os.environ.get("BPS_PS_CONNS", "4"))
                           if conns_per_shard is None else conns_per_shard)
        self._send_prio: Dict[int, int] = {}
        self._rounds: Dict[int, int] = {}
        self._wid = int.from_bytes(os.urandom(4), "big") or 1
        self._push_seq: Dict[int, int] = {}
        self._push_seq_lock = threading.Lock()
        self._shard_bytes: Dict[int, int] = {}
        self._placed: set = set()
        # init_key replay log per server: key -> args
        self._inits: List[Dict[int, tuple]] = [dict() for _ in addrs]
        # lag declarations per server, key -> K, replayed after the inits:
        # a restarted server's empty store would refuse the next lag frame
        self._lag_decls: List[Dict[int, int]] = [dict() for _ in addrs]
        self._pools: List[queue.Queue] = []
        for i in range(len(addrs)):
            pool: queue.Queue = queue.Queue()
            pool.put(_Channel(self._dial(i)))   # eager: validate the address
            for _ in range(self._nconns - 1):
                pool.put(_Channel(None))        # dialed at first use
            self._pools.append(pool)
        # the param mailbox's channels: a new one whenever all are busy
        self._param_pools: List[queue.Queue] = [queue.Queue() for _ in addrs]

    def _dial(self, i: int) -> socket.socket:
        host, port = self._addrs[i]
        s = socket.create_connection((host, int(port)))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _shard(self, key: int) -> int:
        return place_key(key, len(self._pools))

    def _reconnect(self, i: int, ch: _Channel, deadline: float) -> None:
        """Redial ``ch`` with backoff until ``deadline``, then replay the
        server's init log (a restarted server has an empty key table)."""
        get_registry().counter("transport/reconnects").inc()
        delay = 0.1
        while True:
            if self._dead:
                raise ConnectionError(
                    f"PS backend closed while reconnecting to "
                    f"{':'.join(self._addrs[i])}")
            try:
                old, ch.sock = ch.sock, self._dial(i)
                if old is not None:
                    try:
                        old.close()
                    except OSError:
                        pass
                break
            except OSError as e:
                if time.time() + delay > deadline:
                    raise ConnectionError(
                        f"PS server {':'.join(self._addrs[i])} unreachable "
                        f"for {self.reconnect_secs:.0f}s: {e}") from e
                time.sleep(delay)
                delay = min(delay * 2, 2.0)
        get_logger().warning("reconnected to PS server %s; replaying %d key "
                             "inits", ":".join(self._addrs[i]),
                             len(self._inits[i]))
        for args in self._inits[i].values():
            self._send_init(ch.sock, *args)
        # the lag bounds after the inits: a declaration needs the key
        for k, lag in self._lag_decls[i].items():
            self._roundtrip(ch.sock, OP_LAG_DECL, k, int(lag), 0, 0,
                            "uint8", None)

    def _send_init(self, sock, key, nbytes, dtype, init, compression,
                   fused=False) -> None:
        if compression:
            from ..ops.compression.host import serialize_kwargs
            self._roundtrip(sock, OP_INIT_C, key, 0, nbytes, 0, dtype,
                            memoryview(serialize_kwargs(compression)))
        else:
            payload = None if init is None else _as_bytes(init)
            self._roundtrip(sock, OP_INIT, key, 1 if fused else 0, nbytes,
                            0, dtype, payload)

    @staticmethod
    def _roundtrip(sock, op, key, rnd, nbytes, timeout_ms, dtype, payload,
                   recv_into=None):
        _send_req(sock, op, key, rnd, nbytes, timeout_ms, dtype, payload)
        status, rbytes = _RSP.unpack(_recv_exact(sock, _RSP.size))
        if (recv_into is not None and status == ST_OK
                and rbytes == len(recv_into)):
            _recv_exact_into(sock, recv_into)     # straight into the array
            return memoryview(b"")
        data = _recv_exact(sock, rbytes) if rbytes else memoryview(b"")
        if status == ST_TIMEOUT:
            raise _ServerTimeout(bytes(data).decode() or
                                 f"pull({key}) timed out")
        if status == ST_GONE:
            # the server announced its shutdown: reconnect
            raise ConnectionError(bytes(data).decode() or "server gone")
        if status != ST_OK:
            raise RuntimeError(f"PS server rejected key={key} op={op}: "
                               f"{bytes(data).decode()!r}")
        return data

    def _roundtrip_with_retry(self, i: int, ch: _Channel, op, key, rnd,
                              nbytes, timeout_ms, dtype, payload,
                              recv_into=None):
        """One roundtrip on ``ch``; a dropped connection is redialed and
        the request re-sent, all redials drawing on one budget."""
        try:
            if ch.sock is None:
                ch.sock = self._dial(i)
            return self._roundtrip(ch.sock, op, key, rnd, nbytes,
                                   timeout_ms, dtype, payload,
                                   recv_into=recv_into)
        except _ServerTimeout:
            # an application reply (and TimeoutError is an OSError): never
            # the reconnect path
            raise
        except (ConnectionError, OSError):
            if self.reconnect_secs <= 0:
                raise
            deadline = time.time() + self.reconnect_secs
            while True:
                try:
                    self._reconnect(i, ch, deadline)
                    # re-sent whole; the push token keeps it exactly-once
                    get_registry().counter("transport/resends").inc()
                    return self._roundtrip(ch.sock, op, key, rnd, nbytes,
                                           timeout_ms, dtype, payload,
                                           recv_into=recv_into)
                except _ServerTimeout:
                    raise
                except (ConnectionError, OSError):
                    if time.time() >= deadline:
                        raise
                    time.sleep(0.2)

    def _rpc(self, op: int, key: int, rnd: int, nbytes: int,
             timeout_ms: int, dtype: str, payload,
             pull_into: Optional[np.ndarray] = None) -> bytes:
        """One request on a pooled channel of ``key``'s server. A payload
        frame of the gradient class, or a param PUT of the latency class,
        waits for the wire credit and holds it across its roundtrip
        (``BPS_SCHEDULING_CREDIT``)."""
        ticket = scheduler = None
        if payload is not None and (op in self._SCHED_GRAD_OPS
                                    or op == OP_PARAM_PUT):
            from .admission import CLASS_ACT, CLASS_GRAD, send_scheduler
            scheduler = send_scheduler()
            if scheduler is not None:
                ticket = scheduler.acquire(
                    CLASS_ACT if op == OP_PARAM_PUT else CLASS_GRAD,
                    self._send_prio.get(key, 0), key,
                    len(_byteview(payload)))
        try:
            return self._rpc_unscheduled(op, key, rnd, nbytes, timeout_ms,
                                         dtype, payload, pull_into)
        finally:
            if ticket is not None:
                scheduler.release(ticket)

    def _rpc_unscheduled(self, op, key, rnd, nbytes, timeout_ms, dtype,
                         payload, pull_into=None) -> bytes:
        i = self._shard(key)
        if op in self._PARAM_OPS:
            pools = self._param_pools
            try:
                ch = pools[i].get_nowait()
            except queue.Empty:
                ch = _Channel(None)      # dialed in the roundtrip below
        else:
            pools = self._pools
            ch = pools[i].get()          # blocks while every channel is busy
        try:
            recv_into = None
            if pull_into is not None and pull_into.flags["C_CONTIGUOUS"]:
                try:
                    recv_into = memoryview(pull_into).cast("B")
                except (ValueError, TypeError):   # bfloat16
                    recv_into = memoryview(pull_into.view(np.uint8))
            data = self._roundtrip_with_retry(i, ch, op, key, rnd, nbytes,
                                              timeout_ms, dtype, payload,
                                              recv_into=recv_into)
            if pull_into is not None:
                if len(data):
                    np.copyto(pull_into,
                              np.frombuffer(data, dtype=pull_into.dtype)
                              .reshape(pull_into.shape))
                return b""
            return bytes(data)
        finally:
            # back even with a dead socket: the next user redials
            pools[i].put(ch)

    def init_key(self, key: int, nbytes: int, dtype: str = "float32",
                 init: Optional[np.ndarray] = None,
                 compression: Optional[Dict[str, str]] = None,
                 fused: bool = False) -> None:
        if compression:
            from ..ops.compression.host import serialize_kwargs
            self._rpc(OP_INIT_C, key, 0, nbytes, 0, dtype,
                      memoryview(serialize_kwargs(compression)))
        else:
            payload = None if init is None else _as_bytes(init)
            self._rpc(OP_INIT, key, 1 if fused else 0, nbytes, 0, dtype,
                      payload)
        # replayed after a reconnect, recorded only once accepted
        i = self._shard(key)
        self._inits[i][key] = (key, nbytes, dtype,
                               None if init is None else np.array(init),
                               dict(compression) if compression else None,
                               bool(fused))
        if key not in self._placed:
            self._placed.add(key)
            log_key_placement(key, nbytes, i, self._shard_bytes)

    def set_send_priority(self, key: int, prio: int) -> None:
        """The wire credit's priority for ``key``'s frames (higher is sent
        first); the exchange sets reverse first-use order at plan time."""
        self._send_prio[key] = int(prio)

    def _push_token(self, key: int) -> int:
        with self._push_seq_lock:
            seq = self._push_seq.get(key, 0) + 1
            if seq > 0xFFFFFFFF:
                # the seq field is spent: a fresh incarnation resets dedup
                self._wid = int.from_bytes(os.urandom(4), "big") or 1
                self._push_seq.clear()
                seq = 1
            self._push_seq[key] = seq
        return (self._wid << 32) | seq

    def push(self, key: int, data: np.ndarray) -> None:
        self._rpc(OP_PUSH, key, self._push_token(key), 0, 0,
                  bf16.dtype_name(data), _as_bytes(data))

    def _sliced_pull(self, attempt, timeout_ms: int, descr: str):
        """``attempt(slice_ms)`` until it succeeds or one deadline passes;
        each server-side wait is one slice, and the channel goes back to
        the pool between slices."""
        deadline = time.time() + timeout_ms / 1e3
        while True:
            left_ms = max(1, int((deadline - time.time()) * 1e3))
            try:
                return attempt(min(self._PULL_SLICE_MS, left_ms))
            except TimeoutError:
                if time.time() >= deadline:
                    raise TimeoutError(
                        f"{descr} timed out after {timeout_ms}ms "
                        f"(sliced waits)") from None

    def pull(self, key: int, out: np.ndarray, round: int = 0,
             timeout_ms: Optional[int] = None) -> None:
        if timeout_ms is None:
            timeout_ms = int(os.environ.get("BPS_PULL_TIMEOUT_MS", "30000")
                             or 30000)
        self._sliced_pull(
            lambda slice_ms: self._rpc(OP_PULL, key, round, out.nbytes,
                                       slice_ms, bf16.dtype_name(out), None,
                                       pull_into=out),
            timeout_ms, f"pull({key}) round={round}")

    def round(self, key: int) -> int:
        """The server's latest completed round of ``key``."""
        data = self._rpc(OP_ROUND, key, 0, 0, 0, "uint8", None)
        return struct.unpack("!Q", data)[0]

    def declare_lag(self, key: int, max_lag: int) -> None:
        """Declare ``key``'s staleness bound K; kept for the replay to a
        restarted server."""
        self._rpc(OP_LAG_DECL, key, int(max_lag), 0, 0, "uint8", None)
        self._lag_decls[self._shard(key)][key] = int(max_lag)

    def push_lag(self, key: int, worker: int, rnd: int,
                 data: np.ndarray) -> None:
        """A versioned push into ``key``'s round ``rnd``; the packed round
        field is the server's dedup token, so a retried (worker, round)
        folds once."""
        packed = (int(worker) << 48) | (int(rnd) & _LAG_ROUND_MASK)
        self._rpc(OP_PUSH_LAG, key, packed, 0, 0, bf16.dtype_name(data),
                  _as_bytes(data))

    def pull_lag(self, key: int, worker: int, rnd: int, out: np.ndarray,
                 timeout_ms: Optional[int] = None) -> int:
        """Round ``rnd``'s published sum into ``out``; returns the verdict
        flags. Sliced like a pull."""
        if timeout_ms is None:
            timeout_ms = int(os.environ.get("BPS_PULL_TIMEOUT_MS", "30000")
                             or 30000)
        packed = (int(worker) << 48) | (int(rnd) & _LAG_ROUND_MASK)

        def attempt(slice_ms: int) -> int:
            data = self._rpc(OP_PULL_LAG, key, packed, out.nbytes, slice_ms,
                             bf16.dtype_name(out), None)
            np.copyto(out, np.frombuffer(data[1:], dtype=out.dtype)
                      .reshape(out.shape))
            return data[0]

        return self._sliced_pull(attempt, timeout_ms,
                                 f"pull_lag({key}) round={rnd}")

    def push_bytes(self, key: int, payload) -> None:
        """A legacy chain's push: the compressed payload as it is."""
        self._rpc(OP_PUSH_C, key, self._push_token(key), 0, 0, "uint8",
                  memoryview(payload))

    def pull_bytes(self, key: int, round: int = 0,
                   timeout_ms: int = 30000) -> bytes:
        """A legacy chain's pull: the merged round recompressed once."""
        return self._sliced_pull(
            lambda slice_ms: self._rpc(OP_PULL_C, key, round, 0, slice_ms,
                                       "uint8", None),
            timeout_ms, f"pull_bytes({key}) round={round}")

    def push_fused(self, key: int, payload) -> None:
        """Fused-plane push: a self-describing codec payload."""
        self._rpc(OP_PUSH_F, key, self._push_token(key), 0, 0, "uint8",
                  memoryview(payload))

    def pull_fused(self, key: int, nbytes: int, dtype: str, codec: int,
                   round: int = 0, timeout_ms: int = 30000,
                   div: Optional[int] = None) -> bytes:
        """Fused-plane pull: the merged round encoded on the server at
        ``codec`` with this worker's topk divisor."""
        from ..compress.wire import TOPK_DIV
        payload = bytes((int(codec),)) + struct.pack(
            "<H", int(div) if div else TOPK_DIV)
        return self._sliced_pull(
            lambda slice_ms: self._rpc(OP_PULL_F, key, round, int(nbytes),
                                       slice_ms, dtype, payload),
            timeout_ms, f"pull_fused({key}) round={round}")

    def push_rowsparse(self, key: int, idx, rows, dense_nbytes: int,
                       dtype=None) -> None:
        """Row-sparse push: only the touched rows cross the wire, under a
        dedup token like any push. ``dtype`` defaults to the rows' own
        (another would reinterpret their bytes on the server)."""
        from .rowsparse import pack_rows
        if dtype is None:
            dtype = str(np.asarray(rows).dtype)
        self._rpc(OP_PUSH_RS, key, self._push_token(key), dense_nbytes, 0,
                  dtype, memoryview(pack_rows(idx, rows)))

    def param_put(self, key: int, seq: int, payload) -> None:
        """Publish one param frame (the sharded update); last-wins per
        (key, seq), so a resend stores the same bytes again."""
        self._rpc(OP_PARAM_PUT, key, int(seq), 0, 0, "uint8",
                  memoryview(payload))

    def param_get(self, key: int, seq: int,
                  timeout_ms: int = 30000) -> bytes:
        """The (key, seq) param frame, waiting for it and leaving it in
        the mailbox; sliced like a pull. A timeout is the owner-death
        signal the sharded tail turns into its diagnostic."""
        return self._sliced_pull(
            lambda slice_ms: self._rpc(OP_PARAM_GET, key, int(seq), 0,
                                       slice_ms, "uint8", None),
            timeout_ms, f"param_get({key:#x}) seq={seq}")

    def param_latest(self, key: int) -> int:
        """The newest seq the server's param mailbox retains for ``key``
        (0: none)."""
        data = self._rpc(OP_PARAM_SEQ, key, 0, 0, 0, "uint8", None)
        return struct.unpack("!Q", data)[0]

    def push_pull(self, key: int, data: np.ndarray,
                  timeout_ms: int = 30000) -> np.ndarray:
        """One sync round: push, then pull the round this push completes
        (a per-key round counter, as ``HostPSBackend`` keeps), or in async
        mode the store as it is (round 0)."""
        self.push(key, data)
        rnd = self._rounds.get(key, 0) + 1
        self._rounds[key] = rnd
        out = np.empty_like(data)
        self.pull(key, out, 0 if self.async_mode else rnd, timeout_ms)
        return out

    def close(self) -> None:
        # the flag first: a thread in a redial loop holds its channel
        # outside the pool and must stop dialing a dead address
        self._dead = True
        for pool in self._pools + self._param_pools:
            while True:
                try:
                    ch = pool.get_nowait()
                except queue.Empty:
                    break
                if ch.sock is None:
                    continue
                try:
                    _send_req(ch.sock, OP_CLOSE, 0, 0, 0, 0, "", None)
                    _recv_exact(ch.sock, _RSP.size)
                except (ConnectionError, OSError):
                    pass
                ch.sock.close()
