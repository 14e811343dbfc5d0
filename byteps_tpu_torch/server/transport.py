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
key's latest completed round, u64), 10=PUSH_SHM / 11=PULL_SHM (the
shared-memory data plane, ``BPS_ENABLE_SHM``: the payload is the name of
a worker-owned POSIX segment, one per pooled channel, ``nbytes`` the data's
length at its offset 0; the server attaches the segment and pushes from
it, or pulls into it, exactly as OP_PUSH and OP_PULL do), 12=PUSH_PART /
13=PULL_PART (connection striping, ``BPS_STRIPE_MIN``: one dense op of at
least ``max(BPS_STRIPE_MIN, 512 KiB)`` bytes split over the pool's
channels in flight at once; each part's payload leads with ``_PART`` =
offset:u32 | len:u32 | idx:u16 | nparts:u16 | nonce:u64, and ``nbytes`` is
the whole op's length; a push's parts share its dedup token and the
server applies the op once, when every part arrived; a pull's parts share
a nonce fresh for each attempt, and one round-blocked fetch on the server
feeds them all), 17=PUSH_F / 18=PULL_F (the
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

With ``BPS_ENABLE_IPC`` (or ``BYTEPS_ENABLE_IPC``) the server also listens
on the Unix socket ``bps-ipc-<port>.sock`` in ``BPS_IPC_DIR`` (default
``<tmp>/bps-ipc-<uid>``, which must be the user's own, mode 0700), and a
client with the knob on dials it in place of loopback TCP where the file
exists; a client also takes an explicit ``unix:/path.sock`` address. The
frames are the same on either socket. A worker's shm segment lives in
``/dev/shm`` (tmpfs); the port reserves its pages when it makes one, so a
segment that does not fit fails there, not as a ``SIGBUS`` at the first
write past the free space, and the client falls back to the socket for
that server (counted in ``transport/shm_fallbacks`` and logged), as it
does when the server cannot attach the segment. ``snapshot_store`` and
``restore_snapshot`` write and read the JAX package's ``.npz`` of the
store (``k<key>|<dtype>`` entries of raw bytes), which ``launch --server``
takes at ``BPS_SERVER_SNAPSHOT``.

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
_PART = struct.Struct("!IIHHQ")  # offset, part_len, part_idx, nparts, nonce

OP_INIT, OP_PUSH, OP_PULL, OP_CLOSE = 1, 2, 3, 4
OP_INIT_C, OP_PUSH_C, OP_PULL_C = 5, 6, 7
OP_PUSH_RS = 8
OP_ROUND = 9
OP_PUSH_SHM, OP_PULL_SHM = 10, 11
OP_PUSH_PART, OP_PULL_PART = 12, 13
OP_PUSH_F, OP_PULL_F = 17, 18
OP_PARAM_PUT, OP_PARAM_GET, OP_PARAM_SEQ = 21, 22, 24
OP_LAG_DECL, OP_PUSH_LAG, OP_PULL_LAG = 26, 27, 28
ST_OK, ST_ERR, ST_TIMEOUT, ST_GONE = 0, 1, 2, 3
# a lag frame's round field: worker << 48 | round
_LAG_ROUND_MASK = (1 << 48) - 1

_NOT_PORTED = "is not ported yet (see ROADMAP.md, 'Modules still to port'"

# the JAX package's other ops: op -> (what, ROADMAP queue 1 item)
UNPORTED_OPS: Dict[int, Tuple[str, int]] = {
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
    "BPS_REDUCE_ROOTS": ("BYTEPS_REDUCE_ROOTS",
                         "key placement over reduce roots", 8, ("",)),
}
SERVER_REFUSED = {
    "BPS_KEY_LOG": ("PS_KEY_LOG", "the per-key traffic log", 9, _OFF),
}
LAUNCHER_REFUSED = {
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
                             OP_PUSH_PART,    # copied into its stage
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


# ------------------------------------------------- shared memory, Unix sockets

class _PosixShm:
    """A POSIX shared-memory segment (``shm_open`` and ``mmap``), outside
    ``multiprocessing``'s resource tracker: workers make and unlink their
    segments, the server only attaches. A segment the worker makes has its
    pages reserved (``posix_fallocate``): ``/dev/shm`` is tmpfs, where a
    sparse segment's write past the free space raises ``SIGBUS`` in the
    writer, and a reservation that does not fit raises ``OSError`` here
    instead. A worker killed by a signal strands its ``/dev/shm/bps-shm-*``
    files (mode 0600) until they are removed."""

    __slots__ = ("name", "size", "_mmap", "buf")

    def __init__(self, name: Optional[str] = None, create: bool = False,
                 size: int = 0) -> None:
        import mmap
        import secrets
        from multiprocessing import shared_memory
        posixshmem = shared_memory._posixshmem
        if create:
            while True:
                name = f"/bps-shm-{secrets.token_hex(6)}"
                try:
                    fd = posixshmem.shm_open(
                        name, os.O_CREAT | os.O_EXCL | os.O_RDWR, mode=0o600)
                    break
                except FileExistsError:
                    continue
            try:
                os.ftruncate(fd, size)
                os.posix_fallocate(fd, 0, size)
            except OSError:
                os.close(fd)
                posixshmem.shm_unlink(name)
                raise
        else:
            fd = posixshmem.shm_open(name, os.O_RDWR, mode=0o600)
            size = os.fstat(fd).st_size
        try:
            self._mmap = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.name = name
        self.size = size
        self.buf = memoryview(self._mmap)

    def close(self) -> None:
        """Unmap; a buffer still exported stays mapped until it is freed."""
        try:
            self.buf.release()
            self._mmap.close()
        except (BufferError, ValueError):
            pass

    def unlink(self) -> None:
        from multiprocessing import shared_memory
        try:
            shared_memory._posixshmem.shm_unlink(self.name)
        except OSError:
            pass


class _ShmCache:
    """The server's attached worker segments, least recently used first,
    bounded by count and by bytes (a grown segment leaves its predecessor
    unlinked but mapped here until it is evicted). A view is sliced under
    the lock, so an eviction cannot unmap it between lookup and use."""

    def __init__(self, cap: int = 64, cap_bytes: int = 1 << 30) -> None:
        self._segs: Dict[str, _PosixShm] = {}   # insertion order = LRU
        self._lock = threading.Lock()
        self._cap = cap
        self._cap_bytes = cap_bytes

    def view(self, name: str, nbytes: int) -> memoryview:
        with self._lock:
            seg = self._segs.pop(name, None)
            if seg is None:
                seg = _PosixShm(name=name)
            self._segs[name] = seg              # most recent last
            while len(self._segs) > self._cap or (
                    len(self._segs) > 1 and
                    sum(s.size for s in self._segs.values())
                    > self._cap_bytes):
                old = next(iter(self._segs))
                if old == name:
                    break
                self._segs.pop(old).close()
            if nbytes > seg.size:
                raise ValueError(f"shm window {nbytes}B exceeds segment "
                                 f"{name} ({seg.size}B)")
            return seg.buf[:nbytes]

    def close(self) -> None:
        with self._lock:
            for seg in self._segs.values():
                seg.close()
            self._segs.clear()


# hosts whose server shares this machine: the shm plane's and the UDS
# upgrade's condition
_LOCAL_HOSTS = ("127.0.0.1", "localhost")


def _ipc_path(port: int) -> str:
    """The Unix socket of the server on TCP ``port``: colocated workers
    derive it from the port they were given. It lives in a directory of
    this user's, mode 0700 (``BPS_IPC_DIR``, default
    ``<tmp>/bps-ipc-<uid>``); any other is refused, since a shared one
    would let another user take the name or listen in the server's place.
    A socket path holds at most 107 bytes."""
    import stat
    import tempfile
    base = os.environ.get("BPS_IPC_DIR")
    if not base:
        base = os.path.join(tempfile.gettempdir(), f"bps-ipc-{os.getuid()}")
    os.makedirs(base, mode=0o700, exist_ok=True)
    st = os.stat(base)
    if st.st_uid != os.getuid() or (st.st_mode & 0o077):
        raise RuntimeError(
            f"IPC dir {base} must be owned by uid {os.getuid()} with mode "
            f"0700 (found uid {st.st_uid}, mode {stat.S_IMODE(st.st_mode):o})"
            f": refusing to exchange gradients over a socket path others "
            f"can change")
    return os.path.join(base, f"bps-ipc-{port}.sock")


def _bump_bufs(s: socket.socket, nbytes: int = 4 << 20) -> None:
    """Grow a Unix socket's kernel buffers: at the default (~208 KB) a
    multi-MB frame goes over in many small turns."""
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            s.setsockopt(socket.SOL_SOCKET, opt, nbytes)
        except OSError:
            pass


def _ipc_enabled() -> bool:
    """``BPS_ENABLE_IPC`` (or ``BYTEPS_ENABLE_IPC``), by the JAX package's
    rule: anything but unset, 0, empty or false is on."""
    return os.environ.get(
        "BPS_ENABLE_IPC", os.environ.get("BYTEPS_ENABLE_IPC", "0")) \
        not in ("0", "", "false")


# ------------------------------------------------------------------ server

class PSTransportServer:
    """Threaded TCP front for a local summation backend (``PSServer`` or
    ``HostPSBackend``): one thread per connection, one request at a time
    on each; with ``BPS_ENABLE_IPC`` also a Unix-socket listener
    (``ipc_path``) that serves the same frames. ``key_meta`` seeds the
    key table of a backend restored from a snapshot
    (``restore_snapshot``) before this server accepts."""

    def __init__(self, backend, host: str = "0.0.0.0",
                 port: int = 0, key_meta=None) -> None:
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
        self._key_meta: Dict[int, Tuple[int, str]] = dict(key_meta or {})
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
        # frames a data-plane op: the colocated and striped routes' gates
        self._m_frames = {op: reg.counter(name) for op, name in (
            (OP_PUSH, "server/push_frames"), (OP_PULL, "server/pull_frames"),
            (OP_PUSH_SHM, "server/shm_pushes"),
            (OP_PULL_SHM, "server/shm_pulls"),
            (OP_PUSH_PART, "server/part_pushes"),
            (OP_PULL_PART, "server/part_pulls"))}
        self._m_conns = {True: reg.counter("server/tcp_conns"),
                         False: reg.counter("server/ipc_conns")}
        # the worker segments this server attached (ops 10-11)
        self._shm = _ShmCache()
        # the striped ops' stages: a push's parts per (key, token), a
        # pull's per (key, round, nonce); parts arrive on several
        # connections' threads, and an abandoned stage is swept after
        # _STRIPE_TTL_SECS
        self._stripe_lock = threading.Lock()
        self._push_stage: Dict[Tuple[int, int], dict] = {}
        self._pull_stage: Dict[Tuple[int, int, int], dict] = {}
        self._stripe_sweep_at = 0.0
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
            target=self._accept_loop, args=(self._sock, True), daemon=True,
            name="bps-ps-accept")
        self._accept_thread.start()
        # the Unix socket's path comes from the bound TCP port (a port-0
        # server learns it only now); a stale file of a dead server with
        # that port is replaced
        self._ipc_sock = None
        self.ipc_path = None
        if _ipc_enabled():
            try:
                path = _ipc_path(self.port)
                try:
                    os.unlink(path)
                except OSError:
                    pass
                self._ipc_sock = socket.socket(socket.AF_UNIX,
                                               socket.SOCK_STREAM)
                _bump_bufs(self._ipc_sock)
                self._ipc_sock.bind(path)
                self._ipc_sock.listen(64)
            except BaseException:
                self.close()        # the TCP listener too
                raise
            self.ipc_path = path
            threading.Thread(target=self._accept_loop,
                             args=(self._ipc_sock, False), daemon=True,
                             name="bps-ps-ipc-accept").start()

    def _accept_loop(self, sock: socket.socket, is_tcp: bool) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = sock.accept()
            except OSError:
                return
            if is_tcp:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._m_conns[is_tcp].inc()
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="bps-ps-conn").start()

    def _handle(self, conn, op, key, rnd, nbytes, timeout, dtype,
                payload) -> None:
        """One request; backend errors become ST_ERR / ST_TIMEOUT / ST_GONE
        responses and the connection stays up."""
        self._m_requests.inc()
        frames = self._m_frames.get(op)
        if frames is not None:
            frames.inc()
        try:
            if op == OP_INIT:
                init = (bf16.frombuffer(payload, dtype)
                        if payload is not None else None)
                self._fb.init_key(key, nbytes, dtype, init=init,
                                  fused=bool(int(rnd) & 1))
                self._key_meta[key] = (int(nbytes), dtype)
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PUSH:
                self._push_dense(key, rnd, payload, dtype)
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PULL:
                out = self._pull_dense(key, rnd, nbytes, dtype, timeout)
                _send_frame(conn, _RSP.pack(ST_OK, out.nbytes),
                            [_as_bytes(out)])
            elif op == OP_PUSH_SHM:
                # OP_PUSH's apply on the bytes in the worker's segment
                view = self._shm.view(bytes(payload).decode(), int(nbytes))
                try:
                    self._push_dense(key, rnd, view, dtype)
                finally:
                    del view      # no export outlives the frame
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PULL_SHM:
                view = self._shm.view(bytes(payload).decode(), int(nbytes))
                try:
                    self._pull_dense(key, rnd, nbytes, dtype, timeout,
                                     into=view)
                finally:
                    del view
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PUSH_PART:
                self._push_part(key, rnd, nbytes, dtype, payload)
                conn.sendall(_RSP.pack(ST_OK, 0))
            elif op == OP_PULL_PART:
                part = self._pull_part(key, rnd, nbytes, dtype, timeout,
                                       payload)
                _send_frame(conn, _RSP.pack(ST_OK, len(part)), [part])
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

    def _push_dense(self, key: int, rnd: int, payload, dtype: str) -> bool:
        """OP_PUSH's apply, which the shm and striped pushes share: the
        wire transcode (a frame dtype narrower than the store lands in the
        store's dtype; bf16 without ml_dtypes), the dedup, the fused
        front. The front copies before it returns."""
        arr = bf16.frombuffer(payload, dtype)
        meta = self._key_meta.get(key)
        if meta is not None and meta[1] != dtype:
            arr = bf16.cast(arr, meta[1])
        return self._apply_push_once(key, rnd,
                                     lambda: self._fb.push(key, arr))

    def _pull_dense(self, key, rnd, nbytes, dtype, timeout,
                    into=None) -> np.ndarray:
        """Round-blocked pull in the frame's dtype (a narrower one than the
        store's downcasts on the way out), into a fresh array or into the
        bytes ``into`` (a worker's segment)."""
        t0 = time.time()
        elems = int(nbytes) // bf16.np_dtype(dtype).itemsize
        meta = self._key_meta.get(key)
        out = (np.empty(elems, dtype=bf16.np_dtype(dtype)) if into is None
               else np.frombuffer(into, dtype=bf16.np_dtype(dtype),
                                  count=elems))
        if meta is not None and meta[1] != dtype:
            store = np.empty(elems, dtype=bf16.np_dtype(meta[1]))
            self._fb.pull(key, store, round=int(rnd),
                          timeout_ms=int(timeout) or 30000)
            out[...] = bf16.cast(store, dtype)
        else:
            self._fb.pull(key, out, round=int(rnd),
                          timeout_ms=int(timeout) or 30000)
        # the merge's wait: sum time plus the slowest worker's push lag
        self._m_merge_wait.observe(time.time() - t0)
        return out

    # -- striping (ops 12-13): a push's parts are staged per (key, token)
    # and the op applies once, when every byte arrived; a pull's parts
    # share one round-blocked fetch per (key, round, nonce)

    _STRIPE_TTL_SECS = 120.0

    def _push_part(self, key, rnd, nbytes, dtype, payload) -> None:
        off, ln, idx, _, _ = _PART.unpack(payload[:_PART.size])
        stage_key = (key, int(rnd))
        now = time.time()
        with self._stripe_lock:
            self._sweep_stages(now)
            st = self._push_stage.get(stage_key)
            if st is None:
                st = self._push_stage[stage_key] = {
                    "buf": bytearray(int(nbytes)), "got": 0, "seen": set(),
                    "t": now}
            st["t"] = now
        # the copy runs outside the lock: the parts' ranges are disjoint,
        # and one lock over the copies would serialize what the stripes
        # exist to run at once. A part sent again rewrites its own range
        # and counts once.
        memoryview(st["buf"])[off:off + ln] = \
            payload[_PART.size:_PART.size + ln]
        with self._stripe_lock:
            if idx not in st["seen"]:
                st["seen"].add(idx)
                st["got"] += ln
            complete = st["got"] >= int(nbytes)
            if complete:
                self._push_stage.pop(stage_key, None)
        if complete:
            self._push_dense(key, rnd, st["buf"], dtype)

    def _pull_part(self, key, rnd, nbytes, dtype, timeout,
                   payload) -> memoryview:
        off, ln, _, nparts, nonce = _PART.unpack(payload[:_PART.size])
        # the nonce keeps two striped pulls of one async key (round 0)
        # apart: a late part of one must not be served the other's value
        stage_key = (key, int(rnd), int(nonce))
        now = time.time()
        with self._stripe_lock:
            self._sweep_stages(now)
            st = self._pull_stage.get(stage_key)
            fetch = st is None
            if fetch:
                st = self._pull_stage[stage_key] = {
                    "ev": threading.Event(), "data": None, "err": None,
                    "served": 0, "nparts": int(nparts), "t": now}
            st["t"] = now
        if fetch:
            try:
                st["data"] = _as_bytes(self._pull_dense(key, rnd, nbytes,
                                                        dtype, timeout))
            except Exception as e:   # noqa: BLE001 — every part raises it
                st["err"] = e
            finally:
                st["ev"].set()
        if not st["ev"].wait(timeout=(int(timeout) or 30000) / 1e3 + 5):
            # the fetch is still in flight: a retryable timeout, and this
            # part not counted as served (the stage must outlive the fetch)
            raise TimeoutError(f"pull({key}) round={rnd}: the striped "
                               f"fetch did not resolve in time")
        with self._stripe_lock:
            st["served"] += 1
            if st["served"] >= st["nparts"]:
                self._pull_stage.pop(stage_key, None)
        if st["err"] is not None:
            raise st["err"]
        return st["data"][off:off + ln]

    def _sweep_stages(self, now: float) -> None:
        """Drop the stages nobody touched for ``_STRIPE_TTL_SECS`` (the
        caller holds ``_stripe_lock``); never a pull stage whose fetch is
        in flight, whose parts wait on it."""
        if now < self._stripe_sweep_at:
            return
        self._stripe_sweep_at = now + min(30.0, self._STRIPE_TTL_SECS / 4)
        cutoff = now - self._STRIPE_TTL_SECS
        for d in (self._push_stage, self._pull_stage):
            for k in [k for k, st in d.items()
                      if st["t"] < cutoff
                      and ("ev" not in st or st["ev"].is_set())]:
                del d[k]

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

    def snapshot(self, path: str, timeout_ms: int = 250) -> int:
        """Write every known key's latest merged value to ``path``
        (``snapshot_store``); returns the number of keys written."""
        return snapshot_store(self.backend, list(self._key_meta.items()),
                              path, timeout_ms)

    def restore(self, path: str) -> int:
        """Seed the store from a snapshot. This server accepts from its
        construction, so a worker's init could land first and pin its own
        values: restore the backend before constructing the transport
        (``restore_snapshot`` and ``key_meta``), as ``launch --server``
        does."""
        meta = restore_snapshot(self.backend, path)
        self._key_meta.update(meta)
        return len(meta)

    def close(self) -> None:
        """Stop accepting (and unlink the Unix socket); open connections
        end with their clients."""
        self._stop.set()
        self._shm.close()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._ipc_sock is not None:
            try:
                self._ipc_sock.close()
            except OSError:
                pass
        if self.ipc_path is not None:
            try:
                os.unlink(self.ipc_path)
            except OSError:
                pass


# ------------------------------------------------------- state snapshots

def snapshot_store(backend, key_meta, path: str,
                   timeout_ms: int = 250) -> int:
    """Write ``key_meta``'s keys (pairs key, (nbytes, dtype)) from
    ``backend`` to ``path``, the JAX package's file: an ``.npz`` of
    ``k<key>|<dtype>`` entries of raw bytes (so bfloat16 survives),
    written to ``<path>.tmp.npz`` and renamed over ``path``. Each key is
    its round 0 (the latest published value) pulled with a short
    timeout; a key without a completed round (a sync key before its first
    round) is skipped with a warning. Returns the keys written
    (``server/snapshot_keys``)."""
    arrays = {}
    for key, (nbytes, dtype) in sorted(key_meta):
        buf = np.empty(nbytes // bf16.np_dtype(dtype).itemsize,
                       bf16.np_dtype(dtype))
        try:
            backend.pull(key, buf, round=0, timeout_ms=timeout_ms)
        except Exception as e:   # noqa: BLE001 — the key is left out
            get_logger().warning("snapshot: skipping key %d: %s", key, e)
            continue
        arrays[f"k{key}|{dtype}"] = buf.view(np.uint8)
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)         # a reader never sees a torn file
    get_registry().counter("server/snapshot_keys").inc(len(arrays))
    get_logger().info("snapshot: %d keys -> %s", len(arrays), path)
    return len(arrays)


def restore_snapshot(backend, path: str) -> Dict[int, Tuple[int, str]]:
    """Seed ``backend`` from a snapshot (either package's); returns the
    key -> (nbytes, dtype) it restored (``server/restored_keys``). Run it
    before the transport accepts: server-side init is first-wins, so a
    worker's init that lands first keeps its own values. A file with
    embedding-store entries (``e...``) raises: the port has no embedding
    store (ROADMAP.md, queue 1, item 8), and its rows are never dropped
    silently."""
    meta = {}
    with np.load(path) as data:
        embed = [n for n in data.files if n.startswith("e")]
        if embed:
            raise NotImplementedError(
                f"{path} holds {len(embed)} embedding-store entries "
                f"({embed[0]!r}, ...): the embedding store "
                f"(server/embed.py) {_NOT_PORTED}, queue 1, item 8)")
        for name in data.files:
            if not name.startswith("k"):
                continue
            keypart, dtype = name[1:].split("|", 1)
            key = int(keypart)
            arr = bf16.frombuffer(data[name].tobytes(), dtype)
            backend.init_key(key, arr.nbytes, dtype, init=arr)
            meta[key] = (arr.nbytes, dtype)
    get_registry().counter("server/restored_keys").inc(len(meta))
    get_logger().info("restore: %d keys <- %s", len(meta), path)
    return meta


# ------------------------------------------------------------------ client

class _Channel:
    """One pooled connection; ``sock`` is None until first use. ``shm`` is
    the channel's own segment for the shared-memory data plane, made at
    its first use and grown by replacement."""

    __slots__ = ("sock", "shm")

    def __init__(self, sock) -> None:
        self.sock = sock
        self.shm = None

    @staticmethod
    def _unlink(seg) -> None:
        seg.unlink()   # the name goes; the server's mapping survives
        seg.close()

    def ensure_shm(self, nbytes: int) -> _PosixShm:
        if self.shm is None or self.shm.size < nbytes:
            if self.shm is not None:
                self._unlink(self.shm)
                self.shm = None
            self.shm = _PosixShm(create=True, size=max(nbytes, 1 << 20))
        return self.shm

    def drop_shm(self) -> None:
        if self.shm is not None:
            self._unlink(self.shm)
            self.shm = None


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
    its predecessor's.

    A dense ``push`` or ``pull`` takes the shared-memory plane first
    (``BPS_ENABLE_SHM``, servers on ``127.0.0.1``, ``localhost`` or a
    ``unix:`` address), then the stripes (an op of at least
    ``max(BPS_STRIPE_MIN, 512 KiB)`` bytes, ``_stripe_ranges``), then the
    plain op; every other op keeps its own frame on the socket. A server
    that cannot attach this worker's segment (or a segment this worker
    cannot make) turns the shm plane off for that server, with a warning
    and a count in ``transport/shm_fallbacks``, and the op goes over the
    socket with the same token. ``transport/ipc_dials`` and
    ``transport/tcp_dials`` count the connections dialed by kind."""

    # payload frames of the gradient class under the wire credit
    _SCHED_GRAD_OPS = frozenset({OP_PUSH, OP_PUSH_C, OP_PUSH_RS, OP_PUSH_F,
                                 OP_PUSH_PART, OP_PUSH_LAG})
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
        # connection striping (0 = off): an op at least this large is split
        # over the pool's channels in flight at once
        self._stripe_min = int(os.environ.get("BPS_STRIPE_MIN", "0") or 0)
        self._stripe_exec = None
        self._stripe_exec_lock = threading.Lock()
        # the shared-memory data plane, for colocated servers only
        shm_on = os.environ.get("BPS_ENABLE_SHM", "0") not in ("0", "",
                                                               "false")
        self._shm_shards = [shm_on and host in ("unix",) + _LOCAL_HOSTS
                            for host, _ in self._addrs]
        reg = get_registry()
        self._m_shm_fallbacks = reg.counter("transport/shm_fallbacks")
        self._m_dials = {True: reg.counter("transport/tcp_dials"),
                         False: reg.counter("transport/ipc_dials")}
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
        """A connection to server ``i``: its Unix socket for a
        ``unix:/path.sock`` address, or with ``BPS_ENABLE_IPC`` for a
        loopback one whose server listens on its ``_ipc_path``; TCP
        otherwise."""
        host, port = self._addrs[i]
        if host == "unix":
            path = port
        elif _ipc_enabled() and host in _LOCAL_HOSTS:
            path = _ipc_path(int(port))
            if not os.path.exists(path):
                path = None        # a server without the listener
        else:
            path = None
        if path is not None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            _bump_bufs(s)
            try:
                s.connect(path)
                self._m_dials[False].inc()
                return s
            except OSError:
                s.close()
                if host == "unix":
                    raise
        s = socket.create_connection((host, int(port)))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._m_dials[True].inc()
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
                parts = (payload if isinstance(payload, (tuple, list))
                         else (payload,))
                ticket = scheduler.acquire(
                    CLASS_ACT if op == OP_PARAM_PUT else CLASS_GRAD,
                    self._send_prio.get(key, 0), key,
                    sum(len(_byteview(p)) for p in parts))
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

    # -- the dense data plane: shm, then stripes, then the plain op

    def _shm_rpc(self, op: int, key: int, rnd: int,
                 arr: Optional[np.ndarray] = None,
                 out: Optional[np.ndarray] = None,
                 timeout_ms: int = 30000) -> None:
        """One op through the channel's segment: only its name and the
        length cross the socket. The channel, and so its segment, is held
        until the pulled bytes are copied out; a redial keeps the segment
        (a frame names it)."""
        i = self._shard(key)
        ch = self._pools[i].get()
        try:
            nbytes = arr.nbytes if arr is not None else out.nbytes
            try:
                seg = ch.ensure_shm(nbytes)
            except OSError as e:
                # no room in /dev/shm (or no /dev/shm): the server-side
                # attach failure's fallback, not a failed op
                raise RuntimeError(f"client-side shm unavailable: {e}") from e
            if arr is not None:
                seg.buf[:nbytes] = _as_bytes(arr)
            dtype = bf16.dtype_name(arr if arr is not None else out)
            self._roundtrip_with_retry(i, ch, op, key, rnd, nbytes,
                                       timeout_ms, dtype,
                                       memoryview(seg.name.encode()))
            if out is not None:
                flat = np.frombuffer(seg.buf[:nbytes], dtype=out.dtype)
                np.copyto(out, flat.reshape(out.shape))
                del flat
        finally:
            self._pools[i].put(ch)

    def _shm_disable(self, i: int, err: Exception) -> None:
        """Server ``i`` shares no ``/dev/shm`` with this worker (another
        container, a tunneled loopback), or the segment could not be
        made: the socket carries this server's ops from now on, as the
        JAX package does; the port also counts it."""
        self._shm_shards[i] = False
        self._m_shm_fallbacks.inc()
        get_logger().warning(
            "BPS_ENABLE_SHM: server %s cannot use this worker's shm "
            "segment (%s); falling back to the socket for it",
            ":".join(self._addrs[i]), err)

    def _stripe_ranges(self, nbytes: int):
        """[(offset, length)] of a striped op, or None where striping is
        off or not worth it: parts are 16-byte multiples, so no part
        boundary splits an element."""
        if self._stripe_min <= 0 or self._nconns < 2:
            return None
        if nbytes < max(self._stripe_min, 2 * (256 << 10)):
            return None
        if nbytes >= (1 << 32):
            return None     # _PART's offsets are u32: larger ops go whole
        nparts = min(self._nconns, (nbytes + self._stripe_min - 1)
                     // self._stripe_min)
        if nparts < 2:
            return None
        step = ((nbytes + nparts - 1) // nparts + 15) & ~15
        return [(off, min(step, nbytes - off))
                for off in range(0, nbytes, step)]

    def _stripe_pool_get(self):
        with self._stripe_exec_lock:     # one pool, however many callers
            if self._stripe_exec is None:
                from concurrent.futures import ThreadPoolExecutor
                self._stripe_exec = ThreadPoolExecutor(
                    max_workers=self._nconns,
                    thread_name_prefix="bps-stripe")
            return self._stripe_exec

    def _stripe_run(self, fn, items) -> None:
        """One striped op's parts at once; every part is waited for
        before the first error is raised, so a retry never races its own
        stragglers on the server's stage."""
        futs = [self._stripe_pool_get().submit(fn, it) for it in items]
        first = None
        for f in futs:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 — raised below
                if first is None:
                    first = e
        if first is not None:
            raise first

    def push(self, key: int, data: np.ndarray) -> None:
        tok = self._push_token(key)
        i = self._shard(key)
        if self._shm_shards[i]:
            try:
                self._shm_rpc(OP_PUSH_SHM, key, tok, arr=data)
                return
            except RuntimeError as e:     # no segment the server can use
                self._shm_disable(i, e)   # the same token: applied once
        view = _as_bytes(data)
        dtype = bf16.dtype_name(data)
        ranges = self._stripe_ranges(len(view))
        if ranges is None:
            self._rpc(OP_PUSH, key, tok, 0, 0, dtype, view)
            return
        # the parts share the token; the server applies the op once
        nparts = len(ranges)

        def send_part(args):
            pi, (off, ln) = args
            self._rpc(OP_PUSH_PART, key, tok, len(view), 0, dtype,
                      (_PART.pack(off, ln, pi, nparts, 0),
                       view[off:off + ln]))

        self._stripe_run(send_part, list(enumerate(ranges)))

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
        dtype = bf16.dtype_name(out)

        def attempt(slice_ms: int) -> None:
            i = self._shard(key)
            if self._shm_shards[i]:
                try:
                    self._shm_rpc(OP_PULL_SHM, key, round, out=out,
                                  timeout_ms=slice_ms)
                    return
                except RuntimeError as e:   # no segment the server can use
                    self._shm_disable(i, e)
            ranges = (self._stripe_ranges(out.nbytes)
                      if out.flags["C_CONTIGUOUS"] else None)
            if ranges is None:
                self._rpc(OP_PULL, key, round, out.nbytes, slice_ms, dtype,
                          None, pull_into=out)
                return
            # each part lands in its range of ``out``; one fetch on the
            # server feeds this attempt's parts, and the nonce is fresh
            # for every attempt, so a retry never shares a stage with its
            # own stragglers (an abandoned stage is swept on the server)
            flat = out.view(np.uint8).reshape(-1)
            nparts = len(ranges)
            nonce = int.from_bytes(os.urandom(8), "big")

            def pull_part(args):
                pi, (off, ln) = args
                self._rpc(OP_PULL_PART, key, round, out.nbytes, slice_ms,
                          dtype, (_PART.pack(off, ln, pi, nparts, nonce),),
                          pull_into=flat[off:off + ln])

            self._stripe_run(pull_part, list(enumerate(ranges)))

        self._sliced_pull(attempt, timeout_ms, f"pull({key}) round={round}")

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
        if self._stripe_exec is not None:
            self._stripe_exec.shutdown(wait=True)
            self._stripe_exec = None
        for pool in self._pools + self._param_pools:
            while True:
                try:
                    ch = pool.get_nowait()
                except queue.Empty:
                    break
                ch.drop_shm()
                if ch.sock is None:
                    continue
                try:
                    _send_req(ch.sock, OP_CLOSE, 0, 0, 0, 0, "", None)
                    _recv_exact(ch.sock, _RSP.size)
                except (ConnectionError, OSError):
                    pass
                ch.sock.close()
