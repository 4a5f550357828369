"""Real-fleet plumbing: worker identity, heartbeat files, stripe and page
exchanges, and the tree fingerprint.

A copy of the reference package's ``repro.runtime.fleet`` (standard
library and numpy; ``torch`` is imported only by the functions that make
or read tensors):

* :class:`FleetWorker` — a worker process's identity and channels: its
  (process_id, num_processes) coordinates, the shared ``fleet_dir`` it
  heartbeats into (one atomic JSON per rank, watched by the supervisor's
  hang detector), and the train-only fields (coordinator, stripe ports,
  striped restore) kept for the train worker mode.
* :class:`TcpStripeExchange` / :class:`LocalStripeExchange` — all-gather
  of byte payloads across the fleet, over loopback / NIC TCP or between
  simulated hosts (threads) in one process.
* :class:`TcpPageExchange` / :class:`LocalPageExchange` — POINT-TO-POINT
  migration of serving KV pages between fleet hosts (the serving fleet in
  ``serving/fleet.py``): one prefix's pages move from the host that OWNS
  them to the host that needs them — the paper's FIFO-mesh
  promote-local-to-global story at page granularity.  Frames carry a CRC
  per page (:func:`encode_page_frame` / :func:`decode_page_frame`);
  :class:`PageExchangeTimeout` (unreachable peer / netsplit) is
  deliberately distinct from :class:`PageCorruptError` (bad bytes) so the
  router can tell "retry elsewhere" from "recompute".
* :func:`tree_fingerprint` — an order-stable CRC over a tree's leaf
  bytes, so two processes (or two runs) can assert bit-identical params
  by exchanging 8 hex chars instead of gigabytes.

The page frame is the reference's ``PGX1`` frame byte for byte.  A bf16
tensor travels under the dtype name ``bfloat16`` as its raw 16-bit words
(what an ml_dtypes array holds), and decodes back through a 16-bit
integer view, so neither side needs ml_dtypes to read the other's frames.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
import struct
import threading
import time
import zlib

HEARTBEAT_DIR = "hb"
KEEPALIVE_S = 2.0      # heartbeat period while I/O blocks a worker's loop
_LEN = struct.Struct(">Q")


def allocate_ports(n: int, host: str = "127.0.0.1") -> list[int]:
    """Reserve ``n`` distinct ephemeral TCP ports (bind-0 then release).

    A small race window exists between release and the worker's bind;
    acceptable for a single-machine fleet (a collision crashes the
    worker, which the supervisor restarts on a fresh gang).
    """
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def _write_json_atomic(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def heartbeat_path(fleet_dir: str, tag: int) -> str:
    return os.path.join(fleet_dir, HEARTBEAT_DIR, f"rank_{tag}.json")


def read_heartbeat(fleet_dir: str, tag: int) -> dict | None:
    """Latest heartbeat of worker ``tag`` with the file's mtime attached
    (``_mtime``; the supervisor judges staleness by mtime, not by the
    worker's own clock).  None when the worker never heartbeat."""
    path = heartbeat_path(fleet_dir, tag)
    try:
        with open(path) as f:
            hb = json.load(f)
        hb["_mtime"] = os.stat(path).st_mtime
        return hb
    except (OSError, json.JSONDecodeError, ValueError):
        return None


def tree_fingerprint(tree) -> str:
    """Order-stable CRC32 over leaf (path, dtype, shape, bytes) — cheap
    cross-process bit-identity evidence.  The same CRC as the reference's
    ``repro.runtime.fleet.tree_fingerprint`` of the same values: a bf16
    leaf hashes the dtype name ``bfloat16`` and its raw 16-bit words."""
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.weights import to_numpy
    crc = 0
    for path, leaf in flatten_with_paths(tree):
        arr, name = to_numpy(leaf.detach().cpu().contiguous())
        # the reference hashes np.ascontiguousarray's shape, which makes a
        # 0-d leaf (1,)
        head = f"{path}|{name}|{tuple(leaf.shape) or (1,)}|"
        crc = zlib.crc32(head.encode(), crc)
        crc = zlib.crc32(arr.reshape(-1).view("u1"), crc)   # no copy
    return f"{crc:08x}"


# ---------------------------------------------------------------------------
# Stripe exchange: all-gather byte payloads across the fleet
# ---------------------------------------------------------------------------

class StripeExchangeTimeout(TimeoutError):
    """A peer never produced (or never served) its stripe in time.

    Deliberately NOT a :class:`~repro_torch.checkpoint.CheckpointCorruptError`:
    the bytes on disk may be fine — the caller should fail the collective
    restore (and retry / fall back to full reads), not walk to an older
    checkpoint and silently lose steps.
    """


class LocalStripeExchange:
    """In-process all-gather for simulated hosts (threads) — the same
    interface the TCP transport provides, minus the sockets, so tests
    drive the collective code path deterministically."""

    def __init__(self, world: int, *, timeout_s: float = 30.0):
        self.world = world
        self.timeout_s = timeout_s
        self._cv = threading.Condition()
        self._slots: dict[str, dict[int, bytes]] = {}

    def allgather(self, key: str, rank: int, world: int,
                  payload: bytes) -> list[bytes]:
        assert world == self.world, (world, self.world)
        deadline = time.monotonic() + self.timeout_s
        with self._cv:
            self._slots.setdefault(key, {})[rank] = payload
            self._cv.notify_all()
            while len(self._slots[key]) < world:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    missing = sorted(set(range(world))
                                     - set(self._slots[key]))
                    raise StripeExchangeTimeout(
                        f"allgather {key!r}: ranks {missing} never arrived")
            return [self._slots[key][r] for r in range(world)]

    def close(self) -> None:
        with self._cv:
            self._slots.clear()
            self._cv.notify_all()


class TcpStripeExchange:
    """All-gather over loopback/NIC TCP: rank r serves its own payloads on
    ``ports[r]`` (daemon accept loop) and fetches each peer's from theirs.

    Protocol per connection: one request line ``<key>\\n``; the server
    blocks until it has published that key (bounded by its own timeout),
    then answers ``>Q`` length + payload.  Clients retry refused
    connections until the deadline — gang members reach the exchange
    point at different times.
    """

    # extra seconds granted ONCE per fetch when the peer RESETS the
    # connection (a restarting peer is not a missing peer; refused /
    # plain timeouts get no grace — the peer was never there)
    RECONNECT_GRACE_S = 5.0

    def __init__(self, rank: int, ports: list[int], *,
                 host: str = "127.0.0.1", timeout_s: float = 60.0):
        self.rank = rank
        self.ports = list(ports)
        self.host = host
        self.timeout_s = timeout_s
        self.reconnects = 0             # reset-triggered deadline extensions
        self._cv = threading.Condition()
        self._published: dict[str, bytes] = {}
        self._closed = False
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, self.ports[rank]))
        self._srv.listen(max(4, 2 * len(ports)))
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # -- server side --------------------------------------------------------

    def _serve(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return                          # socket closed
            threading.Thread(target=self._answer, args=(conn,),
                             daemon=True).start()

    def _answer(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(self.timeout_s)
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = conn.recv(256)
                if not chunk:
                    return
                buf += chunk
            key = buf[:-1].decode()
            deadline = time.monotonic() + self.timeout_s
            with self._cv:
                while key not in self._published and not self._closed:
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._cv.wait(timeout=left):
                        return                  # requester will time out too
                payload = self._published.get(key)
            if payload is None:
                return
            # header, then the payload through a view: no copy of it
            view = memoryview(payload).cast("B")
            conn.sendall(_LEN.pack(len(view)))
            conn.sendall(view)
        except OSError:
            pass
        finally:
            conn.close()

    # -- client side --------------------------------------------------------

    def _fetch(self, peer: int, key: str, deadline: float) -> bytes:
        last_err: Exception | None = None
        reconnected = False
        while time.monotonic() < deadline:
            try:
                with socket.create_connection(
                        (self.host, self.ports[peer]),
                        timeout=max(0.1, deadline - time.monotonic())) as c:
                    c.sendall(key.encode() + b"\n")
                    c.settimeout(max(0.1, deadline - time.monotonic()))
                    head = self._recv_exact(c, _LEN.size)
                    return self._recv_exact(c, _LEN.unpack(head)[0])
            except (ConnectionResetError, BrokenPipeError) as e:
                # the peer WAS there and dropped us mid-exchange — likely a
                # restart (supervisor bounce).  One bounded reconnect:
                # extend the deadline once so a transient bounce doesn't
                # cost the caller its fallback.
                last_err = e
                if not reconnected:
                    reconnected = True
                    self.reconnects += 1
                    deadline = max(deadline, time.monotonic() +
                                   min(self.RECONNECT_GRACE_S,
                                       self.timeout_s))
                time.sleep(0.05)
            except OSError as e:                # refused / timeout
                last_err = e
                time.sleep(0.05)
        raise StripeExchangeTimeout(
            f"rank {self.rank}: no stripe {key!r} from peer {peer} within "
            f"{self.timeout_s:.0f}s ({last_err})")

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> bytearray:
        """``n`` bytes received into one buffer allocated at that length
        (no growing, no final copy)."""
        out = bytearray(n)
        view = memoryview(out)
        got = 0
        while got < n:
            k = conn.recv_into(view[got:], min(1 << 24, n - got))
            if not k:
                raise OSError("peer closed mid-payload")
            got += k
        view.release()
        return out

    def allgather(self, key: str, rank: int, world: int,
                  payload) -> list:
        """Every rank's payload in rank order: ``payload`` itself (any
        bytes-like object, served to peers without a copy) at ``rank``,
        each peer's as a ``bytearray``."""
        assert rank == self.rank and world == len(self.ports), \
            (rank, self.rank, world, len(self.ports))
        with self._cv:
            self._published[key] = payload
            self._cv.notify_all()
        deadline = time.monotonic() + self.timeout_s
        out: list[bytes | None] = [None] * world
        out[rank] = payload
        for peer in range(world):
            if peer != rank:
                out[peer] = self._fetch(peer, key, deadline)
        return out  # type: ignore[return-value]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        try:
            self._srv.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Page exchange: point-to-point migration of serving KV pages
# ---------------------------------------------------------------------------

_PAGE_MAGIC = b"PGX1"
_BF16 = "bfloat16"


class PageExchangeTimeout(TimeoutError):
    """The owning host never served the migrated pages in time (dead peer,
    netsplit).  The router should fall back to recompute-from-longest-
    surviving-ancestor — the page CONTENT is not suspect."""


class PageCorruptError(RuntimeError):
    """A migrated page frame failed its CRC: the bytes that arrived are
    not the bytes that left.  Deliberately NOT a timeout — retrying the
    same transfer may succeed, but this copy must never enter the pool."""


def _wire_array(value):
    """(C-contiguous numpy array, dtype name) of one frame entry: a tensor
    (any device; bf16 as its raw 16-bit words under ``bfloat16``) or
    anything ``np.asarray`` takes (an ml_dtypes bf16 array keeps its
    name)."""
    import numpy as np
    if hasattr(value, "detach"):                   # a torch tensor
        from repro_torch.weights import to_numpy
        arr, name = to_numpy(value.detach().cpu().contiguous())
        return np.ascontiguousarray(arr), name
    arr = np.ascontiguousarray(np.asarray(value))
    return arr, str(arr.dtype)


def encode_page_frame(tokens, arrays) -> bytes:
    """One migrated page as a self-describing wire frame: magic, the
    page's token content, each pool entry's (key, dtype, shape, bytes),
    and a trailing CRC32 over everything after the magic.  The CRC makes
    corruption detectable at the RECEIVER, before the page touches the
    pool — the serving analogue of the checkpoint commit-marker CRC."""
    toks = [int(t) for t in tokens]
    body = bytearray()
    body += struct.pack(">I", len(toks))
    if toks:
        body += struct.pack(f">{len(toks)}i", *toks)
    body += struct.pack(">I", len(arrays))
    for key in sorted(arrays):
        arr, name = _wire_array(arrays[key])
        kb, db = key.encode(), name.encode()
        body += struct.pack(">H", len(kb)) + kb
        body += struct.pack(">H", len(db)) + db
        body += struct.pack(">B", arr.ndim)
        if arr.ndim:
            body += struct.pack(f">{arr.ndim}I", *arr.shape)
        raw = arr.tobytes()
        body += struct.pack(">Q", len(raw)) + raw
    return _PAGE_MAGIC + bytes(body) + struct.pack(
        ">I", zlib.crc32(body))


def _tensor_from_bytes(raw, dtype: str, shape):
    """A CPU tensor that owns a copy of ``raw`` read as ``dtype``; a
    ``bfloat16`` entry goes through a 16-bit integer view, bit for bit."""
    import numpy as np
    import torch
    if dtype == _BF16:
        words = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(
        np.frombuffer(raw, dtype=dtype).reshape(shape).copy())


def decode_page_frame(frame: bytes):
    """Inverse of :func:`encode_page_frame`; raises
    :class:`PageCorruptError` on any structural or CRC mismatch.
    Returns ``(tokens, {key: CPU torch.Tensor})``."""
    if len(frame) < len(_PAGE_MAGIC) + 4 or \
            not frame.startswith(_PAGE_MAGIC):
        raise PageCorruptError("page frame: bad magic/header")
    body = memoryview(frame)[len(_PAGE_MAGIC):-4]
    (crc,) = struct.unpack(">I", frame[-4:])
    if zlib.crc32(body) != crc:
        raise PageCorruptError("page frame: CRC mismatch")
    off = 0

    def take(n: int) -> memoryview:
        nonlocal off
        if off + n > len(body):
            raise PageCorruptError("page frame: truncated")
        out = body[off:off + n]
        off += n
        return out

    (n_toks,) = struct.unpack(">I", take(4))
    tokens = struct.unpack(f">{n_toks}i", take(4 * n_toks)) \
        if n_toks else ()
    (n_arr,) = struct.unpack(">I", take(4))
    arrays = {}
    for _ in range(n_arr):
        (kl,) = struct.unpack(">H", take(2))
        key = bytes(take(kl)).decode()
        (dl,) = struct.unpack(">H", take(2))
        dtype = bytes(take(dl)).decode()
        (nd,) = struct.unpack(">B", take(1))
        shape = struct.unpack(f">{nd}I", take(4 * nd)) if nd else ()
        (nb,) = struct.unpack(">Q", take(8))
        arrays[key] = _tensor_from_bytes(take(nb), dtype, shape)
    return tokens, arrays


def flip_frame_byte(frame: bytes) -> bytes:
    """XOR one mid-body byte (the ``pagecorrupt`` chaos payload) — the
    deterministic damage the receiver's CRC must catch."""
    off = len(_PAGE_MAGIC) + (len(frame) - len(_PAGE_MAGIC) - 4) // 2
    return frame[:off] + bytes([frame[off] ^ 0xFF]) + frame[off + 1:]


class LocalPageExchange:
    """In-process page-migration channel between the LocalFleet's hosts —
    same decode/CRC path the TCP transport exercises, with injectable
    fault hooks: ``blackout(host)`` (netsplit chaos: the transfer raises
    :class:`PageExchangeTimeout`) and ``corrupt_hook()`` (pagecorrupt
    chaos: one frame byte is flipped in flight).  Byte/frame counters
    feed the fleet's ``page_exchange_bytes`` metric."""

    def __init__(self):
        self.blackout = None            # callable(host) -> bool
        self.corrupt_hook = None        # callable() -> bool
        self.bytes_sent = 0
        self.frames_sent = 0

    def transfer(self, src_host: int, dst_host: int, frames):
        """Move encoded frames ``src -> dst``; returns the decoded
        ``(tokens, arrays)`` list.  Counts bytes before decoding — the
        wire carried them whether or not the CRC holds."""
        if self.blackout is not None and (self.blackout(src_host)
                                          or self.blackout(dst_host)):
            raise PageExchangeTimeout(
                f"netsplit: page channel {src_host}->{dst_host} is black")
        out = []
        for frame in frames:
            if self.corrupt_hook is not None and self.corrupt_hook():
                frame = flip_frame_byte(frame)
            self.bytes_sent += len(frame)
            self.frames_sent += 1
            out.append(decode_page_frame(frame))
        return out


class TcpPageExchange(TcpStripeExchange):
    """Point-to-point page migration over the stripe-exchange wire
    protocol: the source PUBLISHES its encoded frames under a migration
    key, the target FETCHES them from the source's port — no all-gather
    barrier (migration is point-to-point, like the paper's mesh hops).
    Inherits the server loop, length-prefixed framing, and the bounded
    reconnect-on-reset from :class:`TcpStripeExchange`."""

    def __init__(self, rank: int, ports: list[int], *,
                 host: str = "127.0.0.1", timeout_s: float = 60.0):
        super().__init__(rank, ports, host=host, timeout_s=timeout_s)
        self.bytes_sent = 0
        self.frames_sent = 0

    def publish(self, key: str, frames) -> None:
        payload = struct.pack(">I", len(frames)) + b"".join(
            _LEN.pack(len(f)) + f for f in frames)
        with self._cv:
            self._published[key] = payload
            self._cv.notify_all()

    def fetch(self, peer: int, key: str, *,
              timeout_s: float | None = None):
        """Decoded ``(tokens, arrays)`` frames published by ``peer``
        under ``key``; :class:`PageExchangeTimeout` when the peer never
        serves them."""
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.timeout_s)
        try:
            payload = self._fetch(peer, key, deadline)
        except StripeExchangeTimeout as e:
            raise PageExchangeTimeout(str(e)) from None
        (n,) = struct.unpack(">I", payload[:4])
        off, frames = 4, []
        for _ in range(n):
            (ln,) = _LEN.unpack(payload[off:off + _LEN.size])
            off += _LEN.size
            frames.append(payload[off:off + ln])
            off += ln
        self.bytes_sent += sum(len(f) for f in frames)
        self.frames_sent += len(frames)
        return [decode_page_frame(f) for f in frames]


# ---------------------------------------------------------------------------
# Worker identity
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetWorker:
    """One worker process's view of the fleet (built from the CLI flags
    the supervisor passes to the launchers)."""

    process_id: int
    num_processes: int
    fleet_dir: str | None = None
    tag: int | None = None              # stable id across re-mesh renumbering
    coordinator: str | None = None
    stripe_ports: tuple[int, ...] = ()
    striped_restore: bool = False
    distributed: str = "none"           # none | torch
    result_out: str | None = None
    dist_ok: bool = False               # set after the process group is up

    def __post_init__(self):
        if self.tag is None:
            self.tag = self.process_id

    def heartbeat(self, step: int) -> None:
        """Atomically publish (step, wall time); the supervisor's hang
        detector watches the file's mtime."""
        if not self.fleet_dir:
            return
        os.makedirs(os.path.join(self.fleet_dir, HEARTBEAT_DIR),
                    exist_ok=True)
        try:
            _write_json_atomic(heartbeat_path(self.fleet_dir, self.tag),
                               {"rank": self.process_id, "step": int(step),
                                "wall": time.time()})
        except OSError:
            pass                        # a lost heartbeat must not kill a step

    @contextlib.contextmanager
    def keep_alive(self, step: int):
        """Heartbeat ``step`` every ``KEEPALIVE_S`` from a thread while
        the block runs.  A worker blocked on checkpoint I/O (a save's
        snapshot, the wait for the previous write, a restore, the final
        fingerprint) is busy, not hung, so it must not go quiet for the
        supervisor's hang detector; outside such a block only the loop
        beats, so a step that hangs still goes quiet."""
        if not self.fleet_dir:
            yield
            return
        stop = threading.Event()

        def beat():
            while not stop.wait(KEEPALIVE_S):
                self.heartbeat(step)
        t = threading.Thread(target=beat, name="fleet-keepalive",
                             daemon=True)
        t.start()
        try:
            yield
        finally:
            stop.set()
            t.join()

    def make_exchange(self, *, timeout_s: float = 60.0):
        """The stripe-exchange transport for this worker, or None when the
        supervisor allotted no ports (solo restart -> full-read restore)."""
        if len(self.stripe_ports) != self.num_processes \
                or self.num_processes < 2:
            return None
        return TcpStripeExchange(self.process_id, list(self.stripe_ports),
                                 timeout_s=timeout_s)

    def write_result(self, payload: dict) -> None:
        if self.result_out:
            os.makedirs(os.path.dirname(os.path.abspath(self.result_out)),
                        exist_ok=True)
            _write_json_atomic(self.result_out,
                               {"rank": self.process_id, "tag": self.tag,
                                "world": self.num_processes, **payload})
