"""The RPC layer: struct-codec frames over TCP with a first-byte demux (a
copy of ``nomad_tpu/server/rpc.py``'s server side, ``:1-667``; reference
nomad/rpc.go, nomad/pool.go).

One TCP port serves both channels, told apart by the connection's first
byte (rpc.go:23-30): ``RPC_NOMAD`` carries the endpoints
(``server/endpoints.py``), ``RPC_RAFT`` the replicated log's messages
(``MultiRaft.handle_message``).  Frames on either are a little-endian
u32 length and one struct-codec frame (``codec``, subsystem ``rpc``):
``[seq, method, body]`` for a request and ``[seq, error, body]`` for its
reply, the moral of net/rpc's header pairs.

One wire format.  The reference also speaks reflection msgpack, sniffs
the codec per frame and negotiates a connection down to msgpack on a
schema mismatch (rpc.py:36-44, :120-148); the port has no msgpack (its
machine does not install it) and no second format, as its log has one.
A body outside the codec's schema raises ``CodecError`` at encode, and a
received frame that is not one of this build's schema (a reference
peer's frame among them: its schema fingerprint differs) is a
``TransportError`` and the connection is dropped.  Port and reference
servers therefore do not interoperate on the wire.

Each request is traced as an ``rpc.request`` span (rpc.py:364) and
timed as ``rpc.request.<method>``.  Each frame sent passes the
``rpc.send`` fault point (``delay``; ``error`` and ``crash`` surface as
the transport failure a broken wire raises).

Left out: ``NoPathToRegion`` and cross-region forwarding (federation),
the net chaos hook ``ConnPool._net_check`` (the chaos drill), and the
client agent's ``RemoteServerRPC`` (ROADMAP queue 1 item 20).
"""

from __future__ import annotations

import logging
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import codec, fault
from ..utils import tracing
from ..utils.backoff import Backoff
from ..utils.telemetry import NULL_TELEMETRY

# Protocol bytes (rpc.go:23-30).
RPC_NOMAD = 0x01
RPC_RAFT = 0x02

_LEN = struct.Struct("<I")
# A larger length prefix means a desynchronized (or hostile) stream.
MAX_FRAME = 64 << 20


class RPCError(Exception):
    pass


class TransportError(RPCError):
    """Connection-level failure (dial, read, write, a frame that does not
    decode), unlike an application error reply from the remote."""


class DialError(TransportError):
    """The connection could not be established: the request was never
    sent, so retrying elsewhere cannot apply it twice."""


class NoLeaderError(RPCError):
    pass


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def _send_frame(sock: socket.socket, obj: Any) -> None:
    """One frame; ``codec.CodecError`` when ``obj`` is outside the
    schema (nothing is sent then)."""
    data = codec.encode(obj, "rpc")
    act = fault.faultpoint("rpc.send")
    if act is not None:
        if act.kind == "delay":
            time.sleep(act.delay)
        elif act.kind in ("error", "crash"):
            # The transport failure a real broken wire raises, so the
            # fault takes the same discard/retry path.
            raise ConnectionError(f"injected {act.kind} at rpc.send")
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            # EOF mid-frame is a transport failure, not a decode problem.
            if buf:
                raise TransportError(
                    f"connection closed mid-frame ({len(buf)}/{n} bytes)")
            raise TransportError("connection closed")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_FRAME:
        raise TransportError(f"frame too large: {n}")
    data = _recv_exact(sock, n)
    if not codec.is_frame(data):
        raise TransportError("not a struct-codec frame")
    try:
        return codec.decode(data, "rpc")
    except codec.CodecError as e:
        raise TransportError(f"bad codec frame: {e}") from e


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------


class RPCServer:
    """TCP listener demuxing the Nomad and raft channels onto handlers.

    ``register(method, fn)`` exposes ``fn(body) -> reply`` on the Nomad
    channel; ``raft_handler`` receives the raft messages of peers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 logger: Optional[logging.Logger] = None,
                 tls_context=None, metrics=None):
        self.logger = logger or logging.getLogger("nomad_tpu_torch.rpc")
        self.metrics = metrics if metrics is not None else NULL_TELEMETRY
        self.methods: Dict[str, Callable[[Any], Any]] = {}
        self.raft_handler: Optional[Callable[[Any], Any]] = None
        self.tls_context = tls_context
        outer = self

        self._active: set = set()
        self._active_lock = threading.Lock()

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                # Track the raw socket first, so shutdown() can sever a
                # connection stuck mid-handshake; the handshake is bounded.
                with outer._active_lock:
                    outer._active.add(sock)
                if outer.tls_context is not None:
                    try:
                        sock.settimeout(10.0)
                        tls_sock = outer.tls_context.wrap_socket(
                            sock, server_side=True)
                        tls_sock.settimeout(None)
                    except OSError as e:
                        outer.logger.warning("rpc: TLS handshake failed: %s",
                                             e)
                        with outer._active_lock:
                            outer._active.discard(sock)
                        return
                    with outer._active_lock:
                        outer._active.discard(sock)
                        outer._active.add(tls_sock)
                    sock = tls_sock
                try:
                    try:
                        prefix = _recv_exact(sock, 1)[0]
                    except (TransportError, ConnectionError, OSError):
                        return
                    if prefix == RPC_NOMAD:
                        outer._serve_nomad(sock)
                    elif prefix == RPC_RAFT:
                        outer._serve_raft(sock)
                    else:
                        outer.logger.warning(
                            "rpc: unrecognized protocol byte %#x", prefix)
                finally:
                    with outer._active_lock:
                        outer._active.discard(sock)
                        outer._active.discard(self.request)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self.tcp = Server((host, port), Handler)
        self.host = host
        self.port = self.tcp.server_address[1]
        self._thread = threading.Thread(target=self.tcp.serve_forever,
                                        name="rpc", daemon=True)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread.start()

    def threads(self) -> List[threading.Thread]:
        t = self._thread
        return [t] if t.is_alive() else []

    def shutdown(self) -> None:
        if self._thread.is_alive():
            self.tcp.shutdown()
        self.tcp.server_close()
        # Established connections die with the server: a peer's pooled
        # connection left open would keep talking to this dead instance
        # instead of reconnecting to its successor.
        with self._active_lock:
            conns = list(self._active)
            self._active.clear()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._thread.join(timeout=5.0)

    def register(self, method: str, fn: Callable[[Any], Any]) -> None:
        self.methods[method] = fn

    def _reply(self, sock: socket.socket, reply: list) -> bool:
        """Send one reply; a reply body outside the schema goes back as
        the error it is.  False when the connection is gone."""
        try:
            try:
                _send_frame(sock, reply)
            except codec.CodecError as e:
                _send_frame(sock, [reply[0], f"CodecError: {e}", None])
        except (ConnectionError, OSError):
            return False
        return True

    def _serve_nomad(self, sock: socket.socket) -> None:
        """One connection, many sequential requests (a net/rpc codec
        session over a pooled stream)."""
        while True:
            try:
                seq, method, body = _recv_frame(sock)
            except (TransportError, ConnectionError, OSError, ValueError,
                    TypeError):
                return
            self.metrics.incr_counter("rpc.request")
            fn = self.methods.get(method)
            if fn is None:
                # Unknown methods are rejected traffic, not silence.
                self.metrics.incr_counter("rpc.request_error")
                reply = [seq, f"rpc: can't find method {method}", None]
            else:
                t0 = time.perf_counter()
                # Branch before building the span's attrs: the disarmed
                # path pays one load and a comparison.
                tr = tracing.TRACER
                req_span = tracing.NOOP if tr is None else tr.span(
                    "rpc.request", method=method)
                try:
                    with req_span:
                        reply = [seq, None, fn(body)]
                except NoLeaderError as e:
                    reply = [seq, f"__no_leader__:{e}", None]
                except Exception as e:  # the error string to the caller
                    self.metrics.incr_counter("rpc.request_error")
                    reply = [seq, f"{type(e).__name__}: {e}", None]
                self.metrics.measure_since(f"rpc.request.{method}", t0)
            if not self._reply(sock, reply):
                return

    def _serve_raft(self, sock: socket.socket) -> None:
        while True:
            try:
                seq, _method, body = _recv_frame(sock)
            except (TransportError, ConnectionError, OSError, ValueError,
                    TypeError):
                return
            handler = self.raft_handler
            if handler is None:
                reply = [seq, "raft: not ready", None]
            else:
                try:
                    reply = [seq, None, handler(body)]
                except Exception as e:
                    reply = [seq, f"{type(e).__name__}: {e}", None]
            if not self._reply(sock, reply):
                return


# ---------------------------------------------------------------------------
# client side: the connection pool (nomad/pool.go)
# ---------------------------------------------------------------------------


class _Conn:
    def __init__(self, addr: str, channel: int, timeout: float,
                 tls_context=None):
        host, port = addr.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=timeout)
        if tls_context is not None:
            self.sock = tls_context.wrap_socket(self.sock,
                                                server_hostname=host)
        self.sock.sendall(bytes([channel]))
        self.seq = 0
        self.lock = threading.Lock()

    def call(self, method: str, body: Any, timeout: float) -> Any:
        with self.lock:
            self.seq += 1
            seq = self.seq
            self.sock.settimeout(timeout)
            _send_frame(self.sock, [seq, method, body])
            rseq, err, reply = _recv_frame(self.sock)
        if rseq != seq:
            # A desynchronized stream: the connection is unusable.
            raise ConnectionError(f"rpc: sequence mismatch ({rseq} != {seq})")
        if err:
            if isinstance(err, str) and err.startswith("__no_leader__:"):
                raise NoLeaderError(err.split(":", 1)[1])
            if isinstance(err, str) and err.startswith("BrokerLimitError"):
                # Re-typed so wire callers get the retry_after hint.
                from .eval_broker import BrokerLimitError

                raise BrokerLimitError.from_message(err)
            raise RPCError(err)
        return reply

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class ConnPool:
    """Connection reuse per (addr, channel) (pool.go:144).

    Hands out parallel connections: a call checks out an idle connection
    (or dials a new one) and returns it afterwards, so a long poll holding
    one connection cannot starve short calls (the role yamux stream
    multiplexing plays in the reference).

    A failed dial arms a jittered backoff for its address; while it holds,
    dials to that address fail at once with ``DialError`` (no socket), so
    replicators and elections do not hammer a dead peer."""

    MAX_IDLE_PER_KEY = 4
    DIAL_BACKOFF_BASE = 0.05
    DIAL_BACKOFF_MAX = 2.0

    def __init__(self, timeout: float = 10.0, tls_context=None):
        self.timeout = timeout
        self.tls_context = tls_context
        self._idle: Dict[Tuple[str, int], List[_Conn]] = {}
        self._lock = threading.Lock()
        # addr -> [Backoff, not_before (monotonic)]
        self._dial_gate: Dict[str, list] = {}

    def _dial(self, addr: str, channel: int, timeout: float) -> _Conn:
        now = time.monotonic()
        with self._lock:
            gate = self._dial_gate.get(addr)
            if gate is not None and now < gate[1]:
                raise DialError(
                    f"rpc to {addr} failed: in dial backoff for another "
                    f"{gate[1] - now:.2f}s after {gate[0].attempt} "
                    "consecutive dial failures")
        try:
            conn = _Conn(addr, channel, timeout,
                         tls_context=self.tls_context)
        except OSError:
            with self._lock:
                gate = self._dial_gate.get(addr)
                if gate is None:
                    gate = [Backoff(base=self.DIAL_BACKOFF_BASE,
                                    max_delay=self.DIAL_BACKOFF_MAX), 0.0]
                    self._dial_gate[addr] = gate
                gate[1] = time.monotonic() + gate[0].next_delay()
            raise
        with self._lock:
            self._dial_gate.pop(addr, None)
        return conn

    def call(self, addr: str, method: str, body: Any,
             channel: int = RPC_NOMAD, timeout: Optional[float] = None) -> Any:
        timeout = timeout if timeout is not None else self.timeout
        key = (addr, channel)
        with self._lock:
            bucket = self._idle.get(key)
            conn = bucket.pop() if bucket else None
        if conn is None:
            try:
                conn = self._dial(addr, channel, timeout)
            except OSError as e:  # includes ssl.SSLError
                raise DialError(f"rpc to {addr} failed: {e}") from e
        try:
            reply = conn.call(method, body, timeout)
        except TransportError:
            # Already classified (EOF mid-frame, a bad frame): the socket
            # is poisoned; discard, never re-pool.
            conn.close()
            raise
        except (ConnectionError, OSError) as e:
            # Includes socket.timeout: a reply may still be in flight, so
            # releasing this connection would hand the next caller a stale
            # response.  Discard.
            conn.close()
            raise TransportError(f"rpc to {addr} failed: {e}") from e
        except Exception:
            # A request refused at encode (CodecError: nothing was sent)
            # or an application error reply (RPCError, BrokerLimitError):
            # the stream is intact, keep the connection.
            self._release(key, conn)
            raise
        self._release(key, conn)
        return reply

    def _release(self, key: Tuple[str, int], conn: _Conn) -> None:
        with self._lock:
            bucket = self._idle.setdefault(key, [])
            if len(bucket) < self.MAX_IDLE_PER_KEY:
                bucket.append(conn)
                return
        conn.close()

    def invalidate(self, addr: str) -> None:
        """Drop every idle connection to ``addr`` (all channels) and clear
        its dial gate: a peer known to have restarted leaves only dead
        sockets in the pool, and draining them one TransportError at a
        time wastes a failed call per connection."""
        with self._lock:
            dead = [conn for key, bucket in self._idle.items()
                    if key[0] == addr for conn in bucket]
            for key in [k for k in self._idle if k[0] == addr]:
                del self._idle[key]
            self._dial_gate.pop(addr, None)
        for conn in dead:
            conn.close()

    def close(self) -> None:
        with self._lock:
            for bucket in self._idle.values():
                for conn in bucket:
                    conn.close()
            self._idle.clear()
