"""Host-local IPC between the agent process and training processes.

Copy of ``dlrover_tpu/common/multi_process.py`` (``SharedLock``,
``SharedQueue``, ``SharedDict``, ``SharedMemoryBuffer``): the agent hosts the
real lock/queue/dict objects and serves them over unix-domain sockets;
training processes are thin clients.  This is the transport under Flash
Checkpoint's save-event queue and shared-memory lock.  The socket directory
is read at call time (``DLROVER_TPU_SOCKET_DIR``, under the temp directory
by default), and a socket path past the kernel's 107-byte limit is named by
a hash of the object's name instead.

Framing: 4-byte big-endian length + JSON body.  Payload values must be
JSON-serializable (checkpoint events are small metadata dicts; bulk tensor
bytes travel through POSIX shared memory instead).

Protocol notes (hard-won):
  * The server never blocks a connection thread for long — blocking
    semantics (lock acquire, queue get/put on a full queue) are client-side
    polling loops over short server-side slices, so an abandoned client
    leaves no orphaned server thread holding a lock or inserting late.
  * Lock ownership is tracked per client id; a retried acquire from the
    same owner is idempotent, and only the owner can release.
  * Queue puts carry a unique id; the server dedupes recently-seen ids so a
    client retry after an ambiguous timeout cannot double-insert an event.
"""

import collections
import hashlib
import itertools
import json
import os
import pathlib
import queue
import socket
import struct
import threading
import time
import uuid
from multiprocessing import shared_memory
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger

_RECV_CHUNK = 65536
_SLICE_SECS = 1.0  # max time a server conn thread blocks per request


# sun_path holds 108 bytes with the terminating NUL
_MAX_SOCKET_PATH = 107


def _socket_path(name: str) -> str:
    socket_dir = envs.get_str("DLROVER_TPU_SOCKET_DIR")
    os.makedirs(socket_dir, exist_ok=True)
    path = os.path.join(socket_dir, f"{name}.sock")
    if len(path) > _MAX_SOCKET_PATH:
        digest = hashlib.sha1(name.encode()).hexdigest()[:16]
        path = os.path.join(socket_dir, f"{digest}.sock")
    if len(path) > _MAX_SOCKET_PATH:
        raise ValueError(
            f"socket directory {socket_dir!r} is too long for a unix "
            "socket path; set DLROVER_TPU_SOCKET_DIR to a shorter one")
    return path


def _send_msg(sock: socket.socket, obj: Any):
    body = json.dumps(obj).encode("utf-8")
    sock.sendall(struct.pack(">I", len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(_RECV_CHUNK, n - len(buf)))
        if not chunk:
            raise ConnectionError("socket closed mid-message")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> Any:
    (length,) = struct.unpack(">I", _recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, length).decode("utf-8"))


class LocalSocketComm:
    """Base of the shared objects: server (agent) or client (worker)."""

    def __init__(self, name: str, create: bool):
        self._name = name
        self._create = create
        self._path = _socket_path(name)
        self._server: Optional[socket.socket] = None
        self._stopped = False
        self._client_id = uuid.uuid4().hex
        if create:
            self._start_server()

    # -- server ------------------------------------------------------------

    def _start_server(self):
        # Two same-host servers for one name (local backend runs several
        # agents of a job on one machine) race exists→unlink→bind; the
        # loser must retry, not crash.  Last binder owns the path; an
        # earlier server keeps serving connections it already accepted.
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        for attempt in range(3):
            pathlib.Path(self._path).unlink(missing_ok=True)
            try:
                self._server.bind(self._path)
                break
            except OSError:
                if attempt == 2:
                    raise
                logger.warning(
                    "bind race on %s (another server of this scope is "
                    "starting); retrying", self._path,
                )
                time.sleep(0.05 * (attempt + 1))
        self._server.listen(128)
        t = threading.Thread(
            target=self._accept_loop, name=f"ipc-{self._name}", daemon=True
        )
        t.start()

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket):
        with conn:
            while not self._stopped:
                try:
                    request = _recv_msg(conn)
                except (ConnectionError, json.JSONDecodeError, OSError):
                    return
                method = request.get("method", "")
                args = request.get("args", {})
                try:
                    result = self._handle(method, args)
                    _send_msg(conn, {"ok": True, "result": result})
                except Exception as e:  # noqa: BLE001 - serve must survive
                    _send_msg(
                        conn,
                        {
                            "ok": False,
                            "error": f"{type(e).__name__}: {e}",
                            "error_type": type(e).__name__,
                        },
                    )

    def _handle(self, method: str, args: Dict[str, Any]) -> Any:
        raise NotImplementedError

    # -- client ------------------------------------------------------------

    def _request(self, method: str, rpc_timeout: float = 60.0, **args) -> Any:
        if self._create:
            return self._handle(method, args)
        deadline = time.time() + rpc_timeout
        last_err: Optional[Exception] = None
        while time.time() < deadline:
            try:
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                    s.settimeout(max(1.0, deadline - time.time()))
                    s.connect(self._path)
                    _send_msg(s, {"method": method, "args": args})
                    reply = _recv_msg(s)
                if reply.get("ok"):
                    return reply.get("result")
                raise RuntimeError(reply.get("error", "ipc error"))
            except (ConnectionError, FileNotFoundError, socket.timeout, OSError) as e:
                last_err = e
                time.sleep(0.2)
        raise TimeoutError(
            f"IPC {self._name}.{method} timed out: {last_err}"
        )

    def close(self):
        self._stopped = True
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
            try:
                os.unlink(self._path)
            except OSError:
                pass

    def is_available(self) -> bool:
        """True only if a live server accepts connections on the socket.

        A crashed owner leaves the socket file behind; existence alone
        would make a restarting process attach to the dead endpoint and
        time out on every request."""
        if not os.path.exists(self._path):
            return False
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            probe.settimeout(1.0)
            probe.connect(self._path)
            return True
        except OSError:
            return False
        finally:
            probe.close()


class SharedLock(LocalSocketComm):
    """An owner-tracked lock served by the agent.

    Blocking acquires are client-side polling loops: each RPC asks the
    server to try for at most ``_SLICE_SECS``, so no server thread outlives
    its client's interest.  Re-acquire by the current owner is idempotent.
    """

    def __init__(self, name: str, create: bool):
        self._lock = threading.Lock() if create else None
        self._meta_lock = threading.Lock() if create else None
        self._owner: Optional[str] = None
        super().__init__(name, create)

    def _handle(self, method, args):
        if method == "try_acquire":
            owner = args["owner"]
            with self._meta_lock:
                if self._owner == owner:
                    return True
            got = self._lock.acquire(
                blocking=True, timeout=max(0.0, float(args.get("wait", 0.0)))
            ) if args.get("wait", 0.0) > 0 else self._lock.acquire(blocking=False)
            if got:
                with self._meta_lock:
                    self._owner = owner
            return got
        if method == "release":
            owner = args["owner"]
            with self._meta_lock:
                if self._owner != owner:
                    return False
                self._owner = None
            try:
                self._lock.release()
                return True
            except RuntimeError:
                return False
        if method == "force_release":
            # dead-owner recovery: the agent may break a lock held by a
            # worker it just killed (no live process can release it)
            with self._meta_lock:
                self._owner = None
            try:
                self._lock.release()
                return True
            except RuntimeError:
                return False
        if method == "locked":
            return self._lock.locked()
        raise ValueError(f"unknown lock method {method}")

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not blocking:
            return bool(
                self._request("try_acquire", owner=self._client_id, wait=0.0)
            )
        deadline = time.time() + timeout if timeout > 0 else None
        while True:
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                return False
            wait = _SLICE_SECS if remaining is None else min(_SLICE_SECS, remaining)
            got = self._request(
                "try_acquire",
                rpc_timeout=wait + 5.0,
                owner=self._client_id,
                wait=wait,
            )
            if got:
                return True

    def release(self) -> bool:
        return bool(self._request("release", owner=self._client_id))

    def force_release(self) -> bool:
        """Break the lock regardless of owner — only safe when the owner
        is known dead (e.g. the agent just killed its workers)."""
        return bool(self._request("force_release"))

    def locked(self) -> bool:
        return bool(self._request("locked"))

    def ping(self, timeout: float = 2.0) -> bool:
        """True iff the lock SERVER answers — distinguishes a live owner
        from a stale socket file left by a dead process (unix sockets are
        never unlinked by a crash)."""
        try:
            self._request("locked", rpc_timeout=timeout)
            return True
        except (TimeoutError, RuntimeError):
            return False


class SharedQueue(LocalSocketComm):
    """A FIFO owned by the agent, usable from any local process.

    ``put`` is idempotent via per-item ids; full/empty conditions surface as
    ``queue.Full`` / ``queue.Empty`` on the client exactly like ``queue.Queue``.
    """

    _DEDUP_CAPACITY = 1024

    def __init__(self, name: str, create: bool, maxsize: int = 0):
        self._queue: Optional[queue.Queue] = (
            queue.Queue(maxsize) if create else None
        )
        self._seen_puts = collections.OrderedDict() if create else None
        self._seen_lock = threading.Lock() if create else None
        super().__init__(name, create)

    def _handle(self, method, args):
        if method == "put":
            put_id = args.get("put_id", "")
            with self._seen_lock:
                if put_id and put_id in self._seen_puts:
                    return {"done": True}
            wait = float(args.get("wait", 0.0))
            try:
                if wait > 0:
                    self._queue.put(args["item"], timeout=wait)
                else:
                    self._queue.put_nowait(args["item"])
            except queue.Full:
                return {"full": True}
            if put_id:
                with self._seen_lock:
                    self._seen_puts[put_id] = True
                    while len(self._seen_puts) > self._DEDUP_CAPACITY:
                        self._seen_puts.popitem(last=False)
            return {"done": True}
        if method == "get":
            wait = float(args.get("wait", 0.0))
            try:
                if wait > 0:
                    return {"item": self._queue.get(timeout=wait)}
                return {"item": self._queue.get_nowait()}
            except queue.Empty:
                return {"empty": True}
        if method == "qsize":
            return self._queue.qsize()
        if method == "empty":
            return self._queue.empty()
        raise ValueError(f"unknown queue method {method}")

    def put(self, item: Any, timeout: Optional[float] = None):
        """Mirror queue.Queue.put: None = block forever, 0 = non-blocking."""
        put_id = uuid.uuid4().hex
        deadline = None if timeout is None else time.time() + timeout
        for attempt in itertools.count():
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0 and attempt > 0:
                raise queue.Full
            if timeout is not None and timeout == 0:
                wait = 0.0
            else:
                wait = _SLICE_SECS if remaining is None else min(_SLICE_SECS, max(0.0, remaining))
            reply = self._request(
                "put", rpc_timeout=wait + 10.0, item=item, put_id=put_id, wait=wait
            )
            if isinstance(reply, dict) and reply.get("full"):
                if timeout is not None and (timeout == 0 or time.time() >= deadline):
                    raise queue.Full
                continue
            return

    def get(self, timeout: Optional[float] = None) -> Any:
        """Mirror queue.Queue.get: None = block forever, 0 = non-blocking."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            if timeout is not None and timeout == 0:
                wait = 0.0
            else:
                remaining = None if deadline is None else max(0.01, deadline - time.time())
                wait = _SLICE_SECS if remaining is None else min(_SLICE_SECS, remaining)
            reply = self._request("get", rpc_timeout=wait + 10.0, wait=wait)
            if isinstance(reply, dict) and reply.get("empty"):
                if timeout is not None and (
                    timeout == 0 or time.time() >= deadline
                ):
                    raise queue.Empty
                continue
            return reply["item"]

    def qsize(self) -> int:
        return int(self._request("qsize"))

    def empty(self) -> bool:
        return bool(self._request("empty"))


class SharedDict(LocalSocketComm):
    """A dict owned by the agent, readable/writable from local processes."""

    def __init__(self, name: str, create: bool):
        self._dict: Optional[Dict[str, Any]] = {} if create else None
        self._dict_lock = threading.Lock() if create else None
        super().__init__(name, create)

    def _handle(self, method, args):
        with self._dict_lock:
            if method == "set":
                self._dict[args["key"]] = args["value"]
                return True
            if method == "get":
                return {"value": self._dict.get(args["key"])}
            if method == "update":
                self._dict.update(args["other"])
                return True
            if method == "dict":
                return dict(self._dict)
            if method == "pop":
                return {"value": self._dict.pop(args["key"], None)}
        raise ValueError(f"unknown dict method {method}")

    def set(self, key: str, value: Any):
        self._request("set", key=key, value=value)

    def get(self, key: str) -> Any:
        return self._request("get", key=key)["value"]

    def pop(self, key: str) -> Any:
        return self._request("pop", key=key)["value"]

    def update(self, other: Dict[str, Any]):
        self._request("update", other=other)

    def get_dict(self) -> Dict[str, Any]:
        return self._request("dict")


class SharedMemoryBuffer:
    """POSIX shared-memory segment carrying bulk checkpoint bytes.

    The agent (or the first writer) creates it; training processes attach by
    name.  Mirrors the reference's shm usage in ``ckpt_saver.py:164`` but
    holds raw numpy/jax host buffers instead of torch tensors.

    Segments are UNREGISTERED from Python's multiprocessing resource
    tracker: the tracker unlinks a dead process's segments seconds after it
    exits, which would destroy exactly the snapshot a crashed worker's
    restart needs.  Lifetime is owned by the framework (explicit
    ``unlink()`` on clean completion).
    """

    def __init__(self, name: str):
        self._name = name.replace("/", "_")
        self._shm: Optional[shared_memory.SharedMemory] = None

    @staticmethod
    def _untrack(shm: shared_memory.SharedMemory):
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
        except Exception:  # noqa: BLE001 - tracker internals vary
            pass

    @property
    def name(self) -> str:
        return self._name

    @property
    def shm(self) -> Optional[shared_memory.SharedMemory]:
        return self._shm

    @property
    def size(self) -> int:
        return self._shm.size if self._shm else 0

    def init(self, size: int) -> bool:
        """Create (or re-create bigger) the segment; returns True if fresh."""
        if self._shm is not None and self._shm.size >= size:
            return False
        if self._shm is not None:
            self.unlink()
        try:
            self._shm = shared_memory.SharedMemory(
                name=self._name, create=True, size=size
            )
            self._untrack(self._shm)
            return True
        except FileExistsError:
            existing = shared_memory.SharedMemory(name=self._name)
            self._untrack(existing)
            if existing.size >= size:
                self._shm = existing
                return False
            existing.close()
            existing.unlink()
            self._shm = shared_memory.SharedMemory(
                name=self._name, create=True, size=size
            )
            self._untrack(self._shm)
            return True

    def attach(self) -> bool:
        if self._shm is not None:
            return True
        try:
            self._shm = shared_memory.SharedMemory(name=self._name)
            self._untrack(self._shm)
            return True
        except FileNotFoundError:
            return False

    @property
    def buf(self):
        return self._shm.buf if self._shm else None

    def close(self):
        if self._shm is not None:
            try:
                self._shm.close()
            except (OSError, BufferError):
                pass
            self._shm = None

    def unlink(self):
        if self._shm is not None:
            shm = self._shm
            self._shm = None
            try:
                shm.close()
                # SharedMemory.unlink() unregisters the segment from the
                # resource tracker, which no longer tracks it (_untrack):
                # register it back first, or the tracker logs a KeyError
                from multiprocessing import resource_tracker

                resource_tracker.register(shm._name, "shared_memory")  # noqa: SLF001
                shm.unlink()
            except (OSError, FileNotFoundError, BufferError):
                pass


def clean_socket_dir():  # pragma: no cover - operational helper
    socket_dir = envs.get_str("DLROVER_TPU_SOCKET_DIR")
    try:
        for f in os.listdir(socket_dir):
            os.unlink(os.path.join(socket_dir, f))
    except OSError as e:
        logger.warning("failed to clean socket dir: %s", e)
