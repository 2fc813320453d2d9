"""Peer restore: a replaced process's snapshot is refilled from the shm of
the processes that survived, before storage is touched.

Port of ``dlrover_tpu/trainer/flash_checkpoint/peer_restore.py``.  When one
process dies, the committed step still sits in its peers' shm segments;
pulling the lost shards from there is bounded by the network, not by the
storage tier (the reference: "the difference between a sub-minute MTTR
and a multi-minute full restore").

* ``PeerServeEndpoint``: a threaded HTTP server next to a process's
  segment, serving the committed meta (``/peer/meta``), payload ranges
  (``/peer/shard?offset=&nbytes=&gen=``) and the entries of its compile
  cache (``/peer/cache_list``, ``/peer/cache?name=``).  Every 200 carries the seqlock
  generation (``X-Peer-Gen``) and a CRC32 (``X-Peer-Crc32``), the meta
  also the step (``X-Peer-Step``); a torn or moved generation is 409, no
  snapshot 404, a bad query 400, a failure 500.  The routes, queries,
  headers and codes are the reference's, so each package's client reads
  the other's server.  It binds the advertised host only
  (``DLROVER_TPU_PEER_BIND_HOST`` widens it).
* ``PeerRestorer``: donors in the broker's order, generations pinned at
  meta time, and the torn-read protocol: a torn response is retried once
  against the same peer, a second demotes that peer for the whole
  recovery; a transport or hard HTTP error demotes at once, and so does a
  donor holding another step.
* ``recover``: the ladder.  ``peer_shm`` fills every shard from peers;
  ``manifest`` fills the rest with ranged reads of the sealed commit
  (``distributed.read_manifest`` / ``manifest_leaf`` /
  ``read_slice_from``); ``storage`` gives up, commits nothing, and the
  engine's own storage restore runs.  The recovered segment is written
  through ``snapshot.write_snapshot`` in the donor meta's order, so it is
  byte-equal to the donor's.
* ``try_engine_recover``: the engine's hook when the memory agreement
  failed (``engine.py`` ``_load``).  A survivor whose shm holds the
  brokered step fetches nothing.
* ``prewarm_compile_cache``: a replacement pulls the compile-cache entries
  it lacks from the first healthy donor, each written to a temporary name
  and renamed.  The port's compile cache is the kernel build directory
  (``ops/cuda/_build.py``) and its entries are the ``lib<name>_<hash>.so``
  libraries: with them pulled, every build resolves as a hit and no nvcc
  runs.  ``recover`` prewarms its ``cache_dir`` under
  ``DLROVER_TPU_PEER_CACHE_PREWARM`` (``cache_prewarmed`` counts the
  entries pulled), and the worker bootstrap calls
  ``prewarm_from_context`` before it counts its cache.

The broker (``master/ckpt_coordinator.py`` ``PeerRestoreBroker``) lives in
the master, which outlives every worker; ``default_client`` takes the
master's client (its ``report_peer_announce``, ``get_peer_assignment`` and
``report_recovery``) when a master is configured.  Without one, its
stand-ins are ``LocalPeerClient`` (a broker in this process: one process,
the bench) and ``StorePeerClient`` (the world's c10d store).  The store client keeps
each announcement as a key of the store (``announce/<scope>/<process>``)
and each report as one more (``recovery/<n>``); an assignment is the
broker's rule applied to the keys found, by whichever process asks, so no
process holds the directory in its memory alone.  A replacement of
process 0 finds its donors wherever the store outlives process 0: a
``FileStore``, or a ``TCPStore`` served outside the workers (as an
elastic agent serves it); a ``TCPStore`` served by rank 0 itself dies with
it, and the replacement then finds no donor and restores from storage.

The chaos points ``peer.serve`` (a DROP answers 503, a TORN_WRITE flips
a byte of the body under its CRC header) and ``peer.fetch`` (a DROP is an
unreachable donor, a TORN_WRITE a corrupted receive) and the trace spans
``peer_restore.ladder``, ``peer_restore.manifest`` and
``peer_restore.prewarm`` (the goodput ledger charges them to
``peer_restore``) are the reference's.  A report filed through the
master's ``RecoveryReport`` route lands in its time-series store, whose
MTTR sentinel judges ``mttr_s`` against ``budget_s``
(``observability/sentinel.py``).
"""

import http.client
import json
import os
import threading
import time
import urllib.parse
import zlib
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as tdist

from dlrover_tpu_torch import chaos
from dlrover_tpu_torch.common import envs
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import SharedMemoryBuffer
from dlrover_tpu_torch.common.pytree import flatten_with_path
from dlrover_tpu_torch.master.ckpt_coordinator import PeerRestoreBroker
from dlrover_tpu_torch.observability import trace
from dlrover_tpu_torch.trainer.flash_checkpoint import distributed, snapshot

#: ladder rungs, strictest first (a report's ``rung`` is the deepest one
#: the recovery needed)
RUNG_PEER = "peer_shm"
RUNG_MANIFEST = "manifest"
RUNG_STORAGE = "storage"

#: the fields of the reference's ``comm.RecoveryReport``: what a client's
#: ``report_recovery`` files
RECOVERY_REPORT_KEYS = (
    "scope", "process_id", "step", "rung", "mttr_s", "peer_read_gbps",
    "bytes_peer", "bytes_manifest", "storage_reads", "torn_retries",
    "demoted_peers", "cache_prewarmed", "budget_s", "over_budget",
)


# ---------------------------------------------------------------------------
# Process-wide context: who serves and who brokers.  The engine (or a
# drill) registers them once; the engine hook and the saver read them.
# ---------------------------------------------------------------------------

_CTX: Dict[str, Any] = {
    "client": None,      # get_peer_assignment / report_* (a peer client)
    "serve": None,       # this process's PeerServeEndpoint (for announce)
    "cache_dir": "",     # the compile cache (kernel build dir) to prewarm
    "scope": "",
    "process_id": -1,
    "num_processes": 1,
}
_CTX_MU = threading.Lock()


def register_context(**kwargs: Any) -> None:
    """Install the pieces the recovery path needs (peer client, serve
    endpoint, cache dir, scope, identity).  Only the given keys are
    updated."""
    with _CTX_MU:
        for key, value in kwargs.items():
            if key not in _CTX:
                raise KeyError(f"unknown peer-restore context key {key!r}")
            _CTX[key] = value


def get_context() -> Dict[str, Any]:
    with _CTX_MU:
        return dict(_CTX)


def clear_context() -> None:
    with _CTX_MU:
        _CTX.update(client=None, serve=None, cache_dir="", scope="",
                    process_id=-1, num_processes=1)


def maybe_announce(step: int, scope: Optional[str] = None,
                   process_id: Optional[int] = None,
                   num_processes: Optional[int] = None) -> bool:
    """Advertise this process's committed shm step to the broker (a no-op
    unless both a client and a serve endpoint are registered)."""
    ctx = get_context()
    client, serve = ctx["client"], ctx["serve"]
    if client is None or serve is None:
        return False
    try:
        return bool(client.report_peer_announce(
            scope if scope is not None else ctx["scope"],
            int(step), serve.addr,
            num_processes=(ctx["num_processes"] if num_processes is None
                           else int(num_processes)),
            process_id=(ctx["process_id"] if process_id is None
                        else int(process_id)),
        ))
    except Exception as e:  # noqa: BLE001 - announce is best-effort
        logger.warning("peer announce for step %d failed: %s", step, e)
        return False


# ---------------------------------------------------------------------------
# The broker's transport.
# ---------------------------------------------------------------------------


@dataclass
class PeerAssignment:
    """The broker's verdict: donors (process id -> serve address) in the
    order to try, for ``step``."""

    step: int = -1
    donors: Dict[str, str] = field(default_factory=dict)


def _filed(report: Dict[str, Any]) -> Dict[str, Any]:
    return {k: report[k] for k in RECOVERY_REPORT_KEYS if k in report}


class LocalPeerClient:
    """The broker in this process (one process, the bench, tests that
    simulate hosts in one process)."""

    def __init__(self, broker: Optional[PeerRestoreBroker] = None,
                 process_id: int = 0):
        self.broker = broker or PeerRestoreBroker()
        self.process_id = int(process_id)

    def _pid(self, process_id: Optional[int]) -> int:
        return self.process_id if process_id is None else int(process_id)

    def report_peer_announce(self, scope: str, step: int, addr: str,
                             num_processes: int = 1,
                             process_id: Optional[int] = None) -> bool:
        return self.broker.announce(scope, self._pid(process_id),
                                    num_processes, step, addr)

    def get_peer_assignment(self, scope: str, step: int = -1,
                            group: Optional[List[int]] = None,
                            process_id: Optional[int] = None
                            ) -> PeerAssignment:
        verdict = self.broker.assign(scope, self._pid(process_id),
                                     step=step, group=group)
        return PeerAssignment(step=verdict["step"], donors=verdict["donors"])

    def report_recovery(self, report: Dict[str, Any]) -> bool:
        return self.broker.record_recovery(_filed(report))

    def recoveries(self) -> List[Dict]:
        return self.broker.recoveries()


class StorePeerClient:
    """The broker over a ``torch.distributed`` world's c10d store (module
    docstring): announcements and reports are keys of the store, and an
    assignment is ``PeerRestoreBroker.assign`` over the announcements
    found.  Nothing here is a collective of the training group."""

    PREFIX = "dlrover_tpu_peer_restore/"

    def __init__(self, store, process_id: int, num_processes: int):
        self.store = tdist.PrefixStore(self.PREFIX, store)
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)

    def _pid(self, process_id: Optional[int]) -> int:
        return self.process_id if process_id is None else int(process_id)

    def _get(self, key: str) -> Optional[Dict]:
        # an announcement's key is deleted when its process is evicted
        value = distributed.store_read(self.store, key)
        return None if value is None else json.loads(value)

    def report_peer_announce(self, scope: str, step: int, addr: str,
                             num_processes: int = 1,
                             process_id: Optional[int] = None) -> bool:
        self.store.set(f"announce/{scope}/{self._pid(process_id)}",
                       json.dumps({"step": int(step), "addr": addr,
                                   "num_processes": int(num_processes)}))
        return True

    def broker(self, scope: str) -> PeerRestoreBroker:
        """A broker holding every announcement of ``scope`` in the
        store, one key per process of the world."""
        broker = PeerRestoreBroker()
        for pid in range(self.num_processes):
            entry = self._get(f"announce/{scope}/{pid}")
            if entry is not None:
                broker.announce(scope, pid, entry["num_processes"],
                                entry["step"], entry["addr"])
        return broker

    def get_peer_assignment(self, scope: str, step: int = -1,
                            group: Optional[List[int]] = None,
                            process_id: Optional[int] = None
                            ) -> PeerAssignment:
        verdict = self.broker(scope).assign(
            scope, self._pid(process_id), step=step, group=group)
        return PeerAssignment(step=verdict["step"], donors=verdict["donors"])

    def report_recovery(self, report: Dict[str, Any]) -> bool:
        n = int(self.store.add("recovery_seq", 1)) - 1
        self.store.set(f"recovery/{n}", json.dumps(_filed(report)))
        return True

    def recoveries(self) -> List[Dict]:
        """The last ``PeerRestoreBroker.MAX_RECOVERIES`` reports."""
        count = int(self.store.add("recovery_seq", 0))
        first = max(0, count - PeerRestoreBroker.MAX_RECOVERIES)
        got = (self._get(f"recovery/{n}") for n in range(first, count))
        return [r for r in got if r is not None]

    def evict(self, scope: str, process_id: int) -> None:
        self.store.delete_key(f"announce/{scope}/{int(process_id)}")


_local_client: Optional[LocalPeerClient] = None
_store_client: Optional[Tuple[Any, StorePeerClient]] = None
_client_mu = threading.Lock()


def default_client(num_processes: int = 1):
    """The peer client of this process, picked as the commit path is
    (``distributed.get_commit_client``): the master's broker (the
    ``MasterClient``'s ``report_peer_announce``, ``get_peer_assignment``
    and ``report_recovery``) when a master is configured; else the store
    client of the ``torch.distributed`` world when one of more than one
    rank is initialised (one per world); else a process-local broker.
    Several processes with neither a master nor a world raise: a private
    broker would never see the other processes' announcements."""
    global _local_client, _store_client
    mc = distributed.master_client()
    if mc is not None:
        return mc
    if tdist.is_available() and tdist.is_initialized():
        rank, size = tdist.get_rank(), tdist.get_world_size()
    else:
        rank, size = 0, 1
    if size <= 1 and int(num_processes) > 1:
        raise NotImplementedError(
            f"peer restore across {int(num_processes)} processes with no "
            "master and no torch.distributed world: no broker could see "
            "the other processes' announcements (configure the master's "
            "address, DLROVER_TPU_MASTER_ADDR, or initialise the world)")
    with _client_mu:
        if size > 1:
            group = tdist.distributed_c10d._get_default_group()
            if _store_client is None or _store_client[0] is not group:
                store = tdist.distributed_c10d._get_default_store()
                _store_client = (group, StorePeerClient(store, rank, size))
            return _store_client[1]
        if _local_client is None:
            _local_client = LocalPeerClient()
        return _local_client


# ---------------------------------------------------------------------------
# Serve side.
# ---------------------------------------------------------------------------


class PeerServeEndpoint:
    """Serves this process's committed shm snapshot and its compile cache
    (``cache_dir``, the kernel build directory) over HTTP.  Requests
    attach the segment by its well-known name, so the endpoint needs no
    handle on the engine."""

    def __init__(self, process_id: int, scope: str = "",
                 cache_dir: str = "", port: Optional[int] = None,
                 advertise_host: str = "127.0.0.1",
                 bind_host: Optional[str] = None):
        self.process_id = int(process_id)
        self.scope = scope
        self.cache_dir = str(cache_dir)
        if port is None:
            port = envs.get_int("DLROVER_TPU_PEER_SERVE_PORT")
        # the endpoint serves the whole training state with no auth: it
        # listens only where peers reach it, unless widened explicitly
        if bind_host is None:
            bind_host = (envs.get_str("DLROVER_TPU_PEER_BIND_HOST")
                         or advertise_host)
        self._httpd = ThreadingHTTPServer((bind_host, port),
                                          _handler_for(self))
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._advertise_host = advertise_host
        self._thread: Optional[threading.Thread] = None

    @property
    def addr(self) -> str:
        return f"{self._advertise_host}:{self.port}"

    def start(self) -> "PeerServeEndpoint":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"peer-serve-{self.process_id}", daemon=True)
        self._thread.start()
        logger.info("peer serve endpoint up: pid=%d scope=%s addr=%s",
                    self.process_id, self.scope or "<default>", self.addr)
        return self

    def stop(self) -> None:
        try:
            if self._thread is not None:
                # waits for serve_forever to return: only once started
                self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 - teardown is best-effort
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- request handling --------------------------------------------------

    def _shm(self) -> SharedMemoryBuffer:
        from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
            shm_name,
        )

        return SharedMemoryBuffer(shm_name(self.process_id, self.scope))

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urllib.parse.urlparse(req.path)
        route = parsed.path
        params = {k: v[0] for k, v in
                  urllib.parse.parse_qs(parsed.query).items()}
        fault = chaos.point("peer.serve", route=route)
        if fault is not None and fault.kind == chaos.DROP:
            _respond(req, 503, body=b'{"error": "unavailable"}')
            return
        torn_body = fault is not None and fault.kind == chaos.TORN_WRITE
        try:
            if route == "/peer/meta":
                self._serve_meta(req, torn_body)
            elif route == "/peer/shard":
                self._serve_shard(req, params, torn_body)
            elif route == "/peer/cache_list":
                self._serve_cache_list(req)
            elif route == "/peer/cache":
                self._serve_cache(req, params, torn_body)
            else:
                _respond(req, 404, body=b'{"error": "no such route"}')
        except Exception as e:  # noqa: BLE001 - a bad request must not
            # kill the serve thread another fetcher depends on
            logger.warning("peer serve %s failed: %s", route, e)
            try:
                _respond(req, 500, body=b'{"error": "internal"}')
            except Exception:  # noqa: BLE001
                pass

    def _serve_meta(self, req, torn_body: bool) -> None:
        shm = self._shm()
        try:
            gen = snapshot.read_generation(shm)
            if gen is None:
                _respond(req, 404, body=b'{"error": "no snapshot"}')
                return
            if gen % 2 == 1:
                _respond(req, 409, body=b'{"torn": true}')
                return
            meta_bytes = snapshot.read_meta_bytes(shm)
            # re-check: a writer may have begun a rewrite mid-copy
            if meta_bytes is None or snapshot.read_generation(shm) != gen:
                _respond(req, 409, body=b'{"torn": true}')
                return
            try:
                step = int(json.loads(meta_bytes).get("step", -1))
            except ValueError:
                step = -1
            _respond(req, 200, headers={
                "X-Peer-Gen": str(gen),
                "X-Peer-Step": str(step),
                "X-Peer-Crc32": str(zlib.crc32(meta_bytes)),
            }, body=_maybe_tear(meta_bytes, torn_body))
        finally:
            shm.close()

    def _serve_shard(self, req, params: Dict[str, str],
                     torn_body: bool) -> None:
        offset = int(params.get("offset", -1))
        nbytes = int(params.get("nbytes", -1))
        want_gen = int(params.get("gen", -1))
        if offset < 0 or nbytes < 0:
            _respond(req, 400, body=b'{"error": "offset/nbytes required"}')
            return
        shm = self._shm()
        try:
            gen = snapshot.read_generation(shm)
            if gen is None:
                _respond(req, 404, body=b'{"error": "no snapshot"}')
                return
            # the fetcher pinned a generation at meta time: a moved one is
            # another step, and mixing steps breaks the byte equality
            if gen % 2 == 1 or (want_gen >= 0 and gen != want_gen):
                _respond(req, 409, body=b'{"torn": true}')
                return
            payload = snapshot.read_payload_range(shm, offset, nbytes)
            if payload is None or snapshot.read_generation(shm) != gen:
                _respond(req, 409, body=b'{"torn": true}')
                return
            _respond(req, 200, headers={
                "X-Peer-Gen": str(gen),
                "X-Peer-Crc32": str(zlib.crc32(payload)),
            }, body=_maybe_tear(payload, torn_body))
        finally:
            shm.close()


    def _serve_cache_list(self, req) -> None:
        entries = []
        if self.cache_dir and os.path.isdir(self.cache_dir):
            for root, _dirs, files in os.walk(self.cache_dir):
                for name in files:
                    full = os.path.join(root, name)
                    rel = os.path.relpath(full, self.cache_dir)
                    try:
                        entries.append({"name": rel,
                                        "nbytes": os.path.getsize(full)})
                    except OSError:
                        continue
        body = json.dumps({"entries": entries}).encode("utf-8")
        _respond(req, 200, headers={"X-Peer-Crc32": str(zlib.crc32(body))},
                 body=body)

    def _serve_cache(self, req, params: Dict[str, str],
                     torn_body: bool) -> None:
        name = params.get("name", "")
        rel = os.path.normpath(name)
        if not name or rel.startswith("..") or os.path.isabs(rel):
            _respond(req, 400, body=b'{"error": "bad cache entry name"}')
            return
        full = os.path.join(self.cache_dir, rel)
        if not self.cache_dir or not os.path.isfile(full):
            _respond(req, 404, body=b'{"error": "no such entry"}')
            return
        with open(full, "rb") as f:
            payload = f.read()
        _respond(req, 200, headers={"X-Peer-Crc32": str(zlib.crc32(payload))},
                 body=_maybe_tear(payload, torn_body))


def _handler_for(endpoint: PeerServeEndpoint):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # noqa: A003 - no per-request logs
            pass

        def do_GET(self):  # noqa: N802 - http.server API
            endpoint._handle(self)

    return Handler


def _respond(req, status: int, headers: Optional[Dict[str, str]] = None,
             body: bytes = b"") -> None:
    req.send_response(status)
    for key, value in (headers or {}).items():
        req.send_header(key, value)
    req.send_header("Content-Length", str(len(body)))
    req.end_headers()
    if body:
        req.wfile.write(body)


# ---------------------------------------------------------------------------
# Fetch side.
# ---------------------------------------------------------------------------


def _maybe_tear(payload: bytes, torn: bool) -> bytes:
    """Apply a torn_write chaos fault: flip a byte so the advertised
    crc32 no longer matches — exactly what a racing rewrite looks like
    from the fetcher's side."""
    if not torn or not payload:
        return payload
    corrupted = bytearray(payload)
    corrupted[len(corrupted) // 2] ^= 0xFF
    return bytes(corrupted)


def _http_fetch(addr: str, route: str, params: Dict[str, Any],
                timeout_s: float) -> Tuple[int, Dict[str, str], bytes]:
    """One GET against a peer endpoint: ``(status, lower-cased headers,
    body)``, with the ``peer.fetch`` chaos point woven in (drop ->
    unreachable, torn_write -> corrupted receive, delay handled by the
    engine)."""
    fault = chaos.point("peer.fetch", route=route, addr=addr)
    if fault is not None and fault.kind == chaos.DROP:
        raise OSError(f"chaos: peer fetch dropped ({addr}{route})")
    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
    try:
        query = urllib.parse.urlencode(
            {k: v for k, v in params.items() if v is not None})
        conn.request("GET", f"{route}?{query}" if query else route)
        resp = conn.getresponse()
        body = resp.read()
        headers = {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()
    if fault is not None and fault.kind == chaos.TORN_WRITE:
        body = _maybe_tear(body, True)
    return resp.status, headers, body


def _crc_ok(headers: Dict[str, str], body: bytes) -> bool:
    """The endpoint sends ``X-Peer-Crc32`` on every 200: a missing or
    unparseable one means the response was mangled, which counts as torn,
    never as validated."""
    try:
        want = int(headers.get("x-peer-crc32", ""))
    except ValueError:
        return False
    return zlib.crc32(body) == want


class PeerRestorer:
    """Donor-ordered fetching with the torn-read protocol and per-rung
    byte accounting.  One per recovery: a demotion lasts the recovery."""

    def __init__(self, donors: List[Tuple[int, str]],
                 timeout_s: Optional[float] = None,
                 chunk_bytes: Optional[int] = None,
                 step: int = -1):
        #: the broker's order (replica-group members first) is kept
        self.donors = [(int(pid), addr) for pid, addr in donors]
        #: the recovery's step: a donor whose committed snapshot is on any
        #: other step is demoted at meta time (an announcement may be
        #: stale, and its crc-valid bytes would be another step's).  -1
        #: disables the check
        self.step = int(step)
        self.timeout_s = (envs.get_float("DLROVER_TPU_PEER_FETCH_TIMEOUT_S")
                          if timeout_s is None else float(timeout_s))
        self.chunk_bytes = max(1, int(
            envs.get_int("DLROVER_TPU_PEER_FETCH_CHUNK_BYTES")
            if chunk_bytes is None else chunk_bytes))
        self.demoted: List[int] = []
        self.torn_retries = 0
        self.bytes_peer = 0
        self._metas: Dict[int, Tuple[int, Dict]] = {}  # pid -> (gen, meta)

    def healthy_donors(self) -> List[Tuple[int, str]]:
        return [(p, a) for p, a in self.donors if p not in self.demoted]

    def _demote(self, pid: int, why: str) -> None:
        if pid not in self.demoted:
            self.demoted.append(pid)
            logger.warning("peer restore: demoting donor %d for this "
                           "recovery (%s)", pid, why)

    def _request(self, pid: int, addr: str, route: str,
                 params: Dict[str, Any],
                 ) -> Optional[Tuple[Dict[str, str], bytes]]:
        """GET with the torn protocol: a torn response (409, or a body
        failing its crc) is retried once against the same peer (the
        seqlock writer may have been mid-commit); a second demotes the
        peer.  A transport failure or a hard error demotes at once."""
        if pid in self.demoted:
            return None
        for attempt in range(2):
            try:
                status, headers, body = _http_fetch(addr, route, params,
                                                    self.timeout_s)
            except (OSError, http.client.HTTPException) as e:
                self._demote(pid, f"unreachable: {e}")
                return None
            if status == 200 and _crc_ok(headers, body):
                return headers, body
            if status not in (200, 409):
                self._demote(pid, f"http {status} on {route}")
                return None
            if attempt == 0:
                self.torn_retries += 1
                continue
            self._demote(pid, f"torn twice on {route}")
        return None

    def donor_meta(self, pid: int, addr: str) -> Optional[Tuple[int, Dict]]:
        """``(generation, meta)`` of a donor, fetched once and pinned:
        every shard read re-asserts the generation.  A donor on another
        step than the recovery's is demoted here, before any of its bytes
        are used."""
        if pid in self._metas:
            return self._metas[pid]
        got = self._request(pid, addr, "/peer/meta", {})
        if got is None:
            return None
        headers, body = got
        try:
            gen = int(headers.get("x-peer-gen", "-1"))
            meta = json.loads(body)
        except ValueError:
            self._demote(pid, "unparseable meta")
            return None
        donor_step = int(meta.get("step", -1))
        if self.step >= 0 and donor_step != self.step:
            self._demote(pid, f"wrong step: holds {donor_step}, want "
                              f"{self.step}")
            return None
        self._metas[pid] = (gen, meta)
        return gen, meta

    def fetch_range(self, pid: int, addr: str, gen: int, offset: int,
                    nbytes: int) -> Optional[bytes]:
        """``nbytes`` of a donor's committed payload from the
        payload-relative ``offset``, in requests of ``chunk_bytes``."""
        parts: List[bytes] = []
        done = 0
        while done < nbytes:
            take = min(self.chunk_bytes, nbytes - done)
            got = self._request(pid, addr, "/peer/shard",
                                {"offset": offset + done, "nbytes": take,
                                 "gen": gen})
            if got is None:
                return None
            body = got[1]
            if len(body) != take:
                self._demote(pid, f"short read {len(body)}/{take}")
                return None
            parts.append(body)
            done += take
        self.bytes_peer += nbytes
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def fetch_shard(self, path: str, index: List[List[int]],
                    nbytes: int) -> Optional[np.ndarray]:
        """One shard's bytes (a ``uint8`` array) from the first healthy
        donor holding exactly ``(path, index)``; None when no donor can
        serve it (the ladder then takes the manifest rung for it)."""
        want = [[int(a), int(b)] for a, b in index]
        for pid, addr in self.healthy_donors():
            got = self.donor_meta(pid, addr)
            if got is None:
                continue
            gen, meta = got
            rec = _find_shard(meta, path, want)
            if rec is None:
                continue
            if int(rec["nbytes"]) != int(nbytes):
                self._demote(pid, f"shard size mismatch for {path}")
                continue
            raw = self.fetch_range(pid, addr, gen, int(rec["offset"]),
                                   int(nbytes))
            if raw is not None:
                return np.frombuffer(raw, dtype=np.uint8)
        return None


def _find_shard(meta: Dict, path: str,
                index: List[List[int]]) -> Optional[Dict]:
    for leaf in meta.get("leaves", []):
        if leaf.get("path") != path:
            continue
        for rec in leaf.get("shards", []):
            if [[int(a), int(b)] for a, b in rec["index"]] == index:
                return rec
    return None


# ---------------------------------------------------------------------------
# Compile-cache prewarm.
# ---------------------------------------------------------------------------


def _no_prewarm() -> Dict[str, Any]:
    return {"fetched": 0, "present": 0, "donor": -1, "bytes": 0}


def prewarm_compile_cache(
    cache_dir: str, donors: List[Tuple[int, str]],
    restorer: Optional[PeerRestorer] = None,
) -> Dict[str, Any]:
    """Pull the compile-cache entries this process lacks from the first
    healthy donor, before the bootstrap counts the cache, so a recovery
    never trips the ``cache_cold`` sentinel or pays an nvcc run the job
    already paid.  Entries land atomically (a temporary name, then a
    rename): a concurrent build never reads a torn library.  Returns
    ``{fetched, present, donor, bytes}``."""
    out = _no_prewarm()
    if not cache_dir:
        return out
    restorer = restorer or PeerRestorer(donors)
    have = set()
    if os.path.isdir(cache_dir):
        for root, _dirs, files in os.walk(cache_dir):
            for name in files:
                have.add(os.path.relpath(os.path.join(root, name), cache_dir))
    out["present"] = len(have)
    for pid, addr in restorer.healthy_donors():
        got = restorer._request(pid, addr, "/peer/cache_list", {})
        if got is None:
            continue
        try:
            entries = json.loads(got[1]).get("entries", [])
        except ValueError:
            continue
        out["donor"] = pid
        cache_root = os.path.abspath(cache_dir)
        for entry in entries:
            name = entry.get("name", "")
            if not name or name in have:
                continue
            # the listing is the donor's: the serve side's name check again,
            # so a peer cannot steer the write outside cache_dir
            rel = os.path.normpath(name)
            full = os.path.join(cache_dir, rel)
            if (rel.startswith("..") or os.path.isabs(rel)
                    or not os.path.abspath(full).startswith(
                        cache_root + os.sep)):
                logger.warning("cache prewarm: rejecting entry name %r "
                               "from donor %d", name, pid)
                continue
            fetched = restorer._request(pid, addr, "/peer/cache",
                                        {"name": name})
            if fetched is None:
                break  # the donor was demoted mid-walk: report partial
            payload = fetched[1]
            os.makedirs(os.path.dirname(full) or cache_dir, exist_ok=True)
            tmp = f"{full}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, full)
            out["fetched"] += 1
            out["bytes"] += len(payload)
        if out["donor"] >= 0:
            break  # one donor's listing is the job's listing
    return out


def prewarm_from_context(cache_dir: str) -> Dict[str, Any]:
    """The bootstrap's hook: ask the broker for donors and prewarm
    ``cache_dir`` from them.  A no-op without a registered peer client:
    a boot without peer restore pays nothing."""
    ctx = get_context()
    client = ctx["client"]
    if client is None or not cache_dir:
        return _no_prewarm()
    try:
        assignment = client.get_peer_assignment(
            ctx["scope"], step=-1, process_id=ctx["process_id"])
        donors = [(int(pid), addr)
                  for pid, addr in (assignment.donors or {}).items()]
        if not donors:
            return _no_prewarm()
        with trace.span("peer_restore.prewarm"):
            return prewarm_compile_cache(cache_dir, donors)
    except Exception as e:  # noqa: BLE001 - prewarm must never block boot
        logger.warning("compile-cache prewarm skipped: %s", e)
        return _no_prewarm()


# ---------------------------------------------------------------------------
# The ladder.
# ---------------------------------------------------------------------------


def recover(
    *,
    scope: str,
    process_id: int,
    num_processes: int,
    shm: SharedMemoryBuffer,
    checkpoint_dir: str,
    assignment: Dict[str, Any],
    plan: Optional[List[Dict]] = None,
    storage=None,
    cache_dir: str = "",
    client=None,
    budget_s: Optional[float] = None,
    clock: Callable[[], float] = time.monotonic,
) -> Dict[str, Any]:
    """Run the ladder and commit the recovered snapshot into ``shm``;
    returns the recovery report (also filed with ``client`` when given).

    ``assignment``: ``{"step": int, "donors": {pid: addr}}`` from the
    broker.  ``plan``: the shards to recover, a snapshot meta's leaves
    list (``{path, dtype, gshape, shards: [{index, nbytes, shape}]}``);
    None takes the first healthy donor's meta (a replacement on the same
    mesh needs what its donors hold).

    Per shard: peer shm, then the sealed manifest's ranged reads.  A
    recovery that cannot fill every shard commits nothing (the segment
    stays as it was) and reports rung ``storage``.  Then, under
    ``DLROVER_TPU_PEER_CACHE_PREWARM``, the compile-cache entries
    ``cache_dir`` lacks are pulled from the donors
    (``cache_prewarmed``).  ``clock`` times ``mttr_s``."""
    t0 = clock()
    if budget_s is None:
        budget_s = envs.get_float("DLROVER_TPU_MTTR_BUDGET_S")
    step = int(assignment.get("step", -1))
    donors = [(int(pid), addr)
              for pid, addr in (assignment.get("donors") or {}).items()]
    restorer = PeerRestorer(donors, step=step)
    filled = False
    rung = RUNG_STORAGE
    bytes_manifest = 0
    storage_reads = 0
    peer_s = 0.0
    with trace.span("peer_restore.ladder"):
        template_extras: Dict = {}
        if plan is None and step >= 0:
            # donor_meta demotes wrong-step donors, so the first meta that
            # survives is a plan of the right step
            for pid, addr in restorer.healthy_donors():
                got = restorer.donor_meta(pid, addr)
                if got is None:
                    continue
                plan = got[1].get("leaves", [])
                template_extras = got[1].get("extras", {}) or {}
                break
        if plan and step >= 0:
            peer_t0 = clock()
            leaves, missing = _fill_from_peers(restorer, plan)
            peer_s = clock() - peer_t0
            if missing:
                logger.info("peer restore: %d shard(s) need the manifest "
                            "rung", len(missing))
                with trace.span("peer_restore.manifest"):
                    extras2, reads = _fill_from_manifest(
                        checkpoint_dir, step, process_id, num_processes,
                        storage, missing)
                bytes_manifest = reads.get("bytes_read", 0)
                storage_reads = reads.get("shards_fetched", 0)
                if extras2 is not None:
                    template_extras = template_extras or extras2
                    missing = [s for s in missing if s.get("data") is None]
            if not missing and all(s.get("data") is not None
                                   for leaf in leaves
                                   for s in leaf["shards"]):
                snapshot.write_snapshot(shm, step, leaves, template_extras)
                filled = True
                rung = RUNG_MANIFEST if storage_reads else RUNG_PEER
    prewarm = _no_prewarm()
    if cache_dir and envs.get_bool("DLROVER_TPU_PEER_CACHE_PREWARM"):
        with trace.span("peer_restore.prewarm"):
            prewarm = prewarm_compile_cache(cache_dir, donors,
                                            restorer=restorer)
    mttr_s = clock() - t0
    gbps = restorer.bytes_peer * 8.0 / peer_s / 1e9 if peer_s > 0 else 0.0
    report = {
        "scope": scope,
        "process_id": int(process_id),
        "step": step if filled else -1,
        "rung": rung,
        "mttr_s": round(mttr_s, 6),
        "peer_read_gbps": round(gbps, 6),
        "bytes_peer": int(restorer.bytes_peer),
        "bytes_manifest": int(bytes_manifest),
        "storage_reads": int(storage_reads),
        "torn_retries": int(restorer.torn_retries),
        "demoted_peers": list(restorer.demoted),
        "cache_prewarmed": int(prewarm.get("fetched", 0)),
        "budget_s": float(budget_s),
        "over_budget": bool(budget_s > 0 and mttr_s > budget_s),
        "filled": filled,
    }
    logger.info("peer restore: rung=%s step=%d mttr=%.3fs peer=%dB "
                "manifest=%dB torn_retries=%d demoted=%s", rung,
                report["step"], mttr_s, report["bytes_peer"],
                bytes_manifest, report["torn_retries"], restorer.demoted)
    if client is not None:
        try:
            client.report_recovery(report)
        except Exception as e:  # noqa: BLE001 - the report is telemetry:
            # losing it must not fail a recovery that restored the state
            logger.warning("recovery report not delivered: %s", e)
    return report


def _fill_from_peers(restorer: PeerRestorer, plan: List[Dict]
                     ) -> Tuple[List[Dict], List[Dict]]:
    """Fetch every planned shard from peer shm.  Returns ``(leaves,
    missing)``: the plan's leaves with each shard's ``data`` (a CPU tensor
    of the leaf's dtype, or None), and the shards no donor served, each
    pointing at its slot for the next rung."""
    leaves: List[Dict] = []
    missing: List[Dict] = []
    for leaf in plan:
        itemsize = snapshot.torch_dtype(leaf["dtype"]).itemsize
        out_shards = []
        for rec in leaf["shards"]:
            shape = [int(d) for d in rec.get(
                "shape", [b - a for a, b in rec["index"]])]
            nbytes = int(rec.get("nbytes", int(np.prod(shape)) * itemsize))
            raw = restorer.fetch_shard(leaf["path"], rec["index"], nbytes)
            shard = {
                "index": [[int(a), int(b)] for a, b in rec["index"]],
                "data": (None if raw is None else
                         snapshot.tensor_from_bytes(raw, leaf["dtype"],
                                                    shape)),
            }
            out_shards.append(shard)
            if raw is None:
                missing.append({
                    "path": leaf["path"], "dtype": leaf["dtype"],
                    "gshape": leaf["gshape"], "shape": shape,
                    "nbytes": nbytes, "index": shard["index"],
                    "_slot": shard, "data": None,
                })
        leaves.append({"path": leaf["path"], "dtype": leaf["dtype"],
                       "gshape": [int(d) for d in leaf["gshape"]],
                       "shards": out_shards})
    return leaves, missing


def _fill_from_manifest(
    checkpoint_dir: str, step: int, process_id: int, num_processes: int,
    storage, missing: List[Dict],
) -> Tuple[Optional[Dict], Dict[str, int]]:
    """The second rung: ranged reads of the sealed manifest for the shards
    no peer served.  Fills each missing entry's slot in place; returns
    ``(manifest extras, read stats)``, or ``(None, {})`` when no sealed
    manifest exists for the step."""
    manifest = distributed.read_manifest(checkpoint_dir, step, storage)
    if manifest is None:
        return None, {}
    engine = distributed.DistributedCheckpointEngine(
        checkpoint_dir, process_id, num_processes, storage=storage)
    stats = {"bytes_read": 0, "shards_fetched": 0}
    for rec in missing:
        leaf = distributed.manifest_leaf(manifest, rec["path"])
        if leaf is None:
            continue
        target = tuple(slice(int(a), int(b)) for a, b in rec["index"])
        try:
            arr = engine.read_slice_from(leaf, target, stats)
        except (OSError, ValueError) as e:
            logger.warning("manifest rung: %s %s unreadable: %s",
                           rec["path"], rec["index"], e)
            continue
        filled = arr.reshape(rec["shape"]).contiguous()
        rec["data"] = filled
        rec["_slot"]["data"] = filled
    return manifest.get("extras", {}) or {}, stats


# ---------------------------------------------------------------------------
# Engine hook.
# ---------------------------------------------------------------------------


def _replica_group(target, layouts, pid: int, nprocs: int) -> List[int]:
    """Sorted process ids (the requester excluded) holding a byte-identical
    copy of at least one of this process's shards: the processes whose box
    of a leaf is this process's box of it, from every rank's layout
    (``Checkpointer`` gathers them as ``Trainer.state_layout(state,
    rank=r)``), where the reference reads the shardings'
    ``devices_indices_map``.  A leaf no layout names is whole on every
    process.  The broker lists these donors first.  Every other process
    when there are no layouts."""
    everyone = [p for p in range(nprocs) if p != pid]
    if target is None or layouts is None or len(layouts) != nprocs:
        return everyone
    members: set = set()
    for path, leaf in flatten_with_path(target):
        local = [int(d) for d in getattr(leaf, "shape", ())]
        holders: Dict[Tuple, set] = {}
        for rank, layout in enumerate(layouts):
            if path in layout:
                box = tuple(tuple(int(v) for v in span)
                            for span in layout[path][1])
            else:
                box = tuple((0, d) for d in local)
            holders.setdefault(box, set()).add(rank)
        for procs in holders.values():
            if pid in procs:
                members.update(procs)
    members.discard(pid)
    return sorted(members) if members else everyone


def try_engine_recover(engine, target=None, layouts=None) -> bool:
    """The engine's restore hook when the memory agreement failed: ask the
    broker for donors and run the ladder into the engine's own segment,
    holding its buffer lock.  True when a snapshot was committed (the
    engine then agrees on its memory candidate again).  A survivor whose
    segment already holds the brokered step fetches nothing.  The report
    is kept as ``engine.last_recovery``."""
    ctx = get_context()
    client = ctx.get("client")
    if client is None:
        return False
    pid = int(engine.process_id)
    nprocs = int(engine.num_processes)
    group = _replica_group(target, layouts, pid, nprocs)
    try:
        assignment = client.get_peer_assignment(
            engine._scope, step=-1, group=group, process_id=pid)
    except Exception as e:  # noqa: BLE001 - no broker, no fast path
        logger.warning("peer assignment unavailable: %s", e)
        return False
    if assignment.step < 0 or not assignment.donors:
        return False
    meta = snapshot.read_snapshot_meta(engine._shm)
    if meta is not None and int(meta.get("step", -1)) == assignment.step:
        return False  # a survivor: the segment already holds the step
    with engine._buffer_write_lock(60) as held:
        if not held:
            logger.warning("peer restore skipped: could not acquire the "
                           "ckpt buffer")
            return False
        report = recover(
            scope=engine._scope, process_id=pid, num_processes=nprocs,
            shm=engine._shm, checkpoint_dir=engine.checkpoint_dir,
            assignment={"step": int(assignment.step),
                        "donors": dict(assignment.donors)},
            storage=engine._storage, cache_dir=ctx.get("cache_dir", ""),
            client=client)
    engine.last_recovery = report
    return bool(report.get("filled"))


def engine_context(engine) -> Optional[PeerServeEndpoint]:
    """Register what the engine's peer restore needs where nothing is
    registered yet: the default peer client (``default_client``), the
    compile cache (the bootstrap's kernel build directory), a serve
    endpoint of the engine's segment and of that cache, and its scope and
    identity.  Returns the endpoint it started (the engine stops it at
    close), or None."""
    ctx = get_context()
    updates: Dict[str, Any] = dict(scope=engine._scope,
                                   process_id=engine.process_id,
                                   num_processes=engine.num_processes)
    if ctx["client"] is None:
        updates["client"] = default_client(engine.num_processes)
    cache_dir = ctx["cache_dir"]
    if not cache_dir:
        from dlrover_tpu_torch.trainer import bootstrap

        info = bootstrap.compile_cache_info()
        cache_dir = info["dir"] if info.get("enabled") else ""
        updates["cache_dir"] = cache_dir
    own = None
    if ctx["serve"] is None:
        own = PeerServeEndpoint(engine.process_id, scope=engine._scope,
                                cache_dir=cache_dir).start()
        updates["serve"] = own
    register_context(**updates)
    return own


def release_endpoint(endpoint: Optional[PeerServeEndpoint]) -> None:
    """Stop an endpoint ``engine_context`` started, and unregister it."""
    if endpoint is None:
        return
    endpoint.stop()
    with _CTX_MU:
        if _CTX["serve"] is endpoint:
            _CTX["serve"] = None
