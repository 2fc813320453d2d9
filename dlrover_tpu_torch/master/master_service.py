"""Master service transports: gRPC (default) and HTTP (fallback).

Copy of ``dlrover_tpu/master/master_service.py``, the counterpart of
DLRover's ``servicer.py:1074`` (gRPC) / ``:1121`` (Tornado HTTP) +
``dlrover/proto/elastic_training.proto:25-29``.  The service shape is two
unary methods over an opaque envelope, registered as a gRPC *generic*
handler over raw bytes (the envelope is already self-describing JSON), so
no generated stubs are needed and the wire stays protobuf-version-proof.
The service name and the HTTP routes are the reference's, so agents of
either package reach a master of either.

What differs from the copy: ``grpc`` is imported inside
``GrpcMasterServer``, as the client does, so an HTTP master needs no
``grpcio``; a gRPC master asked for without it raises ``ImportError``
(never a quiet switch to HTTP).
"""

import threading
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from dlrover_tpu_torch.common.comm import Message
from dlrover_tpu_torch.common.constants import GRPC_MAX_MESSAGE_LENGTH
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.servicer import MasterServicer

# the gRPC service name on the wire (a protocol name, not a module path)
SERVICE_NAME = "dlrover_tpu.Master"


def _identity(x: bytes) -> bytes:
    return x


def grpc_pool_size() -> int:
    """Worker-pool size for the gRPC transport.  Each long-poll occupies
    one pool thread for up to its chunk; the admission controller's wait
    pool is the logical cap and this is the physical one — the physical
    cap must sit ABOVE the logical ones, or blocked waiters starve fast
    RPCs of a thread before admission control ever runs."""
    from dlrover_tpu_torch.common import envs

    size = envs.get_int("DLROVER_TPU_MASTER_GRPC_WORKERS")
    if size > 0:
        return size
    # a cap of 0 means "unlimited" — no finite pool can sit above that,
    # so size for the registered default instead and the pool becomes
    # the de facto physical cap for the uncapped class
    waiters = envs.get_int("DLROVER_TPU_SERVICER_MAX_WAITERS")
    if waiters <= 0:
        waiters = int(envs.DEFAULTS["DLROVER_TPU_SERVICER_MAX_WAITERS"])
    inflight = envs.get_int("DLROVER_TPU_SERVICER_MAX_INFLIGHT")
    if inflight <= 0:
        inflight = int(envs.DEFAULTS["DLROVER_TPU_SERVICER_MAX_INFLIGHT"])
    return max(64, waiters + inflight + 16)


class GrpcMasterServer:
    def __init__(self, port: int, servicer: MasterServicer,
                 max_workers: Optional[int] = None):
        import grpc

        if max_workers is None:
            max_workers = grpc_pool_size()
        self._servicer = servicer
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[
                ("grpc.max_send_message_length", GRPC_MAX_MESSAGE_LENGTH),
                ("grpc.max_receive_message_length", GRPC_MAX_MESSAGE_LENGTH),
            ],
        )
        handlers = {
            "report": grpc.unary_unary_rpc_method_handler(
                self._report,
                request_deserializer=_identity,
                response_serializer=_identity,
            ),
            "get": grpc.unary_unary_rpc_method_handler(
                self._get,
                request_deserializer=_identity,
                response_serializer=_identity,
            ),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
        )
        self.port = self._server.add_insecure_port(f"[::]:{port}")

    def _report(self, request: bytes, context) -> bytes:
        return self._servicer.report(Message.from_json(request)).to_json()

    def _get(self, request: bytes, context) -> bytes:
        return self._servicer.get(Message.from_json(request)).to_json()

    def start(self):
        self._server.start()
        logger.info("gRPC master service listening on port %d", self.port)

    def stop(self, grace: float = 1.0):
        self._server.stop(grace)


class _HttpHandler(BaseHTTPRequestHandler):
    servicer: Optional[MasterServicer] = None

    def log_message(self, fmt, *args):  # silence default access log
        pass

    def do_POST(self):  # noqa: N802 - http.server API
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        try:
            envelope = Message.from_json(body)
            if self.path.endswith("/report"):
                reply = self.servicer.report(envelope)
            elif self.path.endswith("/get"):
                reply = self.servicer.get(envelope)
            else:
                self.send_error(404)
                return
            payload = reply.to_json()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        except Exception as e:  # noqa: BLE001
            logger.exception("http master handler error")
            self.send_error(500, str(e))


class HttpMasterServer:
    def __init__(self, port: int, servicer: MasterServicer):
        handler = type("BoundHandler", (_HttpHandler,), {"servicer": servicer})
        self._httpd = ThreadingHTTPServer(("", port), handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http-master"
        )
        self._thread.start()
        logger.info("HTTP master service listening on port %d", self.port)

    def stop(self, grace: float = 1.0):
        self._httpd.shutdown()
        self._httpd.server_close()


def create_master_service(
    port: int, servicer: MasterServicer, service_type: str = "grpc"
):
    """Factory mirroring reference ``create_master_service`` (servicer.py:1074)."""
    if service_type == "http":
        return HttpMasterServer(port, servicer)
    return GrpcMasterServer(port, servicer)
