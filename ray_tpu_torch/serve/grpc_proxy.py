"""gRPC ingress for serve deployments (counterpart of the JAX package's
``serve/grpc_proxy.py``).

gRPC's generic handler with a JSON-over-bytes envelope instead of
per-app protoc stubs: ``/rtpu.serve/Call`` takes ``{"route": "/prefix",
"input": ...}`` (and optionally ``timeout_s``, ``request_id``,
``multiplexed_model_id``) and returns ``{"result": ...}``;
``/rtpu.serve/CallStream`` is the server-streaming variant for
``stream=True`` deployments, one ``{"item": ...}`` message an item.
Routing, replica choice and multiplexing ride the same DeploymentHandle
path as HTTP and Python callers; the status mapping is the HTTP proxy's
(RESOURCE_EXHAUSTED with ``retry-after-s`` for back-pressure,
DEADLINE_EXCEEDED, INTERNAL). Every call gets an ``x-request-id`` at
ingress (the envelope's ``request_id``, or one minted here), sent back
in the initial metadata, and roots its trace there (``serve.grpc``).

``grpc`` is imported when the proxy starts, never before: without the
package, ``serve.run(_grpc=True)`` raises an ImportError naming it.
"""
from __future__ import annotations

import json
from concurrent import futures
from typing import Any, Dict, Optional

from . import trace
from .admission import BackPressureError
from .context import DeadlineExceededError
from .handle import DeploymentHandle
from .proxy import finish_trace, request_timeout_s, request_trace, traced


def import_grpc():
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the gRPC ingress (serve.run(_grpc=True)) needs the grpcio "
            "package, which this Python does not have: pip install grpcio, "
            "or use the HTTP ingress (_http=True)") from e
    return grpc


def ingress_request_id(request) -> str:
    """The envelope's request_id where the client sent one, else a new
    one: no request goes on without an id."""
    rid = request.get("request_id")
    if isinstance(rid, str) and rid:
        return rid
    return trace.new_request_id()


def _ser(obj) -> bytes:
    return json.dumps(obj).encode()


def _de(data: bytes):
    return json.loads(data.decode()) if data else {}


class GRPCProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 9000,
                 controller=None):
        self.host = host
        self.port = port
        self._controller = controller
        self._handles: Dict[str, DeploymentHandle] = {}
        self._routes: Dict[str, Dict[str, Any]] = {}
        self._server = None
        self._executor: Optional[futures.ThreadPoolExecutor] = None
        self._stopped = None

    # ----------------------------------------------------------- lifetime

    def start(self) -> None:
        """Bind (port 0 picks a free port, which ``port`` then reports)
        and serve on gRPC's threads."""
        grpc = import_grpc()
        proxy = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                if handler_call_details.method == "/rtpu.serve/Call":
                    return grpc.unary_unary_rpc_method_handler(
                        proxy._call, request_deserializer=_de,
                        response_serializer=_ser)
                if handler_call_details.method == "/rtpu.serve/CallStream":
                    return grpc.unary_stream_rpc_method_handler(
                        proxy._call_stream, request_deserializer=_de,
                        response_serializer=_ser)
                return None

        self._executor = futures.ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="serve-grpc-proxy")
        self._server = grpc.server(self._executor)
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(f"{self.host}:{self.port}")
        self._server.start()

    def close(self) -> None:
        """Stop accepting and free the port; calls in flight get a second
        to finish, then are cancelled."""
        if self._server is not None and self._stopped is None:
            self._stopped = self._server.stop(grace=1)

    def join(self, timeout: float = 10.0) -> None:
        if self._stopped is not None:
            self._stopped.wait(timeout)
        if self._executor is not None:
            self._executor.shutdown(wait=True, cancel_futures=True)

    # ------------------------------------------------------------ routing

    def _ctrl(self):
        if self._controller is None:
            from . import controller

            self._controller = controller.controller_at(None)
        return self._controller

    def _resolve(self, route: str) -> Optional[Dict[str, Any]]:
        info = self._routes.get(route)
        if info is None:
            self._routes = self._ctrl().get_route_info()
            info = self._routes.get(route)
        return info

    def _handle_for(self, request):
        route = request.get("route")
        info = self._resolve(route or "")
        if info is None:
            raise KeyError(f"no deployment at route {route!r}")
        handle = self._handles.get(info["name"])
        if handle is None:
            handle = self._handles[info["name"]] = DeploymentHandle(
                info["name"], controller_address=self._ctrl().address)
        if request.get("multiplexed_model_id"):
            handle = handle.options(
                multiplexed_model_id=request["multiplexed_model_id"])
        return handle, info

    # -------------------------------------------------------------- calls

    def _call(self, request, context):
        grpc = import_grpc()
        rid = ingress_request_id(request)
        root = None
        context.send_initial_metadata((("x-request-id", rid),))
        try:
            handle, info = self._handle_for(request)
            root = request_trace(rid, info["name"], "grpc", "Call")
            result = traced(handle, root, rid).options(
                deadline_s=request_timeout_s(request.get("timeout_s")),
            ).remote(request.get("input")).result()
            finish_trace(root, "ok")
            return {"result": result}
        except BackPressureError as e:
            finish_trace(root, "shed", error=str(e))
            context.set_trailing_metadata(
                (("retry-after-s", f"{e.retry_after_s:g}"),))
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except DeadlineExceededError as e:
            finish_trace(root, "deadline", error=str(e))
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        except Exception as e:  # noqa: BLE001 — the client's INTERNAL
            finish_trace(root, "error", error=str(e))
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    def _call_stream(self, request, context):
        grpc = import_grpc()
        rid = ingress_request_id(request)
        root = None
        context.send_initial_metadata((("x-request-id", rid),))
        stream = None
        items = 0
        status = "cancelled"
        try:
            handle, info = self._handle_for(request)
            root = request_trace(rid, info["name"], "grpc", "CallStream")
            stream = traced(handle, root, rid).options(
                stream=True,
                deadline_s=request_timeout_s(request.get("timeout_s")),
            ).remote(request.get("input"))
            for item in stream:
                if not context.is_active():
                    # The client went away mid-stream: stop pulling; the
                    # finally's close() cancels the replica's generator
                    # and frees its engine slot now.
                    return
                items += 1
                yield {"item": item}
            status = "ok"
        except BackPressureError as e:
            status = "shed"
            context.set_trailing_metadata(
                (("retry-after-s", f"{e.retry_after_s:g}"),))
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except DeadlineExceededError as e:
            status = "deadline"
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        except Exception as e:  # noqa: BLE001 — the client's INTERNAL
            status = "error"
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        finally:
            finish_trace(root, status, items=items)
            if stream is not None:
                stream.close()
