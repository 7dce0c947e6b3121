"""HTTP proxy: route prefix -> deployment handle (counterpart of the JAX
package's ``serve/proxy.py``).

Where the JAX proxy is an aiohttp server, the port's is the standard
library's ``http.server.ThreadingHTTPServer`` speaking HTTP/1.1 (the
card's machine has no HTTP package), on threads of the process that
called ``serve.run`` or ``serve.start``: one accepts, and each connection
is served on a thread of its own, so the blocking handle calls never hold
the accept thread. Requests route by longest-prefix match against the
controller's route table and go through the same DeploymentHandle /
power-of-two router as Python callers.

- JSON in, ``{"result": ...}`` out; other bodies pass through as text.
  A GET's query string is the argument, as a dict.
- A ``stream=True`` deployment answers with a chunked body, one chunk an
  item: str and bytes pass through, anything else is JSON plus "\\n".
  Its first item is read before the status line goes out, so an error
  before it (overload, an expired deadline) still gets its status code;
  an error after it ends the body early.
- A client that disconnects closes the deployment stream before the next
  item is written: the cancel reaches the replica, and the LLM
  deployments' ``engine.abort`` frees the slot.
- ``BackPressureError`` -> 503 with ``Retry-After``;
  ``DeadlineExceededError`` -> 504; an unknown route or a deleted
  deployment -> 404; anything else -> 500.
- The deadline comes from the ``X-Request-Timeout-S`` header, else from
  RTPU_SERVE_REQUEST_TIMEOUT_S (<= 0: none). ``X-Request-Id`` is honoured
  or minted, and echoed on the response.

The proxy roots each request's trace (:func:`request_trace`, a
``serve.http`` root under the request's id) and hands it to the handle,
so the ledger row's wall is the proxy's end to end (dispatch, replica,
the relay of the result or of the whole stream); :func:`finish_trace`
closes it with the terminal status once the client has the last byte.
"""
from __future__ import annotations

import http.server
import json
import select
import socket
import threading
import urllib.parse
from typing import Any, Dict, Optional

from .. import flags
from . import trace
from .admission import BackPressureError
from .context import DeadlineExceededError
from .handle import DeploymentHandle, DeploymentNotFoundError


def request_trace(request_id: str, deployment: str, proto: str,
                  method: str) -> Optional[trace.RootTrace]:
    """The request's root trace (None with RTPU_SERVE_TRACE off)."""
    return trace.start_request(request_id=request_id, deployment=deployment,
                               proto=proto, method=method)


def traced(handle: DeploymentHandle, root: Optional[trace.RootTrace],
           request_id: str) -> DeploymentHandle:
    """``handle`` carrying the ingress's request id and root trace."""
    return handle.options(
        request_id=request_id,
        trace_ctx=root.trace_ctx if root is not None else None)


def request_timeout_s(given: Any) -> Optional[float]:
    """Per-request end-to-end budget: the client's (the X-Request-Timeout-S
    header, the gRPC envelope's timeout_s) where it is a positive number,
    else RTPU_SERVE_REQUEST_TIMEOUT_S (None where that is <= 0: no
    deadline)."""
    try:
        v = float(given or 0)
        if v > 0:
            return v
    except (TypeError, ValueError):
        pass
    v = float(flags.get("RTPU_SERVE_REQUEST_TIMEOUT_S"))
    return v if v > 0 else None


def longest_prefix(routes: Dict[str, Dict[str, Any]], path: str
                   ) -> Optional[Dict[str, Any]]:
    best = None
    for prefix, info in routes.items():
        if path == prefix or path.startswith(prefix.rstrip("/") + "/") \
                or prefix == "/":
            if best is None or len(prefix) > len(best[0]):
                best = (prefix, info)
    return best[1] if best else None


def client_gone(sock: socket.socket) -> bool:
    """Has the client closed its side? (Readable with nothing to read; a
    pipelined next request reads as still there.)"""
    try:
        readable, _, _ = select.select([sock], [], [], 0)
        return bool(readable) and sock.recv(1, socket.MSG_PEEK) == b""
    except OSError:
        return True


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    # The proxy joins its connection threads itself, with a bound.
    block_on_close = False


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "rtpu-serve"

    def log_message(self, format, *args):  # noqa: A002 — the base's name
        pass  # no access log on stderr

    def setup(self):
        super().setup()
        # A chunk a token: no Nagle delay waiting on the client's ACK.
        self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.server.proxy._opened(self)

    def finish(self):
        try:
            super().finish()
        finally:
            self.server.proxy._closed(self)

    def do_GET(self):
        self.server.proxy.handle(self)

    do_POST = do_PUT = do_DELETE = do_PATCH = do_GET


class HTTPProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 controller=None):
        self.host = host
        self.port = port
        self._controller = controller
        self._handles: Dict[str, DeploymentHandle] = {}
        self._routes: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._open: Dict[Any, threading.Thread] = {}
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifetime

    def start(self) -> None:
        """Bind (port 0 picks a free port, which ``port`` then reports)
        and serve on a thread."""
        self._server = _Server((self.host, self.port), _Handler)
        self._server.proxy = self
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name=f"serve-http-proxy-{self.port}")
        self._thread.start()

    def close(self) -> None:
        """Stop accepting, free the port, and shut the open connections'
        sockets (a stream ends at its next item, cancelling its
        deployment call)."""
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        with self._lock:
            handlers = list(self._open)
        for h in handlers:
            try:
                h.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def join(self, timeout: float = 10.0) -> None:
        """Wait for the accept thread and the connection threads."""
        if self._thread is not None:
            self._thread.join(timeout)
        with self._lock:
            threads = list(self._open.values())
        for t in threads:
            t.join(timeout)

    def _opened(self, handler) -> None:
        thread = threading.current_thread()
        thread.name = f"serve-http-proxy-{self.port}-conn"
        with self._lock:
            self._open[handler] = thread

    def _closed(self, handler) -> None:
        with self._lock:
            self._open.pop(handler, None)

    # ------------------------------------------------------------ routing

    def _ctrl(self):
        if self._controller is None:
            from . import controller

            self._controller = controller.controller_at(None)
        return self._controller

    def _refresh_routes(self) -> None:
        self._routes = self._ctrl().get_route_info()

    def _match(self, path: str) -> Optional[Dict[str, Any]]:
        info = longest_prefix(self._routes, path)
        if info is None:
            self._refresh_routes()
            info = longest_prefix(self._routes, path)
        return info

    def _handle_for(self, name: str) -> DeploymentHandle:
        with self._lock:
            h = self._handles.get(name)
            if h is None:
                h = self._handles[name] = DeploymentHandle(
                    name, controller_address=self._ctrl().address)
            return h

    # ---------------------------------------------------------- a request

    def handle(self, req: _Handler) -> None:
        url = urllib.parse.urlsplit(req.path)
        body = b""
        length = int(req.headers.get("Content-Length") or 0)
        if length:
            body = req.rfile.read(length)
        rid = req.headers.get("X-Request-Id") or trace.new_request_id()
        hdrs = {"X-Request-Id": rid}
        info = self._match(url.path)
        if info is None:
            _json(req, 404, {"error": f"no route for {url.path}"}, hdrs)
            return
        name = info["name"]
        if req.command == "GET":
            arg: Any = dict(urllib.parse.parse_qsl(url.query))
        else:
            try:
                arg = json.loads(body) if body else None
            except json.JSONDecodeError:
                arg = body.decode(errors="replace")
        timeout_s = request_timeout_s(req.headers.get("X-Request-Timeout-S"))
        root = request_trace(rid, name, "http", req.command)
        handle = traced(self._handle_for(name), root, rid).options(
            stream=bool(info.get("stream")), deadline_s=timeout_s)
        try:
            if info.get("stream"):
                stream = handle.remote(arg)
                first = next(stream, _END)
            else:
                result = handle.remote(arg).result()
        except DeploymentNotFoundError:
            with self._lock:
                self._handles.pop(name, None)
            self._refresh_routes()
            finish_trace(root, "error", http_status=404)
            _json(req, 404, {"error": f"deployment {name} not found"}, hdrs)
            return
        except BackPressureError as e:
            finish_trace(root, "shed", error=str(e), http_status=503)
            _json(req, 503, {"error": str(e)}, dict(
                hdrs, **{"Retry-After": f"{max(1, round(e.retry_after_s))}"}))
            return
        except DeadlineExceededError as e:
            finish_trace(root, "deadline", error=str(e), http_status=504)
            _json(req, 504, {"error": str(e)}, hdrs)
            return
        except Exception as e:  # noqa: BLE001 — the client's 500
            finish_trace(root, "error", error=str(e), http_status=500)
            _json(req, 500, {"error": str(e)}, hdrs)
            return
        if info.get("stream"):
            self._stream(req, stream, first, hdrs, root)
            return
        finish_trace(root, "ok", http_status=200)
        if isinstance(result, (dict, list, int, float, bool)) \
                or result is None:
            _json(req, 200, {"result": result}, hdrs)
        else:
            _send(req, 200, str(result).encode(),
                  "text/plain; charset=utf-8", hdrs)

    def _stream(self, req: _Handler, stream, first, hdrs, root) -> None:
        """A chunked body fed by the deployment stream, item by item."""
        req.send_response(200)
        for k, v in hdrs.items():
            req.send_header(k, v)
        req.send_header("Content-Type", "application/octet-stream")
        req.send_header("Transfer-Encoding", "chunked")
        req.end_headers()
        items, status, item = 0, "cancelled", first
        try:
            while item is not _END:
                if client_gone(req.connection):
                    break
                if isinstance(item, bytes):
                    data = item
                elif isinstance(item, str):
                    data = item.encode()
                else:
                    data = (json.dumps(item) + "\n").encode()
                req.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                req.wfile.flush()
                items += 1
                try:
                    item = next(stream, _END)
                except DeadlineExceededError:
                    status = "deadline"
                    break
                except Exception:  # noqa: BLE001 — ends the body early
                    status = "error"
                    break
            else:
                status = "ok"
            if status != "cancelled":
                req.wfile.write(b"0\r\n\r\n")
                req.wfile.flush()
        except OSError:
            status = "cancelled"  # the client went away mid-write
        finally:
            # Reached at the end and on a client that left: the cancel
            # frees the replica's slot at once.
            finish_trace(root, status, items=items)
            stream.close()
        if status == "cancelled":
            req.close_connection = True


_END = object()


def finish_trace(root, status: str, **attrs) -> None:
    """Close a root trace that ``request_trace`` opened."""
    if root is not None:
        root.finish(status, **attrs)


def _send(req, code: int, data: bytes, ctype: str,
          hdrs: Dict[str, str]) -> None:
    try:
        req.send_response(code)
        for k, v in hdrs.items():
            req.send_header(k, v)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)
        req.wfile.flush()
    except OSError:
        req.close_connection = True


def _json(req, code: int, obj: Any, hdrs: Dict[str, str]) -> None:
    _send(req, code, json.dumps(obj).encode(), "application/json", hdrs)
