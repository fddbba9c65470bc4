"""HTTP proxy: asyncio HTTP/1.1 server inside an actor.

ray: python/ray/serve/_private/http_proxy.py:234,415 (HTTPProxy/
HTTPProxyActor — an asyncio/uvicorn event loop, NOT a thread per
connection).  Rounds 1-3 used ThreadingHTTPServer: fine at benchmark QPS,
but a thread per keep-alive connection cannot hold thousands of idle
clients.  This build speaks HTTP/1.1 over asyncio streams with no external
deps:

  * idle keep-alive connections cost one coroutine each, bounded by the
    serve_proxy_max_connections knob (excess connections are refused at
    accept instead of silently degrading everyone);
  * active requests resolve replica responses on a bounded thread pool
    (serve_proxy_threads) — the router's replica calls ride the direct
    worker-to-worker transport (peer.py), so a request never touches the
    head on the hot path;
  * streaming responses are chunked NDJSON, one line per generator item,
    flushed as produced (ray: serve StreamingResponse over ASGI).

Routing: POST/GET /<deployment-name> with a JSON body (or query string) →
Router.assign_request → JSON response.
"""

from __future__ import annotations

import asyncio
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import ray_tpu_torch
from ray_tpu_torch._private import config as _config
from ray_tpu_torch.serve.router import Router

_MAX_HEADER_BYTES = 64 * 1024
_IDLE_TIMEOUT_S = 120.0
_STREAM_END = object()


class _BadRequest(Exception):
    pass


async def _read_request(reader) -> Optional[Tuple[str, str, dict, bytes]]:
    """Parse one HTTP/1.1 request; None = clean EOF (client closed)."""
    try:
        line = await asyncio.wait_for(reader.readline(), _IDLE_TIMEOUT_S)
    except asyncio.TimeoutError:
        return None  # idle keep-alive expired
    if not line:
        return None
    parts = line.decode("latin-1").rstrip("\r\n").split(" ")
    if len(parts) != 3:
        raise _BadRequest("malformed request line")
    method, target, _version = parts
    headers = {}
    total = len(line)
    while True:
        h = await asyncio.wait_for(reader.readline(), _IDLE_TIMEOUT_S)
        total += len(h)
        if total > _MAX_HEADER_BYTES:
            raise _BadRequest("headers too large")
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", 0) or 0)
    # Body read carries the same deadline as the headers: a client that
    # declares a Content-Length and withholds bytes must not pin a
    # connection slot forever.
    body = (
        await asyncio.wait_for(reader.readexactly(n), _IDLE_TIMEOUT_S)
        if n else b""
    )
    return method, target, headers, body


def _json_response(code: int, payload, keep_alive: bool,
                   request_id: str = "") -> bytes:
    try:
        data = json.dumps(payload).encode()
    except TypeError:
        data = json.dumps({"result": repr(payload)}).encode()
    reason = {200: "OK", 404: "Not Found", 500: "Internal Server Error",
              503: "Service Unavailable"}.get(code, "OK")
    rid_header = f"X-Request-Id: {request_id}\r\n" if request_id else ""
    head = (
        f"HTTP/1.1 {code} {reason}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(data)}\r\n"
        f"{rid_header}"
        f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n"
    ).encode("latin-1")
    return head + data


def _next_item(it):
    """Executor-side step of a blocking stream iterator."""
    try:
        return it.__next__()
    except StopIteration:
        return _STREAM_END


class HTTPProxy:
    """Actor payload: owns the asyncio loop thread + a Router."""

    def __init__(self, controller_handle, host: str = "127.0.0.1", port: int = 0,
                 max_connections: int = 0):
        self._router = Router(controller_handle)
        self._host = host
        self._pool = ThreadPoolExecutor(
            max_workers=_config.get("serve_proxy_threads"),
            thread_name_prefix="serve-resolve",
        )
        self._max_conns = max_connections or _config.get(
            "serve_proxy_max_connections"
        )
        self._open_conns = 0
        self._loop = asyncio.new_event_loop()
        started = threading.Event()
        boot: dict = {}

        def _run_loop():
            asyncio.set_event_loop(self._loop)

            async def _boot():
                server = await asyncio.start_server(
                    self._handle_conn, host, port, backlog=512
                )
                boot["server"] = server
                boot["port"] = server.sockets[0].getsockname()[1]

            try:
                self._loop.run_until_complete(_boot())
            except BaseException as e:  # noqa: BLE001 — surfaced below
                boot["error"] = e
                started.set()
                return
            started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(
            target=_run_loop, daemon=True, name="serve-http"
        )
        self._thread.start()
        if not started.wait(30):
            raise RuntimeError("serve HTTP proxy failed to start within 30s")
        if "error" in boot:
            # Bind failure (port in use, perms) must fail actor creation
            # loudly, exactly like the threaded server's constructor did.
            raise boot["error"]
        self._server = boot["server"]
        self._port = boot["port"]

    # -- connection handling -------------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        if self._open_conns >= self._max_conns:
            # Bounded keep-alive: refuse loudly instead of degrading every
            # existing connection (ray: uvicorn limit-concurrency 503s).
            try:
                writer.write(_json_response(503, {"error": "too many connections"}, False))
                await writer.drain()
            except (ConnectionError, OSError):
                pass
            writer.close()
            return
        self._open_conns += 1
        try:
            sock = writer.get_extra_info("socket")
            if sock is not None:
                import socket as _socket

                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            while True:
                try:
                    req = await _read_request(reader)
                except (_BadRequest, ValueError):
                    writer.write(_json_response(400, {"error": "bad request"}, False))
                    await writer.drain()
                    return
                except (asyncio.IncompleteReadError, ConnectionError, OSError):
                    return
                if req is None:
                    return
                method, target, headers, body = req
                keep = headers.get("connection", "keep-alive").lower() != "close"
                try:
                    done = await self._dispatch(writer, method, target, body, keep)
                except (ConnectionError, OSError):
                    return
                if not done or not keep:
                    return
        finally:
            self._open_conns -= 1
            try:
                writer.close()
            except OSError:
                pass

    async def _dispatch(self, writer, method: str, target: str, raw: bytes,
                        keep: bool) -> bool:
        """Route one request; returns False when the connection must close
        (e.g. a broken stream).  Replica resolution is blocking router
        code, so it runs on the bounded executor pool."""
        path = urlparse(target)
        deployment = path.path.strip("/").split("/")[0]
        if not deployment:
            writer.write(_json_response(404, {"error": "no deployment in path"}, keep))
            await writer.drain()
            return True
        q = {k: v[0] for k, v in parse_qs(path.query).items()}
        stream = q.pop("stream", "0") in ("1", "true")
        body: Any = None
        if raw:
            try:
                body = json.loads(raw)
            except Exception:
                body = raw.decode(errors="replace")
        if body is None and q:
            body = q
        args = (body,) if body is not None else ()
        loop = asyncio.get_running_loop()
        if stream:
            return await self._stream_reply(writer, loop, deployment, args)
        # Request tracing (ROADMAP item 3's p99 debugging leg): ONE
        # request id — the trace id — spans proxy → router → replica, so
        # the merged timeline renders each serve request as a single
        # parented span tree.  The span's context is passed EXPLICITLY to
        # the executor-pool resolve (contextvars don't cross
        # run_in_executor), and the id returns as X-Request-Id.
        from ray_tpu_torch.util import tracing

        span_cm = ctx = None
        if tracing.is_enabled():
            span_cm = tracing.span(
                "serve::request",
                attrs={"deployment": deployment, "method": method},
            )
            ctx = span_cm.__enter__()
        rid = (ctx or {}).get("trace_id", "")
        try:
            out = await loop.run_in_executor(
                self._pool, self._resolve, deployment, args, ctx
            )
        except Exception as e:  # noqa: BLE001 — HTTP boundary
            writer.write(
                _json_response(500, {"error": str(e)}, keep, request_id=rid)
            )
            await writer.drain()
            return True
        finally:
            if span_cm is not None:
                span_cm.__exit__(None, None, None)
        writer.write(
            _json_response(200, {"result": out}, keep, request_id=rid)
        )
        await writer.drain()
        return True

    def _resolve(self, deployment: str, args: tuple, trace_parent=None):
        ref = self._router.assign_request(
            deployment, "__call__", args, {}, trace_parent=trace_parent
        )
        return ray_tpu_torch.get(ref, timeout=60)

    async def _stream_reply(self, writer, loop, deployment: str, args: tuple) -> bool:
        """Chunked NDJSON: one line per generator item.  Never raises past
        the headers: once they go out, an error MUST be framed as a final
        chunk — a second HTTP response inside the chunked body would
        corrupt it."""
        try:
            it = await loop.run_in_executor(
                self._pool,
                lambda: self._router.assign_request(
                    deployment, "__call__", args, {}, stream=True
                ),
            )
        except Exception as e:  # noqa: BLE001 — pre-headers: plain 500
            writer.write(_json_response(500, {"error": str(e)}, True))
            await writer.drain()
            return True
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/x-ndjson\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n"
        )
        try:
            while True:
                try:
                    item = await loop.run_in_executor(self._pool, _next_item, it)
                except Exception as e:  # noqa: BLE001 — mid-stream error
                    data = (json.dumps({"error": str(e)}) + "\n").encode()
                    writer.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                    break
                if item is _STREAM_END:
                    break
                data = (json.dumps({"item": item}) + "\n").encode()
                writer.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            return True
        except (ConnectionError, OSError):
            it.close()  # client hung up: release the replica stream
            return False

    # -- actor surface -------------------------------------------------------

    def address(self) -> str:
        return f"http://{self._host}:{self._port}"

    def port(self) -> int:
        return self._port

    def ping(self) -> str:
        return "pong"

    def open_connections(self) -> int:
        return self._open_conns

    def shutdown(self) -> None:
        def _stop():
            if self._server is not None:
                self._server.close()
            self._loop.stop()

        try:
            self._loop.call_soon_threadsafe(_stop)
        except RuntimeError:
            pass
        self._pool.shutdown(wait=False)
