"""Threaded stdlib-HTTP front for the continuous-batching engine.

Counterpart of ``horovod_tpu/serving/server.py`` for this slice:
``http.server.ThreadingHTTPServer``, one handler thread per connection,
all funneling into the single engine thread through the scheduler's
bounded queue.

* ``POST /generate`` — body ``{"tokens": [...], "max_new_tokens": N?,
  "eos_id": E?, "timeout_ms": T?, "temperature": 0?}``; replies
  ``{"tokens": [...], "finish_reason": ..., "ttft_ms": ...}``.  Typed
  rejections map to HTTP: queue full / out of pages -> 429, too long ->
  413, deadline -> 504, draining / engine failed -> 503, bad request ->
  400 (including ``temperature > 0``: sampling is not ported yet).
  Without ``timeout_ms`` the engine deadline defaults to the server's
  ``request_timeout``, so a vanished client never pins a slot.
* ``GET /healthz`` — 200 while ``healthy``, 503 when ``draining`` or
  ``failed``.
* ``GET /stats`` — the engine's :meth:`~InferenceEngine.stats`.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from horovod_tpu_torch.serving.engine import HEALTHY, InferenceEngine
from horovod_tpu_torch.serving.scheduler import (
    CacheOutOfPagesError,
    DeadlineExceededError,
    DrainingError,
    EngineFailedError,
    QueueFullError,
    RequestTooLongError,
    ServingError,
)

__all__ = ["ServingServer"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: metrics are the log
        pass

    def _json(self, code: int, payload: dict,
              headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        engine: InferenceEngine = self.server.engine
        if self.path == "/healthz":
            state = engine.health
            code = 200 if state == HEALTHY else 503
            age = engine.heartbeat_age
            self._json(code, {
                "status": state,
                "slots_free": engine.slots.free_count,
                "queue_depth": engine.scheduler.depth,
                "heartbeat_age_s": round(age, 3) if age is not None else -1.0,
            }, headers=None if code == 200 else {"Retry-After": "1"})
        elif self.path == "/stats":
            self._json(200, engine.stats())
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        # Read the body even on error paths: with keep-alive, unread
        # bytes would be parsed as the next request line.
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
        except ValueError:
            self._json(400, {"error": "bad Content-Length"})
            return
        if self.path != "/generate":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        engine: InferenceEngine = self.server.engine
        try:
            req = json.loads(body or b"{}")
        except json.JSONDecodeError as e:
            self._json(400, {"error": f"bad JSON body: {e}"})
            return
        if not isinstance(req, dict) or not req.get("tokens"):
            self._json(400, {"error": "need non-empty 'tokens'"})
            return

        def fail(code: int, e: BaseException, etype: str, **headers):
            self._json(code, {"error": str(e), "type": etype},
                       headers=headers or None)

        fut = None
        try:
            timeout_ms = req.get("timeout_ms")
            deadline = time.monotonic() + (
                float(timeout_ms) / 1e3 if timeout_ms
                else self.server.request_timeout)
            fut = engine.submit(
                [int(t) for t in req["tokens"]],
                max_new_tokens=req.get("max_new_tokens"),
                eos_id=req.get("eos_id"),
                deadline=deadline,
                temperature=float(req.get("temperature") or 0.0))
            # The engine's deadline retirement should win over this hard
            # HTTP timeout, which fires only when the engine cannot retire.
            out = fut.result(timeout=self.server.request_timeout
                             + self.server.timeout_grace)
        except (QueueFullError, CacheOutOfPagesError) as e:
            fail(429, e, "queue_full" if isinstance(e, QueueFullError)
                 else "out_of_pages")
            return
        except RequestTooLongError as e:
            fail(413, e, "too_long")
            return
        except DeadlineExceededError as e:
            fail(504, e, "deadline_exceeded")
            return
        except DrainingError as e:
            fail(503, e, "draining", **{"Retry-After": "1"})
            return
        except EngineFailedError as e:
            fail(503, e, "engine_failed")
            return
        except (ServingError, ValueError, TypeError) as e:
            fail(400, e, "bad_request")
            return
        except TimeoutError as e:
            if fut is not None:
                fut.cancel()  # reclaim the slot on the next tick
            fail(504, e, "timeout")
            return
        payload = {
            "tokens": out,
            "finish_reason": fut.finish_reason,
            "ttft_ms": round(fut.ttft * 1e3, 3) if fut.ttft else None,
        }
        self._json(200, payload)


class ServingServer:
    """Own the engine thread + HTTP listener lifecycle.

    >>> srv = ServingServer(engine, port=0).start()   # 0 = ephemeral
    >>> srv.address                                   # ("127.0.0.1", 43117)
    >>> srv.stop(drain_timeout=30)
    """

    def __init__(self, engine: InferenceEngine, *, host: str = "127.0.0.1",
                 port: int = 8000, request_timeout: float = 120.0,
                 timeout_grace: float = 5.0):
        self.engine = engine
        self.host = host
        self.port = port
        self.request_timeout = request_timeout
        self.timeout_grace = timeout_grace
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        """(host, port) actually bound (resolves port=0)."""
        if self._httpd is None:
            return (self.host, self.port)
        return self._httpd.server_address[:2]

    def start(self) -> "ServingServer":
        if self._httpd is not None:
            return self
        self.engine.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.engine = self.engine
        self._httpd.request_timeout = self.request_timeout
        self._httpd.timeout_grace = self.timeout_grace
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serving-http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, drain_timeout: float = 30.0) -> None:
        """Drain (new work gets 503, admitted and queued work finishes),
        force-resolve whatever is left when the budget lapses, then shut
        the listener and the engine thread down."""
        if self._httpd is None:
            return
        self.engine.begin_drain()
        if not self.engine.drain(timeout=drain_timeout):
            self.engine.terminate(
                f"server shutdown: drain budget ({drain_timeout}s) "
                "exhausted")
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        self._thread.join(5.0)
        self._thread = None
        self.engine.stop()

    def __enter__(self) -> "ServingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
