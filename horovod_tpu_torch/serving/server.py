"""Threaded stdlib-HTTP front for the continuous-batching engine.

Counterpart of ``horovod_tpu/serving/server.py``:
``http.server.ThreadingHTTPServer``, one handler thread per connection,
all funneling into the single engine thread through the scheduler's
bounded queue.

* ``POST /generate`` — body ``{"tokens": [...], "max_new_tokens": N?,
  "eos_id": E?, "timeout_ms": T?, "temperature": f?, "top_k": K?,
  "top_p": p?, "seed": s?, "priority": c?, "stream": bool?}``; replies
  ``{"tokens": [...], "finish_reason": ..., "ttft_ms": ...}``.
  ``temperature`` / ``top_k`` / ``top_p`` / ``seed`` select sampling
  (temperature 0, the default, is greedy); a fixed seed reproduces the
  tokens.  ``priority`` is the request's class (``"interactive"``, the
  default, or ``"batch"``).  Typed rejections map to HTTP: queue full /
  out of pages -> 429, too long -> 413, deadline -> 504, draining /
  engine failed -> 503, bad request (including a bad sampling parameter
  or an unknown class) -> 400.  A 503 ``engine_failed`` for a request
  that was in flight carries the resume descriptor (``"resume":
  {"emitted_tokens", "deadline_remaining_ms", "span_id"}``): the tokens
  already emitted and what is left of the deadline, what a front tier
  needs to continue the request elsewhere.  Without ``timeout_ms`` the
  engine deadline defaults to the server's ``request_timeout``, so a
  vanished client never pins a slot.

  ``"stream": true`` answers with chunked ``text/event-stream``
  (:mod:`~horovod_tpu_torch.serving.sse`): one ``token`` event per
  token as the engine emits it, then exactly one ``done`` (the
  non-streamed 200 payload) or ``error`` event (an ``engine_failed``
  one carries the same resume descriptor).  A client that disconnects
  mid-stream cancels its request: the engine frees its slot and pages on
  the next tick (``serving_disconnects_total``).  Submit-time rejections
  are ordinary JSON error replies.
  A valid ``X-Trace-Id`` request header (1-64 characters of
  ``[A-Za-z0-9._-]``) names the request, else the server mints an id;
  every ``/generate`` reply carries it in the same header, and the
  engine journals the request under it (what a front tier reads back
  from a dead replica's journal file with ``RequestJournal.read_live``).
* ``GET /healthz`` — 200 while ``healthy`` or ``degraded`` (restarted,
  serving), 503 when ``draining`` or ``failed``.
* ``GET /stats`` — the engine's :meth:`~InferenceEngine.stats`.
"""

from __future__ import annotations

import json
import queue
import re
import select
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from horovod_tpu_torch.serving import sse
from horovod_tpu_torch.serving.engine import (
    DEGRADED,
    HEALTHY,
    InferenceEngine,
)
from horovod_tpu_torch.serving.scheduler import (
    CacheOutOfPagesError,
    DeadlineExceededError,
    DrainingError,
    EngineFailedError,
    QueueFullError,
    RequestTooLongError,
    ServingError,
)

__all__ = ["ServingServer", "TRACE_ID_HEADER"]

#: The request and reply header of the trace id.
TRACE_ID_HEADER = "X-Trace-Id"
_TRACE_ID = re.compile(r"^[A-Za-z0-9._\-]{1,64}$")


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
            code = 200 if state in (HEALTHY, DEGRADED) else 503
            age = engine.heartbeat_age
            self._json(code, {
                "status": state,
                "slots_free": engine.slots.free_count,
                "queue_depth": engine.scheduler.depth,
                "heartbeat_age_s": round(age, 3) if age is not None else -1.0,
                "engine_restarts": engine.metrics.engine_restarts.value,
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
        hdr = self.headers.get(TRACE_ID_HEADER)
        trace_id = hdr if isinstance(hdr, str) and _TRACE_ID.match(hdr) \
            else uuid.uuid4().hex[:16]

        def fail(code: int, e: BaseException, etype: str,
                 resume: Optional[dict] = None, **headers):
            payload = {"error": str(e), "type": etype}
            if resume is not None:
                payload["resume"] = resume
            self._json(code, payload,
                       headers={TRACE_ID_HEADER: trace_id, **headers})

        fut = None
        stream = bool(req.get("stream"))
        t_recv = time.monotonic()
        # Streamed tokens cross from the engine thread to this handler
        # thread through a queue: the engine never blocks on a socket.
        tok_q: Optional[queue.Queue] = queue.Queue() if stream else None
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
                temperature=req.get("temperature", 0.0),
                top_k=req.get("top_k", 0),
                top_p=req.get("top_p", 0.0),
                seed=req.get("seed"),
                priority=req.get("priority", "interactive"),
                on_token=tok_q.put if stream else None,
                trace_id=trace_id)
            if stream:
                # The request is live: from here the reply is the SSE
                # stream, errors included.
                self._stream_response(engine, fut, tok_q, t_recv, deadline)
                return
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
            # At submit (no future: nothing ran) or for a request in
            # flight when the engine failed for good: then the reply
            # carries what a front tier needs to continue it elsewhere.
            fail(503, e, "engine_failed",
                 resume=_resume_descriptor(fut, deadline)
                 if fut is not None else None)
            return
        except (ServingError, ValueError, TypeError) as e:
            fail(400, e, "bad_request")
            return
        except TimeoutError as e:
            if fut is not None:
                fut.cancel()  # reclaim the slot on the next tick
            fail(504, e, "timeout")
            return
        self._json(200, _done_payload(fut, out),
                   headers={TRACE_ID_HEADER: trace_id})

    # -- SSE streaming (stream=true) ---------------------------------------

    def _client_gone(self) -> bool:
        """Peek the client socket between events: a readable socket whose
        recv returns b"" is a half-closed connection — the client hung
        up.  (A client pipelining bytes reads as data, not a hangup.)"""
        try:
            r, _, _ = select.select([self.connection], [], [], 0)
            if not r:
                return False
            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def _stream_response(self, engine: InferenceEngine, fut,
                         tok_q: "queue.Queue", t_recv: float,
                         deadline: float) -> None:
        """Stream one live request as chunked SSE: token events as the
        engine emits them, then exactly one terminal ``done`` / ``error``
        event.  A client disconnect — a failed write, or the socket peek
        while waiting between tokens — cancels the request.  Once the 200
        is on the wire, failures are in-band ``error`` events."""
        metrics = engine.metrics
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header(TRACE_ID_HEADER, fut.trace_id)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self.close_connection = True  # the stream owns the connection
        budget = t_recv + self.server.request_timeout \
            + self.server.timeout_grace
        n_sent = 0

        def emit(kind, payload) -> None:
            data = sse.event_bytes(kind, payload)
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

        def send_tok(tok) -> None:
            nonlocal n_sent
            emit("token", {"i": n_sent, "token": int(tok)})
            n_sent += 1
            metrics.streamed_tokens.inc()

        try:
            while True:
                try:
                    tok = tok_q.get(timeout=0.05)
                except queue.Empty:
                    if fut.done():
                        break
                    if time.monotonic() > budget:
                        fut.cancel()
                        emit("error", {
                            "type": "timeout",
                            "error": "generation still in progress at "
                                     "the server timeout"})
                        self.wfile.write(b"0\r\n\r\n")
                        return
                    if self._client_gone():
                        raise ConnectionAbortedError("client gone")
                    continue
                send_tok(tok)
            # Resolved: tokens always reach the queue before the future
            # resolves, so drain them, then the one terminal event.
            while True:
                try:
                    send_tok(tok_q.get_nowait())
                except queue.Empty:
                    break
            try:
                out = fut.result(timeout=0)
            except EngineFailedError as e:
                emit("error", {"type": "engine_failed", "error": str(e),
                               "resume": _resume_descriptor(fut, deadline)})
            except DeadlineExceededError as e:
                emit("error", {"type": "deadline_exceeded",
                               "error": str(e)})
            except CacheOutOfPagesError as e:
                emit("error", {"type": "out_of_pages", "error": str(e)})
            except ServingError as e:
                emit("error", {"type": "error", "error": str(e)})
            else:
                emit("done", _done_payload(fut, out))
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            # The client hung up: cancel, and the engine reclaims the
            # slot and its pages on its next tick.
            if fut.cancel():
                metrics.disconnects.inc()


def _resume_descriptor(fut, deadline: float) -> dict:
    """The resume descriptor of a request the engine failed in flight:
    the tokens it already emitted (append them to the prompt and decode
    continues with the same tokens) and the deadline budget left (a
    failover inherits it, never a fresh one).  ``span_id`` is None: the
    port does not trace."""
    return {"emitted_tokens": fut.tokens_so_far(),
            "deadline_remaining_ms": max(0.0, round(
                (deadline - time.monotonic()) * 1e3, 3)),
            "span_id": None}


def _done_payload(fut, tokens) -> dict:
    """The body of a successful reply (and of the ``done`` event)."""
    return {"tokens": tokens, "finish_reason": fut.finish_reason,
            "ttft_ms": round(fut.ttft * 1e3, 3) if fut.ttft else None}


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
