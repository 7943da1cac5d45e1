"""The front door: one stdlib HTTP listener proxying over N replicas.

Same idiom as :mod:`horovod_tpu_torch.serving.server` — a
``ThreadingHTTPServer`` with one handler thread per connection — but
each ``POST /generate`` is PROXIED to a replica chosen by
join-shortest-queue over the registry's live routing set, instead of
submitted to a local engine.

Failover contract (docs/serving.md "Front tier"): when the chosen
replica fails mid-request at the connection level (refused, reset,
proxy timeout — the SIGKILL signature), the router evicts it from
rotation immediately (:meth:`ReplicaRegistry.mark_failed`) and retries
the SAME request on another replica, up to ``max_attempts`` with
exponential backoff.  The retry is safe: a replica that died at the
connection level resolved nothing — the client saw no bytes — and
generation is repeatable, so re-running it elsewhere changes nothing
the caller can observe.  A replica that ANSWERS, even with a typed
error, resolved the request; 503 (draining / engine failed — the
replica is leaving rotation and produced no tokens the CLIENT saw) and
429 (queue full / out of pages — another replica may have room) are
relayed only after a retry elsewhere also fails.  Responses the
replica produced tokens for (200, 400, 413, 504) are relayed verbatim,
trace id and all.

Failover RESUMES rather than re-executes whenever a resume descriptor
is available (docs/serving.md "Front tier"): a replica whose engine
failed terminally answers 503 with ``{"resume": {"emitted_tokens":
[...], "deadline_remaining_ms": ...}}``, and a SIGKILL'd replica
leaves a request journal file (``--journal``, read post-mortem via
``resume_lookup``).  The router then re-dispatches ``prompt + emitted``
with the REMAINING decode and deadline budgets — the surviving replica
re-prefills once and decode continues token-identically — and prepends
the carried tokens to the final response (``"resumed": true``).  A
deadline that expires mid-failover resolves as the same typed 504 the
replicas use.  Only the paid-for work moves; nothing is generated
twice, nothing is dropped.

SLO classes ride failover untouched: the client's ``"priority"`` field
lives in the request body, and every re-dispatch (``dispatch_body`` /
the streamed twin) rewrites only ``tokens`` / ``max_new_tokens`` /
``timeout_ms`` around the original body — so a batch-class request
resumes as batch on the survivor, and a journal descriptor additionally
records the class (``priority`` in ``RequestJournal.read_live``) for
consumers that rebuild a body from scratch.  Deadline budgets compose
with EDF scheduling: the REMAINING ``timeout_ms`` a failover dispatches
becomes the replica-side deadline the scheduler orders on.

STREAMING (``"stream": true`` — docs/serving.md "Sampling +
streaming"): the replica's chunked SSE body is proxied through
event-by-event with trace headers intact, token indices kept GLOBAL
across failovers.  A replica that dies mid-stream (connection death,
or an in-band ``error`` event carrying a resume descriptor) is failed
over like the non-streamed path — the journal/descriptor tells the
router every token the dead replica emitted, the continuation is
dispatched as ``prompt + frontier`` with the remaining budgets, and
the client's stream continues WITHOUT re-emitting anything it already
received (tokens the dead replica journaled but never got onto the
wire are synthesized by the router first, then the survivor's events
follow).  The terminal ``done`` event carries the full concatenated
token list (``resumed: true``), byte-identical to an uninterrupted
run.  A client that disconnects mid-stream tears down the upstream
leg, which cancels the request on the replica within one tick.

Endpoints:

* ``POST /generate`` — proxied with failover, as above.  Adds
  ``X-Router-Replica`` (the replica that answered) and
  ``X-Router-Attempts``.  When no replica is in rotation: 503
  ``{"type": "no_replicas"}`` with a ``Retry-After`` header.
* ``GET /healthz`` — 200 while at least one replica is in rotation,
  503 (+ ``Retry-After``) otherwise; body carries
  ``replicas_in_rotation`` / ``replicas_total``.
* ``GET /stats`` — the router metrics snapshot plus every replica's
  last polled status.
* ``GET /metrics`` — the ``router_*`` families as Prometheus text.
* ``GET /trace/<id>`` — the full request AUTOPSY: the cross-process
  span tree for one trace id, assembled from the spans directory
  (``span_dir``) every process of this deployment appends to — every
  attempt on every replica generation (a SIGKILL'd attempt shows as an
  UNFINISHED span), the failover / resume / retry edges, and the
  carried-token accounting.  404 for an unknown id, 503 when no
  ``span_dir`` was configured.

Distributed tracing (docs/observability.md): when a span recorder is
active in the router process (``obs.tracing.start_spans``), each
request gets a ``router /generate`` root span with one child span per
proxy attempt; the attempt's span id rides the ``X-Parent-Span``
header to the replica, whose request span nests under it — the
collector then assembles ONE tree across processes.  Failover /
resume re-dispatches also carry ``X-Trace-Sampled: 1``: the
downstream share of an interesting trace must not be tail-dropped by
a replica that saw nothing unusual.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from horovod_tpu_torch.obs import tracing as obs_tracing
from horovod_tpu_torch.serving import sse
from horovod_tpu_torch.serving.journal import RequestJournal
from horovod_tpu_torch.serving.router.registry import ReplicaRegistry

__all__ = ["RouterServer"]

#: Replica responses that mean "this replica cannot take the request,
#: but another one might": worth a retry elsewhere before relaying.
RETRYABLE_STATUS = (429, 503)


class _ProxyError(Exception):
    """A proxy attempt died at the connection level: nothing was
    resolved on the replica side, so a retry duplicates no work the
    client could ever observe."""


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: metrics are the log
        pass

    # -- plumbing ----------------------------------------------------------

    def _json(self, code: int, payload: dict,
              headers: Optional[Dict[str, str]] = None) -> None:
        self._sent_code = code  # the root span's status (do_POST)
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- GET ---------------------------------------------------------------

    def do_GET(self):
        router: "RouterServer" = self.server.router
        registry = router.registry
        if self.path == "/healthz":
            up = len(registry.in_rotation())
            total = len(registry.statuses())
            code = 200 if up else 503
            hdrs = {} if up else {"Retry-After": str(router.retry_after)}
            self._json(code, {
                "status": "healthy" if up else "no_replicas",
                "replicas_in_rotation": up,
                "replicas_total": total,
            }, headers=hdrs)
        elif self.path == "/stats":
            self._json(200, router.stats())
        elif self.path == "/rollout":
            if router.rollout is None:
                self._json(503, {
                    "error": "no rollout controller configured on this "
                             "router (RouterServer(rollout=...))",
                    "type": "no_rollout_controller"})
            else:
                self._json(200, router.rollout.status())
        elif self.path == "/metrics":
            body = registry.metrics.registry.to_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/trace/"):
            tid = self.path[len("/trace/"):]
            if not obs_tracing.valid_trace_id(tid):
                self._json(400, {"error": "bad trace id",
                                 "type": "bad_trace_id"})
            elif router.span_dir is None:
                self._json(503, {
                    "error": "no span_dir configured on this router "
                             "(RouterServer(span_dir=...))",
                    "type": "no_span_store"})
            else:
                try:
                    autopsy = router.autopsy(tid)
                except Exception as e:
                    # A broken store must read as a broken STORE, not
                    # as "trace never recorded" — a 404 here would
                    # misdirect an operator mid-postmortem.
                    self._json(500, {
                        "error": f"span store unreadable: {e!r}",
                        "type": "span_store_error"})
                    return
                if autopsy is None:
                    self._json(404, {"error": f"trace {tid} not found",
                                     "type": "unknown_trace"})
                else:
                    self._json(200, autopsy)
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    # -- POST /rollout: the fleet-reconfiguration admin surface ------------

    def _rollout_admin(self, router: "RouterServer", body: bytes) -> None:
        """``POST /rollout`` (docs/serving.md "Fleet rollouts"):
        ``{"candidate": {...}}`` starts a rolling reconfiguration (202
        + status), ``{"abort": true}`` trips the active one into
        rollback.  409 when one is already in flight, 503 when the
        router has no controller wired."""
        from horovod_tpu_torch.serving.router.rollout import RolloutError

        if router.rollout is None:
            self._json(503, {
                "error": "no rollout controller configured on this "
                         "router (RouterServer(rollout=...))",
                "type": "no_rollout_controller"})
            return
        try:
            obj = json.loads(body or b"{}")
        except json.JSONDecodeError:
            self._json(400, {"error": "body is not valid JSON",
                             "type": "bad_request"})
            return
        if not isinstance(obj, dict):
            self._json(400, {"error": "body must be a JSON object",
                             "type": "bad_request"})
            return
        if obj.get("abort"):
            self._json(200, router.rollout.abort())
            return
        candidate = obj.get("candidate")
        if not isinstance(candidate, dict) or not candidate:
            self._json(400, {
                "error": 'body needs {"candidate": {...config '
                         'deltas...}} or {"abort": true}',
                "type": "bad_request"})
            return
        try:
            status = router.rollout.start(
                candidate,
                allow_capacity_dip=obj.get("allow_capacity_dip"))
        except RolloutError as e:
            active = router.rollout.active
            self._json(409 if active else 400,
                       {"error": str(e),
                        "type": "rollout_active" if active
                        else "bad_candidate"})
            return
        self._json(202, status)

    # -- POST /generate: proxy with failover -------------------------------

    def _proxy_once(self, status_ep, body: bytes,
                    trace_id: Optional[str],
                    timeout: float,
                    parent_span: Optional[str] = None,
                    force_sample: bool = False
                    ) -> Tuple[int, bytes, Dict[str, str]]:
        """One attempt against one replica.  Raises :class:`_ProxyError`
        on connection-level failure (retry-safe); returns the replica's
        full response otherwise."""
        ep = status_ep.endpoint
        conn = http.client.HTTPConnection(ep.host, ep.port,
                                          timeout=timeout)
        try:
            headers = {"Content-Type": "application/json"}
            if trace_id:
                headers[obs_tracing.TRACE_ID_HEADER] = trace_id
                if parent_span:
                    headers[obs_tracing.PARENT_SPAN_HEADER] = parent_span
                if force_sample:
                    headers[obs_tracing.SAMPLED_HEADER] = "1"
            conn.request("POST", "/generate", body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            out_headers = {}
            for h in (obs_tracing.TRACE_ID_HEADER, "Retry-After"):
                v = resp.getheader(h)
                if v is not None:
                    out_headers[h] = v
            return resp.status, payload, out_headers
        except (OSError, socket.timeout, http.client.HTTPException) as e:
            raise _ProxyError(f"replica {ep.rid}: {e}") from e
        finally:
            conn.close()

    def _proxy_open(self, status_ep, body: bytes,
                    trace_id: Optional[str], timeout: float,
                    parent_span: Optional[str] = None,
                    force_sample: bool = False):
        """Open one attempt and return ``(conn, resp)`` WITHOUT reading
        the body — the streaming variant of :meth:`_proxy_once` (the
        caller forwards the SSE body incrementally and must close the
        connection).  Raises :class:`_ProxyError` on connection-level
        failure before any response line arrived."""
        ep = status_ep.endpoint
        conn = http.client.HTTPConnection(ep.host, ep.port,
                                          timeout=timeout)
        try:
            headers = {"Content-Type": "application/json"}
            if trace_id:
                headers[obs_tracing.TRACE_ID_HEADER] = trace_id
                if parent_span:
                    headers[obs_tracing.PARENT_SPAN_HEADER] = parent_span
                if force_sample:
                    headers[obs_tracing.SAMPLED_HEADER] = "1"
            conn.request("POST", "/generate", body=body, headers=headers)
            return conn, conn.getresponse()
        except (OSError, socket.timeout, http.client.HTTPException) as e:
            conn.close()
            raise _ProxyError(f"replica {ep.rid}: {e}") from e

    def do_POST(self):
        router: "RouterServer" = self.server.router
        registry = router.registry
        metrics = registry.metrics
        # Read the body FIRST, error paths included: HTTP/1.1
        # keep-alive would parse unread body bytes as the next request.
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
        except ValueError:
            self._json(400, {"error": "bad Content-Length"})
            return
        if self.path == "/rollout":
            self._rollout_admin(router, body)
            return
        if self.path != "/generate":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        # The shared ingress trust rule (obs/tracing.py — identical at
        # replica ingress, so the two fronts cannot drift): a client's
        # X-Parent-Span nests the root span, and X-Trace-Sampled
        # force-samples every dispatch of this request — both honored
        # only alongside a valid X-Trace-Id.
        trace_id, client_parent, client_sampled = \
            obs_tracing.propagation_from_headers(self.headers)
        metrics.requests.inc()

        # Distributed-tracing root span (module docstring): one
        # "router /generate" span per request, one child per proxy
        # attempt, typed events for every failover hop.  rec is None
        # unless obs.tracing.start_spans ran in this process — every
        # site below is a no-op then.
        rec = obs_tracing.spans()
        root_sid = None
        if rec is not None:
            root_sid = rec.begin("router /generate", trace_id,
                                 parent=client_parent)
        self._sent_code = 0
        self._root_attrs: Dict = {}
        try:
            self._generate(router, registry, metrics, body, trace_id,
                           rec, root_sid, client_sampled, client_parent)
        finally:
            if rec is not None and root_sid is not None:
                rec.finish(root_sid,
                           status=f"http:{self._sent_code}"
                           if self._sent_code else "error:unsent",
                           attrs=self._root_attrs)

    def _generate(self, router, registry, metrics, body, trace_id,
                  rec, root_sid, client_sampled=False,
                  client_parent=None):

        # Resume-aware failover state (docs/serving.md "Front tier").
        # A failed attempt may yield a RESUME DESCRIPTOR — from the
        # replica's typed engine-failure response, or post-mortem from
        # a SIGKILL'd replica's journal file — carrying the tokens it
        # already emitted and the REMAINING deadline budget.  The next
        # attempt then dispatches prompt + carried tokens with the
        # reduced decode budget and the remaining timeout: decode
        # continues where it left off (greedy output is a pure function
        # of the token sequence), and the final relay prepends the
        # carried tokens so the client sees one seamless result.
        try:
            body_obj = json.loads(body or b"{}")
        except json.JSONDecodeError:
            body_obj = None
        resumable = (isinstance(body_obj, dict)
                     and isinstance(body_obj.get("tokens"), list)
                     and isinstance(body_obj.get("max_new_tokens"), int))
        if isinstance(body_obj, dict) and body_obj.get("stream"):
            self._generate_stream(router, registry, metrics, body,
                                  body_obj, resumable, trace_id, rec,
                                  root_sid, client_sampled,
                                  client_parent)
            return
        carried: list = []
        remaining_ms: Optional[float] = None
        absorbed_at: float = 0.0
        carried_from: Optional[str] = None   # latest dead attempt's span

        def current_remaining_ms() -> Optional[float]:
            # Time the ROUTER spends between attempts (backoff, further
            # failures) counts against the budget too — the journal
            # path gets this for free (remaining computed at read
            # time); the inline-descriptor path must age it here, or
            # every crash-hop would extend the request's wall budget.
            # TWIN: _generate_stream has the streamed variant of this
            # carry machinery (frontier vs carried; wire already
            # partially sent) — budget/descriptor semantics changed
            # here must change there too.
            if remaining_ms is None:
                return None
            return remaining_ms - (time.monotonic() - absorbed_at) * 1e3

        def dispatch_body() -> bytes:
            rem = current_remaining_ms()
            if not carried and rem is None:
                return body
            obj = dict(body_obj)
            obj["tokens"] = list(body_obj["tokens"]) + carried
            obj["max_new_tokens"] = \
                body_obj["max_new_tokens"] - len(carried)
            if rem is not None:
                # The REMAINING budget, never a fresh one: a request
                # must not live longer because it crash-hopped.
                obj["timeout_ms"] = max(1.0, rem)
            return json.dumps(obj).encode()

        def absorb(desc, rid: Optional[str] = None,
                   source: Optional[str] = None) -> None:
            """Fold one attempt's resume descriptor into the carry."""
            nonlocal remaining_ms, absorbed_at, carried_from
            if not resumable or not isinstance(desc, dict):
                return
            if desc.get("span_id"):
                carried_from = desc["span_id"]
            toks = desc.get("emitted_tokens")
            if isinstance(toks, list):
                carried.extend(int(t) for t in toks)
                if rec is not None and toks:
                    # The RESUME edge, with the carried-token
                    # accounting and (when the journal/descriptor knew
                    # it) the dead attempt's span id — the autopsy
                    # links the continuation to the attempt it
                    # continues.
                    attrs = {"carried": len(toks)}
                    if rid:
                        attrs["from_replica"] = rid
                    if source:
                        attrs["source"] = source
                    if desc.get("span_id"):
                        attrs["resumed_from_span"] = desc["span_id"]
                    rec.event(trace_id, root_sid, "resume", attrs)
            rem = desc.get("deadline_remaining_ms")
            if rem is not None:
                remaining_ms = float(rem)
                absorbed_at = time.monotonic()

        def deadline_expired() -> bool:
            rem = current_remaining_ms()
            return rem is not None and rem <= 0.0

        def carry_complete() -> Optional[str]:
            """The carried tokens may already BE the full result — the
            dead replica emitted its last token but never answered
            (killed before the end-of-journal line, or the budget was
            spent across hops).  Re-dispatching would send
            ``max_new_tokens <= 0`` (a 400) or decode past EOS; finish
            the request here instead."""
            if not resumable or not carried:
                return None
            eos = body_obj.get("eos_id")
            if eos is not None and carried[-1] == eos:
                return "eos"
            if len(carried) >= body_obj["max_new_tokens"]:
                return "length"
            return None

        def finish_from_carry(reason: str, attempts: int) -> None:
            metrics.resume_failovers.inc()
            self._json(200, {
                "tokens": list(carried),
                "finish_reason": reason,
                "resumed": True,
                "resume_carried_tokens": len(carried),
                "trace_id": trace_id,
            }, headers={obs_tracing.TRACE_ID_HEADER: trace_id,
                        "X-Router-Attempts": str(attempts)})

        def track_root() -> None:
            self._root_attrs.update({
                "attempts": attempts,
                "carried_tokens": len(carried),
                "resumed": bool(carried)})

        tried = set()
        attempts = 0
        failed_over = False
        last: Optional[Tuple[int, bytes, Dict[str, str]]] = None
        while attempts < router.max_attempts:
            rep = registry.pick(exclude=tried)
            if rep is None and tried:
                # Everything in rotation was already tried; a replica
                # may have REJOINED (or a respawn landed) — allow a
                # fresh pick rather than failing a retryable request.
                rep = registry.pick()
            if rep is None:
                break
            if attempts:
                metrics.retries.inc()
                if rec is not None:
                    rec.event(trace_id, root_sid, "retry",
                              {"attempt": attempts + 1,
                               "replica": rep.endpoint.rid})
                time.sleep(min(
                    router.retry_backoff * (2.0 ** (attempts - 1)),
                    router.retry_backoff_max))
            attempts += 1
            tried.add(rep.endpoint.rid)
            track_root()
            att_sid = None
            if rec is not None:
                att_sid = rec.begin(
                    f"attempt {attempts} -> {rep.endpoint.rid}",
                    trace_id, parent=root_sid,
                    attrs={"replica": rep.endpoint.rid,
                           **({"carried_tokens": len(carried)}
                              if carried else {})})
            t0 = time.monotonic()
            try:
                status, payload, hdrs = self._proxy_once(
                    rep, dispatch_body(), trace_id, router.proxy_timeout,
                    # The attempt span is the replica-side request
                    # span's parent; with no router recorder the
                    # client's own (validated) parent is forwarded
                    # instead, so a replicas-only span deployment
                    # still joins the upstream caller's tree.
                    # Failover/resume continuations are force-sampled
                    # end to end (module docstring) — NOT routine
                    # 429/capacity retries, which would re-introduce
                    # per-token span volume exactly at peak load.
                    parent_span=att_sid or client_parent,
                    force_sample=(client_sampled or bool(carried)
                                  or failed_over))
            except _ProxyError:
                metrics.proxy_latency.observe(time.monotonic() - t0)
                # Connection-level death: evict NOW (the poll thread
                # would take up to one interval to notice) and retry —
                # the replica resolved nothing CLIENT-VISIBLE, so the
                # retry is safe; its journal file (when the supervisor
                # armed one) tells us how far decode got, so the retry
                # RESUMES rather than re-executing.
                registry.mark_failed(rep.endpoint.rid)
                failed_over = True
                if rec is not None:
                    rec.finish(att_sid, status="error:connection")
                    rec.event(trace_id, root_sid, "failover",
                              {"replica": rep.endpoint.rid,
                               "attempt": attempts})
                absorb(router.lookup_resume(rep.endpoint, trace_id),
                       rid=rep.endpoint.rid, source="journal")
                track_root()
                reason = carry_complete()
                if reason is not None:
                    finish_from_carry(reason, attempts)
                    return
                if deadline_expired():
                    break  # typed 504 below — the budget died with it
                continue
            metrics.proxy_latency.observe(time.monotonic() - t0)
            if status in RETRYABLE_STATUS:
                last = (status, payload, hdrs)
                if rec is not None:
                    rec.finish(att_sid, status=f"http:{status}")
                # A typed engine-failure response carries the resume
                # descriptor inline — absorb it before trying elsewhere.
                try:
                    absorb(json.loads(payload).get("resume"),
                           rid=rep.endpoint.rid, source="descriptor")
                except (json.JSONDecodeError, AttributeError):
                    pass
                track_root()
                reason = carry_complete()
                if reason is not None:
                    finish_from_carry(reason, attempts)
                    return
                if deadline_expired():
                    break
                continue
            if rec is not None:
                rec.finish(att_sid, status=f"http:{status}")
            if attempts > 1 and status == 200:
                # Only a SUCCESS bought by a retry counts as a
                # failover save (the documented meaning of the family).
                metrics.failovers.inc()
            if status == 200 and carried:
                payload = self._merge_resumed(payload, carried, metrics)
            hdrs.setdefault(obs_tracing.TRACE_ID_HEADER, trace_id)
            hdrs["X-Router-Replica"] = rep.endpoint.rid
            hdrs["X-Router-Attempts"] = str(attempts)
            self._relay(status, payload, hdrs)
            return

        track_root()
        if deadline_expired():
            # The deadline lapsed MID-FAILOVER: same typed 504 the
            # replicas use for a queued-deadline lapse, with whatever
            # was decoded before the crash (token ids are authoritative
            # — a client that cares can keep them).
            self._json(504, {
                "error": "deadline expired during failover",
                "type": "deadline_exceeded",
                "trace_id": trace_id,
                "attempts": attempts,
                "tokens_so_far": carried,
            }, headers={obs_tracing.TRACE_ID_HEADER: trace_id,
                        "X-Router-Attempts": str(attempts)})
            return

        metrics.requests_failed.inc()
        if last is not None:
            # Every replica we reached answered with a typed
            # retryable error — relay the last one (it carries the
            # replica's own reason and trace id) rather than masking
            # it behind a generic router error.
            status, payload, hdrs = last
            if carried:
                # Rewrite the relayed descriptor to the FULL carry, so
                # a client that resumes upstream continues from the
                # true frontier, not just the last replica's share.
                try:
                    obj = json.loads(payload)
                    obj["resume"] = {
                        "emitted_tokens": list(carried),
                        "deadline_remaining_ms": current_remaining_ms(),
                        # the latest dead attempt's span id survives
                        # the rewrite: an upstream caller that resumes
                        # from this descriptor keeps the causal edge
                        # into ITS trace tree (stacked front tiers)
                        "span_id": carried_from,
                    }
                    payload = json.dumps(obj).encode()
                except (json.JSONDecodeError, AttributeError):
                    pass
            hdrs.setdefault(obs_tracing.TRACE_ID_HEADER, trace_id)
            hdrs.setdefault("Retry-After", str(router.retry_after))
            hdrs["X-Router-Attempts"] = str(attempts)
            self._relay(status, payload, hdrs)
            return
        self._json(503, {
            "error": "no replica in rotation"
                     if not attempts else
                     f"no replica reachable after {attempts} attempt(s)",
            "type": "no_replicas",
            "trace_id": trace_id,
            "attempts": attempts,
        }, headers={"Retry-After": str(router.retry_after),
                    obs_tracing.TRACE_ID_HEADER: trace_id})

    def _generate_stream(self, router, registry, metrics, body,
                         body_obj, resumable, trace_id, rec, root_sid,
                         client_sampled=False, client_parent=None):
        """``POST /generate`` with ``"stream": true`` — proxy the
        replica's SSE body through event-by-event, failing over
        MID-STREAM without re-emitting anything the client already has
        (module docstring).

        The carry is a FRONTIER: every token any replica is known to
        have emitted, in order.  ``sent`` counts token events on the
        client's wire — always a prefix of the frontier (the journal
        may know tokens that never reached the wire; the router
        synthesizes their events before forwarding a survivor).
        TWIN: ``_generate`` holds the non-streamed variant of this
        carry machinery — budget/descriptor semantics changed here
        must change there too (the differences are deliberate: the
        frontier keeps the LONGER of events-seen vs journal, and a
        non-resumable body can only retry before the first wire
        event).  Each
        attempt is dispatched with ``prompt + frontier`` and the
        remaining budgets; the position-keyed sampling PRNG makes the
        continuation token-identical for sampled requests too."""
        frontier: list = []       # every token any replica emitted
        sent = 0                  # token events on the client's wire
        remaining_ms: Optional[float] = None
        absorbed_at = 0.0
        carried_from: Optional[str] = None
        headers_sent = False

        class _ClientGone(Exception):
            """The CLIENT hung up — distinct from upstream death, so
            the failover loop cannot mistake one for the other."""

        def current_remaining_ms() -> Optional[float]:
            if remaining_ms is None:
                return None
            return remaining_ms - (time.monotonic() - absorbed_at) * 1e3

        def deadline_expired() -> bool:
            rem = current_remaining_ms()
            return rem is not None and rem <= 0.0

        def dispatch_body() -> bytes:
            rem = current_remaining_ms()
            # A non-resumable body (no token list / no int
            # max_new_tokens) can never be rewritten — and the loop
            # below guarantees it is only ever re-dispatched before
            # the first token event reached the client.
            if not resumable or (not frontier and rem is None):
                return body
            obj = dict(body_obj)
            obj["tokens"] = list(body_obj["tokens"]) + frontier
            obj["max_new_tokens"] = \
                body_obj["max_new_tokens"] - len(frontier)
            if rem is not None:
                obj["timeout_ms"] = max(1.0, rem)
            return json.dumps(obj).encode()

        def absorb(base: list, desc, rid=None, source=None) -> None:
            """Fold a dead attempt's resume descriptor into the
            frontier.  ``base`` is what the attempt was DISPATCHED
            with; the descriptor's ``emitted_tokens`` are the
            attempt's own share, appended after it.  The journal's
            view is a superset of what we saw as events, never a
            contradiction — keep whichever is longer."""
            nonlocal remaining_ms, absorbed_at, carried_from
            if not resumable or not isinstance(desc, dict):
                return
            if desc.get("span_id"):
                carried_from = desc["span_id"]
            toks = desc.get("emitted_tokens")
            if isinstance(toks, list):
                cand = list(base) + [int(t) for t in toks]
                if len(cand) > len(frontier):
                    frontier[:] = cand
                if rec is not None and toks:
                    attrs = {"carried": len(frontier)}
                    if rid:
                        attrs["from_replica"] = rid
                    if source:
                        attrs["source"] = source
                    if desc.get("span_id"):
                        attrs["resumed_from_span"] = desc["span_id"]
                    rec.event(trace_id, root_sid, "resume", attrs)
            rem = desc.get("deadline_remaining_ms")
            if rem is not None:
                remaining_ms = float(rem)
                absorbed_at = time.monotonic()

        def send_headers(rid: Optional[str], attempts: int) -> None:
            nonlocal headers_sent
            if headers_sent:
                return
            headers_sent = True
            self._sent_code = 200
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header(obs_tracing.TRACE_ID_HEADER, trace_id)
            if rid:
                self.send_header("X-Router-Replica", rid)
            self.send_header("X-Router-Attempts", str(attempts))
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self.close_connection = True  # the stream owns the socket

        def emit(kind, payload) -> None:
            data = sse.event_bytes(kind, payload)
            try:
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            except OSError as e:
                raise _ClientGone() from e

        def emit_token(tok: int, text=None) -> None:
            nonlocal sent
            ev = {"i": sent, "token": int(tok)}
            if text is not None:
                ev["text"] = text
            emit("token", ev)
            sent += 1

        def catch_up() -> None:
            # Tokens the journal proved emitted but the client never
            # received (the dead replica was killed between journaling
            # and the socket): synthesize their events — ids only,
            # ids are the authoritative cross-replica representation.
            while sent < len(frontier):
                emit_token(frontier[sent])

        def finish_chunks() -> None:
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass

        def carry_reason() -> Optional[str]:
            # The frontier may already BE the full result (the dead
            # replica emitted its last token but never finished the
            # stream) — re-dispatching would 400 or decode past EOS.
            if not (resumable and frontier):
                return None
            eos = body_obj.get("eos_id")
            if eos is not None and frontier[-1] == eos:
                return "eos"
            if len(frontier) >= body_obj["max_new_tokens"]:
                return "length"
            return None

        def finish_from_frontier(reason: str, attempts: int) -> None:
            send_headers(None, attempts)
            catch_up()
            metrics.resume_failovers.inc()
            emit("done", {"tokens": list(frontier),
                          "finish_reason": reason,
                          "resumed": True,
                          "resume_carried_tokens": len(frontier),
                          "trace_id": trace_id})
            finish_chunks()

        def track_root(attempts: int) -> None:
            self._root_attrs.update({
                "attempts": attempts, "streamed": True,
                "carried_tokens": len(frontier),
                "resumed": bool(frontier)})

        tried = set()
        attempts = 0
        failed_over = False
        last: Optional[Tuple[int, bytes, Dict[str, str]]] = None
        try:
            while attempts < router.max_attempts:
                rep = registry.pick(exclude=tried)
                if rep is None and tried:
                    rep = registry.pick()  # a respawn may have rejoined
                if rep is None:
                    break
                if attempts:
                    metrics.retries.inc()
                    if rec is not None:
                        rec.event(trace_id, root_sid, "retry",
                                  {"attempt": attempts + 1,
                                   "replica": rep.endpoint.rid})
                    time.sleep(min(
                        router.retry_backoff * (2.0 ** (attempts - 1)),
                        router.retry_backoff_max))
                attempts += 1
                tried.add(rep.endpoint.rid)
                track_root(attempts)
                att_sid = None
                if rec is not None:
                    att_sid = rec.begin(
                        f"attempt {attempts} -> {rep.endpoint.rid}",
                        trace_id, parent=root_sid,
                        attrs={"replica": rep.endpoint.rid,
                               "streamed": True,
                               **({"carried_tokens": len(frontier)}
                                  if frontier else {})})
                dispatched = list(frontier)
                t0 = time.monotonic()
                try:
                    conn, resp = self._proxy_open(
                        rep, dispatch_body(), trace_id,
                        router.proxy_timeout,
                        parent_span=att_sid or client_parent,
                        force_sample=(client_sampled or bool(frontier)
                                      or failed_over))
                except _ProxyError:
                    metrics.proxy_latency.observe(time.monotonic() - t0)
                    registry.mark_failed(rep.endpoint.rid)
                    failed_over = True
                    if rec is not None:
                        rec.finish(att_sid, status="error:connection")
                        rec.event(trace_id, root_sid, "failover",
                                  {"replica": rep.endpoint.rid,
                                   "attempt": attempts})
                    absorb(dispatched,
                           router.lookup_resume(rep.endpoint, trace_id),
                           rid=rep.endpoint.rid, source="journal")
                    track_root(attempts)
                    reason = carry_reason()
                    if reason is not None:
                        finish_from_frontier(reason, attempts)
                        return
                    if deadline_expired():
                        break
                    continue
                status = resp.status
                ctype = resp.getheader("Content-Type") or ""
                if status != 200 or "text/event-stream" not in ctype:
                    # A pre-stream answer: submit-time rejection (the
                    # replica never started the SSE body) — exactly the
                    # non-streamed retry/relay protocol.
                    payload = resp.read()
                    hdrs = {}
                    for h in (obs_tracing.TRACE_ID_HEADER,
                              "Retry-After"):
                        v = resp.getheader(h)
                        if v is not None:
                            hdrs[h] = v
                    conn.close()
                    metrics.proxy_latency.observe(time.monotonic() - t0)
                    if rec is not None:
                        rec.finish(att_sid, status=f"http:{status}")
                    if status in RETRYABLE_STATUS:
                        last = (status, payload, hdrs)
                        try:
                            absorb(dispatched,
                                   json.loads(payload).get("resume"),
                                   rid=rep.endpoint.rid,
                                   source="descriptor")
                        except (json.JSONDecodeError, AttributeError):
                            pass
                        track_root(attempts)
                        reason = carry_reason()
                        if reason is not None:
                            finish_from_frontier(reason, attempts)
                            return
                        if deadline_expired():
                            break
                        continue
                    if not headers_sent:
                        hdrs.setdefault(obs_tracing.TRACE_ID_HEADER,
                                        trace_id)
                        hdrs["X-Router-Replica"] = rep.endpoint.rid
                        hdrs["X-Router-Attempts"] = str(attempts)
                        self._relay(status, payload, hdrs)
                        return
                    # Mid-stream continuation met a non-retryable
                    # answer (e.g. the remaining deadline lapsed into
                    # a 504): surface it in-band and end the stream.
                    try:
                        obj = json.loads(payload)
                    except json.JSONDecodeError:
                        obj = {}
                    emit("error", {
                        "type": obj.get("type", f"http_{status}"),
                        "error": obj.get("error",
                                         f"replica answered {status}"),
                        "trace_id": trace_id})
                    finish_chunks()
                    return
                # 200 text/event-stream: forward it.
                if attempts > 1:
                    metrics.failovers.inc()
                metrics.proxy_latency.observe(time.monotonic() - t0)
                send_headers(rep.endpoint.rid, attempts)
                catch_up()
                parser = sse.SSEParser()
                outcome = None  # "done" | "error" | ("failover", desc)
                try:
                    while outcome is None:
                        # read1, not read: read(n) BLOCKS until n bytes
                        # accumulate, which would buffer the live
                        # stream into one burst — read1 returns as
                        # soon as the current chunk has data, so each
                        # token event forwards the moment it lands.
                        data = resp.read1(4096)
                        if not data:
                            break  # EOF before a terminal event
                        for kind, ev in parser.feed(data):
                            if kind == "token" and "token" in ev:
                                tok = int(ev["token"])
                                frontier.append(tok)
                                # text pieces survive only unresumed
                                # streams: a continuation replica only
                                # detokenized its own share, and a
                                # spliced text stream would lie.
                                emit_token(tok,
                                           None if dispatched
                                           else ev.get("text"))
                            elif kind == "done":
                                out = dict(ev)
                                out["tokens"] = dispatched + [
                                    int(t)
                                    for t in (ev.get("tokens") or [])]
                                out.setdefault("trace_id", trace_id)
                                if dispatched:
                                    out.pop("text", None)
                                    out["resumed"] = True
                                    out["resume_carried_tokens"] = \
                                        len(dispatched)
                                    metrics.resume_failovers.inc()
                                emit("done", out)
                                outcome = "done"
                                break
                            elif kind == "error":
                                if (ev.get("type") == "engine_failed"
                                        and resumable
                                        and attempts
                                        < router.max_attempts):
                                    # The replica's engine died under
                                    # the stream and said so, resume
                                    # descriptor attached: fail over.
                                    outcome = ("failover",
                                               ev.get("resume"))
                                else:
                                    out = dict(ev)
                                    out.setdefault("trace_id", trace_id)
                                    emit("error", out)
                                    outcome = "error"
                                break
                except (OSError, socket.timeout,
                        http.client.HTTPException):
                    outcome = None  # connection death mid-stream
                finally:
                    conn.close()
                if outcome in ("done", "error"):
                    if rec is not None:
                        rec.finish(att_sid, status=f"sse:{outcome}")
                    finish_chunks()
                    return
                failed_over = True
                if isinstance(outcome, tuple):
                    if rec is not None:
                        rec.finish(att_sid, status="sse:engine_failed")
                    absorb(dispatched, outcome[1],
                           rid=rep.endpoint.rid, source="descriptor")
                else:
                    registry.mark_failed(rep.endpoint.rid)
                    if rec is not None:
                        rec.finish(att_sid, status="error:connection")
                        rec.event(trace_id, root_sid, "failover",
                                  {"replica": rep.endpoint.rid,
                                   "attempt": attempts})
                    absorb(dispatched,
                           router.lookup_resume(rep.endpoint, trace_id),
                           rid=rep.endpoint.rid, source="journal")
                track_root(attempts)
                if not resumable and sent:
                    # The client already has token events and the body
                    # cannot express a continuation: a retry would
                    # re-emit from scratch (duplicates on the wire).
                    # End the stream with a terminal error instead.
                    emit("error", {
                        "type": "stream_interrupted",
                        "error": "replica died mid-stream and the "
                                 "request body is not resumable (a "
                                 "token-list prompt and integer "
                                 "max_new_tokens are required)",
                        "trace_id": trace_id, "attempts": attempts})
                    finish_chunks()
                    return
                reason = carry_reason()
                if reason is not None:
                    finish_from_frontier(reason, attempts)
                    return
                if deadline_expired():
                    break

            track_root(attempts)
            if deadline_expired():
                if headers_sent:
                    catch_up()
                    emit("error", {
                        "type": "deadline_exceeded",
                        "error": "deadline expired during failover",
                        "tokens_so_far": list(frontier),
                        "trace_id": trace_id, "attempts": attempts})
                    finish_chunks()
                else:
                    self._json(504, {
                        "error": "deadline expired during failover",
                        "type": "deadline_exceeded",
                        "trace_id": trace_id, "attempts": attempts,
                        "tokens_so_far": frontier,
                    }, headers={obs_tracing.TRACE_ID_HEADER: trace_id,
                                "X-Router-Attempts": str(attempts)})
                return
            metrics.requests_failed.inc()
            if headers_sent:
                # Out of options with the stream already open: one
                # terminal in-band error, full-frontier resume
                # descriptor attached (a stacked front tier can
                # continue from it).
                catch_up()
                err = {"type": "no_replicas",
                       "error": "no replica reachable after "
                                f"{attempts} attempt(s)",
                       "trace_id": trace_id, "attempts": attempts}
                if frontier:
                    err["resume"] = {
                        "emitted_tokens": list(frontier),
                        "deadline_remaining_ms": current_remaining_ms(),
                        "span_id": carried_from}
                emit("error", err)
                finish_chunks()
                return
            if last is not None:
                status, payload, hdrs = last
                if frontier:
                    try:
                        obj = json.loads(payload)
                        obj["resume"] = {
                            "emitted_tokens": list(frontier),
                            "deadline_remaining_ms":
                                current_remaining_ms(),
                            "span_id": carried_from}
                        payload = json.dumps(obj).encode()
                    except (json.JSONDecodeError, AttributeError):
                        pass
                hdrs.setdefault(obs_tracing.TRACE_ID_HEADER, trace_id)
                hdrs.setdefault("Retry-After", str(router.retry_after))
                hdrs["X-Router-Attempts"] = str(attempts)
                self._relay(status, payload, hdrs)
                return
            self._json(503, {
                "error": "no replica in rotation"
                         if not attempts else
                         f"no replica reachable after {attempts} "
                         f"attempt(s)",
                "type": "no_replicas",
                "trace_id": trace_id, "attempts": attempts,
            }, headers={"Retry-After": str(router.retry_after),
                        obs_tracing.TRACE_ID_HEADER: trace_id})
        except _ClientGone:
            # The CLIENT hung up mid-stream: the per-attempt finally
            # already closed the upstream leg, which cancels the
            # request on the replica (its own disconnect handling) —
            # nothing more to send, just give the socket back.
            self.close_connection = True

    @staticmethod
    def _merge_resumed(payload: bytes, carried: list, metrics) -> bytes:
        """Prepend the carried tokens to a successful continuation's
        payload: the client sees ONE result, byte-identical to an
        uninterrupted run.  ``text`` is dropped — the continuation
        replica detokenized only its own share, and token ids are the
        authoritative cross-replica representation."""
        try:
            obj = json.loads(payload)
            obj["tokens"] = list(carried) + list(obj.get("tokens") or [])
            obj.pop("text", None)
            obj["resumed"] = True
            obj["resume_carried_tokens"] = len(carried)
            metrics.resume_failovers.inc()
            return json.dumps(obj).encode()
        except (json.JSONDecodeError, AttributeError, TypeError):
            return payload  # pragma: no cover - malformed replica reply

    def _relay(self, status: int, payload: bytes,
               headers: Dict[str, str]) -> None:
        self._sent_code = status  # the root span's status (do_POST)
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


class RouterServer:
    """Own the router HTTP listener (and optionally the registry poll
    thread) lifecycle.

    >>> rt = RouterServer(registry, port=0).start()
    >>> rt.address                       # ("127.0.0.1", 43117)
    >>> rt.stop()

    ``max_attempts`` caps placement tries per request;
    ``retry_backoff`` / ``retry_backoff_max`` shape the exponential
    backoff between them; ``proxy_timeout`` bounds one attempt — set
    it ABOVE the replicas' ``request_timeout`` so a slow-but-correct
    replica is never double-generated, and the timeout only fires for
    replicas that genuinely wedged.  ``retry_after`` is the seconds
    hint on 503s (load shedding guidance for well-behaved clients).

    ``resume_lookup`` is the post-mortem resume source for
    connection-level deaths: ``(rid, trace_id) -> resume descriptor or
    None`` (``ReplicaSupervisor.resume_lookup`` reads the dead
    replica's journal file, surviving the reap).  When None, the
    router falls back to the endpoint's advertised ``journal_path``
    (still registered until the supervisor reaps it).

    ``span_dir`` arms ``GET /trace/<id>``: the spans directory every
    process of this deployment appends its span stream to
    (``ReplicaSupervisor(span_dir=...)`` for the replicas, plus the
    router's own ``obs.tracing.start_spans(<span_dir>/router...)``);
    each autopsy re-reads the streams — cold by design, this is a
    postmortem endpoint, not a hot path.
    """

    def __init__(self, registry: ReplicaRegistry, *,
                 host: str = "127.0.0.1", port: int = 8080,
                 max_attempts: int = 3,
                 retry_backoff: float = 0.05,
                 retry_backoff_max: float = 1.0,
                 proxy_timeout: float = 150.0,
                 retry_after: int = 1,
                 resume_lookup=None,
                 span_dir: Optional[str] = None,
                 rollout=None,
                 own_registry_thread: bool = True) -> None:
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.resume_lookup = resume_lookup
        self.span_dir = span_dir
        #: RolloutController wired behind POST/GET /rollout (None =
        #: the admin surface answers a typed 503).
        self.rollout = rollout
        self.registry = registry
        self.host = host
        self.port = port
        self.max_attempts = max_attempts
        self.retry_backoff = retry_backoff
        self.retry_backoff_max = retry_backoff_max
        self.proxy_timeout = proxy_timeout
        self.retry_after = retry_after
        self._own_registry_thread = own_registry_thread
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        """(host, port) actually bound (resolves port=0)."""
        if self._httpd is None:
            return (self.host, self.port)
        return self._httpd.server_address[:2]

    def lookup_resume(self, endpoint, trace_id: str) -> Optional[Dict]:
        """Resume descriptor for ``trace_id`` on a replica that died at
        the connection level, or None (→ re-execute from scratch, the
        pre-journal behavior).  Never raises: resume is an
        optimization, failover correctness does not depend on it."""
        try:
            if self.resume_lookup is not None:
                return self.resume_lookup(endpoint.rid, trace_id)
            if endpoint.journal_path:
                return RequestJournal.read_live(
                    endpoint.journal_path).get(trace_id)
        except Exception:  # pragma: no cover - post-mortem best effort
            return None
        return None

    def autopsy(self, trace_id: str) -> Optional[Dict]:
        """Assemble the cross-process span tree for ``trace_id`` from
        ``span_dir``; None when the id is unknown or no span_dir is
        configured.  Collector failures PROPAGATE (the HTTP handler
        maps them to a typed 500 ``span_store_error``) — malformed
        individual records/files are already skipped inside
        :class:`~horovod_tpu_torch.obs.trace_store.TraceStore`, so an
        exception here means the store itself is broken and must not
        masquerade as a missing trace."""
        if self.span_dir is None:
            return None
        from horovod_tpu_torch.obs.trace_store import TraceStore

        store = TraceStore.from_dir(self.span_dir)
        if not store.n_readable:
            # Wrong/moved directory or every stream unreadable: "store
            # is broken", not "trace never recorded" — surface the 500.
            raise FileNotFoundError(
                f"no readable span streams under {self.span_dir}")
        return store.autopsy(trace_id)

    def stats(self) -> Dict:
        out = {
            **self.registry.metrics.snapshot(),
            "policy": "join-shortest-queue",
            "max_attempts": self.max_attempts,
            "in_rotation": sorted(
                s.endpoint.rid for s in self.registry.in_rotation()),
            "replicas": {s.endpoint.rid: s.as_dict()
                         for s in self.registry.statuses()},
        }
        if self.rollout is not None:
            out["rollout"] = self.rollout.status()
        return out

    def start(self) -> "RouterServer":
        if self._httpd is not None:
            return self
        if self._own_registry_thread:
            self.registry.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _RouterHandler)
        self._httpd.daemon_threads = True
        self._httpd.router = self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="router-http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        if self._own_registry_thread:
            self.registry.stop()

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
