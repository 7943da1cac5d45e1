"""Server-Sent Events plumbing shared by the serving server (emit) and its
clients and tests (parse): one definition of the wire format.

A copy of ``horovod_tpu/serving/sse.py`` (the port imports nothing of
the JAX package).  The stream a ``POST /generate`` with ``"stream":
true`` returns:

* ``event: token`` — ``{"i": N, "token": ID}``: one event per emitted
  token, in order, ``i`` the 0-based index within the request (a client
  detects gaps and duplicates from it).
* ``event: done`` — the payload of the non-streamed 200 body
  (``tokens`` — the full id list, authoritative — plus
  ``finish_reason`` and ``ttft_ms``).
* ``event: error`` — the payload of a non-streamed typed error body
  (``type`` / ``error``), for failures after the 200 and its headers
  are on the wire.

Every stream ends with exactly one ``done`` or one ``error`` event (the
terminal event), carried over chunked transfer encoding.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

__all__ = ["SSEParser", "event_bytes", "read_stream"]


def event_bytes(kind: str, payload: Dict) -> bytes:
    """One SSE event frame: ``event: <kind>`` + one JSON ``data`` line."""
    return (f"event: {kind}\ndata: "
            f"{json.dumps(payload, separators=(',', ':'))}\n\n").encode()


class SSEParser:
    """Incremental SSE frame parser: feed raw body bytes (any chunking),
    get completed ``(kind, payload)`` events out.  Unknown lines are
    ignored (comments, retry hints); a frame with unparseable JSON data
    surfaces as ``(kind, {"_raw": <text>})`` rather than ending the
    stream."""

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, data: bytes) -> List[Tuple[str, Dict]]:
        self._buf += data
        out: List[Tuple[str, Dict]] = []
        while b"\n\n" in self._buf:
            frame, self._buf = self._buf.split(b"\n\n", 1)
            kind, payload = "message", {}
            for line in frame.decode("utf-8", "replace").splitlines():
                if line.startswith("event:"):
                    kind = line[len("event:"):].strip()
                elif line.startswith("data:"):
                    text = line[len("data:"):].strip()
                    try:
                        payload = json.loads(text)
                    except json.JSONDecodeError:
                        payload = {"_raw": text}
            out.append((kind, payload))
        return out


def read_stream(resp, chunk: int = 4096) -> List[Tuple[str, Dict]]:
    """Drain an ``http.client.HTTPResponse`` SSE body to completion.  Uses
    ``read1`` (returns as soon as the current chunk has data) so events
    arrive live; plain ``read(n)`` would block until ``n`` bytes
    accumulate."""
    parser = SSEParser()
    events: List[Tuple[str, Dict]] = []
    read1 = getattr(resp, "read1", None)
    while True:
        data = read1(chunk) if read1 is not None else resp.read(chunk)
        if not data:
            return events
        events.extend(parser.feed(data))
