"""Deterministic fault injection for the serving stack.

A verbatim copy of ``horovod_tpu/serving/faults.py`` (standard library
only): the port keeps its own copy because importing anything from
``horovod_tpu`` loads JAX.  The site list is kept whole so that one
:class:`FaultSpec` fires on the same visit in both engines; the port's
engine probes ``prefill``, ``decode_tick``, ``decode_fetch``,
``watchdog`` and ``restart_resume`` (chunked prefill, and with it
``prefill_chunk``, is not ported; the rollout sites belong to the JAX
package's fleet controller).  The references to the JAX package's docs
and modules below describe the original.

The chaos suite (``tests/test_chaos.py``) needs to prove one invariant:
*no submitted request ever hangs* — under device exceptions, hung
ticks, non-finite logits, and mid-stream cancellations, every
:class:`~horovod_tpu.serving.engine.GenerationFuture` resolves with
tokens or a typed error within a bounded wall-clock, and the engine
recovers to oracle-identical greedy output.  Proving that requires
faults that fire at EXACT, reproducible points, which is what this
module provides: a seedable :class:`FaultInjector` with site-addressed
probes that the engine calls at its failure-prone boundaries.

Sites (``FaultInjector.SITES``):

* ``"prefill"`` — probed in ``InferenceEngine._admit_batch``
  immediately before the batched prefill (a device fault during
  admission).
* ``"decode_tick"`` — probed in the engine's decode path immediately
  before the compiled tick is DISPATCHED (a device fault mid-decode);
  the ``"nonfinite"`` kind corrupts the tick's per-slot max-logit
  vector at its fetch instead, modeling NaN/Inf logits from bad
  params or flaky hardware.
* ``"decode_fetch"`` — probed immediately before the engine fetches a
  dispatched tick's results (``np.asarray`` of the device tokens).
  With the overlapped pipeline this is the DEFERRED-fetch boundary —
  the one host sync per steady-state tick, where an async device
  failure from the PREVIOUS tick actually surfaces — so the chaos
  suite can model a device that accepted the dispatch and then died
  (raise) or wedged (hang) before delivering the value.
* ``"watchdog"`` — probed at the top of ``InferenceEngine.step``; a
  ``"hang"`` here stalls the whole tick outside any device call,
  which is exactly what the watchdog thread exists to catch.
* ``"prefill_chunk"`` — probed in ``InferenceEngine._ingest_step``
  immediately before each CHUNK of a chunked prompt ingestion is
  dispatched (docs/serving.md "Scheduling"), so the chaos invariant
  covers a crash at every chunk boundary: the partially-ingested
  request suspends through the resume path (no tokens were emitted
  yet — the journal frontier is the original prompt) and re-ingests
  oracle-exact after the supervised restart.
* ``"restart_resume"`` — probed in ``InferenceEngine._recover`` at
  the point where a non-terminal restart would SUSPEND in-flight
  requests for resume (the durability path).  A ``"raise"``
  models the resume machinery itself failing (unreadable journal,
  corrupted state): the engine degrades to the legacy fail-typed
  restart — in-flight futures resolve with ``EngineFailedError``
  instead of resuming, and nothing is ever replayed from state it
  cannot trust.
* ``"rollout_drain"`` / ``"rollout_rebuild"`` / ``"rollout_canary"``
  / ``"rollout_promote"`` — probed by the fleet
  :class:`~horovod_tpu.serving.router.rollout.RolloutController` (NOT
  the engine) at each step of a rolling reconfiguration: before a
  replica is drained for rebuild, before the rebuilt replica is
  awaited, before the canary is admitted for scoring, and before each
  post-canary promotion step (docs/serving.md "Fleet rollouts").  A
  ``"raise"`` at any of them models the controller machinery failing
  mid-step and must trip the automatic rollback; a ``"hang"`` models
  a stalled step (the rollback path still converges the fleet).

Kinds:

* ``"raise"`` — raise :class:`InjectedFaultError` at the site.
* ``"hang"`` — sleep ``delay`` seconds at the site (the tick
  heartbeat keeps aging, so a delay past the engine's
  ``tick_timeout`` budget trips the watchdog).
* ``"nonfinite"`` — only meaningful at ``decode_tick``: the engine
  replaces the active slots' max-logits with NaN, which its
  finiteness check then converts into a typed engine failure.

Determinism: each site keeps a visit counter; a spec fires on visits
``skip, skip+1, ...`` until ``max_fires`` is exhausted, gated by a
``random.Random(seed)`` draw when ``p < 1`` — same seed + same call
sequence = same faults.  The injector records every firing in
:attr:`FaultInjector.fired` so tests can assert exactly what happened.
The injector is probed only from the engine thread; it is not
thread-safe and does not need to be.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["FaultInjector", "FaultSpec", "InjectedFaultError"]


class InjectedFaultError(RuntimeError):
    """Raised at a fault site by a ``kind="raise"`` spec.  Deliberately
    NOT a ServingError: the engine must survive arbitrary exceptions,
    not just its own typed ones."""


@dataclasses.dataclass
class FaultSpec:
    """One scripted fault.

    ``site`` must be in :attr:`FaultInjector.SITES`; ``kind`` in
    ``("raise", "hang", "nonfinite")``.  The spec becomes eligible on
    the site's ``skip``-th visit (0-based) and fires at most
    ``max_fires`` times (``None`` = unlimited), each eligible visit
    passing an independent probability-``p`` draw."""

    site: str
    kind: str = "raise"
    p: float = 1.0
    delay: float = 0.0
    max_fires: Optional[int] = 1
    skip: int = 0
    _fires: int = dataclasses.field(default=0, init=False, repr=False)


class FaultInjector:
    """Seedable, site-addressed fault probes for the inference engine.

    >>> inj = FaultInjector([
    ...     FaultSpec(site="decode_tick", kind="raise", skip=3),
    ...     FaultSpec(site="decode_tick", kind="hang", delay=0.5,
    ...               skip=10),
    ... ], seed=7)
    >>> cfg = EngineConfig(faults=inj)

    The engine calls :meth:`probe` at each site; the third decode tick
    raises, the tenth hangs 0.5 s, everything else runs clean.
    """

    SITES = ("prefill", "prefill_chunk", "decode_tick", "decode_fetch",
             "watchdog", "restart_resume",
             # Fleet-rollout sites, probed by the RolloutController in
             # the SUPERVISOR process (never by an engine):
             "rollout_drain", "rollout_rebuild", "rollout_canary",
             "rollout_promote")
    KINDS = ("raise", "hang", "nonfinite")

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs: List[FaultSpec] = []
        self._rng = random.Random(seed)
        self._visits: Dict[str, int] = {s: 0 for s in self.SITES}
        #: every firing, in order: (site, kind, site-visit index)
        self.fired: List[Tuple[str, str, int]] = []
        self.add(*specs)

    def add(self, *specs: FaultSpec) -> "FaultInjector":
        """Validate and append specs — also usable MID-RUN, so a test
        can warm an engine fault-free and then schedule a fault
        relative to :meth:`visits` (``skip=inj.visits(site) + n``:
        fire on the n-th visit from now)."""
        for spec in specs:
            if spec.site not in self.SITES:
                raise ValueError(
                    f"unknown fault site {spec.site!r}; expected one of "
                    f"{self.SITES}")
            if spec.kind not in self.KINDS:
                raise ValueError(
                    f"unknown fault kind {spec.kind!r}; expected one of "
                    f"{self.KINDS}")
            self.specs.append(spec)
        return self

    def visits(self, site: str) -> int:
        """How many times ``site`` has been probed so far."""
        return self._visits[site]

    @property
    def exhausted(self) -> bool:
        """True when every bounded spec has fired its fill (an
        unlimited spec never exhausts)."""
        return all(s.max_fires is not None and s._fires >= s.max_fires
                   for s in self.specs)

    def probe(self, site: str) -> Optional[str]:
        """Visit ``site``; fire the first matching eligible spec.

        ``"raise"`` raises :class:`InjectedFaultError` here;
        ``"hang"`` sleeps ``delay`` here and returns ``"hang"``;
        ``"nonfinite"`` returns ``"nonfinite"`` for the caller to apply
        (only the engine knows where its logits are).  Returns None
        when nothing fires."""
        visit = self._visits[site]
        self._visits[site] = visit + 1
        for spec in self.specs:
            if spec.site != site or visit < spec.skip:
                continue
            if spec.max_fires is not None and spec._fires >= spec.max_fires:
                continue
            if spec.p < 1.0 and self._rng.random() >= spec.p:
                continue
            spec._fires += 1
            self.fired.append((site, spec.kind, visit))
            if spec.kind == "raise":
                raise InjectedFaultError(
                    f"injected fault at {site} (visit {visit})")
            if spec.kind == "hang":
                time.sleep(spec.delay)
            return spec.kind
        return None
