"""Tunable serving knobs whose every value replays a captured graph.

The port of ``horovod_tpu/tuning/params.py``.  The JAX module's
contract is "compile-safe": a knob enters the online space only with
values that reuse an executable warmup compiled.  On the port the
contract reads "capture-safe": every value must replay a CUDA graph
that :meth:`~horovod_tpu_torch.serving.engine.InferenceEngine.warmup`
captured, so ``decode_compilations`` and ``prefill_compilations`` stay
where warmup left them across the whole tuning trajectory.

The online space, derived from a warmed engine by
:func:`online_knob_space`:

* ``max_prefills_per_tick`` — integer in ``[1, warmed_kmax]``: warmup
  captures the admission graphs of every k up to the construction value.
* ``prefill_chunk_tokens`` — integer within the chunk bucket
  ``(B/2, B]`` (only when chunking is on), narrowed to the values whose
  chunk graphs warmup captured.  The JAX argument (every value in the
  bucket pads to one compile shape) holds for the chunk's own width, but
  the port keys each later chunk's graph by the power-of-two page count
  of the positions already landed (``("suffix", pages, B, 1)``), and a
  chunk size changes where the chunks fall.  A value is kept when every
  key it reaches, on every prompt the construction value serves without
  a capture, is captured (:func:`_captured_chunk_bounds`).
* ``page_grant_ahead`` — swept {0, 1, 2} pages: how far past the write
  position decode growth grants pages.  Page-table data only.  The port
  is paged only, so the knob is always in the space.
* ``spec_enabled`` — swept {on, off} (speculative engines only): both
  tick graphs are captured by warmup and the toggle is admission-mask
  data (``_spec_runtime_enabled``).

No knob changes emitted tokens.  Constructor-level knobs (``kv_dtype``,
``n_slots``, ``page_size``, ``spec_k``) are the offline space
:mod:`horovod_tpu_torch.tuning.replay` explores by building an engine a
sample.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

__all__ = ["Knob", "KnobSpace", "online_knob_space", "apply_settings"]


@dataclass(frozen=True)
class Knob:
    """One tunable knob and its compile-safe candidate set.

    ``kind`` routes it to the reference split: ``"sweep"`` knobs are
    exhaustively swept (``CategoricalSweep``), ``"bo"`` knobs form the
    jointly-BO'd box (integer-valued; suggestions are rounded then
    clamped).  ``candidates`` (sweep) / ``bounds`` (bo, inclusive)
    contain ONLY values the warmed engine can apply without tracing.
    """

    name: str
    default: object
    kind: str                      # "sweep" | "bo"
    candidates: Tuple = ()
    bounds: Tuple[int, int] = (0, 0)
    direction: str = "max"         # which way better scores move it
    #: scoring windows to discard after applying a new value —
    #: requests admitted under the old setting are still in flight.
    discard_windows: int = 1
    apply_path: str = ""           # human-readable, for /tuning + docs

    def clamp(self, value):
        if self.kind == "bo":
            lo, hi = self.bounds
            return int(min(max(int(round(float(value))), lo), hi))
        return value if value in self.candidates else self.default


class KnobSpace:
    """The online knob set for ONE engine, with apply machinery."""

    def __init__(self, knobs: List[Knob]):
        self.knobs = list(knobs)
        by_name = [k.name for k in knobs]
        if len(set(by_name)) != len(by_name):
            raise ValueError(f"duplicate knob names: {by_name}")

    @property
    def sweep_knobs(self) -> List[Knob]:
        return [k for k in self.knobs if k.kind == "sweep"]

    @property
    def bo_knobs(self) -> List[Knob]:
        return [k for k in self.knobs if k.kind == "bo"]

    def defaults(self) -> Dict[str, object]:
        return {k.name: k.default for k in self.knobs}

    def clamp(self, settings: Dict[str, object]) -> Dict[str, object]:
        """Round/clamp a proposal into the compile-safe set (unknown
        keys dropped — a stale proposal must never reach the engine)."""
        known = {k.name: k for k in self.knobs}
        return {name: known[name].clamp(v)
                for name, v in settings.items() if name in known}

    def describe(self) -> List[Dict]:
        """The /tuning + docs view of the space."""
        out = []
        for k in self.knobs:
            out.append({
                "name": k.name, "kind": k.kind,
                "default": k.default,
                "candidates": list(k.candidates) if k.kind == "sweep"
                else list(range(k.bounds[0], k.bounds[1] + 1)),
                "direction": k.direction,
                "discard_windows": k.discard_windows,
                "apply": k.apply_path,
            })
        return out


def online_knob_space(engine) -> KnobSpace:
    """Derive the compile-safe online space from a WARMED engine.

    Bounds come from the engine's actual warmed state — the prefill
    compile cache and construction-time config — never from what a
    config "could" support: a knob value outside what warmup compiled
    would trace mid-serving.
    """
    cfg = engine.engine_cfg
    knobs: List[Knob] = []

    # Warmup compiles batched prefill for every k in [1, kmax]:
    # any k <= the construction value is a warm shape.
    kmax = min(cfg.max_prefills_per_tick, cfg.n_slots)
    if kmax > 1:
        knobs.append(Knob(
            name="max_prefills_per_tick", default=kmax, kind="bo",
            bounds=(1, kmax),
            apply_path="EngineConfig replace + Scheduler."
                       "max_prefills_per_tick at the tick boundary"))

    # Chunk budget: only within the warmed power-of-two bucket — every
    # value in (B/2, B] pads to the same compile shape.
    chunk = cfg.prefill_chunk_tokens
    if chunk > 0:
        bucket = engine._bucket(chunk)
        lo, hi = _captured_chunk_bounds(engine, chunk, bucket)
        if hi > lo:
            knobs.append(Knob(
                name="prefill_chunk_tokens", default=chunk, kind="bo",
                bounds=(lo, hi),
                apply_path=f"EngineConfig replace; moves inside the "
                           f"warmed {bucket}-token chunk bucket"))

    knobs.append(Knob(
        name="page_grant_ahead", default=cfg.page_grant_ahead,
        kind="sweep",
        candidates=tuple(sorted({cfg.page_grant_ahead, 0, 1, 2})),
        apply_path="EngineConfig replace; page-table data only "
                   "(_ensure_write_page grant-ahead span)"))

    if getattr(engine, "_spec", False):
        knobs.append(Knob(
            name="spec_enabled", default=True, kind="sweep",
            candidates=(True, False),
            apply_path="engine._spec_runtime_enabled admission mask "
                       "(both tick executables pre-warmed)"))

    return KnobSpace(knobs)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _captured_chunk_bounds(engine, chunk: int,
                           bucket: int) -> Tuple[int, int]:
    """The widest interval around ``chunk`` inside ``(bucket/2,
    bucket]`` whose values replay only captured chunk graphs.

    A prompt chunked at ``c`` lands its first chunk through the
    ``("full", bucket, 1)`` graph and its chunk at position ``lo`` (a
    multiple of ``c``) through ``("suffix", pad(pages(lo)), bucket, 1)``.
    ``limit`` is the first chunk position of the construction value
    whose key warmup did not capture: prompts up to that length ingest
    with no capture at ``chunk``.  A value ``c`` is kept when its chunk
    positions below ``limit`` all reach captured keys (and, below
    ``chunk``, when the first-chunk graph was captured).  Prompts longer
    than ``limit``, and chunking after an attached prefix, capture at
    their first use under any value, as the construction value's do."""
    ps = engine.slots.page_size
    max_len = engine.slots.max_len
    suffix = {key[0] for key in engine._graphs.keys("suffix")
              if tuple(key[1:]) == (bucket, 1)}
    first = (bucket, 1) in {tuple(k) for k in engine._graphs.keys("full")}

    def key(pos: int) -> int:
        return _pow2(-(-pos // ps))

    limit = max_len
    for pos in range(chunk, max_len, chunk):
        if key(pos) not in suffix:
            limit = pos
            break

    def ok(c: int) -> bool:
        if c < chunk and not first:
            return False
        return all(key(pos) in suffix for pos in range(c, limit, c))

    lo = hi = chunk
    while lo - 1 > bucket // 2 and ok(lo - 1):
        lo -= 1
    while hi + 1 <= bucket and ok(hi + 1):
        hi += 1
    return lo, hi


def apply_settings(engine, settings: Dict[str, object]) -> Dict[str, object]:
    """THE apply path — the serving analogue of
    ``Controller::SynchronizeParameters``: swap knob values into a
    live engine at a tick boundary.  Caller holds the engine step lock
    (the tuner's on-tick hook runs inside :meth:`InferenceEngine.step`)
    or owns the engine exclusively (replay).  Returns what was
    actually applied."""
    applied: Dict[str, object] = {}
    cfg_updates: Dict[str, object] = {}
    for name, value in settings.items():
        if name == "max_prefills_per_tick":
            cfg_updates[name] = int(value)
            engine.scheduler.max_prefills_per_tick = int(value)
        elif name in ("prefill_chunk_tokens", "page_grant_ahead"):
            cfg_updates[name] = int(value)
        elif name == "spec_enabled":
            engine._spec_runtime_enabled = bool(value)
        else:
            continue
        applied[name] = settings[name]
    if cfg_updates:
        # EngineConfig is frozen by design — the swap is a replace +
        # reassign, atomic at the tick boundary the caller guarantees.
        engine.engine_cfg = dataclasses.replace(
            engine.engine_cfg, **cfg_updates)
    return applied
