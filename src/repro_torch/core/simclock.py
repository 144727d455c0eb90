"""SimClock + deterministic Scheduler — the discrete-event simulation core.

Before this module, execution was call-driven: the test harness (or a
bench) called ``cluster.tick()``, ``run_gc()``, ``RepairDaemon.step()``
and each client's writes in whatever order it remembered, so exactly one
thing ever ran "at a time" and the per-edge stats / straggler-NIC model
had no concurrency to measure (ROADMAP item 1). The Scheduler inverts
that: client sessions, GC sweeps, repair rounds and time advancement are
all *actors* on one event heap, and the Scheduler alone advances the
cluster clock (``cluster.tick`` — which drains ``Transport.advance``
late-delivery copies and every node's ConsistencyManager flip queue)
between events. N client sessions genuinely interleave: wave k of
session A is in flight (sent, un-committed) while session B chunks and
sends its own wave at the same tick.

Determinism argument (the property every test leans on):

* the event heap orders by ``(time, tiebreak, seq)`` where ``tiebreak``
  is drawn from a ``random.Random(seed)`` at push time and ``seq`` is a
  monotonic push counter — so ties at one tick are broken by the seeded
  stream, reproducibly, and two runs with the same seed pop events in
  the identical order;
* actors are cooperative generators — no threads, no wall clock, no OS
  scheduling anywhere;
* everything else in the system is already deterministic (seeded
  delivery policies, insertion-ordered dicts, no hash-order iteration).

Same seed ⇒ identical event log, stats snapshot and final cluster state;
a different seed is a different legal interleaving of the same ops —
which must (and does: tests/test_workload.py) converge to the same
per-name winners after recovery, because commit authority is the
cluster-monotonic version counter, not arrival order.

Retransmission timeouts stay *inside* ``Transport.send`` (a sender
synchronously waits out ``ack_timeout`` ticks per attempt, booked in
``timeout_ticks_waited``): hoisting them onto the heap would change the
message sequence of every existing chaos schedule, and the parity pin —
single-session scheduled runs must be message-identical to the
call-driven path — forbids that. The send-level wait models a blocked
client thread, which is exactly what it is.

Clock skew: ``SimClock`` carries per-node bounded offsets mirroring
``StorageNode.clock_offset`` (configure both via
``Scheduler.set_clock_skew`` / ``DedupCluster.set_clock_skew``). Offsets
apply ONLY where a real deployment would read a wall clock — tombstone
``deleted_at`` stamping and tombstone aging — never to delivery order or
version authority. See docs/concurrency.md.
"""

from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field


@dataclass
class SimClock:
    """Monotonic simulated event time plus per-node bounded clock offsets.

    ``now`` is the single event-time axis every actor shares; a node's
    *local* clock reads ``node_now(nid) = now + offsets[nid]`` (the
    skewed reading ``StorageNode.local_now`` applies to tombstone
    stamping/aging). ``max_skew`` is the bound the reap guard widens the
    GC horizon by."""

    now: int = 0
    offsets: dict[str, int] = field(default_factory=dict)

    def advance(self, dt: int) -> int:
        if dt < 0:
            raise ValueError("SimClock is monotonic: dt must be >= 0")
        self.now += dt
        return self.now

    def node_now(self, nid: str) -> int:
        return self.now + self.offsets.get(nid, 0)

    @property
    def max_skew(self) -> int:
        return max((abs(v) for v in self.offsets.values()), default=0)


@dataclass(order=True)
class _Event:
    time: int
    tiebreak: float
    seq: int
    name: str = field(compare=False)


class Scheduler:
    """Deterministic discrete-event scheduler over one ``DedupCluster``.

    Actors are generators yielding integer tick delays (``yield 3`` =
    "resume me 3 ticks from now"; a bare ``yield`` means 1). ``spawn``
    registers a one-shot actor (runs to ``StopIteration``; its return
    value lands in ``results[name]``); ``every`` registers a recurring
    actor around a plain callable (GC sweep, ``RepairDaemon.step``).

    ``run()`` is run-to-quiescence: process events until no ONE-SHOT
    actor remains runnable (recurring actors alone don't keep the
    simulation alive — they exist to interleave with the real work),
    then keep ticking until the wire is quiet (no held transport copies)
    and every live node's flip queue is drained. ``run_until(t)``
    processes everything due through ``t`` and leaves the clock there.

    The event log records, per actor step, ``(time, actor, in-flight
    session labels)`` — the labels are the registered sessions whose
    ``in_flight`` flag was set *after* the step, so
    ``max_in_flight_sessions >= 2`` is the witness that two sessions
    had sent-but-uncommitted waves at the same tick (the acceptance
    criterion's interleaving proof)."""

    def __init__(self, cluster, seed: int = 0):
        self.cluster = cluster
        self.seed = seed
        self.clock = SimClock(
            now=cluster.now,
            offsets={
                nid: n.clock_offset
                for nid, n in cluster.nodes.items()
                if n.clock_offset
            },
        )
        self._rng = random.Random(seed)
        self._heap: list[_Event] = []
        self._actors: dict[str, object] = {}      # name -> generator
        self._recurring: set[str] = set()
        self._sessions: dict[str, object] = {}    # label -> DedupClient
        self._seq = 0
        self._live_oneshot = 0
        self.results: dict[str, object] = {}
        self.errors: dict[str, Exception] = {}
        self.event_log: list[tuple[int, str, tuple[str, ...]]] = []
        self.steps = 0

    # ------------------------------------------------------------- registration
    def spawn(self, gen, name: str, delay: int = 0, session=None) -> None:
        """Register a one-shot generator actor; first step after ``delay``
        ticks. ``session`` (a ``DedupClient``) makes the actor's session
        visible to the in-flight log under label ``name``."""
        if name in self._actors:
            raise ValueError(f"actor {name!r} already registered")
        self._actors[name] = gen
        if session is not None:
            self._sessions[name] = session
        self._live_oneshot += 1
        self._push(self.cluster.now + max(0, delay), name)

    def every(self, interval: int, fn, name: str, start: int | None = None) -> None:
        """Register a recurring actor: call ``fn()`` every ``interval``
        ticks (first call after ``start`` ticks, default one interval).
        Recurring actors interleave with session actors but do not keep
        ``run()`` alive on their own."""
        if interval <= 0:
            raise ValueError("recurring interval must be positive")

        def _loop():
            while True:
                fn()
                yield interval

        if name in self._actors:
            raise ValueError(f"actor {name!r} already registered")
        self._actors[name] = _loop()
        self._recurring.add(name)
        self._push(
            self.cluster.now + (interval if start is None else max(0, start)), name
        )

    def set_clock_skew(self, offsets: dict[str, int], guard: bool = True) -> int:
        """Install bounded per-node clock offsets on the cluster (see
        ``DedupCluster.set_clock_skew``) and mirror them on ``clock``."""
        self.clock.offsets = {k: v for k, v in offsets.items() if v}
        return self.cluster.set_clock_skew(offsets, guard=guard)

    # ------------------------------------------------------------------ running
    def run(self, max_time: int = 1_000_000) -> dict:
        """Run to quiescence (see class docstring). Returns ``results``."""
        while self._live_oneshot > 0 and self._heap:
            if self._heap[0].time > max_time:
                raise RuntimeError(
                    f"scheduler exceeded max_time={max_time} with "
                    f"{self._live_oneshot} one-shot actor(s) still live"
                )
            self._step()
        self._settle(max_time)
        return self.results

    def run_until(self, t_end: int) -> dict:
        """Process every event due at or before ``t_end``, then advance
        the clock to exactly ``t_end`` (late copies land, flip queues
        drain through that tick)."""
        while self._heap and self._heap[0].time <= t_end:
            self._step()
        self._advance_to(t_end)
        return self.results

    @property
    def max_in_flight_sessions(self) -> int:
        """Peak count of sessions with a sent-but-uncommitted wave at one
        logged step — >= 2 proves genuine interleaving."""
        return max((len(e[2]) for e in self.event_log), default=0)

    # ---------------------------------------------------------------- internals
    def _push(self, t: int, name: str) -> None:
        self._seq += 1
        heapq.heappush(self._heap, _Event(t, self._rng.random(), self._seq, name))

    def _advance_to(self, t: int) -> None:
        c = self.cluster
        if t > c.now:
            c.tick(t - c.now)
        self.clock.now = c.now

    def _in_flight_labels(self) -> tuple[str, ...]:
        return tuple(
            sorted(
                label
                for label, s in self._sessions.items()
                if getattr(s, "in_flight", 0)
            )
        )

    def _step(self) -> None:
        ev = heapq.heappop(self._heap)
        gen = self._actors.get(ev.name)
        if gen is None:
            return  # actor already finished/failed (stale heap entry)
        self._advance_to(ev.time)
        self.steps += 1
        recurring = ev.name in self._recurring
        try:
            delay = next(gen)
        except StopIteration as stop:
            self.results[ev.name] = stop.value
            self._retire(ev.name, recurring)
        except Exception as exc:  # actor died: record, don't kill the sim
            self.errors[ev.name] = exc
            self._retire(ev.name, recurring)
        else:
            self._push(ev.time + max(1, int(delay) if delay is not None else 1),
                       ev.name)
        self.event_log.append((ev.time, ev.name, self._in_flight_labels()))

    def _retire(self, name: str, recurring: bool) -> None:
        del self._actors[name]
        if recurring:
            self._recurring.discard(name)
        else:
            self._live_oneshot -= 1

    def _settle(self, max_time: int) -> None:
        """Quiescence tail: tick until nothing is on the wire and every
        live node's consistency queue is drained (bounded by the pending
        flips' own due-times plus one tick per held copy, so this cannot
        spin)."""
        c = self.cluster
        guard = 0
        while c.now < max_time and guard < 10_000:
            held = c.transport.in_flight_copies()
            pending = [
                n.cm.next_due() for n in c.nodes.values() if n.alive and n.cm.pending()
            ]
            if not held and not pending:
                break
            target = c.now + 1
            due = [d for d in pending if d is not None]
            if not held and due:
                target = max(target, min(due))
            self._advance_to(min(target, max_time))
            guard += 1
        self.clock.now = c.now
