"""Explicit message-passing transport for the shared-nothing cluster.

The paper's claims — no central metadata bottleneck, fingerprint-routed
unicasts instead of broadcasts, flag-based asynchronous consistency — are
statements about *messages between nodes*. This module makes those messages
first-class: every cluster interaction goes through ``Transport.send``,
which owns

* delivery (dispatch to the destination's ``handle(msg, recv_time, env)``),
* per-edge and per-type byte/message accounting (``EdgeStats``), and
* the message-level fault surface: pluggable delivery policies
  (``reliable`` / ``drop`` / ``delay`` / ``partition`` / ``duplicate`` /
  ``reorder`` / ``ack_loss`` / ``chaos``) plus a hook that feeds the
  cluster's fault injector a ``transport_send`` event point.

At-least-once delivery model
----------------------------

Every unicast is stamped with a cluster-unique message id and a per-edge
sequence number (``Envelope``). The receiver acks each delivery — acks cost
``ACK_MSG_BYTES`` on the reverse edge and are part of ``net_bytes`` — and
the sender runs a simulated-clock timeout/retransmission loop:

* an attempt whose message (or whose ack) is lost costs ``ack_timeout``
  simulated ticks of waiting, then the SAME envelope is retransmitted
  (``retry_budget`` times at most);
* a retransmission of a message the receiver already applied is answered
  from the receiver's bounded seen-window (idempotent re-ack) — state is
  mutated at most once per message id;
* when the budget is exhausted ``MessageDropped`` is raised carrying the
  message id and ``maybe_applied`` — True when at least one attempt reached
  the receiver (its ack was lost, or it is still in flight), which is the
  "ack lost, op applied?" ambiguity senders must reconcile (the cluster
  answers it with a conditional ``TxnCancel``).

``retry_budget=0`` (the default) preserves the legacy fire-and-forget
model: the first lost message raises immediately.

Failure semantics (deterministic, simulation-friendly):

* **drop** loses the attempt in flight — with no retry budget the sender
  sees ``MessageDropped`` at once.
* **delay** delivers immediately in simulation order but time-shifts the
  *receive timestamp* by the configured ticks. Everything the destination
  stamps with its receive time shifts with it — most visibly the async
  commit-flag flips, which become due later, so a read racing a delayed
  write exercises the paper's repair-on-read consistency check.
* **partition** drops every message between nodes in different groups
  (the external client reaches all nodes).
* **duplicate** delivers the message normally AND enqueues a second copy
  that arrives later, after subsequent traffic (a duplicated, reordered
  arrival the receiver must suppress).
* **reorder** holds the original copy back (it arrives after later
  traffic); the sender times out and retransmits, so the late original
  lands as a stale duplicate.
* **ack_drop** delivers and applies the message but loses the ack: the
  sender cannot distinguish it from a lost message and retransmits.

Held (duplicated/reordered) copies are flushed after each subsequent
``send`` and from ``Transport.advance`` (called by the cluster's tick), so
no copy is stranded in flight forever.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Mapping

from repro_torch.core.messages import ACK_MSG_BYTES, CONTROL_MSG_BYTES, Message

# policy(src, dst, msg, now) -> (action, ticks) with action one of
# "deliver" | "delay" | "drop" | "dup" | "reorder" | "ack_drop".
DeliveryPolicy = Callable[[str, str, Message, int], tuple[str, int]]


class MessageDropped(RuntimeError):
    def __init__(
        self,
        src: str,
        dst: str,
        msg: Message,
        msg_id: int = 0,
        maybe_applied: bool = False,
    ):
        state = "maybe-applied" if maybe_applied else "lost"
        super().__init__(f"{msg.TYPE} {src}->{dst} dropped ({state})")
        self.src, self.dst, self.msg = src, dst, msg
        self.msg_id = msg_id
        # True when at least one attempt reached (or will reach) the
        # receiver but its ack never came back: the op may have applied.
        self.maybe_applied = maybe_applied


@dataclass(frozen=True)
class Envelope:
    """Delivery metadata stamped on every unicast: the cluster-unique
    message id (retransmissions REUSE it — receiver dedup keys on it) and
    the per-(src, dst)-edge sequence number (reorder detection)."""

    msg_id: int
    seq: int
    src: str
    dst: str
    attempt: int = 0  # 0 = original transmission, >0 = retransmission


class SeenWindow:
    """Bounded per-receiver duplicate-suppression window: message id ->
    cached response of the first application. Retransmitted or duplicated
    deliveries of a seen id are answered from the cache without touching
    state. Bounded FIFO memory: ids older than ``capacity`` messages are
    evicted — the at-least-once guarantee holds for duplicates arriving
    within the window (sized far above the in-flight message count)."""

    _ABSENT = object()

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        # Eviction pressure (ROADMAP's seen-window sizing study): ids pushed
        # out by the bound, and the peak occupancy. At default sizing both
        # should read zero pressure — anything else means in-flight depth is
        # approaching the point where a late duplicate could slip past the
        # window and re-apply.
        self.evictions = 0
        self.high_water = 0
        self._responses: dict[int, object] = {}
        self._order: deque[int] = deque()

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, msg_id: int) -> bool:
        return msg_id in self._responses

    def get(self, msg_id: int):
        """Cached response for ``msg_id``, or ``SeenWindow.ABSENT``."""
        return self._responses.get(msg_id, self._ABSENT)

    @property
    def ABSENT(self):
        return self._ABSENT

    def record(self, msg_id: int, response) -> int:
        """Record ``msg_id``'s first response; returns the number of older
        ids the bound evicted to make room (eviction pressure)."""
        if msg_id in self._responses:
            self._responses[msg_id] = response
            return 0
        self._order.append(msg_id)
        self._responses[msg_id] = response
        evicted = 0
        while len(self._order) > self.capacity:
            self._responses.pop(self._order.popleft(), None)
            evicted += 1
        self.evictions += evicted
        self.high_water = max(self.high_water, len(self._order))
        return evicted


class BoundedIdSet:
    """Bounded FIFO membership set for message ids (the membership-only
    sibling of ``SeenWindow``): the node's poison list and the consistency
    manager's flip-registration guard. O(1) add/contains/evict."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._ids: set[int] = set()
        self._order: deque[int] = deque()

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, msg_id: int) -> bool:
        return msg_id in self._ids

    def add(self, msg_id: int) -> None:
        if msg_id in self._ids:
            return
        self._ids.add(msg_id)
        self._order.append(msg_id)
        while len(self._order) > self.capacity:
            self._ids.discard(self._order.popleft())

    def clear(self) -> None:
        self._ids.clear()
        self._order.clear()


def _policy(kind: str, lossy: bool = True):
    """Tag built-in policies so consumers (the baselines) can tell a
    reliable transport from a lossy one without executing it."""

    def tag(fn):
        fn.kind = kind
        fn.lossy = lossy
        return fn

    return tag


# --------------------------------------------------------------- policies
def reliable() -> DeliveryPolicy:
    """Every message is delivered immediately (the default)."""

    @_policy("reliable", lossy=False)
    def policy(src, dst, msg, now):
        return ("deliver", 0)

    return policy


def drop(p: float, seed: int = 0, only: tuple | None = None) -> DeliveryPolicy:
    """Drop each matching message with probability ``p`` (seeded, so runs
    are reproducible). ``only`` restricts dropping to the given message
    classes — e.g. ``only=(ChunkOpBatch,)`` to lose write batches while
    control traffic survives."""
    rng = random.Random(seed)

    @_policy("drop")
    def policy(src, dst, msg, now):
        if only is not None and not isinstance(msg, only):
            return ("deliver", 0)
        if rng.random() < p:
            return ("drop", 0)
        return ("deliver", 0)

    return policy


def delay(ticks: int, only: tuple | None = None) -> DeliveryPolicy:
    """Deliver matching messages with their receive timestamp shifted
    ``ticks`` into the future (in-flight latency). Commit-flag flips
    registered by a delayed write become due later, widening the INVALID
    window the tagged-consistency design tolerates."""

    @_policy("delay")
    def policy(src, dst, msg, now):
        if only is not None and not isinstance(msg, only):
            return ("deliver", 0)
        return ("delay", ticks)

    return policy


def partition(*groups: tuple[str, ...]) -> DeliveryPolicy:
    """Network partition: messages between nodes in different groups are
    dropped. Nodes not named in any group, and the external "client", can
    reach everyone."""
    member: dict[str, int] = {}
    for gi, g in enumerate(groups):
        for nid in g:
            member[nid] = gi

    @_policy("partition")
    def policy(src, dst, msg, now):
        gs, gd = member.get(src), member.get(dst)
        if gs is not None and gd is not None and gs != gd:
            return ("drop", 0)
        return ("deliver", 0)

    return policy


def duplicate(
    p: float, seed: int = 0, only: tuple | None = None, lag: int = 1
) -> DeliveryPolicy:
    """Deliver each matching message normally AND enqueue a second copy
    that lands ``lag`` ticks later, after subsequent traffic — a
    duplicated out-of-order arrival the receiver's seen-window must make a
    no-op. ``p=1.0`` duplicates everything (the idempotency-proof mode)."""
    rng = random.Random(seed)

    @_policy("duplicate")
    def policy(src, dst, msg, now):
        if only is not None and not isinstance(msg, only):
            return ("deliver", 0)
        if rng.random() < p:
            return ("dup", lag)
        return ("deliver", 0)

    return policy


def reorder(
    p: float, seed: int = 0, only: tuple | None = None, lag: int = 1
) -> DeliveryPolicy:
    """Hold each matching message back with probability ``p``: it arrives
    ``lag`` ticks later, AFTER traffic sent after it. The sender sees a
    timeout (no ack) and retransmits; the retransmission races the held
    original, so the receiver sees the same message id twice, out of
    order."""
    rng = random.Random(seed)

    @_policy("reorder")
    def policy(src, dst, msg, now):
        if only is not None and not isinstance(msg, only):
            return ("deliver", 0)
        if rng.random() < p:
            return ("reorder", lag)
        return ("deliver", 0)

    return policy


def ack_loss(p: float, seed: int = 0, only: tuple | None = None) -> DeliveryPolicy:
    """Deliver and APPLY each matching message but lose its ack with
    probability ``p``. Indistinguishable from a lost message at the
    sender, which times out and retransmits — the receiver answers the
    retransmission from its seen-window without re-applying."""
    rng = random.Random(seed)

    @_policy("ack_loss")
    def policy(src, dst, msg, now):
        if only is not None and not isinstance(msg, only):
            return ("deliver", 0)
        if rng.random() < p:
            return ("ack_drop", 0)
        return ("deliver", 0)

    return policy


def chaos(
    seed: int = 0,
    p_drop: float = 0.1,
    p_dup: float = 0.1,
    p_reorder: float = 0.1,
    p_ack_drop: float = 0.1,
    only: tuple | None = None,
    lag: int = 1,
) -> DeliveryPolicy:
    """Composite randomized policy: each matching attempt independently
    drops, duplicates, reorders, loses its ack, or delivers cleanly —
    one seeded RNG, so a schedule is reproducible from its seed."""
    rng = random.Random(seed)

    @_policy("chaos")
    def policy(src, dst, msg, now):
        if only is not None and not isinstance(msg, only):
            return ("deliver", 0)
        r = rng.random()
        if r < p_drop:
            return ("drop", 0)
        r -= p_drop
        if r < p_dup:
            return ("dup", lag)
        r -= p_dup
        if r < p_reorder:
            return ("reorder", lag)
        r -= p_reorder
        if r < p_ack_drop:
            return ("ack_drop", 0)
        return ("deliver", 0)

    return policy


# -------------------------------------------------------------- accounting
@dataclass
class EdgeStats:
    msgs: int = 0
    wire_bytes: int = 0
    payload_bytes: int = 0
    dropped: int = 0
    delayed: int = 0
    retransmits: int = 0
    duplicates: int = 0     # extra copies enqueued by a `duplicate` policy
    reordered: int = 0      # originals held back by a `reorder` policy
    acks: int = 0           # acks sent on THIS edge (reverse of the data edge)
    acks_dropped: int = 0
    next_seq: int = 0       # per-edge sequence counter (stamped on envelopes)


@dataclass
class _Held:
    """A copy in flight: delivered after later traffic (reordering)."""

    env: Envelope
    msg: Message
    recv_time: int
    release_after: int  # global send counter this copy must let pass first


@dataclass
class Transport:
    """Message delivery + accounting between cluster participants.

    ``handlers`` maps participant id -> object with
    ``.handle(msg, now, env)`` (and optionally ``.alive``). The cluster
    passes its live ``nodes`` dict, so topology changes are visible without
    re-registration.

    ``retry_budget`` retransmissions (same message id) follow a lost attempt
    after ``ack_timeout`` simulated ticks each; 0 keeps the legacy
    fire-and-forget behavior.
    """

    handlers: Mapping[str, object] = field(default_factory=dict)
    # Non-node participants (client sessions with a presence cache) register
    # here under their session id; consulted only when ``handlers`` has no
    # entry for the destination, so node ids always win and an empty dict
    # keeps the legacy single-map behavior byte-identical.
    extra_handlers: dict[str, object] = field(default_factory=dict)
    policy: DeliveryPolicy = field(default_factory=reliable)
    retry_budget: int = 0
    ack_timeout: int = 2
    # optional cluster fault hook: (event, ctx_dict) -> None
    fault_hook: Callable[[str, dict], None] | None = None

    edges: dict[tuple[str, str], EdgeStats] = field(default_factory=dict)
    msgs_by_type: dict[str, int] = field(default_factory=dict)
    messages_sent: int = 0          # logical sends: ClusterStats.control_msgs
    net_bytes: int = 0              # payload + ack bytes on the wire
    wire_bytes: int = 0             # net_bytes + CONTROL_MSG_BYTES headers
    lookup_unicasts: int = 0        # CIT lookups carried (always unicast)
    lookup_broadcasts: int = 0      # never incremented — the paper's point
    dropped: int = 0
    delayed: int = 0
    deliveries: int = 0             # handler invocations (incl. dup/late copies)
    retransmits: int = 0            # wire-level re-sends (not in messages_sent)
    acks_sent: int = 0
    ack_bytes: int = 0
    acks_dropped: int = 0
    duplicates: int = 0             # extra copies enqueued by `duplicate`
    reordered: int = 0              # originals held back by `reorder`
    late_deliveries: int = 0        # held copies flushed after later traffic
    late_delivery_errors: int = 0   # held copies lost to a dead/raising handler
    timeout_ticks_waited: int = 0   # simulated ticks spent waiting on lost acks
    _msg_counter: int = 0
    _send_counter: int = 0
    _held: list[_Held] = field(default_factory=list)

    def edge(self, src: str, dst: str) -> EdgeStats:
        e = self.edges.get((src, dst))
        if e is None:
            e = self.edges[(src, dst)] = EdgeStats()
        return e

    # ----------------------------------------------------------- delivery
    def send(self, src: str, dst: str, msg: Message, now: int):
        """At-least-once unicast: deliver ``msg`` to ``dst`` and return the
        handler's response (the ack carries it).

        One logical send; up to ``retry_budget`` retransmissions of the
        same envelope chase a lost message or lost ack, each costing
        ``ack_timeout`` simulated ticks of sender waiting. Raises
        ``MessageDropped`` when the budget is exhausted (``maybe_applied``
        distinguishes "no attempt reached the receiver" from "an attempt
        reached it but its ack never came back"), or whatever the
        destination handler raises (``NodeDown``, ``ChunkMissing``, ...).
        Accounting: the logical send is counted unconditionally; payload
        and ack bytes only on delivered attempts.
        """
        self._msg_counter += 1
        self._send_counter += 1
        send_order = self._send_counter
        edge = self.edge(src, dst)
        env = Envelope(self._msg_counter, edge.next_seq, src, dst)
        edge.next_seq += 1
        edge.msgs += 1
        self.messages_sent += 1
        self.msgs_by_type[msg.TYPE] = self.msgs_by_type.get(msg.TYPE, 0) + 1
        self.lookup_unicasts += msg.lookups()
        if self.fault_hook is not None:
            self.fault_hook(
                "transport_send", {"src": src, "dst": dst, "type": msg.TYPE}
            )
        maybe_applied = False
        try:
            for attempt in range(self.retry_budget + 1):
                attempt_now = now + attempt * self.ack_timeout
                if attempt > 0:
                    edge.retransmits += 1
                    self.retransmits += 1
                    self.timeout_ticks_waited += self.ack_timeout
                action, ticks = self.policy(src, dst, msg, attempt_now)
                if action == "drop":
                    edge.dropped += 1
                    self.dropped += 1
                    continue  # wait out the ack timeout, retransmit
                if action == "reorder":
                    # The copy WILL arrive — late, after subsequent traffic.
                    # The sender cannot know that: it times out like a drop.
                    self._hold(env, msg, attempt_now + max(1, ticks), send_order)
                    edge.reordered += 1
                    self.reordered += 1
                    maybe_applied = True
                    continue
                recv_time = attempt_now + (ticks if action == "delay" else 0)
                if action == "delay":
                    edge.delayed += 1
                    self.delayed += 1
                attempt_env = Envelope(env.msg_id, env.seq, src, dst, attempt)
                response = self._deliver(attempt_env, msg, recv_time)
                if action == "dup":
                    # A second copy of the same envelope lands later, after
                    # subsequent traffic (duplicated + reordered arrival).
                    self._hold(env, msg, recv_time + max(1, ticks), send_order)
                    edge.duplicates += 1
                    self.duplicates += 1
                if action == "ack_drop":
                    # Applied at the receiver, but the sender never learns:
                    # the ack is lost in flight.
                    edge_rev = self.edge(dst, src)
                    edge_rev.acks_dropped += 1
                    self.acks_dropped += 1
                    maybe_applied = True
                    continue  # timeout, retransmit the same envelope
                return response
        finally:
            self._flush_held(send_order)
        # The final attempt's ack never came either: the sender waits out
        # one more timeout before concluding failure.
        self.timeout_ticks_waited += self.ack_timeout
        raise MessageDropped(src, dst, msg, env.msg_id, maybe_applied)

    def _deliver(self, env: Envelope, msg: Message, recv_time: int):
        """One attempt reaching the receiver: dispatch + wire accounting
        for the request payload and the ack flowing back."""
        handler = self.handlers.get(env.dst)
        if handler is None:
            handler = self.extra_handlers[env.dst]
        response = handler.handle(msg, recv_time, env)
        self.deliveries += 1
        edge = self.edge(env.src, env.dst)
        payload = msg.payload_bytes(env.dst, response) + msg.response_payload_bytes(
            response
        )
        edge.payload_bytes += payload
        edge.wire_bytes += CONTROL_MSG_BYTES + payload
        self.wire_bytes += CONTROL_MSG_BYTES + payload
        self.net_bytes += payload
        # The ack: ACK_MSG_BYTES on the reverse edge, part of net_bytes.
        rev = self.edge(env.dst, env.src)
        rev.acks += 1
        rev.wire_bytes += ACK_MSG_BYTES
        rev.payload_bytes += ACK_MSG_BYTES
        self.acks_sent += 1
        self.ack_bytes += ACK_MSG_BYTES
        self.wire_bytes += ACK_MSG_BYTES
        self.net_bytes += ACK_MSG_BYTES
        return response

    # ----------------------------------------------- in-flight (held) copies
    def _hold(self, env: Envelope, msg: Message, recv_time: int, send_order: int) -> None:
        self._held.append(_Held(env, msg, recv_time, send_order))

    def _flush_held(self, upto_send: int) -> None:
        """Deliver held copies whose reorder window has passed: a copy held
        during send N lands at the end of send N+1 (or on ``advance``) —
        i.e. strictly after the traffic that overtook it."""
        if not self._held:
            return
        due = [h for h in self._held if h.release_after < upto_send]
        if not due:
            return
        self._held = [h for h in self._held if h.release_after >= upto_send]
        for h in due:
            self._deliver_late(h)

    def advance(self, now: int) -> int:
        """Time passes (cluster tick): every copy still in flight lands.
        Returns the number of late deliveries."""
        held, self._held = self._held, []
        for h in held:
            self._deliver_late(h, now)
        return len(held)

    def _deliver_late(self, h: _Held, now: int | None = None) -> None:
        """A late (duplicated/reordered) copy arrives. Nobody awaits its
        ack — the original sender moved on — so errors are swallowed: a
        copy landing on a crashed node is simply lost."""
        self.late_deliveries += 1
        recv_time = h.recv_time if now is None else max(h.recv_time, now)
        try:
            self._deliver(h.env, h.msg, recv_time)
        except Exception:
            self.late_delivery_errors += 1

    def client_transfer(self, dst: str, nbytes: int, src: str = "client") -> None:
        """Object-ingress accounting: a client ships object bytes to a
        primary OSS. Modeled as pure data transfer (no control message, no
        ack), exactly as in the pre-transport accounting; delivery policies
        do not apply to the external client's ingress path. ``src`` names
        the client endpoint — distinct per-session names (``c0``, ``c1``,
        ...) give concurrent sessions their own ingress edges."""
        edge = self.edge(src, dst)
        edge.payload_bytes += nbytes
        edge.wire_bytes += nbytes
        self.wire_bytes += nbytes
        self.net_bytes += nbytes

    def in_flight_copies(self) -> int:
        """Held (duplicated/reordered) copies not yet delivered — the
        scheduler's quiescence probe: the simulation is quiet only when no
        actor is runnable AND nothing is still on the wire."""
        return len(self._held)
