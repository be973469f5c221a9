"""Host-side TCP collective transport: the Linker analog.

Port of lightgbm_tpu/parallel/transport.py: numpy over sockets, the
module, its wire protocol (v2 frames, CRC, sequence numbers), its
fault seams and its telemetry names are the JAX package's, so a port
process and the JAX package's codec agree bit for bit.

The reference LightGBM runs ``data_parallel`` training over real
process boundaries through its socket/MPI ``Linkers``
(src/network/linkers_socket.cpp:20-78 TCP-mesh construction,
src/network/network.cpp Bruck allgather + recursive-halving
allreduce).  This module is that layer for the port: a
coordinator-rendezvous TCP transport over persistent peer sockets and
length-prefixed frames, implementing

* **Bruck-style allgather** (log2(P) rounds over byte blocks, so
  variable-length payloads — pickled candidate sets, bin shards —
  gather without padding),
* **ring allreduce** (reduce-scatter + allgather rings for integer
  payloads — order-independent, therefore EXACT; float payloads take
  the gather + rank-ordered ``np.sum(np.stack(...))`` route instead,
  which is bit-identical to ``HostCollectives``' simulated reduction
  and deterministic across runs), and
* **ring reduce-scatter** (rank ``r`` ends with chunk ``r`` of the
  world sum).

Selection rides ``Config.collective_transport``:

* ``tcp``  — this transport (host-side numpy collectives); every
  process runs the single-device program on the replicated bins,
* ``auto`` — TCP for a world above one process where the device
  plane cannot run (``device=cpu``, or no NCCL), else ``xla``,
* ``xla``  — the cross-process device plane: in the port
  ``torch.distributed`` (NCCL across cards, gloo on the CPU), each
  process holding only its own rows of the bin matrix
  (parallel/distributed.py).

Reliability contract: every communication round fires the
``transport.round`` fault seam (``peer_drop``/``peer_slow`` chaos
actions land here) and, with ``watchdog_collective_s`` armed, bounds
its socket waits by the collective deadline — a hung peer surfaces as
a retry-transient :class:`~..reliability.watchdog.StallError` with
all-thread stacks dumped, a DEAD peer (reset/EOF) as
:class:`TransportPeerLost` (a ``ConnectionError``, so the retry
machinery classifies it transient; the epoch protocol below is the
actual recovery path).  Rendezvous/mesh connects fire
``transport.connect`` and retry under the config's bounded policy.

Elastic membership (the :class:`WorldLedger` epoch protocol): the
coordinator (rank 0) owns the membership ledger.  ``epoch_tick()`` is
a control-plane barrier every participant enters between training
iterations (``Config.transport_epoch_iters``); the coordinator
collects one TICK per live member, notices dead members (their
control socket EOFs) and pending JOIN requests, and — only at this
boundary — publishes a new ledger: survivors drop the dead ranks
(degraded continuation per ``sharded_allow_degraded``), joiners are
admitted with a fresh rank plus a HANDOFF payload (caller-provided
state bytes, e.g. a pickled ``GBDT.capture_state``, plus the
r16 shard-cache manifest location), and every member rebuilds the
peer mesh for the new epoch.  Between boundaries the mesh is static,
so collectives never race a membership change.

Observability: ``collective_tcp_bytes`` / ``collective_tcp_rounds``
counters (plus per-primitive ``collective_tcp_<primitive>_*``
splits), the ``collective_tcp_round_ms`` latency histogram, and the
``collective_tcp_world`` gauge (docs/OBSERVABILITY.md).
"""
from __future__ import annotations

import collections
import pickle
import select
import socket
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils.log import Log

TRANSPORT_MODES = ("auto", "xla", "tcp")

# wire protocol v2: every frame is
#   magic(u16) | ver(u8) | tag(u8) | seq(u32) | len(u32) | crc32(u32)
# The CRC covers the payload (crc 0 = unprotected frame, the bench's
# overhead-measurement mode); seq is a per-peer DATA-frame sequence
# number (control frames carry 0) — a reconnect re-sends the same seq,
# and the receiver's dup-discard makes the retried round idempotent.
# A v1 peer's 8-byte header parses here as ver 0 -> the version-skew
# refusal below, not a silent desync.
PROTOCOL_VERSION = 2
_MAGIC = 0x4C54                       # "LT"
_HDR = struct.Struct(">HBBIII")
# CRC verification toggle — module-level so the distributed_exchange
# bench can measure the wire path with integrity off; everything else
# runs with it ON
_FRAME_CRC = True
# frame tags (unchanged since wire v1)
TAG_DATA = 1        # collective payload
TAG_HELLO = 2       # rendezvous: rank announces its data listener
TAG_ROSTER = 3      # coordinator -> members: the epoch-0 ledger
TAG_IDENT = 4       # mesh: connecting peer announces its rank
TAG_TICK = 5        # member -> coordinator epoch barrier entry
TAG_DIRECTIVE = 6   # coordinator -> member/joiner: ledger for the
                    # next epoch (carries the receiver's rank)
TAG_JOIN = 7        # joiner -> coordinator admission request
TAG_HANDOFF = 8     # coordinator -> joiner: state + manifest handoff

# control-plane waits (rendezvous, tick collection) fall back to this
# when no collective deadline is armed; a JOIN waits longer — it
# blocks until the running world reaches its next epoch boundary
_CTRL_TIMEOUT_S = 120.0
_JOIN_TIMEOUT_S = 600.0
# after EOF on a member's control socket the coordinator waits this
# long for the member to re-home on a fresh connection (a control-plane
# blip) before declaring it dead; bounded by the collective budget
_REHOME_GRACE_S = 2.0
# single-candidate dial timeout during failover walks / reconnects —
# a dead process refuses instantly, this only bounds a wedged host
_DIAL_TIMEOUT_S = 5.0


class TransportError(ConnectionError):
    """TCP transport failure (rendezvous, framing, protocol)."""


class TransportPeerLost(TransportError):
    """A peer died mid-collective (reset/EOF on its socket).  A
    ``ConnectionError`` subclass ON PURPOSE: ``retry.is_transient``
    classifies it retryable, and the epoch protocol (``epoch_tick``
    with ``allow_degraded``) is the recovery path that actually
    removes the corpse from the world."""

    def __init__(self, rank: Optional[int], detail: str = ""):
        self.peer_rank = rank
        who = f"peer rank {rank}" if rank is not None else "peer"
        super().__init__(
            f"{who} lost mid-collective"
            + (f": {detail}" if detail else "")
            + " — survivors reform at the next epoch boundary "
              "(epoch_tick; docs/RELIABILITY.md peer-death row)")


class FrameCorrupt(TransportError):
    """A received frame failed its CRC32 payload check.  Counted as
    ``collective_tcp_crc_errors`` and journaled (kind ``crc_error``)
    at the receive site; a corrupt DATA frame converts to a clean
    in-epoch reconnect + idempotent resend, a corrupt CONTROL frame
    stays loud."""

    def __init__(self, tag: int, peer, want: int, got: int):
        self.tag = tag
        self.peer = peer
        super().__init__(
            f"frame CRC mismatch on tag {tag} from peer {peer}: "
            f"header crc 0x{want:08x}, payload crc 0x{got:08x} — "
            "bytes were corrupted in flight (never applied; "
            "docs/RELIABILITY.md frame-integrity row)")


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------
# payload-digest fold threshold: frames below it get a plain crc32;
# larger frames get the crc32 of their 64-bit XOR word-fold (+ tail
# bytes), which runs at memory bandwidth (~30x software crc32 here) —
# that is what keeps integrity-on inside the distributed_exchange
# bench's <2% q16 wire-path budget.  The fold catches any single-bit
# flip (and any odd number of flips per bit column); uncorrelated
# multi-word corruption escapes with ~2^-64 fold-collision odds.
_CRC_FOLD_MIN = 4096


def _payload_crc(payload: bytes) -> int:
    """The 4-byte header digest over ``payload`` (see fold note
    above).  Both ends compute the same function, so the header field
    stays a plain u32 checksum."""
    if len(payload) < _CRC_FOLD_MIN:
        return zlib.crc32(payload) & 0xFFFFFFFF
    n = len(payload) & ~7
    words = np.frombuffer(payload, dtype="<u8", count=n // 8)
    fold = int(np.bitwise_xor.reduce(words))
    crc = zlib.crc32(fold.to_bytes(8, "little"))
    return zlib.crc32(payload[n:], crc) & 0xFFFFFFFF


def _send_frame(sock: socket.socket, tag: int, payload: bytes,
                seq: int = 0) -> int:
    crc = _payload_crc(payload) if _FRAME_CRC else 0
    sock.sendall(_HDR.pack(_MAGIC, PROTOCOL_VERSION, tag, seq,
                           len(payload), crc) + payload)
    return len(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportError(
                "connection closed mid-frame (peer died or was "
                "dropped)")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket,
                expect_tag: Optional[int] = None,
                peer="?") -> Tuple[int, int, bytes]:
    """Read one frame -> (tag, seq, payload).  Verifies magic, then
    protocol version (BEFORE trusting the length field — a skewed
    peer's header is not laid out like ours), then the payload CRC."""
    magic, ver, tag, seq, n, crc = _HDR.unpack(
        _recv_exact(sock, _HDR.size))
    if magic != _MAGIC:
        raise TransportError(
            f"bad frame magic 0x{magic:04x} (expected 0x{_MAGIC:04x}) "
            "— not a lightgbm_tpu transport peer, or a desynchronized "
            "stream")
    if ver != PROTOCOL_VERSION:
        raise TransportError(
            f"transport protocol version mismatch: peer {peer} speaks "
            f"v{ver}, this process speaks v{PROTOCOL_VERSION} — "
            "upgrade skew across the world (a rolling restart must "
            "finish before mixed versions exchange frames; restart "
            "the older participant on the current build)")
    if expect_tag is not None and tag != expect_tag:
        raise TransportError(
            f"unexpected frame tag {tag} (expected {expect_tag})")
    payload = _recv_exact(sock, n)
    if _FRAME_CRC and crc != 0:
        got = _payload_crc(payload)
        if got != crc:
            from ..telemetry import TELEMETRY
            TELEMETRY.add("collective_tcp_crc_errors", 1)
            TELEMETRY.journal.emit(
                "crc_error", seam="transport.round", tag=tag,
                peer=str(peer), seq=seq, nbytes=n)
            raise FrameCorrupt(tag, peer, crc, got)
    return tag, seq, payload


def _refuse_skew(payload: dict, who: str) -> None:
    """Handshake-level (HELLO/IDENT/TICK) protocol-version refusal —
    the frame layer already rejects skewed headers; this catches a
    same-header build whose PAYLOAD contract moved."""
    ver = int(payload.get("ver", 0))
    if ver != PROTOCOL_VERSION:
        raise TransportError(
            f"{who} announced transport protocol v{ver}, this process "
            f"speaks v{PROTOCOL_VERSION} — upgrade skew: finish the "
            "rolling restart (restart the older participant) before "
            "it joins the world")


def _obj_frame(obj) -> bytes:
    return pickle.dumps(obj, protocol=4)


# ---------------------------------------------------------------------------
# world ledger
# ---------------------------------------------------------------------------
class WorldLedger:
    """Epoch-versioned membership: ``{rank: (host, data_port)}`` plus
    the epoch counter.  Immutable — ``degrade``/``admit`` return the
    NEXT epoch's ledger, so a collective in flight can never observe a
    half-applied membership change."""

    __slots__ = ("members", "epoch", "next_rank")

    def __init__(self, members: Dict[int, Tuple[str, int]],
                 epoch: int = 0, next_rank: Optional[int] = None):
        self.members = {int(r): (str(h), int(p))
                        for r, (h, p) in members.items()}
        self.epoch = int(epoch)
        # the high-water rank: survives degrades, so a retired rank is
        # never handed to a later joiner
        floor = (max(self.members) + 1) if self.members else 0
        self.next_rank = max(floor, int(next_rank or 0))

    @property
    def world_size(self) -> int:
        return len(self.members)

    def ranks(self) -> List[int]:
        return sorted(self.members)

    def degrade(self, dead: List[int]) -> "WorldLedger":
        """Next epoch's ledger with ``dead`` ranks retired.  Retired
        ranks are never reused — a recovered participant re-joins
        under a FRESH rank, so a stale frame from the corpse can
        never be attributed to its successor."""
        dead = set(int(d) for d in dead)
        left = {r: a for r, a in self.members.items() if r not in dead}
        if not left:
            raise TransportError(
                "ledger degrade would leave an empty world")
        return WorldLedger(left, self.epoch + 1,
                           next_rank=self.next_rank)

    def admit(self, addrs: List[Tuple[str, int]]
              ) -> Tuple["WorldLedger", List[int]]:
        """Next epoch's ledger with one fresh rank per joiner address;
        returns (ledger, assigned ranks)."""
        nxt = self.next_rank
        members = dict(self.members)
        assigned = []
        for a in addrs:
            members[nxt] = (str(a[0]), int(a[1]))
            assigned.append(nxt)
            nxt += 1
        return WorldLedger(members, self.epoch + 1,
                           next_rank=nxt), assigned

    def to_state(self) -> dict:
        return {"epoch": self.epoch, "next_rank": self.next_rank,
                "members": {str(r): list(a)
                            for r, a in self.members.items()}}

    @classmethod
    def from_state(cls, state: dict) -> "WorldLedger":
        return cls({int(r): (a[0], int(a[1]))
                    for r, a in state["members"].items()},
                   epoch=int(state["epoch"]),
                   next_rank=int(state.get("next_rank", 0)))

    def __repr__(self):
        return (f"WorldLedger(epoch={self.epoch}, "
                f"members={self.members})")


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------
class TcpTransport:
    """Persistent-socket TCP collective transport over one
    :class:`WorldLedger` epoch.  Create with :meth:`create` (founding
    members) or :meth:`join` (elastic re-join into a running world).
    """

    def __init__(self):
        self.rank: int = 0
        self.ledger: WorldLedger = WorldLedger({0: ("localhost", 0)})
        self.epoch_every: int = 1
        # fleet trace id (docs/OBSERVABILITY.md, Tracing): minted by
        # the coordinator at rendezvous and distributed with the
        # roster/directives, so collective rounds, epoch ticks and
        # join/handoff exchanges on DIFFERENT hosts tag their spans
        # and journal events with one shared trace
        self.trace_id: str = ""
        # handoff metadata published to joiners (e.g. the shard-cache
        # manifest directory); coordinator-side, caller-settable
        self.handoff_meta: dict = {}
        # a joiner's received handoff: {"meta": dict, "state": bytes}
        self.handoff: Optional[dict] = None
        self._ctrl: Dict[int, socket.socket] = {}   # coordinator only
        self._coord_sock: Optional[socket.socket] = None  # members
        self._ctrl_listener: Optional[socket.socket] = None
        self._data_listener: Optional[socket.socket] = None
        self._peers: Dict[int, socket.socket] = {}
        self._my_addr: Tuple[str, int] = ("localhost", 0)
        self._retry_policy = None
        self._lock = threading.Lock()
        self._closed = False
        # the coordinator is ALWAYS the lowest rank in the ledger
        # (founding coordinator is rank 0; joiners only ever get fresh
        # higher ranks) — so the successor after a coordinator death
        # is named by the replicated ledger itself, no election
        self._coord_rank: int = 0
        # reconnect dials per blip before TransportPeerLost/degrade
        self.reconnect_retries: int = 3
        # per-peer DATA-frame sequence state (reset at epoch flips,
        # KEPT across in-epoch reconnects — that continuity is what
        # makes a re-sent round idempotent)
        self._send_seq: Dict[int, int] = {}
        self._recv_seq: Dict[int, int] = {}
        # the last few DATA frames sent per peer, for resend after a
        # reconnect (a sender runs at most one round ahead of a
        # receiver, so a short log always covers the unacked window)
        self._sent_log: Dict[int, collections.deque] = {}
        # JOIN connections that arrived on the data listener outside a
        # tick (a joiner walking the ledger) — served at the next tick
        self._pending_joins: List[Tuple[socket.socket, dict]] = []

    # -- identity -----------------------------------------------------
    @property
    def world_size(self) -> int:
        return self.ledger.world_size

    @property
    def epoch(self) -> int:
        return self.ledger.epoch

    @property
    def is_coordinator(self) -> bool:
        return self.rank == self._coord_rank

    # -- construction -------------------------------------------------
    @classmethod
    def create(cls, coordinator_address: str, num_processes: int,
               process_id: int, config=None,
               bind_host: Optional[str] = None) -> "TcpTransport":
        """Founding rendezvous (the Linkers ctor / mlist.txt role of
        ``coordinator_address``): rank 0 listens there, every other
        rank connects, announces its data listener, and receives the
        epoch-0 roster; then the full peer mesh is built."""
        if num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got "
                             f"{num_processes}")
        if not (0 <= process_id < num_processes):
            raise ValueError(f"process_id {process_id} outside world "
                             f"of {num_processes}")
        self = cls()
        self.rank = int(process_id)
        self._init_policy(config)
        host, port = _parse_addr(coordinator_address)
        my_host = bind_host or host
        self._data_listener = _listen(my_host, 0)
        self._my_addr = (my_host, self._data_listener.getsockname()[1])

        if self.rank == 0:
            self._ctrl_listener = _listen(host, port)
            members = {0: self._my_addr}
            for _ in range(num_processes - 1):
                conn = self._accept(self._ctrl_listener)
                _, _, payload = _recv_frame(conn, TAG_HELLO)
                hello = pickle.loads(payload)
                _refuse_skew(hello, "rendezvous HELLO from rank "
                             f"{hello.get('rank')}")
                r = int(hello["rank"])
                if r in members or r in self._ctrl:
                    raise TransportError(
                        f"duplicate rendezvous rank {r}")
                members[r] = (hello["host"], int(hello["port"]))
                self._ctrl[r] = conn
            if sorted(members) != list(range(num_processes)):
                raise TransportError(
                    f"rendezvous ranks {sorted(members)} do not tile "
                    f"[0, {num_processes})")
            self.ledger = WorldLedger(members, epoch=0)
            from ..telemetry import new_trace_id
            self.trace_id = new_trace_id()
            state = self.ledger.to_state()
            state["trace"] = self.trace_id
            roster = _obj_frame(state)
            for r, conn in self._ctrl.items():
                _send_frame(conn, TAG_ROSTER, roster)
        else:
            self._coord_sock = self._connect_retry(host, port)
            _send_frame(self._coord_sock, TAG_HELLO, _obj_frame(
                {"rank": self.rank, "host": self._my_addr[0],
                 "port": self._my_addr[1],
                 "ver": PROTOCOL_VERSION}))
            self._coord_sock.settimeout(_CTRL_TIMEOUT_S)
            _, _, payload = _recv_frame(self._coord_sock, TAG_ROSTER,
                                        peer="coordinator")
            state = pickle.loads(payload)
            self.trace_id = str(state.get("trace", ""))
            self.ledger = WorldLedger.from_state(state)
        self._coord_rank = min(self.ledger.members)
        self._build_mesh()
        self._note_world()
        Log.info(f"tcp transport up: rank {self.rank} of "
                 f"{self.world_size} (epoch {self.epoch}, "
                 f"coordinator {coordinator_address})")
        return self

    @classmethod
    def join(cls, coordinator_address: str, config=None,
             bind_host: Optional[str] = None,
             timeout_s: float = _JOIN_TIMEOUT_S,
             ledger=None) -> "TcpTransport":
        """Elastic re-join: connect to a RUNNING world's coordinator,
        wait for admission at its next epoch boundary, receive the
        new ledger + the handoff payload (``self.handoff``), and build
        the mesh as a fresh rank.

        ``ledger`` (a :class:`WorldLedger` or its ``to_state()`` dict,
        e.g. from a checkpoint or a prior directive) arms the STALE
        COORDINATOR WALK: if ``coordinator_address`` refuses, the
        joiner dials the ledger's members in ascending rank order —
        the lowest live rank IS the coordinator (failover invariant),
        so the first successful connect lands the JOIN at the right
        door (the coordinator drains its data listener every tick)."""
        self = cls()
        self._init_policy(config)
        host, port = _parse_addr(coordinator_address)
        my_host = bind_host or host
        self._data_listener = _listen(my_host, 0)
        self._my_addr = (my_host, self._data_listener.getsockname()[1])
        led = None
        if ledger is not None:
            led = ledger if isinstance(ledger, WorldLedger) \
                else WorldLedger.from_state(dict(ledger))
        if led is None:
            self._coord_sock = self._connect_retry(host, port)
        else:
            candidates = [("coordinator", (host, port))] + \
                [(f"ledger rank {r}", led.members[r])
                 for r in led.ranks()]
            last: Optional[BaseException] = None
            for who, (h, p) in candidates:
                try:
                    self._coord_sock = _dial(h, int(p))
                    break
                except (ConnectionError, OSError, socket.timeout) as e:
                    last = e
                    Log.warning(
                        f"join: {who} at {h}:{p} unreachable ({e}) — "
                        "walking the replicated ledger for the live "
                        "coordinator")
            else:
                raise TransportError(
                    f"join: no reachable coordinator among "
                    f"{len(candidates)} candidate(s) — the whole "
                    f"world is gone? (last: {last})")
        _send_frame(self._coord_sock, TAG_JOIN, _obj_frame(
            {"host": self._my_addr[0], "port": self._my_addr[1],
             "ver": PROTOCOL_VERSION}))
        self._coord_sock.settimeout(float(timeout_s))
        _, _, payload = _recv_frame(self._coord_sock, TAG_DIRECTIVE,
                                    peer="coordinator")
        directive = pickle.loads(payload)
        self.rank = int(directive["you"])
        self.trace_id = str(directive.get("trace", ""))
        self.ledger = WorldLedger.from_state(directive["ledger"])
        self._coord_rank = min(self.ledger.members)
        if directive.get("hmeta"):
            self.handoff_meta = dict(directive["hmeta"])
        _, _, hpayload = _recv_frame(self._coord_sock, TAG_HANDOFF,
                                     peer="coordinator")
        self.handoff = pickle.loads(hpayload)
        self._coord_sock.settimeout(_CTRL_TIMEOUT_S)
        self._build_mesh()
        self._note_world()
        from ..telemetry import TELEMETRY
        TELEMETRY.journal.emit(
            "membership_join", seam="transport.connect",
            rank=self.rank, epoch=self.epoch, trace=self.trace_id,
            world=self.world_size)
        Log.info(f"tcp transport joined: rank {self.rank} of "
                 f"{self.world_size} at epoch {self.epoch}")
        return self

    def _init_policy(self, config) -> None:
        from ..reliability.retry import RetryPolicy
        if config is None:
            self._retry_policy = RetryPolicy()
        else:
            self._retry_policy = RetryPolicy.from_config(config)
            self._retry_policy.budget_s = \
                float(getattr(config, "time_out", 2)) * 60.0
            self.epoch_every = max(1, int(getattr(
                config, "transport_epoch_iters", 1) or 1))
            self.reconnect_retries = max(0, int(getattr(
                config, "transport_reconnect_retries", 3)))

    def _connect_retry(self, host: str, port: int) -> socket.socket:
        """Coordinator/peer connect under the bounded retry policy —
        the ``transport.connect`` seam (a coordinator still starting
        or a DNS race is transient, exactly like ``distributed.init``).
        """
        from ..reliability.faults import FAULTS
        from ..reliability.retry import retry_call

        def _connect():
            from ..reliability.faults import TransportChaos
            try:
                FAULTS.fault_point("transport.connect")
            except TransportChaos as e:
                # a network-shaped chaos action at connect time IS a
                # failed dial: transient, retried under the policy
                raise ConnectionResetError(str(e)) from e
            s = socket.create_connection((host, port),
                                         timeout=_CTRL_TIMEOUT_S)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return s

        return retry_call(_connect, seam="transport.connect",
                          policy=self._retry_policy)

    def _accept(self, listener: socket.socket) -> socket.socket:
        listener.settimeout(_CTRL_TIMEOUT_S)
        conn, _ = listener.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(_CTRL_TIMEOUT_S)
        return conn

    def _build_mesh(self) -> None:
        """(Re)build the persistent peer mesh for the CURRENT ledger:
        for every pair the HIGHER rank connects to the lower rank's
        data listener and identifies itself — a deterministic
        connection direction, so no pair ever cross-connects."""
        for s in self._peers.values():
            _quiet_close(s)
        self._peers = {}
        # fresh epoch, fresh sequence space (in-epoch reconnects KEEP
        # these — see _reconnect_peer)
        self._send_seq = {}
        self._recv_seq = {}
        self._sent_log = {}
        lower = [r for r in self.ledger.ranks() if r < self.rank]
        higher = [r for r in self.ledger.ranks() if r > self.rank]
        # connect up to every lower rank...
        for r in lower:
            h, p = self.ledger.members[r]
            s = self._connect_retry(h, p)
            _send_frame(s, TAG_IDENT, _obj_frame(
                {"rank": self.rank, "epoch": self.epoch,
                 "ver": PROTOCOL_VERSION}))
            self._peers[r] = s
        # ...and accept every higher rank (any order)
        expect = set(higher)
        while expect:
            conn = self._accept(self._data_listener)
            try:
                tag, _, payload = _recv_frame(conn)
            except TransportError:
                _quiet_close(conn)
                continue
            if tag == TAG_JOIN:
                # a ledger-walking joiner knocked during a reform —
                # park it for the next epoch tick
                self._pending_joins.append((conn,
                                            pickle.loads(payload)))
                continue
            if tag != TAG_IDENT:
                _quiet_close(conn)
                continue
            ident = pickle.loads(payload)
            _refuse_skew(ident, "mesh IDENT from rank "
                         f"{ident.get('rank')}")
            r = int(ident["rank"])
            if int(ident.get("epoch", self.epoch)) != self.epoch:
                # a corpse from a previous epoch racing the reform —
                # refuse it; the live peer reconnects with the right
                # epoch
                _quiet_close(conn)
                continue
            if r not in expect:
                raise TransportError(
                    f"unexpected mesh peer rank {r} "
                    f"(expected one of {sorted(expect)})")
            if ident.get("reconnect"):
                # a reconnect dial raced the epoch flip: complete its
                # ack handshake so the dialer unblocks
                _send_frame(conn, TAG_IDENT, _obj_frame(
                    {"rank": self.rank, "epoch": self.epoch,
                     "ver": PROTOCOL_VERSION,
                     "ack": self._recv_seq.get(r, 0)}))
            expect.discard(r)
            self._peers[r] = conn

    def _note_world(self) -> None:
        from ..telemetry import TELEMETRY
        if TELEMETRY.on:
            TELEMETRY.gauge("collective_tcp_world", self.world_size)
            TELEMETRY.gauge("collective_tcp_epoch", self.epoch)

    # -- round plumbing ----------------------------------------------
    def _peer(self, rank: int) -> socket.socket:
        try:
            return self._peers[rank]
        except KeyError:
            raise TransportPeerLost(
                rank, "no socket in the current epoch's mesh") \
                from None

    def _round(self, primitive: str,
               sends: List[Tuple[int, bytes]],
               recvs: List[int]) -> Dict[int, bytes]:
        """One communication round: send each payload, receive one
        DATA frame per listed peer.  Fires the ``transport.round``
        fault seam, bounds every socket wait by the armed collective
        deadline (hung peer -> ``StallError``), classifies dead peers
        as ``TransportPeerLost``, and lands bytes/rounds/latency in
        the ``collective_tcp_*`` telemetry family.  In spans mode the
        round records a ``transport_round`` span tagged with the
        active trace context (falling back to the fleet trace id the
        coordinator distributed at rendezvous), so the SAME round's
        spans on every host share one trace id in the merged
        timeline."""
        from ..telemetry import TELEMETRY as tm
        if not tm.spans_on:
            return self._round_inner(primitive, sends, recvs)
        from ..telemetry import current_trace, new_span_id
        ctx = current_trace()
        attrs = {"primitive": primitive, "epoch": self.epoch,
                 "span": new_span_id()}
        trace_id = ctx[0] if ctx is not None else self.trace_id
        if trace_id:
            attrs["trace"] = trace_id
        with tm.span("transport_round", **attrs):
            return self._round_inner(primitive, sends, recvs)

    def _round_inner(self, primitive: str,
                     sends: List[Tuple[int, bytes]],
                     recvs: List[int]) -> Dict[int, bytes]:
        from ..reliability import watchdog as _watchdog
        from ..reliability.faults import FAULTS, TransportChaos
        from ..telemetry import TELEMETRY as tm

        chaos: Optional[TransportChaos] = None
        try:
            FAULTS.fault_point("transport.round")
        except TransportChaos as e:
            chaos = e          # applied to real frames below
        except ConnectionError as e:
            # an injected peer_drop IS a reset socket with no live
            # endpoint to re-dial: classify it the way a real one
            # classifies
            raise TransportPeerLost(None, str(e)) from e
        deadline = _watchdog.deadline("collective")
        budget = deadline if deadline > 0 else _CTRL_TIMEOUT_S
        t0 = time.perf_counter()
        # sequence numbers are assigned ONCE per round — a reconnect
        # re-sends the SAME seq, and the receiver's dup-discard makes
        # the retried round idempotent (a chunk is never double-added)
        seq_of: Dict[int, int] = {}
        for r, _p in sends:
            seq_of[r] = self._send_seq.get(r, 0) + 1
            self._send_seq[r] = seq_of[r]
        corrupt = chaos is not None and chaos.action == "corrupt"
        dup = chaos is not None and chaos.action == "dup"
        if chaos is not None and chaos.action == "partition":
            self._chaos_partition(recvs or [r for r, _ in sends],
                                  chaos.duration_ms)
        out: Dict[int, bytes] = {}
        sent_ok: set = set()
        blips = 0
        while True:
            # sends ride a helper thread so a same-peer exchange can
            # never deadlock on full TCP buffers (both sides blocked
            # in sendall)
            send_err: List[Tuple[Optional[int], BaseException]] = []
            pending = [(r, p) for r, p in sends if r not in sent_ok]

            def _do_sends(pending=pending, send_err=send_err,
                          corrupt=corrupt, dup=dup):
                for r, payload in pending:
                    try:
                        if dup:
                            self._replay_last(r, budget)
                            dup = False
                        self._send_data(r, payload, seq_of[r], budget,
                                        corrupt=corrupt)
                        corrupt = False
                        sent_ok.add(r)
                    except BaseException as e:  # noqa: BLE001
                        send_err.append((r, e))
                        return

            sender = threading.Thread(target=_do_sends, daemon=True)
            sender.start()
            blip: Optional[Tuple[Optional[int], BaseException]] = None
            peer = None
            try:
                for peer in recvs:
                    if peer in out:
                        continue
                    out[peer] = self._recv_data(peer, budget)
            except socket.timeout:
                elapsed = time.perf_counter() - t0
                if deadline > 0:
                    _watchdog._record_stall("host_collective",
                                            "transport.round",
                                            deadline, elapsed)
                    raise _watchdog.StallError(
                        phase="host_collective",
                        seam="transport.round",
                        deadline_s=deadline,
                        elapsed_s=elapsed) from None
                raise TransportPeerLost(
                    peer, f"no frame within {budget:g}s") from None
            except (ConnectionError, OSError, TransportError) as e:
                if isinstance(e, TransportPeerLost):
                    raise
                blip = (peer, e)
            sender.join(timeout=budget)
            for r, e in send_err:
                if isinstance(e, socket.timeout) and deadline > 0:
                    elapsed = time.perf_counter() - t0
                    _watchdog._record_stall("host_collective",
                                            "transport.round",
                                            deadline, elapsed)
                    raise _watchdog.StallError(
                        phase="host_collective",
                        seam="transport.round",
                        deadline_s=deadline, elapsed_s=elapsed)
                if isinstance(e, (ConnectionError, OSError,
                                  TransportError)) \
                        and not isinstance(e, TransportPeerLost):
                    if blip is None:
                        blip = (r, e)
                else:
                    raise e
            # chaos one-shots are consumed by the first attempt; a
            # retried attempt re-sends the TRUE frame
            corrupt = dup = False
            if blip is None:
                break
            rank, cause = blip
            blips += 1
            if rank is None or blips > self.reconnect_retries:
                raise TransportPeerLost(rank, str(cause)) from cause
            # a reset/EOF/corrupt frame mid-round is a transient blip
            # until reconnection exhausts — reconnect within the
            # epoch, resync by ack, resend what the peer never applied
            self._reconnect_peer(rank, budget, cause)
        nbytes = sum(len(out[p]) for p in out) \
            + sum(len(p) for _, p in sends)
        if tm.on:
            tm.add("collective_tcp_bytes", nbytes)
            tm.add("collective_tcp_rounds", 1)
            tm.add(f"collective_tcp_{primitive}_bytes", nbytes)
            tm.add(f"collective_tcp_{primitive}_rounds", 1)
            tm.observe("collective_tcp_round_ms",
                       (time.perf_counter() - t0) * 1e3)
        return out

    # -- data-plane frames, reconnection ------------------------------
    def _send_data(self, rank: int, payload: bytes, seq: int,
                   budget: float, corrupt: bool = False) -> None:
        """One DATA frame to ``rank``, logged for post-reconnect
        resend.  ``corrupt`` (chaos) flips one payload bit IN FLIGHT —
        the header CRC still covers the true bytes, so the receiver
        must detect it."""
        # log BEFORE touching the socket: a dead socket must not keep
        # this frame out of the post-reconnect resend window
        log = self._sent_log.setdefault(
            rank, collections.deque(maxlen=4))
        if not log or log[-1][0] != seq:
            log.append((seq, payload))
        s = self._peer(rank)
        s.settimeout(budget)
        if corrupt and payload:
            crc = _payload_crc(payload) if _FRAME_CRC else 0
            bad = bytearray(payload)
            bad[0] ^= 0x01
            s.sendall(_HDR.pack(_MAGIC, PROTOCOL_VERSION, TAG_DATA,
                                seq, len(bad), crc) + bytes(bad))
            return
        _send_frame(s, TAG_DATA, payload, seq=seq)

    def _recv_data(self, rank: int, budget: float) -> bytes:
        """One in-sequence DATA payload from ``rank``: replayed or
        duplicated frames (seq <= last applied) are discarded, a
        sequence GAP is loud — it means a frame this process never saw
        was silently skipped."""
        from ..telemetry import TELEMETRY
        last = self._recv_seq.get(rank, 0)
        while True:
            s = self._peer(rank)
            s.settimeout(budget)
            _, seq, payload = _recv_frame(s, TAG_DATA, peer=rank)
            if seq <= last:
                TELEMETRY.add("collective_tcp_dup_frames", 1)
                continue
            if seq != last + 1:
                raise TransportError(
                    f"DATA sequence gap from rank {rank}: got seq "
                    f"{seq}, expected {last + 1} — a frame was lost "
                    "without a reconnect resync")
            self._recv_seq[rank] = seq
            return payload

    def _replay_last(self, rank: int, budget: float) -> None:
        """Chaos ``dup``: re-send the most recent DATA frame to
        ``rank`` with its ORIGINAL seq — the receiver's dup-discard
        must drop it."""
        log = self._sent_log.get(rank)
        if not log:
            return
        seq, payload = log[-1]
        s = self._peer(rank)
        s.settimeout(budget)
        _send_frame(s, TAG_DATA, payload, seq=seq)

    def _chaos_partition(self, victims: List[int], ms: int) -> None:
        """Chaos ``partition:<ms>``: sever the link to the first
        listed peer in BOTH directions (close our end — the peer sees
        FIN/RST), sit out the outage, then proceed into the round;
        reconnection heals the link and the resynced round completes
        bit-exact."""
        for v in victims:
            s = self._peers.get(v)
            if s is not None:
                Log.debug(f"chaos partition: severing link to rank "
                          f"{v} for {ms} ms")
                _quiet_close(s)
                break
        time.sleep(max(0, int(ms)) / 1e3)

    def _reconnect_peer(self, rank: int, budget: float,
                        cause: BaseException) -> None:
        """Heal the link to ``rank`` WITHIN the epoch: the higher rank
        dials the lower rank's data listener (same direction as the
        mesh build) under bounded backoff; an IDENT{reconnect} ack
        exchange tells each side the other's last applied seq, and any
        unacked frame is re-sent from the sent log.  Exhaustion — and
        only exhaustion — converts to :class:`TransportPeerLost`."""
        from ..telemetry import TELEMETRY
        old = self._peers.pop(rank, None)
        if old is not None:
            _quiet_close(old)
        if rank not in self.ledger.members:
            raise TransportPeerLost(
                rank, f"not in the epoch-{self.epoch} ledger") \
                from cause
        deadline_at = time.monotonic() + budget
        delay = 0.05
        last: BaseException = cause
        for attempt in range(max(1, self.reconnect_retries)):
            remain = deadline_at - time.monotonic()
            if remain <= 0:
                break
            try:
                if self.rank > rank:
                    conn = self._dial_reconnect(rank, remain)
                else:
                    conn = self._accept_reconnect(rank, remain)
                self._peers[rank] = conn
                TELEMETRY.add("collective_tcp_reconnects", 1)
                TELEMETRY.journal.emit(
                    "reconnect", seam="transport.round", peer=rank,
                    rank=self.rank, epoch=self.epoch,
                    trace=self.trace_id, attempt=attempt + 1,
                    cause=str(cause)[:160])
                Log.warning(
                    f"tcp transport: link to rank {rank} reconnected "
                    f"within epoch {self.epoch} (attempt "
                    f"{attempt + 1}; cause: {cause})")
                return
            except (ConnectionError, OSError, socket.timeout,
                    TransportError) as e:
                last = e
                time.sleep(min(delay, max(0.0, deadline_at
                                          - time.monotonic())))
                delay = min(delay * 2, 1.0)
        raise TransportPeerLost(
            rank, f"reconnect exhausted after "
            f"{max(1, self.reconnect_retries)} attempt(s) "
            f"(last: {last})") from cause

    def _dial_reconnect(self, rank: int,
                        remain: float) -> socket.socket:
        h, p = self.ledger.members[rank]
        s = _dial(h, p, timeout=min(_DIAL_TIMEOUT_S, remain))
        try:
            s.settimeout(max(0.1, remain))
            _send_frame(s, TAG_IDENT, _obj_frame(
                {"rank": self.rank, "epoch": self.epoch,
                 "ver": PROTOCOL_VERSION, "reconnect": True,
                 "ack": self._recv_seq.get(rank, 0)}))
            _, _, payload = _recv_frame(s, TAG_IDENT, peer=rank)
            reply = pickle.loads(payload)
            if int(reply.get("epoch", -1)) != self.epoch:
                raise TransportError(
                    f"reconnect ack from rank {rank} is for epoch "
                    f"{reply.get('epoch')}, not {self.epoch}")
            self._resync(rank, s, int(reply.get("ack", 0)))
            return s
        except BaseException:
            _quiet_close(s)
            raise

    def _accept_reconnect(self, rank: int,
                          remain: float) -> socket.socket:
        """Lower-rank side of a reconnect: accept on the data listener
        until the expected peer's IDENT{reconnect} arrives (other
        valid reconnects are adopted in passing; stale epochs and
        stray frames are refused).  Each attempt's wait is capped at
        the re-home grace, NOT the full collective budget — a live
        blipped peer redials within milliseconds, so a silent listener
        means the peer is dead and waiting the whole budget would turn
        every peer death into a near-hang for its lower-rank
        survivors."""
        deadline_at = time.monotonic() + min(remain, _REHOME_GRACE_S)
        while True:
            left = deadline_at - time.monotonic()
            if left <= 0:
                raise socket.timeout(
                    f"no reconnect dial from rank {rank} within "
                    f"{remain:g}s")
            self._data_listener.settimeout(min(0.5, left))
            try:
                conn, _ = self._data_listener.accept()
            except (socket.timeout, BlockingIOError):
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(min(_DIAL_TIMEOUT_S, max(0.1, left)))
            try:
                tag, _, payload = _recv_frame(conn)
                obj = pickle.loads(payload)
            except (ConnectionError, OSError, socket.timeout,
                    TransportError):
                _quiet_close(conn)
                continue
            if tag == TAG_JOIN:
                self._pending_joins.append((conn, obj))
                continue
            if tag != TAG_IDENT \
                    or int(obj.get("epoch", -1)) != self.epoch \
                    or not obj.get("reconnect"):
                _quiet_close(conn)
                continue
            _refuse_skew(obj, "reconnect IDENT from rank "
                         f"{obj.get('rank')}")
            r = int(obj["rank"])
            try:
                _send_frame(conn, TAG_IDENT, _obj_frame(
                    {"rank": self.rank, "epoch": self.epoch,
                     "ver": PROTOCOL_VERSION,
                     "ack": self._recv_seq.get(r, 0)}))
                self._resync(r, conn, int(obj.get("ack", 0)))
            except (ConnectionError, OSError, socket.timeout,
                    TransportError):
                # a failed handshake must CLOSE the conn — a leaked
                # half-healed socket leaves the dialer believing the
                # link is up and blocking on a frame that never comes
                _quiet_close(conn)
                continue
            if r == rank:
                return conn
            # a concurrent blip on another link: adopt its healed
            # socket and keep waiting for the one we came for
            old = self._peers.pop(r, None)
            if old is not None:
                _quiet_close(old)
            self._peers[r] = conn

    def _resync(self, rank: int, sock: socket.socket,
                their_ack: int) -> None:
        """Post-reconnect resend: every logged frame the peer never
        applied (seq > their ack) goes again, in order, with its
        ORIGINAL seq.  An ack below the log's reach is loud — the
        frames to replay are gone."""
        sent = self._send_seq.get(rank, 0)
        if sent <= their_ack:
            return
        log = self._sent_log.get(rank) or ()
        replay = [(q, p) for q, p in log if q > their_ack]
        if not replay or replay[0][0] != their_ack + 1:
            raise TransportError(
                f"reconnect resync with rank {rank} impossible: peer "
                f"acked seq {their_ack}, sent log covers "
                f"{[q for q, _ in log]} — unacked frames fell out of "
                "the resend window")
        for q, p in replay:
            _send_frame(sock, TAG_DATA, p, seq=q)

    # -- collectives --------------------------------------------------
    def allgather_bytes(self, payload: bytes,
                        primitive: str = "allgather") -> List[bytes]:
        """Bruck-style allgather over byte blocks (log2(P) rounds;
        reference network.cpp BruckAllgather): returns the P payloads
        in RANK ORDER — the deterministic merge order every consumer
        (candidate merge, histogram sum) relies on."""
        P = self.world_size
        if P == 1:
            return [payload]
        ranks = self.ledger.ranks()
        pos = ranks.index(self.rank)
        have: List[bytes] = [payload]     # have[i] = block of
        m = 1                             # ranks[(pos + i) % P]
        while m < P:
            cnt = min(m, P - m)
            dst = ranks[(pos - m) % P]
            src = ranks[(pos + m) % P]
            got = self._round(primitive,
                              [(dst, _obj_frame(have[:cnt]))], [src])
            have.extend(pickle.loads(got[src]))
            m += cnt
        out: List[bytes] = [b""] * P
        for i, blk in enumerate(have[:P]):
            out[(pos + i) % P] = blk
        return out

    def allgather_obj(self, obj, primitive: str = "allgather") -> List:
        """Allgather arbitrary (picklable) objects; rank order."""
        return [pickle.loads(b) for b in
                self.allgather_bytes(_obj_frame(obj), primitive)]

    def allgather(self, arr: np.ndarray) -> np.ndarray:
        """Allgather equal-shape arrays -> the stacked (P, \\*shape)
        array (the ``multihost_utils.process_allgather`` contract
        ``distributed._allgather`` expects)."""
        arr = np.ascontiguousarray(arr)
        parts = self.allgather_obj(arr)
        shapes = {p.shape for p in parts}
        if len(shapes) != 1:
            raise TransportError(
                f"allgather shape mismatch across ranks: {shapes} — "
                "use allgather_obj for variable-size payloads")
        return np.stack(parts, axis=0)

    def allreduce_sum(self, arr: np.ndarray,
                      primitive: str = "allreduce") -> np.ndarray:
        """World sum on every rank.  Integer payloads ride the ring
        (reduce-scatter + allgather — exact in any order); floats
        gather and sum in rank order, bit-identical to
        ``HostCollectives.simulate_allreduce``'s
        ``np.sum(np.stack(parts), axis=0)``."""
        arr = np.ascontiguousarray(arr)
        P = self.world_size
        if P == 1:
            return arr.copy()
        if arr.dtype.kind not in "iu":
            parts = self.allgather_obj(arr, primitive=primitive)
            return np.sum(np.stack(parts, axis=0), axis=0)
        flat = arr.reshape(-1)
        pad = (-len(flat)) % P
        if pad:
            flat = np.concatenate(
                [flat, np.zeros(pad, dtype=flat.dtype)])
        chunks = [c.copy() for c in np.split(flat, P)]
        ranks = self.ledger.ranks()
        pos = ranks.index(self.rank)
        right = ranks[(pos + 1) % P]
        left = ranks[(pos - 1) % P]
        # ring chunks are equal-length and of a dtype both ends
        # already know, so they cross as RAW bytes — no pickle copy,
        # and the wire carries exactly chunk.nbytes per hop (the
        # bench's q16/q8 payload-reduction gates measure these frames)
        dt = flat.dtype
        # ring reduce-scatter: chunk c starts at position c+1 and
        # accumulates rightward until it lands, fully summed, at
        # position c
        for s in range(P - 1):
            send_i = (pos - s - 1) % P
            recv_i = (pos - s - 2) % P
            got = self._round(
                primitive,
                [(right, chunks[send_i].tobytes())], [left])
            chunks[recv_i] = chunks[recv_i] \
                + np.frombuffer(got[left], dtype=dt)
        # ring allgather of the summed chunks
        for s in range(P - 1):
            send_i = (pos - s) % P
            recv_i = (pos - s - 1) % P
            got = self._round(
                primitive,
                [(right, chunks[send_i].tobytes())], [left])
            chunks[recv_i] = np.frombuffer(got[left], dtype=dt)
        out = np.concatenate(chunks)
        if pad:
            out = out[:-pad]
        return out.reshape(arr.shape)

    def reduce_scatter(self, arr: np.ndarray,
                       axis: int = 0) -> np.ndarray:
        """Ring reduce-scatter: rank r returns chunk r (``np.
        array_split`` tiling along ``axis``) of the world sum — the
        reference data-parallel histogram exchange shape
        (data_parallel_tree_learner.cpp:117-246)."""
        arr = np.ascontiguousarray(arr)
        P = self.world_size
        chunks = [np.ascontiguousarray(c)
                  for c in np.array_split(arr, P, axis=axis)]
        if P == 1:
            return chunks[0]
        ranks = self.ledger.ranks()
        pos = ranks.index(self.rank)
        right = ranks[(pos + 1) % P]
        left = ranks[(pos - 1) % P]
        acc = [c.copy() for c in chunks]
        for s in range(P - 1):
            send_i = (pos - s - 1) % P
            recv_i = (pos - s - 2) % P
            got = self._round(
                "reduce_scatter",
                [(right, _obj_frame(acc[send_i]))], [left])
            acc[recv_i] = acc[recv_i] + pickle.loads(got[left])
        return acc[pos]

    def pmax(self, arr: np.ndarray,
             primitive: str = "allreduce") -> np.ndarray:
        """Elementwise world max (the scale-sync primitive of the
        hist_exchange codec; max is associative+commutative, so the
        gather route is exact)."""
        parts = self.allgather_obj(np.ascontiguousarray(arr),
                                   primitive=primitive)
        return np.max(np.stack(parts, axis=0), axis=0)

    def barrier(self) -> None:
        self.allgather_bytes(b"", primitive="allgather")

    # -- compressed histogram exchange over the wire ------------------
    def exchange_histograms(self, local_hist: np.ndarray,
                            mode: str = "f32") -> np.ndarray:
        """The r21 ``hist_exchange`` codec over real TCP: q16/q8
        delta-coded integer payloads ship verbatim (int16/int8 on the
        wire, world-headroom so the ring sum can never overflow their
        own dtype) and the reconstruction is BIT-EXACT against
        ``collectives.host_exchange_histograms`` on the same shards —
        the scales cross as one pmax'd stat payload exactly like the
        in-program ``exchange_histograms`` lowering."""
        from ..reliability.faults import FAULTS
        from .collectives import HIST_EXCHANGE_MODES, _note_collective
        if mode not in HIST_EXCHANGE_MODES:
            raise ValueError(f"hist_exchange must be one of "
                             f"{HIST_EXCHANGE_MODES}, got {mode!r}")
        FAULTS.fault_point("collectives.hist_exchange")
        local = np.asarray(local_hist, dtype=np.float32)
        if mode == "f32":
            _note_collective("hist_exchange", local)
            # the payload frames carry their own primitive label, so
            # collective_tcp_hist_exchange_bytes reads the HISTOGRAM
            # wire bytes alone — the bench wire-reduction gate compares
            # exactly these frames across modes
            parts = self.allgather_obj(local, primitive="hist_exchange")
            return np.sum(np.stack(parts, axis=0), axis=0)
        world = self.world_size
        bits = 16 if mode == "q16" else 8
        qmax = (2 ** (bits - 1) - 1) // world
        if qmax < 1:
            raise ValueError(
                f"hist_exchange={mode}: world size {world} leaves no "
                f"quantization levels inside int{bits}")
        npdt = np.int16 if mode == "q16" else np.int8
        delta = np.concatenate(
            [local[..., :1, :], np.diff(local, axis=-2)], axis=-2)
        amax_l = np.max(np.abs(delta), axis=-2, keepdims=True)
        frac_l = np.max(np.abs(delta - np.round(delta)), axis=-2,
                        keepdims=True)
        # ONE pmax round syncs scale + integrality residual: the
        # elementwise world max of per-shard maxima IS the joint max
        # host_exchange_histograms takes over (shard, bin)
        stat = self.pmax(np.concatenate([amax_l, frac_l],
                                        axis=-2).astype(np.float32),
                         primitive="hist_scale")
        amax, frac = stat[..., :1, :], stat[..., 1:, :]
        exact = (frac == 0) & (amax <= qmax)
        denom = np.where(exact, np.float32(qmax),
                         np.maximum(amax, np.float32(1e-30)))
        q = np.clip(np.round(delta / denom * qmax),
                    -qmax, qmax).astype(npdt)
        _note_collective("hist_exchange", q)
        _note_collective("hist_exchange_scale", stat)
        # the narrow integers ride the ring IN the wire dtype — the
        # world-headroom qmax guarantees the running partial sums fit
        qsum = self.allreduce_sum(q, primitive="hist_exchange")
        deq = qsum.astype(np.int32).astype(np.float32) \
            * (denom / np.float32(qmax))
        return np.cumsum(deq, axis=-2, dtype=np.float32)

    # -- elastic membership -------------------------------------------
    def epoch_tick(self, handoff: Optional[Callable[[], bytes]] = None,
                   allow_degraded: bool = False) -> dict:
        """One epoch-boundary barrier.  Members TICK the coordinator
        and adopt its DIRECTIVE; the coordinator collects ticks,
        retires dead members, admits pending joiners (serving each the
        ``handoff()`` payload + ``handoff_meta``), and publishes the
        next ledger.  With an unchanged world this is one tiny
        control round.  Returns ``{"epoch", "world_size", "changed",
        "dead", "admitted"}``.

        A dead member with ``allow_degraded=False`` raises
        :class:`TransportPeerLost` — the fail-fast default mirrors
        ``sharded_allow_degraded``."""
        from ..reliability import watchdog as _watchdog
        from ..reliability.faults import FAULTS, TransportChaos
        chaos = None
        try:
            FAULTS.fault_point("transport.round")
        except TransportChaos as e:
            chaos = e
        except ConnectionError as e:
            raise TransportPeerLost(None, str(e)) from e
        deadline = _watchdog.deadline("collective")
        budget = deadline if deadline > 0 else _CTRL_TIMEOUT_S
        if chaos is not None and chaos.action == "partition" \
                and self.rank != self._coord_rank \
                and self._coord_sock is not None:
            # control-plane blip: sever our coordinator link; the
            # member tick below heals it by re-homing through the
            # coordinator's data listener (same walk as failover)
            _quiet_close(self._coord_sock)
            time.sleep(max(0, chaos.duration_ms) / 1e3)
        if self.rank == self._coord_rank:
            return self._coordinator_tick(handoff, allow_degraded,
                                          budget)
        return self._member_tick(handoff, allow_degraded, budget)

    def _member_tick(self, handoff, allow_degraded: bool,
                     budget: float) -> dict:
        try:
            if self._coord_sock is None:
                raise TransportError("no coordinator socket")
            self._coord_sock.settimeout(budget)
            _send_frame(self._coord_sock, TAG_TICK, _obj_frame(
                {"rank": self.rank, "epoch": self.epoch,
                 "trace": self.trace_id, "ver": PROTOCOL_VERSION}))
            _, _, payload = _recv_frame(self._coord_sock,
                                        TAG_DIRECTIVE,
                                        peer="coordinator")
        except (ConnectionError, OSError, socket.timeout,
                TransportError) as e:
            return self._coordinator_failover(e, handoff,
                                              allow_degraded, budget)
        directive = pickle.loads(payload)
        return self._adopt(directive)

    def _coordinator_failover(self, cause, handoff,
                              allow_degraded: bool,
                              budget: float) -> dict:
        """The coordinator is unreachable at a tick.  Walk the
        REPLICATED ledger inside a ``watchdog_collective_s``-bounded
        grace: re-dial the old coordinator's data listener first (a
        control-plane blip heals by re-homing to the SAME coordinator
        — no spurious failover on a one-sided reset), then every
        survivor in ascending rank order.  The lowest live rank is the
        deterministic successor; reaching our own rank on the walk
        means WE are it."""
        from ..reliability.faults import FAULTS
        try:
            FAULTS.fault_point("transport.failover")
        except ConnectionError as e:
            raise TransportPeerLost(self._coord_rank, str(e)) from e
        old = self._coord_rank
        if self._coord_sock is not None:
            _quiet_close(self._coord_sock)
            self._coord_sock = None
        Log.warning(
            f"tcp transport rank {self.rank}: coordinator rank {old} "
            f"unreachable at epoch {self.epoch} tick ({cause}) — "
            "walking the replicated ledger for the successor "
            "(docs/RELIABILITY.md coordinator-failover runbook)")
        deadline_at = time.monotonic() + budget
        candidates = [old] + [r for r in self.ledger.ranks()
                              if r != old]
        last: BaseException = cause
        for cand in candidates:
            remain = deadline_at - time.monotonic()
            if remain <= 0:
                break
            if cand == self.rank:
                return self._become_coordinator(
                    old, handoff, allow_degraded, max(0.5, remain))
            addr = self.ledger.members.get(cand)
            if addr is None:
                continue
            s = None
            try:
                s = _dial(addr[0], addr[1],
                          timeout=min(_DIAL_TIMEOUT_S, remain))
                s.settimeout(max(0.5, remain))
                _send_frame(s, TAG_TICK, _obj_frame(
                    {"rank": self.rank, "epoch": self.epoch,
                     "trace": self.trace_id,
                     "ver": PROTOCOL_VERSION, "rehome": True}))
                _, _, payload = _recv_frame(
                    s, TAG_DIRECTIVE, peer=f"successor {cand}")
            except (ConnectionError, OSError, socket.timeout,
                    TransportError) as e:
                last = e
                if s is not None:
                    _quiet_close(s)
                continue
            self._coord_sock = s
            from ..telemetry import TELEMETRY
            TELEMETRY.add("collective_tcp_rehomes", 1)
            TELEMETRY.journal.emit(
                "reconnect", seam="transport.failover",
                rank=self.rank, peer=cand, epoch=self.epoch,
                trace=self.trace_id, control_plane=True,
                cause=str(cause)[:160])
            Log.warning(
                f"tcp transport rank {self.rank}: re-homed control "
                f"traffic to rank {cand} ({'same coordinator' if cand == old else 'successor'})")
            return self._adopt(pickle.loads(payload))
        raise TransportPeerLost(
            old, f"coordinator failover exhausted every ledger "
            f"candidate (last: {last})") from cause

    def _become_coordinator(self, old: int, handoff,
                            allow_degraded: bool,
                            budget: float) -> dict:
        """This process is the lowest surviving rank: journal the
        change, take over the epoch protocol mid-run, and run the tick
        we were already inside — collecting the other survivors'
        re-homed TICKs on the data listener."""
        self._coord_rank = self.rank
        from ..telemetry import TELEMETRY
        TELEMETRY.add("collective_tcp_coordinator_changes", 1)
        TELEMETRY.journal.emit(
            "coordinator_change", seam="transport.failover",
            old=old, new=self.rank, epoch=self.epoch,
            trace=self.trace_id, world=self.world_size)
        Log.warning(
            f"tcp transport: rank {self.rank} is the new coordinator "
            f"(rank {old} died at epoch {self.epoch}; trace "
            f"{self.trace_id or '-'}) — resuming the epoch protocol "
            "mid-run")
        return self._coordinator_tick(handoff, allow_degraded, budget,
                                      pre_dead=[old])

    def _drain_listener(self, listener: socket.socket, budget: float,
                        ticked: Dict[int, bool],
                        joins: List[Tuple[socket.socket, dict]],
                        eof_at: Dict[int, float]) -> None:
        """Accept every pending connection on ``listener`` and sort
        its first frame: re-homed member TICKs replace control
        sockets, JOINs queue for admission, reconnect IDENTs heal data
        links that blipped into a tick boundary."""
        while True:
            listener.settimeout(0.0)
            try:
                conn, _ = listener.accept()
            except (BlockingIOError, socket.timeout, OSError):
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(min(_DIAL_TIMEOUT_S, budget))
            try:
                tag, _, payload = _recv_frame(conn)
                obj = pickle.loads(payload)
            except (ConnectionError, OSError, socket.timeout,
                    TransportError):
                _quiet_close(conn)
                continue
            if tag == TAG_JOIN:
                joins.append((conn, obj))
                continue
            if tag == TAG_TICK:
                if int(obj.get("epoch", -1)) != self.epoch:
                    _quiet_close(conn)   # stale-epoch corpse
                    continue
                r = int(obj["rank"])
                old = self._ctrl.pop(r, None)
                if old is not None:
                    _quiet_close(old)
                conn.settimeout(_CTRL_TIMEOUT_S)
                self._ctrl[r] = conn
                ticked[r] = True
                eof_at.pop(r, None)
                continue
            if tag == TAG_IDENT and obj.get("reconnect") \
                    and int(obj.get("epoch", -1)) == self.epoch:
                r = int(obj["rank"])
                _send_frame(conn, TAG_IDENT, _obj_frame(
                    {"rank": self.rank, "epoch": self.epoch,
                     "ver": PROTOCOL_VERSION,
                     "ack": self._recv_seq.get(r, 0)}))
                self._resync(r, conn, int(obj.get("ack", 0)))
                stale = self._peers.pop(r, None)
                if stale is not None:
                    _quiet_close(stale)
                self._peers[r] = conn
                continue
            _quiet_close(conn)

    def _coordinator_tick(self, handoff, allow_degraded: bool,
                          budget: float,
                          pre_dead: Optional[List[int]] = None
                          ) -> dict:
        dead: List[int] = list(pre_dead or [])
        expected = [r for r in self.ledger.ranks()
                    if r != self.rank and r not in dead]
        ticked: Dict[int, bool] = {}
        joins: List[Tuple[socket.socket, dict]] = \
            list(self._pending_joins)
        self._pending_joins = []
        # EOF on a member's control socket starts a short re-home
        # grace (a blipped member re-dials our data listener) before
        # the member is declared dead
        eof_at: Dict[int, float] = {
            r: 0.0 for r in expected if r not in self._ctrl}
        deadline_at = time.monotonic() + budget
        listeners = [ln for ln in (self._ctrl_listener,
                                   self._data_listener)
                     if ln is not None]
        while True:
            now = time.monotonic()
            for r in list(expected):
                if r in ticked:
                    continue
                started = eof_at.get(r)
                if started is not None and started > 0 \
                        and now - started > min(_REHOME_GRACE_S,
                                                budget):
                    dead.append(r)
                    expected.remove(r)
            pending = [r for r in expected if r not in ticked]
            if not pending:
                break
            if now >= deadline_at:
                for r in pending:
                    dead.append(r)
                    expected.remove(r)
                break
            socks = [self._ctrl[r] for r in pending
                     if r in self._ctrl] + listeners
            for r in pending:
                # a fresh successor has no control socket yet: start
                # its re-home wait against the FULL budget, not the
                # EOF grace
                if r not in self._ctrl and r not in eof_at:
                    eof_at[r] = 0.0
            try:
                rd, _, _ = select.select(
                    socks, [], [], min(0.25, deadline_at - now))
            except (OSError, ValueError):
                rd = []
            for s in rd:
                if s in listeners:
                    self._drain_listener(s, budget, ticked, joins,
                                         eof_at)
                    continue
                r = next((k for k, v in self._ctrl.items()
                          if v is s), None)
                if r is None:
                    continue
                try:
                    _recv_frame(s, TAG_TICK, peer=r)
                    ticked[r] = True
                    eof_at.pop(r, None)
                except (ConnectionError, OSError, socket.timeout,
                        TransportError):
                    _quiet_close(s)
                    self._ctrl.pop(r, None)
                    if r not in ticked:
                        eof_at[r] = time.monotonic()
        # one final drain for joiners/re-homes that raced the barrier
        for ln in listeners:
            self._drain_listener(ln, budget, ticked, joins, eof_at)
        if dead and not allow_degraded:
            for conn, _ in joins:
                _quiet_close(conn)
            raise TransportPeerLost(
                dead[0], "died before its epoch tick (arm "
                "sharded_allow_degraded for degraded continuation)")
        from ..telemetry import TELEMETRY
        ledger = self.ledger
        admitted: List[int] = []
        if dead:
            ledger = ledger.degrade(dead)
            TELEMETRY.journal.emit(
                "membership_degrade", seam="transport.round",
                dead=dead, epoch=ledger.epoch, trace=self.trace_id,
                world=ledger.world_size)
            Log.warning(
                f"tcp transport: peer rank(s) {dead} dead — world "
                f"degrades to {ledger.world_size} at epoch "
                f"{ledger.epoch} (survivor shards continue; "
                "docs/RELIABILITY.md)")
        skewed = [(c, j) for c, j in joins
                  if int(j.get("ver", 0)) != PROTOCOL_VERSION]
        for conn, j in skewed:
            Log.warning(
                f"tcp transport: refusing joiner {j.get('host')}:"
                f"{j.get('port')} speaking protocol v"
                f"{j.get('ver', 0)} (this world speaks v"
                f"{PROTOCOL_VERSION}) — finish the rolling restart "
                "before it re-joins")
            _quiet_close(conn)
        joins = [(c, j) for c, j in joins if (c, j) not in skewed]
        if joins:
            ledger, admitted = ledger.admit(
                [(j["host"], j["port"]) for _, j in joins])
            TELEMETRY.journal.emit(
                "membership_admit", seam="transport.round",
                admitted=admitted, epoch=ledger.epoch,
                trace=self.trace_id, world=ledger.world_size)
            Log.info(f"tcp transport: admitting joiner rank(s) "
                     f"{admitted} at epoch {ledger.epoch}")
        changed = ledger.epoch != self.ledger.epoch
        state = ledger.to_state()
        # the full ledger AND the handoff metadata ride EVERY
        # directive: any member can serve as successor without ever
        # having talked to a joiner
        directive = {"ledger": state, "changed": changed,
                     "dead": dead, "admitted": admitted,
                     "trace": self.trace_id, "coord": self.rank,
                     "hmeta": dict(self.handoff_meta)}
        for r, conn in list(self._ctrl.items()):
            try:
                _send_frame(conn, TAG_DIRECTIVE,
                            _obj_frame(dict(directive, you=r)))
            except (ConnectionError, OSError) as e:
                if not allow_degraded:
                    raise TransportPeerLost(r, str(e)) from e
        handoff_bytes = b""
        if joins and handoff is not None:
            handoff_bytes = handoff()
        for (conn, _), r in zip(joins, admitted):
            _send_frame(conn, TAG_DIRECTIVE,
                        _obj_frame(dict(directive, you=r)))
            _send_frame(conn, TAG_HANDOFF, _obj_frame(
                {"meta": dict(self.handoff_meta),
                 "state": handoff_bytes}))
            self._ctrl[r] = conn
        return self._adopt(dict(directive, you=self.rank))

    def _adopt(self, directive: dict) -> dict:
        new = WorldLedger.from_state(directive["ledger"])
        changed = bool(directive.get("changed"))
        if directive.get("trace"):
            self.trace_id = str(directive["trace"])
        if directive.get("hmeta"):
            # replicated so ANY survivor can serve joiners after a
            # coordinator death
            self.handoff_meta = dict(directive["hmeta"])
        if changed:
            self.ledger = new
            self._build_mesh()
            self._note_world()
            # every member (coordinator included) journals the epoch
            # flip with the SHARED fleet trace id, so the merged
            # timeline shows one trace spanning all host lanes
            from ..telemetry import TELEMETRY
            TELEMETRY.journal.emit(
                "epoch_change", seam="transport.round",
                epoch=self.epoch, rank=self.rank,
                world=self.world_size, trace=self.trace_id,
                dead=list(directive.get("dead") or []),
                admitted=list(directive.get("admitted") or []))
        # the coordinator is named by the ledger itself: lowest rank
        self._coord_rank = min(self.ledger.members)
        info = {"epoch": self.epoch, "world_size": self.world_size,
                "changed": changed,
                "dead": list(directive.get("dead") or []),
                "admitted": list(directive.get("admitted") or [])}
        return info

    # -- teardown -----------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for s in self._peers.values():
            _quiet_close(s)
        for s in self._ctrl.values():
            _quiet_close(s)
        for conn, _ in self._pending_joins:
            _quiet_close(conn)
        for s in (self._coord_sock, self._ctrl_listener,
                  self._data_listener):
            if s is not None:
                _quiet_close(s)
        self._peers = {}
        self._ctrl = {}
        self._pending_joins = []
        self._sent_log = {}


# ---------------------------------------------------------------------------
# helpers + process-global registry
# ---------------------------------------------------------------------------
def _parse_addr(address: str) -> Tuple[str, int]:
    if not address or ":" not in address:
        raise ValueError(
            f"coordinator address {address!r} must be host:port")
    host, _, port = address.rpartition(":")
    return host, int(port)


def _dial(host: str, port: int,
          timeout: float = _DIAL_TIMEOUT_S) -> socket.socket:
    """One bounded dial (no retry policy): failover walks and
    reconnects bound each candidate attempt themselves."""
    s = socket.create_connection((host, int(port)),
                                 timeout=max(0.1, timeout))
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def _listen(host: str, port: int) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.listen(64)
    return s


def _quiet_close(s: socket.socket) -> None:
    try:
        s.close()
    except OSError:
        pass


_active: Optional[TcpTransport] = None


def install(transport: Optional[TcpTransport]) -> None:
    """Install the process-global transport (``None`` uninstalls).
    ``distributed._allgather`` / ``_num_processes`` /
    ``sample_local_rows`` and the sharded candidate gather consult it
    before any other world query."""
    global _active
    if _active is not None and transport is not None \
            and _active is not transport:
        _active.close()
    _active = transport


def active() -> Optional[TcpTransport]:
    return _active


def xla_multiprocess_available(device=None) -> bool:
    """Whether the cross-process device plane can run for ``device``
    (a config's ``device``, "cuda" by default).  The JAX package's rule
    is "a non-CPU backend" (its CPU client runs no multiprocess
    computations); the port's counterpart is ``torch.distributed`` over
    NCCL on CUDA cards.  gloo runs the plane on the CPU too, but only
    when asked for explicitly (``collective_transport=xla``), so
    ``auto`` on the CPU stays tcp, as in the JAX package."""
    if str(device if device is not None else "cuda").lower() != "cuda":
        return False
    try:
        import torch
        import torch.distributed as dist
        return bool(torch.cuda.is_available() and dist.is_available()
                    and dist.is_nccl_available())
    except Exception:  # pragma: no cover - no torch.distributed at all
        return False


def resolve_transport_mode(config=None,
                           num_processes: Optional[int] = None) -> str:
    """``collective_transport`` resolution (JAX transport.py:1713-1731):
    explicit ``xla``/``tcp`` win; ``auto`` picks tcp exactly when a
    multi-process world is requested and the device plane is
    unavailable for the config's ``device``."""
    mode = str(getattr(config, "collective_transport", "auto")
               or "auto").lower()
    if mode not in TRANSPORT_MODES:
        raise ValueError(f"collective_transport must be one of "
                         f"{TRANSPORT_MODES}, got {mode!r}")
    if mode != "auto":
        return mode
    world = int(num_processes or 1)
    if world > 1 and not xla_multiprocess_available(
            getattr(config, "device", "cuda")):
        return "tcp"
    return "xla"
