"""The port's host-side TCP collective transport
(lightgbm_tpu_torch/parallel/transport.py) across THREADS over
localhost sockets: tests/test_transport.py's thread-world cases,
pointed at the port's modules.

Covered: Bruck allgather / ring allreduce / ring reduce-scatter,
``pmax`` and barrier (integer rings exact, float sums bit-identical to
the rank-ordered ``np.sum(np.stack(...))``), the q16/q8 hist_exchange
codec over the wire bit for bit against both the port's and the JAX
package's ``host_exchange_histograms``, the ``transport.connect`` /
``transport.round`` / ``transport.failover`` seams (peer_drop ->
TransportPeerLost, hung peer + ``watchdog_collective_s`` ->
StallError), frame CRC, dup and partition handling, coordinator
failover, the WorldLedger epoch protocol, the transport-aware world
view of ``distributed._num_processes`` / ``_process_index`` /
``sample_local_rows``, and ``collective_transport`` resolution (an
explicit ``xla`` raises: the torch.distributed plane is ROADMAP.md
queue 1, item 5b)."""
import socket
import threading
import time

import numpy as np
import pytest

from lightgbm_tpu.parallel import collectives as JC
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.parallel import collectives as C
from lightgbm_tpu_torch.parallel import distributed as D
from lightgbm_tpu_torch.parallel import transport as T
from lightgbm_tpu_torch.reliability import watchdog
from lightgbm_tpu_torch.reliability.faults import FAULTS
from lightgbm_tpu_torch.reliability.retry import is_transient
from lightgbm_tpu_torch.telemetry import TELEMETRY


@pytest.fixture(autouse=True)
def _clean():
    FAULTS.reset()
    watchdog.set_deadline("collective", 0.0)
    yield
    FAULTS.reset()
    watchdog.set_deadline("collective", 0.0)
    T.install(None)
    TELEMETRY.configure("off")
    TELEMETRY.reset()


def _free_coord():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return f"localhost:{port}"


def _run_world(world, fn, timeout=60.0, config=None):
    """Create a `world`-member transport across threads and run
    ``fn(transport, rank)`` on each; returns per-rank results.  Any
    member's exception is re-raised in the caller."""
    coord = _free_coord()
    results = [None] * world
    errors = [None] * world
    tps = [None] * world

    def _member(rank):
        try:
            tps[rank] = T.TcpTransport.create(coord, world, rank,
                                              config=config)
            results[rank] = fn(tps[rank], rank)
        except BaseException as e:  # noqa: BLE001 - relayed to caller
            errors[rank] = e
        finally:
            if tps[rank] is not None:
                tps[rank].close()

    threads = [threading.Thread(target=_member, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    hung = [i for i, t in enumerate(threads) if t.is_alive()]
    assert not hung, f"transport members hung: ranks {hung}"
    for e in errors:
        if e is not None:
            raise e
    return results


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 3])
def test_allgather_matches_stacked_rank_order(world):
    payloads = [np.arange(6, dtype=np.float32).reshape(2, 3) * (r + 1)
                for r in range(world)]
    expect = np.stack(payloads, axis=0)

    outs = _run_world(world, lambda tp, r: tp.allgather(payloads[r]))
    for out in outs:
        np.testing.assert_array_equal(out, expect)


def test_allgather_obj_variable_sizes_rank_order():
    objs = [b"x" * (r + 1) for r in range(3)]
    outs = _run_world(3, lambda tp, r: tp.allgather_obj(objs[r]))
    for out in outs:
        assert out == objs


@pytest.mark.parametrize("world", [2, 3])
def test_allreduce_integer_ring_exact(world):
    arrs = [np.arange(13, dtype=np.int64) * (r + 1) + r
            for r in range(world)]
    expect = np.sum(np.stack(arrs), axis=0)
    outs = _run_world(world, lambda tp, r: tp.allreduce_sum(arrs[r]))
    for out in outs:
        assert out.dtype == np.int64
        np.testing.assert_array_equal(out, expect)


def test_allreduce_float_bitmatches_host_collective_sum():
    rng = np.random.RandomState(3)
    arrs = [rng.randn(5, 7).astype(np.float32) for _ in range(3)]
    # the simulated in-process reduction every other seam produces
    expect = np.sum(np.stack(arrs, axis=0), axis=0)
    outs = _run_world(3, lambda tp, r: tp.allreduce_sum(arrs[r]))
    for out in outs:
        assert (out == expect).all(), "float allreduce must be " \
            "BIT-identical to the rank-ordered stacked sum"


def test_reduce_scatter_rank_owns_its_chunk():
    world = 3
    arrs = [np.arange(10, dtype=np.int64) * (r + 2)
            for r in range(world)]
    total = np.sum(np.stack(arrs), axis=0)
    chunks = np.array_split(total, world)
    outs = _run_world(world,
                      lambda tp, r: tp.reduce_scatter(arrs[r]))
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out, chunks[r])


def test_pmax_and_barrier():
    arrs = [np.array([r, 10 - r, 5], dtype=np.float32)
            for r in range(3)]
    expect = np.max(np.stack(arrs), axis=0)

    def _body(tp, r):
        out = tp.pmax(arrs[r])
        tp.barrier()
        return out

    for out in _run_world(3, _body):
        np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("mode", ["f32", "q16", "q8"])
def test_tcp_hist_exchange_bit_exact_vs_host_codec(mode):
    """The compressed exchange over real sockets: the integer payloads
    ship in their wire dtype and the reconstruction is bit-exact
    against the in-process host_exchange_histograms of both packages
    on the same shards — the transport cannot perturb trained trees."""
    world = 3
    rng = np.random.RandomState(11)
    hists = [(rng.randn(2, 4, 16, 3) * 40).astype(np.float32)
             for _ in range(world)]
    hists[1][0, 1] = 0.0                      # an all-zero histogram
    hists[2][1, 2] = np.round(hists[2][1, 2])  # an exact-int one
    expect = C.host_exchange_histograms(list(hists), mode=mode)
    np.testing.assert_array_equal(
        expect.view(np.uint32),
        JC.host_exchange_histograms(list(hists), mode=mode).view(np.uint32))

    outs = _run_world(
        world, lambda tp, r: tp.exchange_histograms(hists[r], mode))
    for out in outs:
        assert out.dtype == np.float32
        assert (out == expect).all(), \
            f"TCP {mode} exchange diverged from the host codec"


def test_tcp_collective_telemetry_counters():
    TELEMETRY.configure("counters")

    def _body(tp, r):
        tp.allgather(np.arange(8, dtype=np.float32))
        tp.allreduce_sum(np.arange(8, dtype=np.int64))
        return None

    _run_world(2, _body)
    counts = TELEMETRY.counters()
    assert counts.get("collective_tcp_bytes", 0) > 0
    assert counts.get("collective_tcp_rounds", 0) >= 2
    assert counts.get("collective_tcp_allgather_bytes", 0) > 0
    assert counts.get("collective_tcp_allreduce_rounds", 0) >= 1
    # latency histogram: _sum/_count live in the histogram family
    hists = getattr(TELEMETRY, "histograms", None)
    if callable(hists):
        assert any("collective_tcp_round_ms" in k for k in hists())


# ---------------------------------------------------------------------------
# reliability: seams, peer death, watchdog
# ---------------------------------------------------------------------------
def test_connect_seam_retries_transient_faults():
    # first connect attempt at the transport.connect seam fails with a
    # transient ConnectionError; the bounded retry policy re-enters
    # and the rendezvous completes
    FAULTS.configure("transport.connect:1:ConnectionError")
    outs = _run_world(2, lambda tp, r: tp.allgather_obj(r))
    assert outs[0] == [0, 1]
    assert any(f["seam"] == "transport.connect" for f in FAULTS.fired)


def test_peer_drop_classifies_as_transport_peer_lost():
    """An injected peer_drop (reset socket) surfaces as
    TransportPeerLost on the injected member — and the peer that was
    mid-gather with it sees the closed socket as TransportPeerLost
    too.  Both classify retry-TRANSIENT (ConnectionError subclass):
    the epoch protocol, not a blind retry, is the recovery path."""
    FAULTS.configure("transport.round:2:peer_drop")
    seen = []
    lock = threading.Lock()

    def _body(tp, r):
        try:
            tp.allgather_obj(r)
        except T.TransportPeerLost as e:
            with lock:
                seen.append(e)
            tp.close()   # the dropped member dies; EOF reaches peers
            return "lost"
        return "ok"

    outs = _run_world(2, _body)
    assert "lost" in outs
    assert seen and all(is_transient(e) for e in seen)
    assert all(isinstance(e, ConnectionError) for e in seen)


def test_hung_peer_stalls_under_collective_watchdog():
    """watchdog_collective_s arms PER TCP round: a peer that hangs
    instead of dying bounds the round's socket waits, records the
    stall and raises a classified, retry-transient StallError."""
    watchdog.set_deadline("collective", 0.3)
    stalls = []
    lock = threading.Lock()

    def _body(tp, r):
        if r == 1:
            time.sleep(1.2)      # the hung peer: misses the round
        try:
            tp.allgather_obj(r)
        except watchdog.StallError as e:
            with lock:
                stalls.append(e)
            return "stalled"
        return "ok"

    outs = _run_world(2, _body, timeout=30.0)
    assert "stalled" in outs
    for e in stalls:
        assert e.phase == "host_collective"
        assert e.seam == "transport.round"
        assert is_transient(e)


# ---------------------------------------------------------------------------
# world ledger + elastic membership
# ---------------------------------------------------------------------------
def test_world_ledger_degrade_admit_never_reuses_ranks():
    led = T.WorldLedger({0: ("a", 1), 1: ("b", 2), 2: ("c", 3)})
    assert led.world_size == 3 and led.epoch == 0
    deg = led.degrade([1])
    assert deg.ranks() == [0, 2] and deg.epoch == 1
    grown, assigned = deg.admit([("d", 4)])
    # the retired rank 1 is NOT reused: the joiner gets a fresh rank,
    # so a stale frame from the corpse can never be misattributed
    assert assigned == [3]
    assert grown.ranks() == [0, 2, 3] and grown.epoch == 2
    rt = T.WorldLedger.from_state(grown.to_state())
    assert rt.members == grown.members and rt.epoch == grown.epoch
    with pytest.raises(T.TransportError):
        led.degrade([0, 1, 2])


def test_epoch_tick_unchanged_world_is_cheap_noop():
    def _body(tp, r):
        info = tp.epoch_tick()
        return info

    for info in _run_world(3, _body):
        assert info["changed"] is False
        assert info["epoch"] == 0 and info["world_size"] == 3


def test_elastic_death_then_rejoin_with_handoff():
    """The full grow-and-shrink-live story across threads: rank 2
    dies, the survivors reform degraded at an epoch boundary, a NEW
    participant joins, receives the state + manifest handoff, and the
    reformed 3-member world completes a collective correctly."""
    coord = _free_coord()
    world = 3
    degraded = threading.Event()
    outcome = {}
    errors = []
    lock = threading.Lock()

    def _survivor(rank):
        try:
            tp = T.TcpTransport.create(coord, world, rank)
            if rank == 0:
                tp.handoff_meta = {"manifest_dir": "/tmp/shards"}
            tp.barrier()
            if rank == 2:
                tp.close()          # dies between epochs
                return
            # boundary 1: the corpse retires (degraded continuation)
            info = tp.epoch_tick(handoff=lambda: b"MODEL-STATE",
                                 allow_degraded=True)
            with lock:
                outcome[f"tick1_r{rank}"] = info
            degraded.set()
            time.sleep(0.5)         # let the joiner's JOIN land
            # boundary 2: the joiner is admitted
            info = tp.epoch_tick(handoff=lambda: b"MODEL-STATE",
                                 allow_degraded=True)
            with lock:
                outcome[f"tick2_r{rank}"] = info
            got = tp.allgather_obj(("rank", tp.rank))
            with lock:
                outcome[f"gather_r{rank}"] = got
            tp.close()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            with lock:
                errors.append((rank, e))

    def _joiner():
        try:
            assert degraded.wait(30.0)
            tp = T.TcpTransport.join(coord)
            with lock:
                outcome["join_handoff"] = tp.handoff
                outcome["join_rank"] = tp.rank
                outcome["join_epoch"] = tp.epoch
            got = tp.allgather_obj(("rank", tp.rank))
            with lock:
                outcome["gather_join"] = got
            tp.close()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            with lock:
                errors.append(("joiner", e))

    threads = [threading.Thread(target=_survivor, args=(r,),
                                daemon=True) for r in range(world)]
    threads.append(threading.Thread(target=_joiner, daemon=True))
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not any(t.is_alive() for t in threads), \
        f"elastic scenario hung (outcome so far: {sorted(outcome)})"
    assert not errors, errors

    t1 = outcome["tick1_r0"]
    assert t1["changed"] and t1["dead"] == [2]
    assert t1["world_size"] == 2 and t1["epoch"] == 1
    t2 = outcome["tick2_r0"]
    assert t2["changed"] and t2["admitted"] == [3]
    assert t2["world_size"] == 3 and t2["epoch"] == 2
    # the joiner took a FRESH rank and got the state + manifest
    assert outcome["join_rank"] == 3 and outcome["join_epoch"] == 2
    assert outcome["join_handoff"]["state"] == b"MODEL-STATE"
    assert outcome["join_handoff"]["meta"] == {
        "manifest_dir": "/tmp/shards"}
    expect = [("rank", 0), ("rank", 1), ("rank", 3)]
    assert outcome["gather_r0"] == expect
    assert outcome["gather_r1"] == expect
    assert outcome["gather_join"] == expect


def test_dead_peer_without_allow_degraded_is_loud():
    coord = _free_coord()
    errors = []
    results = {}
    lock = threading.Lock()

    def _member(rank):
        try:
            tp = T.TcpTransport.create(coord, 2, rank)
            tp.barrier()
            if rank == 1:
                tp.close()
                return
            try:
                tp.epoch_tick(allow_degraded=False)
                with lock:
                    results[rank] = "ticked"
            except T.TransportPeerLost as e:
                with lock:
                    results[rank] = e
            tp.close()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            with lock:
                errors.append((rank, e))

    threads = [threading.Thread(target=_member, args=(r,), daemon=True)
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not errors, errors
    assert isinstance(results[0], T.TransportPeerLost)
    assert results[0].peer_rank == 1


# ---------------------------------------------------------------------------
# frame integrity + versioning (wire v2)
# ---------------------------------------------------------------------------
def test_frame_crc_rejects_corrupt_payload_loudly():
    """A bit-flipped payload under a truthful header CRC raises
    FrameCorrupt naming tag + peer, bumps the counter, and journals —
    never silently returns wrong bytes."""
    TELEMETRY.configure("counters")
    a, b = socket.socketpair()
    try:
        payload = b"histogram-bytes" * 10
        crc = T._payload_crc(payload)
        bad = bytearray(payload)
        bad[3] ^= 0x40
        a.sendall(T._HDR.pack(T._MAGIC, T.PROTOCOL_VERSION,
                              T.TAG_DATA, 7, len(bad), crc)
                  + bytes(bad))
        with pytest.raises(T.FrameCorrupt) as ei:
            T._recv_frame(b, T.TAG_DATA, peer=5)
        assert ei.value.tag == T.TAG_DATA and ei.value.peer == 5
        assert "peer 5" in str(ei.value)
    finally:
        a.close()
        b.close()
    assert TELEMETRY.counters().get("collective_tcp_crc_errors", 0) \
        == 1
    assert any(e["kind"] == "crc_error"
               for e in TELEMETRY.journal.events())


def test_payload_digest_tiers_catch_bit_flips():
    """Both digest tiers (plain crc32 under the fold threshold, the
    crc32'd XOR word-fold above it) change under a single flipped bit
    at the start, middle and end of the payload."""
    for payload in (b"\x5a" * 100, b"\x5a" * 100_000):
        ref = T._payload_crc(payload)
        for pos in (0, len(payload) // 2, len(payload) - 1):
            bad = bytearray(payload)
            bad[pos] ^= 0x10
            assert T._payload_crc(bytes(bad)) != ref, \
                f"flip at {pos}/{len(payload)} escaped the digest"


def test_version_skew_refused_with_actionable_message():
    """A frame from a peer speaking another protocol version is
    refused BEFORE its length field is trusted, and the handshake
    layer refuses a skewed HELLO/IDENT — both messages name the fix
    (finish the rolling restart)."""
    a, b = socket.socketpair()
    try:
        a.sendall(T._HDR.pack(T._MAGIC, T.PROTOCOL_VERSION - 1,
                              T.TAG_DATA, 0, 4, 0) + b"xxxx")
        with pytest.raises(T.TransportError, match="upgrade skew"):
            T._recv_frame(b, peer=3)
    finally:
        a.close()
        b.close()
    with pytest.raises(T.TransportError, match="rolling restart"):
        T._refuse_skew({"ver": T.PROTOCOL_VERSION - 1},
                       "rendezvous HELLO from rank 1")


def test_corrupt_frame_retries_clean_bit_exact():
    """Chaos ``corrupt``: the receiver's CRC catches the flipped
    frame, the link reconnects within the epoch, the round re-sends
    the TRUE bytes, and every collective lands bit-exact."""
    TELEMETRY.configure("counters")
    FAULTS.configure("transport.round:3:corrupt")
    watchdog.set_deadline("collective", 8.0)

    def _body(tp, r):
        return [tp.allreduce_sum(
            np.arange(8, dtype=np.int64) * (k + 1) + r)
            for k in range(4)]

    outs = _run_world(2, _body)
    for r in range(2):
        for k in range(4):
            np.testing.assert_array_equal(
                outs[r][k],
                np.arange(8, dtype=np.int64) * (k + 1) * 2 + 1)
    c = TELEMETRY.counters()
    assert c.get("collective_tcp_crc_errors", 0) >= 1
    assert c.get("collective_tcp_reconnects", 0) >= 1


# ---------------------------------------------------------------------------
# transient-blip reconnection (in-epoch) + coordinator failover
# ---------------------------------------------------------------------------
def test_partition_heals_within_epoch_idempotent():
    """Chaos ``partition:<ms>``: the severed link heals by an
    in-epoch reconnect (IDENT epoch+rank handshake, ack-based
    resend), the seq dup-discard keeps the retried round idempotent,
    and NOTHING degrades: same epoch, same world, bit-exact sums."""
    TELEMETRY.configure("counters")
    FAULTS.configure("transport.round:3:partition:60")
    watchdog.set_deadline("collective", 8.0)
    state = {}

    def _body(tp, r):
        outs = [tp.allreduce_sum(
            np.arange(8, dtype=np.int64) * (k + 1) + r)
            for k in range(5)]
        state[r] = (tp.epoch, tp.world_size)
        return outs

    outs = _run_world(2, _body)
    for r in range(2):
        for k in range(5):
            np.testing.assert_array_equal(
                outs[r][k],
                np.arange(8, dtype=np.int64) * (k + 1) * 2 + 1)
        assert state[r] == (0, 2), \
            "a transient partition must not degrade the world"
    c = TELEMETRY.counters()
    assert c.get("collective_tcp_reconnects", 0) >= 1
    assert any(e["kind"] == "reconnect"
               for e in TELEMETRY.journal.events())


def test_dup_frame_discarded_by_sequence():
    """Chaos ``dup``: a replayed frame (original seq) is discarded by
    the receiver's sequence check — counted, harmless, bit-exact."""
    TELEMETRY.configure("counters")
    FAULTS.configure("transport.round:3:dup")

    def _body(tp, r):
        return [tp.allreduce_sum(
            np.arange(8, dtype=np.int64) * (k + 1) + r)
            for k in range(4)]

    outs = _run_world(2, _body)
    for r in range(2):
        for k in range(4):
            np.testing.assert_array_equal(
                outs[r][k],
                np.arange(8, dtype=np.int64) * (k + 1) * 2 + 1)
    assert TELEMETRY.counters().get(
        "collective_tcp_dup_frames", 0) >= 1


def test_coordinator_death_promotes_lowest_surviving_rank():
    """Coordinator failover end to end: rank 0 dies, rank 1 (the
    lowest survivor — named by the replicated ledger, no election)
    takes over the epoch protocol mid-run and journals the change,
    rank 2 re-homes its control traffic, and the reformed world
    completes a bit-exact collective."""
    TELEMETRY.configure("counters")
    coord = _free_coord()
    world = 3
    outcome = {}
    errors = []
    lock = threading.Lock()

    def _member(rank):
        try:
            tp = T.TcpTransport.create(coord, world, rank)
            tp.barrier()
            if rank == 0:
                tp.close()             # the coordinator dies
                return
            info = tp.epoch_tick(handoff=lambda: b"",
                                 allow_degraded=True)
            got = tp.allreduce_sum(
                np.arange(6, dtype=np.int64) + tp.rank)
            with lock:
                outcome[rank] = (info, tp.is_coordinator, got,
                                 tp.world_size)
            tp.close()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            with lock:
                errors.append((rank, e))

    threads = [threading.Thread(target=_member, args=(r,),
                                daemon=True) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(40.0)
    assert not any(t.is_alive() for t in threads), \
        f"failover hung (outcome so far: {sorted(outcome)})"
    assert not errors, errors
    info1, is_coord1, got1, ws1 = outcome[1]
    info2, is_coord2, got2, ws2 = outcome[2]
    assert info1["changed"] and 0 in info1["dead"]
    assert ws1 == ws2 == 2 and info1["epoch"] == 1
    assert is_coord1 and not is_coord2, \
        "the LOWEST surviving rank must be the successor"
    expect = np.arange(6, dtype=np.int64) * 2 + 3
    np.testing.assert_array_equal(got1, expect)
    np.testing.assert_array_equal(got2, expect)
    c = TELEMETRY.counters()
    assert c.get("collective_tcp_coordinator_changes", 0) >= 1
    assert c.get("collective_tcp_rehomes", 0) >= 1
    assert any(e["kind"] == "coordinator_change"
               for e in TELEMETRY.journal.events())


def test_stale_coordinator_joiner_walks_ledger():
    """A joiner handed a DEAD coordinator address plus a replicated
    ledger walks the member list: the first live member it reaches is
    the coordinator (lowest-live-rank invariant), and admission
    proceeds normally from there."""
    coord = _free_coord()
    stale = _free_coord()                 # nothing ever listens here
    world = 2
    ledger_state = {}
    ready = threading.Event()
    outcome = {}
    errors = []
    lock = threading.Lock()

    def _member(rank):
        try:
            tp = T.TcpTransport.create(coord, world, rank)
            with lock:
                if not ledger_state:
                    ledger_state.update(tp.ledger.to_state())
            tp.barrier()
            ready.set()
            time.sleep(0.5)            # let the walked JOIN land
            info = tp.epoch_tick(handoff=lambda: b"WALKED",
                                 allow_degraded=True)
            got = tp.allgather_obj(("rank", tp.rank))
            with lock:
                outcome[rank] = (info, got)
            tp.close()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            with lock:
                errors.append((rank, e))

    def _joiner():
        try:
            assert ready.wait(30.0)
            tp = T.TcpTransport.join(stale, ledger=ledger_state)
            got = tp.allgather_obj(("rank", tp.rank))
            with lock:
                outcome["join"] = (tp.rank, tp.handoff["state"], got)
            tp.close()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            with lock:
                errors.append(("joiner", e))

    threads = [threading.Thread(target=_member, args=(r,),
                                daemon=True) for r in range(world)]
    threads.append(threading.Thread(target=_joiner, daemon=True))
    for t in threads:
        t.start()
    for t in threads:
        t.join(40.0)
    assert not any(t.is_alive() for t in threads), \
        f"joiner walk hung (outcome so far: {sorted(map(str, outcome))})"
    assert not errors, errors
    join_rank, join_state, join_got = outcome["join"]
    assert join_rank == 2 and join_state == b"WALKED"
    expect = [("rank", 0), ("rank", 1), ("rank", 2)]
    assert join_got == expect
    assert outcome[0][1] == expect and outcome[1][1] == expect
    assert outcome[0][0]["admitted"] == [2]


def test_failover_seam_injected_fault_is_peer_lost():
    """An injected fault at the ``transport.failover`` seam (chaos
    hitting the walk itself) converts to TransportPeerLost — the
    degrade/abort path, never a hang or a silent retry loop."""
    FAULTS.configure("transport.failover:1:ConnectionError")
    coord = _free_coord()
    results = {}
    errors = []
    lock = threading.Lock()

    def _member(rank):
        try:
            tp = T.TcpTransport.create(coord, 2, rank)
            tp.barrier()
            if rank == 0:
                tp.close()
                return
            try:
                tp.epoch_tick(allow_degraded=True)
                with lock:
                    results[rank] = "ticked"
            except T.TransportPeerLost as e:
                with lock:
                    results[rank] = e
            tp.close()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            with lock:
                errors.append((rank, e))

    threads = [threading.Thread(target=_member, args=(r,),
                                daemon=True) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not errors, errors
    assert isinstance(results[1], T.TransportPeerLost)
    assert any(f["seam"] == "transport.failover"
               for f in FAULTS.fired)


# ---------------------------------------------------------------------------
# world view + mode resolution + config
# ---------------------------------------------------------------------------
class _StubTransport:
    world_size = 3
    rank = 2
    epoch_every = 1

    def close(self):
        pass


def test_world_view_consults_active_transport():
    """Satellite: _num_processes / _process_index / sample_local_rows
    report the TRANSPORT's world (degraded/elastic worlds report
    honest sizes), not only jax.process_count()."""
    assert D._num_processes() == 1
    assert D._process_index() == 0
    stub = _StubTransport()
    T.install(stub)
    try:
        assert D._num_processes() == 3
        assert D._process_index() == 2
        # the sampling seed derives from the HELD rank
        data = np.arange(40, dtype=np.float64).reshape(10, 4)
        as_rank2 = D.sample_local_rows(data, 4, seed=7)
        T.install(None)
        as_rank0 = D.sample_local_rows(data, 4, seed=7)
        assert not np.array_equal(as_rank2, as_rank0)
    finally:
        T.install(None)
    assert D._num_processes() == 1


def test_resolve_transport_mode_matrix():
    # explicit tcp wins
    assert T.resolve_transport_mode(
        Config(collective_transport="tcp"), 1) == "tcp"
    # explicit xla wins: the cross-process device plane, which on
    # device=cuda needs a card (none here) and says so
    assert T.resolve_transport_mode(
        Config(collective_transport="xla"), 8) == "xla"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.initialize("localhost:1", 2, 0,
                     config=Config(collective_transport="xla"))
    assert D.plane() is None
    # auto: single process never needs a plane; more than one process
    # takes the TCP plane where the device plane cannot run (no card)
    assert T.resolve_transport_mode(Config(), 1) == "xla"
    assert not T.xla_multiprocess_available()
    assert T.resolve_transport_mode(Config(), 2) == "tcp"
    # a world of one process returns at once
    D.initialize(config=Config(collective_transport="tcp"))
    assert T.active() is None


def test_config_transport_knobs_validate():
    assert Config(collective_transport="tcp",
                  transport_epoch_iters=3).transport_epoch_iters == 3
    with pytest.raises(ValueError, match="collective_transport"):
        Config(collective_transport="udp")
    with pytest.raises(ValueError, match="transport_epoch_iters"):
        Config(transport_epoch_iters=0)


def test_fault_plan_peer_actions_grammar():
    from lightgbm_tpu_torch.reliability.chaos import chaos_spec
    from lightgbm_tpu_torch.reliability.faults import parse_plan
    entries = parse_plan("transport.round:1:peer_drop;"
                         "transport.round:2:peer_slow:25")
    assert [e.action for e in entries] == ["peer_drop", "peer_slow"]
    assert entries[1].duration_ms == 25
    with pytest.raises(ValueError):
        parse_plan("transport.round:1:peer_slow")   # needs :<ms>
    # chaos draws over transport seams may include the peer actions,
    # and the expansion stays deterministic per seed
    spec = chaos_spec(7, 4, "transport.*")
    assert spec == chaos_spec(7, 4, "transport.*")
    for entry in spec.split(";"):
        assert entry.split(":")[0].startswith("transport.")
