"""WebSocket/SSE broadcast hub and the frame outbox.

The port's own copy of ``binquant_tpu/fanout/hub.py`` (stdlib asyncio and
numpy). The serving half of the fan-out plane: subscribers connect over
WebSocket (``GET /ws?user=<id>[&cursor=<c>]``) or Server-Sent Events
(``GET /sse?user=<id>[&cursor=<c>]``, ``Last-Event-ID`` honored) and
receive exactly the signal frames the device match addressed to them.
RFC 6455's server side is written out here, the
:class:`~binquant_tpu_torch.obs.exposition.MetricsServer` idiom.

Backpressure (the delivery plane's "lossy" class, per connection): every
connection owns a BOUNDED queue drained by its writer task. A slow or
stalled consumer fills its queue and overflow frames are shed with a
counted reason (``bqt_fanout_shed_total{reason=slow_consumer}``) and the
connection marked ``gapped`` — the tick's thread (and every other
subscriber) never waits. A gapped client recovers by reconnecting with a
cursor: the hub replays the gap from the :class:`BroadcastOutbox`
(append-only JSONL with packed recipient words per frame, size-bounded by
an O(1) two-generation file swap) or, when the cursor lies inside it, from
the in-memory tail ring of the last ``tail_cap`` frames.

Cursor semantics: every frame carries a monotonically increasing ``seq``
(the SSE ``id``) and its ``trace_id`` / ``tick_seq`` provenance stamps;
``cursor=<seq>`` resumes strictly after that frame, and
``cursor=<trace_id>/<tick_seq>`` resolves through the outbox to the LAST
frame of that traced tick (at-least-once within a tick).

:class:`ShardedBroadcastOutbox` splits the outbox into per-shard
partitions (``<path>.pK-of-N``, routed by the firing row's shard) under the
one global cursor: appends go to the firing row's partition, every read
serves the merged, seq-ordered stream, and partitions of an earlier count
(or a single-file log at the base path) are folded in read-only. Either
package reads the other's partitions.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import os
import time
from collections import deque
from pathlib import Path
from urllib.parse import parse_qs

import numpy as np

from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import (
    DELIVERY_CURSOR_LAG,
    FANOUT_CONN_QUEUE_DEPTH,
    FANOUT_CONNECTIONS,
    FANOUT_FRAMES,
    FANOUT_RESUME_FALLBACK,
    FANOUT_RESUME_REPLAYED,
    FANOUT_SHED,
    FANOUT_WRITE_LATENCY,
)

log = logging.getLogger(__name__)

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


# -- RFC 6455 codec helpers (the server side and a test client's) -------------


def ws_accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _WS_MAGIC).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def ws_encode_frame(
    payload: bytes, opcode: int = 0x1, mask: bytes | None = None
) -> bytes:
    """One FIN frame. Servers send unmasked; a client passes a
    4-byte ``mask`` (clients MUST mask per RFC 6455 §5.3)."""
    head = bytearray([0x80 | (opcode & 0x0F)])
    mask_bit = 0x80 if mask is not None else 0
    n = len(payload)
    if n < 126:
        head.append(mask_bit | n)
    elif n < 1 << 16:
        head.append(mask_bit | 126)
        head += n.to_bytes(2, "big")
    else:
        head.append(mask_bit | 127)
        head += n.to_bytes(8, "big")
    if mask is not None:
        head += mask
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


async def ws_read_frame(reader: asyncio.StreamReader) -> tuple[int, bytes]:
    """Read one frame → (opcode, unmasked payload). Raises
    ``ConnectionError`` on EOF mid-frame."""
    try:
        b0, b1 = await reader.readexactly(2)
    except asyncio.IncompleteReadError as exc:
        raise ConnectionError("ws peer closed") from exc
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        n = int.from_bytes(await reader.readexactly(2), "big")
    elif n == 127:
        n = int.from_bytes(await reader.readexactly(8), "big")
    mask = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(n) if n else b""
    if mask:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return opcode, payload


# -- outbox ------------------------------------------------------------------


class BroadcastOutbox:
    """Append-only JSONL log of broadcast frames + their packed recipient
    words — what a reconnecting client's cursor replays from. Lossy-tier
    durability: flushed per append, NOT fsynced (a host crash may lose the
    tail; the delivery WAL owns the at-least-once class). Size-bounded by
    a two-generation swap: when the live file reaches ``cap`` entries it
    is renamed to ``<path>.1`` (dropping the previous generation) and
    appends continue into a fresh live file — rotation is one O(1)
    ``os.replace``, never a content rewrite on the tick finalize path (at
    1M-subscription scale a line carries ~170 KB of packed words; a
    rewrite there would stall finalize for the whole retained window).
    Total retention stays within ``cap``..``2 × cap`` entries."""

    def __init__(self, path: str | Path, cap: int = 4096) -> None:
        self.path = Path(path)
        self.cap = max(int(cap), 1)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._gen1 = self.path.with_name(self.path.name + ".1")
        self._lines = sum(1 for _ in open(self.path)) if self.path.exists() else 0
        self._f = open(self.path, "a", encoding="utf-8")
        self.appends = 0
        self.rotations = 0

    def append(self, frame: dict, words: np.ndarray) -> None:
        rec = {
            "frame": frame,
            "w": base64.b64encode(
                np.ascontiguousarray(words, np.uint32).tobytes()
            ).decode("ascii"),
        }
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()
        self.appends += 1
        self._lines += 1
        if self._lines >= self.cap:
            self._rotate()

    def _rotate(self) -> None:
        self._f.close()
        os.replace(self.path, self._gen1)
        self._f = open(self.path, "a", encoding="utf-8")
        self._lines = 0
        self.rotations += 1

    def entries(self) -> list[tuple[dict, np.ndarray]]:
        """Every (frame, recipient words) pair in append order; torn
        lines skipped."""
        return _read_entries((self._gen1, self.path))  # gen-1 is strictly older

    def last_seq(self) -> int:
        """Highest frame seq in the log (-1 when empty) — what a plane
        reopening a persistent outbox seeds its counter PAST, so
        post-restart frames never collide with retained ones (a collision
        would silently hide them from every cursor replay)."""
        best = -1
        for frame, _ in self.entries():
            best = max(best, int(frame.get("seq", -1)))
        return best

    def resolve_cursor(
        self, cursor: str, entries: list | None = None
    ) -> int | None:
        """Cursor string → frame seq to resume AFTER. ``"17"`` is a frame
        seq; ``"<trace_id>/<tick_seq>"`` resolves to that traced tick's
        LAST frame in the log (None = unresolvable — caller treats the
        connect as cursor-less). ``entries`` reuses a caller's scan."""
        cursor = cursor.strip()
        if not cursor:
            return None
        try:
            return int(cursor)
        except ValueError:
            pass
        if "/" not in cursor:
            return None
        trace_id, _, tick_s = cursor.rpartition("/")
        try:
            tick_seq = int(tick_s)
        except ValueError:
            return None
        best = None
        for frame, _ in entries if entries is not None else self.entries():
            if (
                frame.get("trace_id") == trace_id
                and frame.get("tick_seq") == tick_seq
            ):
                best = int(frame["seq"])
        return best

    def replay_after(
        self, seq: int, slot: int, entries: list | None = None
    ) -> list[dict]:
        """Frames with ``seq`` strictly greater whose recipient bit for
        ``slot`` is set — a reconnect's gap. ``entries`` reuses a
        caller's scan."""
        w, bit = slot >> 5, np.uint32(1 << (slot & 31))
        out = []
        for frame, words in entries if entries is not None else self.entries():
            if int(frame.get("seq", -1)) <= seq:
                continue
            if w < len(words) and (words[w] & bit):
                out.append(frame)
        return out

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:  # pragma: no cover
            pass


def _read_entries(paths) -> list[tuple[dict, np.ndarray]]:
    """The (frame, recipient words) records of outbox files, in file then
    line order; a missing or unreadable file and torn lines are skipped."""
    out = []
    for p in paths:
        try:
            with open(p, encoding="utf-8") as f:
                lines = [line.rstrip("\n") for line in f if line.strip()]
        except OSError:
            continue
        for raw in lines:
            try:
                rec = json.loads(raw)
                out.append((rec["frame"], np.frombuffer(base64.b64decode(rec["w"]), np.uint32)))
            except (ValueError, KeyError):
                continue
    return out


class ShardedBroadcastOutbox:
    """:class:`BroadcastOutbox` split into per-shard partitions under ONE
    global cursor. Appends route by ``shard_of(frame)`` (the firing row's
    shard) into ``<path>.pK-of-N`` partition logs, each bounded by ``cap``
    as a :class:`BroadcastOutbox` is; every read (``entries``,
    ``last_seq``, ``resolve_cursor``, ``replay_after``) serves the merged
    stream in seq order, so the hub sees one population and cursors of an
    unsharded deployment keep resolving. Partition files of an earlier
    count, and a single-file log at ``path`` itself (with its ``.1``
    generation), are folded in read-only as retired sources: their frames
    stay replayable and seed ``last_seq``. A drop-in for
    :class:`BroadcastOutbox`."""

    def __init__(self, path: str | Path, n_shards: int, cap: int = 4096, shard_of=None) -> None:
        self.path = Path(path)
        self.n_shards = max(int(n_shards), 1)
        self.cap = max(int(cap), 1)
        self._shard_of = shard_of
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._parts = [
            BroadcastOutbox(
                self.path.with_name(f"{self.path.name}.p{k}-of-{self.n_shards}"), cap=self.cap
            )
            for k in range(self.n_shards)
        ]
        self._retired: list[Path] = [
            p for p in (self.path.with_name(self.path.name + ".1"), self.path) if p.is_file()
        ]
        live = {part.path.name for part in self._parts} | {part._gen1.name for part in self._parts}
        self._retired += [
            p for p in sorted(self.path.parent.glob(f"{self.path.name}.p*-of-*"))
            if p.name not in live and p.is_file()
        ]

    @property
    def appends(self) -> int:
        return sum(p.appends for p in self._parts)

    @property
    def rotations(self) -> int:
        return sum(p.rotations for p in self._parts)

    def _route(self, frame: dict) -> int:
        """The frame's partition: ``shard_of(frame)``, or (no router, or
        one that fails or answers out of range) a stable hash of the
        symbol name; merge order is by seq either way."""
        if self._shard_of is not None:
            try:
                k = int(self._shard_of(frame))
                if 0 <= k < self.n_shards:
                    return k
            except Exception:
                pass
        return sum(str(frame.get("symbol", "")).encode()) % self.n_shards

    def append(self, frame: dict, words: np.ndarray) -> None:
        self._parts[self._route(frame)].append(frame, words)

    def entries(self) -> list[tuple[dict, np.ndarray]]:
        """The retired sources' and every partition's records, merged in
        the plane's global seq order."""
        out = _read_entries(self._retired)
        for part in self._parts:
            out.extend(part.entries())
        out.sort(key=lambda e: int(e[0].get("seq", -1)))
        return out

    def last_seq(self) -> int:
        return BroadcastOutbox.last_seq(self)

    def resolve_cursor(self, cursor: str, entries: list | None = None) -> int | None:
        return BroadcastOutbox.resolve_cursor(
            self, cursor, entries if entries is not None else self.entries()
        )

    def replay_after(self, seq: int, slot: int, entries: list | None = None) -> list[dict]:
        return BroadcastOutbox.replay_after(
            self, seq, slot, entries if entries is not None else self.entries()
        )

    def close(self) -> None:
        for part in self._parts:
            part.close()


# -- connections -------------------------------------------------------------


class _Connection:
    def __init__(
        self, user_id: str, slot: int, transport: str, queue_max: int
    ) -> None:
        self.user_id = user_id
        self.slot = int(slot)
        self.transport = transport  # "ws" | "sse"
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=max(queue_max, 1))
        self.delivered = 0
        self.dropped = 0
        self.replayed = 0
        self.gapped = False
        self.lag_ms_sum = 0.0
        self.lag_ms_max = 0.0
        # highest frame seq WRITTEN to this peer's socket — the hub's
        # cursor-lag watermark compares it against the outbox head to
        # report how far the laggiest consumer trails
        self.last_seq = -1
        self.closed = asyncio.Event()
        # set by FanoutHub._close_conn: the close bookkeeping (per-user
        # totals fold + conn_close event) must run exactly once whether
        # the handler's finally or hub.stop() gets there first
        self.finalized = False

    def offer(self, item: tuple) -> bool:
        try:
            self.queue.put_nowait(item)
            return True
        except asyncio.QueueFull:
            self.dropped += 1
            self.gapped = True
            return False

    def note_delivered(self, t_pub: float | None, seq: int = -1) -> None:
        self.delivered += 1
        if seq > self.last_seq:
            self.last_seq = seq
        if t_pub is not None:
            # subscriber match→socket-write latency: t_pub is stamped by
            # FanoutPlane.on_fired at frame mint, so this spans bitset
            # match + queue dwell + the actual transport write
            lag = (time.perf_counter() - t_pub) * 1000.0
            self.lag_ms_sum += lag
            self.lag_ms_max = max(self.lag_ms_max, lag)
            FANOUT_WRITE_LATENCY.labels(transport=self.transport).observe(lag)

    def stats(self) -> dict:
        return {
            "user": self.user_id,
            "transport": self.transport,
            "delivered": self.delivered,
            "dropped": self.dropped,
            "replayed": self.replayed,
            "gapped": self.gapped,
            "lag_ms_mean": (
                round(self.lag_ms_sum / self.delivered, 3)
                if self.delivered
                else None
            ),
            "lag_ms_max": round(self.lag_ms_max, 3),
            "last_seq": self.last_seq,
            "queue_depth": self.queue.qsize(),
        }


class FanoutHub:
    """The broadcast tier: an asyncio socket server fanning matched frames
    out to per-user WS/SSE connections. ``slot_of`` maps a connecting
    user id to its subscription slot (unknown users are refused with 404
    — subscribe first, then connect)."""

    def __init__(
        self,
        slot_of,
        outbox: BroadcastOutbox | None = None,
        conn_queue_max: int = 256,
        host: str = "0.0.0.0",
        port: int = 0,
        min_seq_of=None,
        tail_cap: int = 0,
    ) -> None:
        self.slot_of = slot_of
        # slot → lowest frame seq the slot's CURRENT owner may receive
        # (slots recycle on unsubscribe; frames below the floor were
        # addressed to a previous owner and must not deliver or replay)
        self.min_seq_of = min_seq_of or (lambda slot: 0)
        self.outbox = outbox
        self.conn_queue_max = int(conn_queue_max)
        self.host = host
        self.port = int(port)
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[_Connection] = set()
        # in-memory ring of the last `tail_cap` broadcast frames (seq,
        # encoded payload, packed recipient words): a reconnect whose
        # numeric cursor lands inside the retained window replays from
        # here instead of re-parsing the whole outbox — the hot path for
        # fresh cursors. Cursors the ring can't serve fall back to the
        # outbox scan with a counted reason.
        self.tail_cap = max(int(tail_cap), 0)
        self._tail: deque | None = (
            deque(maxlen=self.tail_cap) if self.tail_cap else None
        )
        self.tail_resumes = 0
        self.resume_fallbacks: dict[str, int] = {}
        # seq range [lo, hi] excluded from every replay: frames published
        # between a fanout snapshot save and the crash were addressed by
        # a registry whose post-save churn a restore cannot reconstruct
        # (slot may have changed hands) — replaying them against the
        # restored layout risks cross-user misdelivery
        self.replay_excluded: tuple[int, int] | None = None
        self.frames_sent = 0
        self.shed = 0
        self.resumed = 0
        # highest frame seq broadcast so far — the head the fan-out
        # consumer-group cursor lag is measured against (a memory-held
        # mirror; outbox.last_seq() is a full-file scan, unfit for
        # snapshot-rate reads)
        self.head_seq = -1
        # accumulated per-user delivery totals incl. closed connections —
        # the report tool's "hottest subscriptions" feed
        self.totals_by_user: dict[str, int] = {}

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("fanout hub listening on %s:%d", self.host, self.port)
        return self.port

    async def stop(self) -> None:
        # close the still-open connections FIRST: their delivery totals fold
        # now (the plane emits fanout_summary right after stop()), and their
        # handlers return. Since Python 3.12.1 ``Server.wait_closed()``
        # waits for every open connection, and an SSE handler whose peer
        # went away never reads its socket, so waiting before closing them
        # never returns (the reference waits first). _close_conn is
        # idempotent: the handlers' own later calls are no-ops.
        for conn in list(self._conns):
            self._close_conn(conn)
        self._conns.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    @property
    def connections(self) -> int:
        return len(self._conns)

    def close_user(self, user_id: str) -> int:
        """Close every connection bound to ``user_id`` (called on
        unsubscribe: the freed slot may be reclaimed by another user, and
        a connection still holding it would receive the claimant's
        frames). Returns the number of connections closed."""
        victims = [c for c in self._conns if c.user_id == user_id]
        for conn in victims:
            conn.closed.set()
            self._conns.discard(conn)
        return len(victims)

    def rebind_slots(self, reason: str = "compaction") -> int:
        """Re-resolve every open connection's slot after the registry
        re-packed (compaction moves users to new slots); a connection
        whose user vanished closes. The tail ring resets too — its packed
        recipient words address the OLD slot layout and would misdeliver
        against the new one."""
        rebound = 0
        for conn in list(self._conns):
            slot = self.slot_of(conn.user_id)
            if slot is None:
                conn.closed.set()
                self._conns.discard(conn)
                continue
            if int(slot) != conn.slot:
                conn.slot = int(slot)
                rebound += 1
        self.reset_tail()
        get_event_log().emit(
            "fanout_rebind", reason=reason, rebound=rebound
        )
        return rebound

    def reset_tail(self) -> None:
        if self._tail is not None:
            self._tail.clear()

    def cursor_lag(self) -> int:
        """Records-behind-head for the hub's LAGGIEST open connection —
        the fan-out plane's entry in the per-consumer-group cursor-lag
        watermark (the delivery lanes are the other three groups). A
        connection that has written frames trails by ``head_seq -
        last_seq``; one that hasn't yet trails by its queued backlog.
        Refreshes the gauge on read, the watermark pattern (labelled
        fanout_hub — the delivery plane's "fanout" lane is the
        worker-side group; this one is the socket-side consumers)."""
        lag = 0
        for conn in self._conns:
            if conn.last_seq >= 0 and self.head_seq >= 0:
                lag = max(lag, self.head_seq - conn.last_seq)
            else:
                lag = max(lag, conn.queue.qsize())
        DELIVERY_CURSOR_LAG.labels(group="fanout_hub").set(lag)
        return lag

    def snapshot(self) -> dict:
        return {
            "port": self.port if self._server is not None else None,
            "connections": [c.stats() for c in self._conns],
            "frames_sent": self.frames_sent,
            "shed": self.shed,
            "resumed": self.resumed,
            "tail_resumes": self.tail_resumes,
            "tail_retained": len(self._tail) if self._tail is not None else 0,
            "tail_cap": self.tail_cap,
            "resume_fallbacks": dict(self.resume_fallbacks),
            "replay_excluded": (
                list(self.replay_excluded)
                if self.replay_excluded is not None
                else None
            ),
            "head_seq": self.head_seq,
            "cursor_lag": self.cursor_lag(),
            "outbox": (
                {
                    "path": str(self.outbox.path),
                    "appends": self.outbox.appends,
                    "rotations": self.outbox.rotations,
                }
                if self.outbox is not None
                else None
            ),
        }

    # -- broadcast (called from the plane / delivery worker) -----------------

    def broadcast(
        self, frame: dict, words: np.ndarray, t_pub: float | None = None
    ) -> None:
        """Offer one matched frame to every connected recipient — bounded
        ``put_nowait`` per connection, never blocks. Packed-word bit test
        per connection: O(connections), independent of the user count."""
        seq = int(frame.get("seq", 0))
        data: str | None = None
        if self._tail is not None:
            # tail ring feeds BEFORE the no-connections early return: the
            # retained window must cover frames broadcast while nobody
            # was connected, or the first reconnect after a quiet spell
            # would always fall back to the outbox scan
            data = json.dumps(frame, separators=(",", ":"))
            if self._tail and seq <= self._tail[-1][0]:
                # seq went backwards (restore/reshard seam): the ring's
                # in-order invariant broke — reset rather than serve a
                # spliced window
                self._tail.clear()
            self._tail.append(
                (seq, data, np.ascontiguousarray(words, np.uint32).copy())
            )
        if seq > self.head_seq:
            self.head_seq = seq
        if not self._conns:
            return
        if data is None:
            data = json.dumps(frame, separators=(",", ":"))
        for conn in list(self._conns):
            w = conn.slot >> 5
            if w >= len(words) or not (
                int(words[w]) >> (conn.slot & 31) & 1
            ):
                continue
            if seq < self.min_seq_of(conn.slot):
                # an in-flight frame addressed to this slot's PREVIOUS
                # owner (delivery-worker handoff raced an unsubscribe)
                continue
            # queue-depth distribution sampled at offer time — the shape
            # of this histogram is the early-warning for shed storms
            FANOUT_CONN_QUEUE_DEPTH.observe(conn.queue.qsize())
            if not conn.offer((seq, data, t_pub)):
                self.shed += 1
                FANOUT_SHED.labels(reason="slow_consumer").inc()
                get_event_log().emit(
                    "fanout_shed",
                    reason="slow_consumer",
                    user=conn.user_id,
                    transport=conn.transport,
                    seq=seq,
                )

    # -- request handling ----------------------------------------------------

    @staticmethod
    def _http(status: int, reason: str, body: str, ctype="application/json"):
        payload = body.encode("utf-8")
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(payload)}\r\n"
            "Connection: close\r\n\r\n"
        )
        return head.encode("ascii") + payload

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn: _Connection | None = None
        try:
            request_line = await asyncio.wait_for(reader.readline(), timeout=5)
            parts = request_line.decode("latin-1").split()
            headers: dict[str, str] = {}
            for _ in range(100):
                line = await asyncio.wait_for(reader.readline(), timeout=5)
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode("latin-1").partition(":")
                headers[name.strip().lower()] = value.strip()
            if len(parts) < 2 or parts[0] != "GET":
                writer.write(
                    self._http(405, "Method Not Allowed", '{"error":"GET only"}')
                )
                await writer.drain()
                return
            path, _, query = parts[1].partition("?")
            params = parse_qs(query)
            if path not in ("/ws", "/sse"):
                writer.write(self._http(404, "Not Found", '{"error":"not found"}'))
                await writer.drain()
                return
            user = (params.get("user") or [""])[0]
            slot = self.slot_of(user) if user else None
            if slot is None:
                writer.write(
                    self._http(
                        404, "Not Found",
                        '{"error":"unknown user; subscribe before connecting"}',
                    )
                )
                await writer.drain()
                return
            cursor_raw = (params.get("cursor") or [""])[0]
            if path == "/sse" and not cursor_raw:
                cursor_raw = headers.get("last-event-id", "")
            # resume source, cheapest first: a numeric cursor inside the
            # tail ring's window replays from memory (no I/O at all);
            # anything else falls back to the outbox scan — OFF-LOOP and
            # BEFORE registration (a reconnect burst must not freeze
            # broadcast under full-file JSON+base64 parses); the appends-
            # stability loop guarantees no frame lands between the
            # accepted scan and registration
            entries = None
            tail = None
            if cursor_raw and self.outbox is not None:
                tail = self._tail_window_for(cursor_raw)
                if tail is None:
                    entries = await self._scan_outbox_stable()
            conn = _Connection(
                user, slot, "ws" if path == "/ws" else "sse",
                self.conn_queue_max,
            )
            # register, then enqueue the replayed gap SYNCHRONOUSLY (no
            # awaits until the replay is queued): live frames broadcast
            # after this block land in the queue BEHIND the gap
            self._conns.add(conn)
            FANOUT_CONNECTIONS.labels(transport=conn.transport).set(
                sum(1 for c in self._conns if c.transport == conn.transport)
            )
            self._replay_cursor(conn, cursor_raw, entries, tail=tail)
            if path == "/ws":
                await self._serve_ws(conn, reader, writer, headers)
            else:
                await self._serve_sse(conn, writer)
        except (TimeoutError, asyncio.TimeoutError, ConnectionError, OSError):
            pass  # peer went away; cleanup below
        except Exception:
            log.exception("fanout connection handling failed")
        finally:
            if conn is not None:
                self._close_conn(conn)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _scan_outbox_stable(self) -> list:
        """Parse the outbox on a worker thread, re-scanning until no
        frame was appended mid-scan: after the accepted scan the caller
        registers + replays with no intervening await, so every frame is
        either in the scan or broadcast live to the registered queue —
        never lost between the two."""
        for _ in range(3):
            n0 = self.outbox.appends
            entries = await asyncio.to_thread(self.outbox.entries)
            if self.outbox.appends == n0:
                return entries
        # a publish storm outpaced three off-loop scans: take ONE
        # synchronous scan on the loop — briefly blocking, but nothing can
        # append mid-scan, so the no-lost-frame guarantee still holds
        return self.outbox.entries()

    def _count_fallback(self, reason: str) -> None:
        self.resume_fallbacks[reason] = (
            self.resume_fallbacks.get(reason, 0) + 1
        )
        FANOUT_RESUME_FALLBACK.labels(reason=reason).inc()

    def _tail_window_for(self, cursor_raw: str) -> list | None:
        """The reconnect fast path: a numeric cursor whose resume point
        lies inside the tail ring's retained window is served from
        memory — return the ``(seq, data, words)`` window to replay.
        ``None`` means the ring can't serve it and the caller takes the
        outbox scan, with the reason counted
        (``bqt_fanout_resume_fallback_total``): ``trace_cursor`` (a
        trace-id cursor needs the log to resolve), ``tail_off`` (ring
        not configured), ``tail_cold`` (ring empty), ``cursor_gap``
        (cursor older than the ring's first retained frame — the ring
        can't prove it would replay the full gap)."""
        try:
            cursor_seq = int(cursor_raw.strip())
        except ValueError:
            self._count_fallback("trace_cursor")
            return None
        if self._tail is None:
            self._count_fallback("tail_off")
            return None
        if not self._tail:
            self._count_fallback("tail_cold")
            return None
        if cursor_seq < self._tail[0][0] - 1:
            self._count_fallback("cursor_gap")
            return None
        return [t for t in self._tail if t[0] > cursor_seq]

    def _replay_cursor(
        self,
        conn: _Connection,
        cursor_raw: str,
        entries: list | None,
        tail: list | None = None,
    ) -> None:
        if not cursor_raw:
            return
        overflow = 0
        excl = self.replay_excluded

        def _excluded(fseq: int) -> bool:
            return excl is not None and excl[0] <= fseq <= excl[1]

        if tail is not None:
            # in-memory window: same floor + recipient-bit discipline as
            # the outbox path, zero parse cost
            floor = self.min_seq_of(conn.slot) - 1
            w, bitpos = conn.slot >> 5, conn.slot & 31
            for fseq, data, words in tail:
                if fseq <= floor or _excluded(fseq):
                    continue
                if w >= len(words) or not (int(words[w]) >> bitpos & 1):
                    continue
                if conn.offer((fseq, data, None)):
                    conn.replayed += 1
                    self.resumed += 1
                    self.tail_resumes += 1
                    FANOUT_RESUME_REPLAYED.inc()
                else:
                    self.shed += 1
                    overflow += 1
                    FANOUT_SHED.labels(reason="resume_overflow").inc()
        elif entries is not None and self.outbox is not None:
            seq = self.outbox.resolve_cursor(cursor_raw, entries=entries)
            if seq is None:
                return
            # frames below the slot's min-seq floor were addressed to the
            # slot's previous owner — never replayed to the new claimant
            seq = max(seq, self.min_seq_of(conn.slot) - 1)
            for frame in self.outbox.replay_after(
                seq, conn.slot, entries=entries
            ):
                if _excluded(int(frame.get("seq", -1))):
                    continue
                data = json.dumps(frame, separators=(",", ":"))
                if conn.offer((int(frame.get("seq", 0)), data, None)):
                    conn.replayed += 1
                    self.resumed += 1
                    FANOUT_RESUME_REPLAYED.inc()
                else:
                    # a gap larger than the connection queue: the shed is
                    # counted and the client must re-cursor from its last
                    # received seq (at-least-once, never silent)
                    self.shed += 1
                    overflow += 1
                    FANOUT_SHED.labels(reason="resume_overflow").inc()
        else:
            return
        if overflow:
            get_event_log().emit(
                "fanout_shed",
                reason="resume_overflow",
                user=conn.user_id,
                transport=conn.transport,
                count=overflow,
            )
        get_event_log().emit(
            "fanout_resume",
            user=conn.user_id,
            transport=conn.transport,
            cursor=cursor_raw,
            replayed=conn.replayed,
            source="tail" if tail is not None else "outbox",
        )

    def _close_conn(self, conn: _Connection) -> None:
        self._conns.discard(conn)
        conn.closed.set()
        if conn.finalized:
            return
        conn.finalized = True
        # frames still queued at close never reached the peer: counted,
        # never silent (the shed contract holds through shutdown too)
        pending = conn.queue.qsize()
        if pending:
            self.shed += pending
            FANOUT_SHED.labels(reason="close_pending").inc(pending)
            get_event_log().emit(
                "fanout_shed",
                reason="close_pending",
                user=conn.user_id,
                transport=conn.transport,
                count=pending,
            )
        self.totals_by_user[conn.user_id] = (
            self.totals_by_user.get(conn.user_id, 0) + conn.delivered
        )
        FANOUT_CONNECTIONS.labels(transport=conn.transport).set(
            sum(1 for c in self._conns if c.transport == conn.transport)
        )
        get_event_log().emit("fanout_conn_close", **conn.stats())

    # -- transports ----------------------------------------------------------

    async def _pump(self, conn: _Connection, write_frame) -> None:
        """Drain the connection queue through ``write_frame`` until the
        peer disconnects or the hub stops."""
        closed = asyncio.ensure_future(conn.closed.wait())
        try:
            while True:
                getter = asyncio.ensure_future(conn.queue.get())
                done, _ = await asyncio.wait(
                    {getter, closed}, return_when=asyncio.FIRST_COMPLETED
                )
                if getter not in done:
                    getter.cancel()
                    return
                seq, data, t_pub = getter.result()
                await write_frame(seq, data)
                conn.note_delivered(t_pub, seq)
                self.frames_sent += 1
                FANOUT_FRAMES.labels(transport=conn.transport).inc()
        finally:
            closed.cancel()

    async def _serve_sse(self, conn: _Connection, writer) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: keep-alive\r\n\r\n"
        )
        await writer.drain()

        async def write_frame(seq: int, data: str) -> None:
            writer.write(f"id: {seq}\ndata: {data}\n\n".encode())
            await writer.drain()

        await self._pump(conn, write_frame)

    async def _serve_ws(self, conn, reader, writer, headers) -> None:
        key = headers.get("sec-websocket-key")
        if not key:
            writer.write(
                self._http(400, "Bad Request", '{"error":"missing ws key"}')
            )
            await writer.drain()
            return
        writer.write(
            (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {ws_accept_key(key)}\r\n\r\n"
            ).encode("ascii")
        )
        await writer.drain()

        async def write_frame(seq: int, data: str) -> None:
            writer.write(ws_encode_frame(data.encode("utf-8")))
            await writer.drain()

        async def read_control() -> None:
            # client→server traffic is control-only: answer pings, honor
            # close, ignore anything else. The finally matters: a peer
            # that vanishes WITHOUT a close frame (kill -9, partition)
            # surfaces here as ConnectionError, and unless the conn is
            # closed its _pump would block on an empty queue forever — a
            # zombie registration broadcast keeps offering into
            try:
                while True:
                    opcode, payload = await ws_read_frame(reader)
                    if opcode == 0x8:  # close
                        writer.write(ws_encode_frame(payload, opcode=0x8))
                        await writer.drain()
                        return
                    if opcode == 0x9:  # ping → pong
                        writer.write(ws_encode_frame(payload, opcode=0xA))
                        await writer.drain()
            finally:
                conn.closed.set()

        reader_task = asyncio.ensure_future(read_control())
        try:
            await self._pump(conn, write_frame)
        finally:
            reader_task.cancel()
            try:
                await reader_task
            except (asyncio.CancelledError, ConnectionError, Exception):
                pass
