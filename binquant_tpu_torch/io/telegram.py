"""Telegram alert sink.

The port's own copy of ``binquant_tpu/io/telegram.py``: HTML-safe message
rendering limited to Telegram's supported tags, content-derived duplicate
suppression with a 900 s cooldown, a paced single-flight send channel with
flood-control backoff, and two entry points: ``dispatch_signal``
(fire-and-forget, the inline path and the regime digest) and
``deliver_signal`` (awaited and raising, the delivery plane's Telegram
sink). Sanitization is a single-pass tokenizer over the raw message,
dedupe a parsed :class:`SignalFingerprint` admitted through a
:class:`CooldownLedger`, and the transport an injected async callable;
``httpx`` is imported only when the consumer is built with a token and no
transport, and only when that transport sends.

Behaviour:
- whitelisted tags (b/strong/i/em/u/s/code/pre/a) survive verbatim;
  ``<a href='u'>`` is normalized to double quotes; ``<pre lang=x>`` keeps
  attribute text only when it carries no quoting/entity characters;
  pre-escaped entities (&lt; &gt; &amp; &quot; &#x27;) pass through;
  everything else is entity-escaped.
- two messages collide iff their (algo, symbol, Action, Strategy,
  Autotrade-route, autotrade-enabled-flag) extraction collides; a message
  with none of those fields dedupes on its full content hash.
- at most one send per second, serialized, retrying on flood control with
  a 2 s pad.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import re
import time
from collections.abc import Awaitable, Callable
from dataclasses import dataclass

from binquant_tpu_torch.obs.instruments import SINK_EMISSIONS

log = logging.getLogger(__name__)

TransportFn = Callable[[str, str], Awaitable[None]]


class RetryAfterError(Exception):
    """Raised by a transport when Telegram flood control asks us to wait."""

    def __init__(self, retry_after: float) -> None:
        super().__init__(f"retry after {retry_after}s")
        self.retry_after = retry_after


# ---------------------------------------------------------------------------
# Sanitizer: one tokenizing scan over the raw message.
#
# Rather than escaping the whole string and then carving a whitelist back
# out of entity-space, classify each region of the raw text directly:
# known-safe markup and already-encoded entities are emitted as-is, every
# other character is escaped. One regex pass, no re-entrant substitutions.
# ---------------------------------------------------------------------------

_TELEGRAM_TAGS = ("b", "strong", "i", "em", "u", "s", "code", "pre", "a")

_CHAR_ENTITIES = {
    "&": "&amp;",
    "<": "&lt;",
    ">": "&gt;",
    '"': "&quot;",
    "'": "&#x27;",
}

_KNOWN_ENTITY = r"&(?:lt|gt|amp|quot|#x27);"

_TOKEN_SCANNER = re.compile(
    # plain open/close form of any supported tag, e.g. <strong> </a>
    rf"(?P<tag></?(?:{'|'.join(_TELEGRAM_TAGS)})>)"
    # anchor with a quoted href (either quote style; emitted double-quoted)
    r"|(?P<anchor><a\s+href=['\"](?P<href>.+?)['\"]>)"
    # pre/code carrying attribute text free of quoting/entity characters
    r"|(?P<fenced><(?P<fence>pre|code)\s+(?P<fattrs>[^&<>'\"]*)>)"
    # an entity the author already encoded; passes through untouched
    rf"|(?P<entity>{_KNOWN_ENTITY})"
)

_ENTITY_OR_CHAR = re.compile(rf"({_KNOWN_ENTITY})|(.)", re.S)


def _escape_segment(text: str) -> str:
    """Entity-escape plain text, letting already-encoded entities stand."""
    return _ENTITY_OR_CHAR.sub(
        lambda m: m.group(1) or _CHAR_ENTITIES.get(m.group(2), m.group(2)),
        text,
    )


def sanitize_telegram_html(message: str) -> str:
    out: list[str] = []
    cursor = 0
    for token in _TOKEN_SCANNER.finditer(message):
        out.append(_escape_segment(message[cursor : token.start()]))
        if token.group("tag") or token.group("entity"):
            out.append(token.group(0))
        elif token.group("anchor"):
            out.append(f'<a href="{_escape_segment(token.group("href"))}">')
        else:  # fenced: attribute text is verified entity-free by the regex
            out.append(f"<{token.group('fence')} {token.group('fattrs')}>")
        cursor = token.end()
    out.append(_escape_segment(message[cursor:]))
    return "".join(out)


# ---------------------------------------------------------------------------
# Duplicate suppression: parse once into a fingerprint, admit via a ledger.
# ---------------------------------------------------------------------------

_HASHTAG = re.compile(r"#([A-Za-z0-9_]+)")
_ALGO_HEADER = re.compile(r"<strong>#([^<\s]+)\s+algorithm</strong>")
_KEYED_FIELDS = ("Action", "Strategy", "Autotrade route")


@dataclass(frozen=True)
class SignalFingerprint:
    """The identity of an alert for dedupe purposes.

    Extraction targets the structured message layout every emission uses
    (``- Label: value`` bullet lines, a ``#algo algorithm`` header, a
    trailing ``#SYMBOL`` hashtag, and the autotrade enabled/disabled
    sentence). Messages that expose none of those collapse to a content
    digest, so free-form digests still dedupe on exact repetition.
    """

    algo: str = ""
    symbol: str = ""
    action: str = ""
    strategy: str = ""
    route: str = ""
    autotrade: str = ""
    digest: str = ""

    def key(self) -> tuple[str, ...]:
        structured = (
            self.algo,
            self.symbol,
            self.action,
            self.strategy,
            self.route,
            self.autotrade,
        )
        if any(structured):
            return structured
        return ("digest", self.digest)


def parse_fingerprint(condensed: str) -> SignalFingerprint:
    bullets: dict[str, str] = {}
    for line in condensed.splitlines():
        if not line.startswith("- "):
            continue
        label, sep, value = line[2:].partition(":")
        if sep and label in _KEYED_FIELDS:
            bullets.setdefault(label, value.strip())

    tags = _HASHTAG.findall(condensed)
    header = _ALGO_HEADER.search(condensed)

    if "Autotrade is enabled" in condensed:
        autotrade = "enabled"
    elif "Autotrade is disabled" in condensed:
        autotrade = "disabled"
    else:
        autotrade = ""

    return SignalFingerprint(
        algo=header.group(1) if header else "",
        symbol=tags[-1] if tags else "",
        action=bullets.get("Action", ""),
        strategy=bullets.get("Strategy", ""),
        route=bullets.get("Autotrade route", ""),
        autotrade=autotrade,
        digest=hashlib.sha1(condensed.encode("utf-8")).hexdigest(),
    )


class CooldownLedger:
    """Admission control over fingerprint keys.

    Two layers: an *in-flight* set (a key currently being sent is never
    re-admitted, regardless of TTL) and a *sent-at* map enforcing a
    cooldown window. A non-positive TTL disables the window, leaving
    in-flight suppression only.
    """

    def __init__(self) -> None:
        self._sent_at: dict[tuple[str, ...], float] = {}
        self._inflight: set[tuple[str, ...]] = set()

    def admit(self, key: tuple[str, ...], ttl: float) -> bool:
        if key in self._inflight:
            log.info("Telegram duplicate signal already pending; skipping")
            return False
        if ttl <= 0:
            self._inflight.add(key)
            return True

        now = time.monotonic()
        for stale in [k for k, at in self._sent_at.items() if now - at >= ttl]:
            del self._sent_at[stale]

        if key in self._sent_at:
            log.info("Telegram duplicate signal inside cooldown; skipping")
            return False
        self._sent_at[key] = now
        self._inflight.add(key)
        return True

    def release(self, key: tuple[str, ...]) -> None:
        self._inflight.discard(key)

    def forget(self, key: tuple[str, ...]) -> None:
        """Drop a key's cooldown stamp — a FAILED send must not suppress
        the delivery plane's retry of the same message as a duplicate
        (admit records the stamp at admission, not at send success)."""
        self._sent_at.pop(key, None)


# ---------------------------------------------------------------------------
# Transport + consumer
# ---------------------------------------------------------------------------


def httpx_bot_transport(token: str) -> TransportFn:
    """Production transport: Bot API sendMessage over httpx (imported at
    the first send)."""
    endpoint = f"https://api.telegram.org/bot{token}/sendMessage"

    async def post(chat_id: str, text: str) -> None:
        import httpx

        async with httpx.AsyncClient(timeout=10) as client:
            reply = await client.post(
                endpoint,
                json={"chat_id": chat_id, "text": text, "parse_mode": "HTML"},
            )
            if reply.status_code == 429:
                pause = reply.json().get("parameters", {}).get("retry_after", 5)
                raise RetryAfterError(float(pause))
            reply.raise_for_status()

    return post


def _condense(message: str) -> str:
    """Strip indentation and blank lines (messages are triple-quoted)."""
    return "\n".join(ln.strip() for ln in message.splitlines() if ln.strip())


class TelegramConsumer:
    _MIN_SEND_INTERVAL_SECONDS = 1.0
    _RETRY_AFTER_PAD_SECONDS = 2.0
    _SIGNAL_DEDUPE_SECONDS = 900.0

    def __init__(
        self,
        token: str,
        chat_id: str,
        is_enabled: bool = True,
        transport: TransportFn | None = None,
    ) -> None:
        self.chat_id = chat_id
        self.is_enabled = is_enabled
        if transport is None and token:
            transport = httpx_bot_transport(token)
        self._transport = transport
        self._ledger = CooldownLedger()
        self._send_lock = asyncio.Lock()
        self._min_send_interval_seconds = self._MIN_SEND_INTERVAL_SECONDS
        self._retry_after_pad_seconds = self._RETRY_AFTER_PAD_SECONDS
        self._signal_dedupe_seconds = self._SIGNAL_DEDUPE_SECONDS
        self._sent_monotonic: float | None = None
        # Hold strong refs so fire-and-forget tasks survive GC mid-send.
        self._background_tasks: set[asyncio.Task] = set()

    # The method name is part of the tested surface; logic lives above.
    def _sanitize_html(self, message: str) -> str:
        return sanitize_telegram_html(message)

    async def _pace(self) -> None:
        if self._sent_monotonic is None or self._min_send_interval_seconds <= 0:
            return
        due = self._sent_monotonic + self._min_send_interval_seconds
        wait = due - time.monotonic()
        if wait > 0:
            await asyncio.sleep(wait)

    async def send_msg(self, message: str) -> None:
        """Deliver one message, serialized, paced, flood-control aware."""
        if self._transport is None:
            return
        text = sanitize_telegram_html(message)
        async with self._send_lock:
            while True:
                await self._pace()
                try:
                    await self._transport(self.chat_id, text)
                except RetryAfterError as flood:
                    SINK_EMISSIONS.labels(sink="telegram", outcome="retry").inc()
                    pause = flood.retry_after + self._retry_after_pad_seconds
                    log.warning(
                        "Telegram flood control active; retrying in %.1fs", pause
                    )
                    await asyncio.sleep(pause)
                    continue
                self._sent_monotonic = time.monotonic()
                SINK_EMISSIONS.labels(sink="telegram", outcome="ok").inc()
                return

    async def send_signal(self, message: str) -> None:
        """send_msg that swallows every error (alerting must never crash)."""
        try:
            condensed = _condense(message)
            if condensed:
                await self.send_msg(condensed)
        except Exception as exc:
            SINK_EMISSIONS.labels(sink="telegram", outcome="error").inc()
            log.error("Error sending telegram signal: %s", exc)
            log.error("Original message: %s", message)

    async def deliver_signal(self, message: str) -> bool:
        """Delivery-plane entry point (io/delivery.py TelegramSink): the
        same admission control as ``dispatch_signal``, but awaited and
        RAISING on transport failure so the plane's retry/backoff and
        circuit breaker own the error instead of a swallowed log line.
        Returns False when disabled, empty, or suppressed as a duplicate
        (all successful no-op deliveries)."""
        if not self.is_enabled or self._transport is None:
            return False
        condensed = _condense(message)
        if not condensed:
            return False
        key = parse_fingerprint(condensed).key()
        if not self._ledger.admit(key, self._signal_dedupe_seconds):
            SINK_EMISSIONS.labels(sink="telegram", outcome="suppressed").inc()
            return False
        try:
            await self.send_msg(condensed)
            return True
        except BaseException as exc:
            if isinstance(exc, Exception):
                SINK_EMISSIONS.labels(sink="telegram", outcome="error").inc()
            # a failed send — or one cancelled by the plane's per-attempt
            # deadline (CancelledError is a BaseException) — must not hold
            # the cooldown window against the retry of the very same
            # message, else the retry is suppressed as a duplicate and
            # acked without ever sending
            self._ledger.forget(key)
            raise
        finally:
            self._ledger.release(key)

    def dispatch_signal(self, message: str) -> asyncio.Task | None:
        """Fire-and-forget entry point used by the emission path.

        Returns the created task (kept alive in ``_background_tasks``), or
        None when disabled, empty, or suppressed as a duplicate.
        """
        if not self.is_enabled:
            return None
        condensed = _condense(message)
        if not condensed:
            return None
        key = parse_fingerprint(condensed).key()
        if not self._ledger.admit(key, self._signal_dedupe_seconds):
            SINK_EMISSIONS.labels(sink="telegram", outcome="suppressed").inc()
            return None

        task = asyncio.create_task(self.send_signal(condensed))
        self._background_tasks.add(task)

        def _done(t: asyncio.Task, key: tuple[str, ...] = key) -> None:
            self._background_tasks.discard(t)
            self._ledger.release(key)

        task.add_done_callback(_done)
        return task
