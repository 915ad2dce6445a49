"""The port's Telegram consumer against the reference's.

The cases of ``tests/test_telegram_deep.py`` (flood control, pacing,
swallowed errors, the pending set, the cooldown, the sanitizer's edges),
the Telegram cases of ``tests/test_io.py`` and of ``tests/test_delivery.py``
(``deliver_signal`` raising and releasing its cooldown stamp on a failed or
cancelled send) run through both packages on the same scripts and must
give the same sends; the sanitizer and the fingerprint parser are swept
with hypothesis against the reference's, and the cooldown ledger runs on a
scripted clock. Every async drive runs under ``asyncio.wait_for``.
"""

import asyncio
import time
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from binquant_tpu.io import telegram as jtel
from binquant_tpu_torch.io import telegram as ttel

PACKAGES = {"jax": jtel, "torch": ttel}


def run(coro, limit_s: float = 10.0):
    return asyncio.run(asyncio.wait_for(coro, timeout=limit_s))


def make_consumer(tel, transport, **kw):
    c = tel.TelegramConsumer(token="", chat_id="chat", transport=transport, **kw)
    c._min_send_interval_seconds = 0.0  # keep tests fast unless testing it
    c._retry_after_pad_seconds = 0.0
    return c


def both(case) -> object:
    out = {key: case(tel) for key, tel in PACKAGES.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _recorder(tel, fail_first=None):
    sent = []

    async def transport(chat_id, text):
        sent.append(text)
        if fail_first is not None and len(sent) == 1:
            raise fail_first(tel)

    return sent, transport


SIGNAL_MSG = """
    - [test] <strong>#mean_reversion_fade algorithm</strong> #BTCUSDT
    - Action: LONG ENTRY
    - Current price: 100.5
    - Strategy: long
    - Autotrade route: long_autotrade_allowed
    - Autotrade is enabled
"""


# -- flood control, pacing, swallowed errors ---------------------------------------


def test_retry_after_backoff_then_success():
    def case(tel):
        sent, transport = _recorder(tel, fail_first=lambda t: t.RetryAfterError(0.01))
        run(make_consumer(tel, transport).send_msg("hello"))
        return sent

    assert both(case) == ["hello", "hello"]


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_min_interval_spacing(package):
    tel = PACKAGES[package]
    stamps = []

    async def transport(chat_id, text):
        stamps.append(time.monotonic())

    c = make_consumer(tel, transport)
    c._min_send_interval_seconds = 0.05

    async def go():
        await c.send_msg("a")
        await c.send_msg("b")

    run(go())
    assert stamps[1] - stamps[0] >= 0.05


def test_transport_errors_never_propagate():
    def case(tel):
        calls = []

        async def transport(chat_id, text):
            calls.append(text)
            raise RuntimeError("boom")

        run(make_consumer(tel, transport).send_signal("message"))  # must not raise
        return calls

    assert both(case) == ["message"]


# -- the pending set and the cooldown ----------------------------------------------


def test_pending_released_after_send_completes():
    def case(tel):
        sent, transport = _recorder(tel)
        c = make_consumer(tel, transport)
        c._signal_dedupe_seconds = 0.0  # pending-set-only dedupe

        async def go():
            msg = "<strong>#algo1 algorithm</strong> #BTCUSDT\n- Action: buy"
            t1 = c.dispatch_signal(msg)
            second = c.dispatch_signal(msg)  # pending -> dropped
            await t1
            t3 = c.dispatch_signal(msg)
            await t3
            return second is None, t3 is not None

        return run(go()), sent

    (dropped, resent), sent = both(case)
    assert dropped and resent and len(sent) == 2


def test_cooldown_dedupe_and_distinct_keys():
    def case(tel):
        sent, transport = _recorder(tel)
        c = make_consumer(tel, transport)

        async def go():
            base = "<strong>#algo1 algorithm</strong> #BTCUSDT\n- Action: {a}"
            await c.dispatch_signal(base.format(a="buy"))
            again = c.dispatch_signal(base.format(a="buy"))  # inside the cooldown
            await asyncio.gather(c.dispatch_signal(base.format(a="sell")),
                                 c.dispatch_signal(SIGNAL_MSG))
            other = SIGNAL_MSG.replace("LONG ENTRY", "SHORT ENTRY")
            await c.dispatch_signal(other)
            return again is None, c.dispatch_signal(SIGNAL_MSG) is None

        return run(go()), sent

    (again_dropped, dup_dropped), sent = both(case)
    assert again_dropped and dup_dropped and len(sent) == 4


def test_background_task_set_gc_and_disabled_consumer():
    def case(tel):
        async def transport(chat_id, text):
            pass

        c = make_consumer(tel, transport)

        async def go():
            t = c.dispatch_signal("- Action: hold\n#X")
            held = t in c._background_tasks
            await t
            await asyncio.sleep(0)
            return held, t in c._background_tasks

        off = tel.TelegramConsumer(token="", chat_id="c", is_enabled=False)
        return run(go()), off.dispatch_signal(SIGNAL_MSG)

    assert both(case) == ((True, False), None)


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_cooldown_ledger_on_a_scripted_clock(package, monkeypatch):
    tel = PACKAGES[package]
    clock = SimpleNamespace(now=100.0)
    monkeypatch.setattr(tel, "time", SimpleNamespace(monotonic=lambda: clock.now))
    ledger = tel.CooldownLedger()
    key = ("algo", "X", "", "", "", "")
    assert ledger.admit(key, 900.0)
    assert not ledger.admit(key, 900.0)  # in flight
    ledger.release(key)
    clock.now += 899.0
    assert not ledger.admit(key, 900.0)  # inside the window
    clock.now += 1.0
    assert ledger.admit(key, 900.0)  # the stale stamp is swept
    ledger.release(key)
    ledger.forget(key)
    assert ledger.admit(key, 900.0)  # a forgotten stamp admits at once


# -- the delivery plane's entry point ---------------------------------------------


def test_deliver_signal_raises_and_releases_cooldown():
    def case(tel):
        sent, transport = _recorder(tel, fail_first=lambda t: RuntimeError("scripted"))
        consumer = make_consumer(tel, transport)
        msg = "- Action: LONG ENTRY\n- Strategy: long\n#SYMUSDT"

        async def go():
            with pytest.raises(RuntimeError):
                await consumer.deliver_signal(msg)
            retried = await consumer.deliver_signal(msg)
            duplicate = await consumer.deliver_signal(msg)
            return retried, duplicate

        return run(go()), len(sent)

    assert both(case) == ((True, False), 2)


def test_deliver_signal_cancelled_forgets_cooldown():
    def case(tel):
        calls = {"n": 0}

        async def transport(chat_id, text):
            calls["n"] += 1
            if calls["n"] == 1:
                await asyncio.sleep(60)  # hang past the plane's deadline

        consumer = make_consumer(tel, transport)
        msg = "- Action: LONG ENTRY\n- Strategy: long\n#SYMUSDT"

        async def go():
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(consumer.deliver_signal(msg), timeout=0.05)
            return await consumer.deliver_signal(msg)

        return run(go()), calls["n"]

    assert both(case) == (True, 2)


def test_deliver_signal_disabled_or_empty_is_a_no_op():
    def case(tel):
        sent, transport = _recorder(tel)
        off = make_consumer(tel, transport, is_enabled=False)
        on = make_consumer(tel, transport)
        return run(off.deliver_signal(SIGNAL_MSG)), run(on.deliver_signal("  \n ")), sent

    assert both(case) == (False, False, [])


# -- the sanitizer and the fingerprint --------------------------------------------


@pytest.mark.parametrize("text,expected", [
    ('<a href="https://x.y/z?a=1">link</a>', '<a href="https://x.y/z?a=1">link</a>'),
    ("5 &lt; 6 &amp; 7 &gt; 2", "5 &lt; 6 &amp; 7 &gt; 2"),
    ("price < 5 and x > 3", "price &lt; 5 and x &gt; 3"),
    ("<strong>#x</strong> <script>evil()</script> RSI &lt; 30 <a href='https://x.y/z'>link</a>",
     '<strong>#x</strong> &lt;script&gt;evil()&lt;/script&gt; RSI &lt; 30 '
     '<a href="https://x.y/z">link</a>'),
    ("<pre lang=python>x</pre><code a='1'>y</code>",
     "<pre lang=python>x</pre>&lt;code a=&#x27;1&#x27;&gt;y</code>"),
])
def test_sanitizer_edges(text, expected):
    assert ttel.sanitize_telegram_html(text) == jtel.sanitize_telegram_html(text) == expected


MARKUP = st.sampled_from([
    "<b>", "</b>", "<strong>", "</strong>", "<i>", "</em>", "<u>", "<s>", "<code>", "</pre>",
    "<a href='https://x.y/z'>", '<a href="u">', "</a>", "<pre lang=py>", "<code x\">",
    "&lt;", "&gt;", "&amp;", "&quot;", "&#x27;", "&", "<", ">", "'", '"', "<script>",
    "<b class=x>", "&nbsp;", "#BTCUSDT", "\n- Action: LONG ENTRY", "\n- Strategy: short",
    "\n- Autotrade route: x", "Autotrade is enabled", "Autotrade is disabled",
    "<strong>#mrf algorithm</strong>", "\n- Label without colon",
])


@settings(max_examples=300, deadline=None)
@given(st.lists(st.one_of(MARKUP, st.text(max_size=6)), max_size=14).map("".join))
def test_sanitizer_and_fingerprint_match_the_reference(text):
    assert ttel.sanitize_telegram_html(text) == jtel.sanitize_telegram_html(text)
    condensed = ttel._condense(text)
    assert condensed == jtel._condense(text)
    assert ttel.parse_fingerprint(condensed).key() == jtel.parse_fingerprint(condensed).key()


def test_disabled_transport_without_token_sends_nothing():
    """No token and no transport: nothing to send through, so nothing is
    built (no ``httpx`` import) and a send is a no-op."""
    def case(tel):
        c = tel.TelegramConsumer(token="", chat_id="c")
        return c._transport is None, run(c.deliver_signal(SIGNAL_MSG))

    assert both(case) == (True, False)
