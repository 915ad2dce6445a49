"""The port's exception hierarchy.

Its own copy of ``binquant_tpu/exceptions.py``, under the same hierarchy:
:class:`ConfigurationError` is a deployment missing a required environment
variable (``config.Config``); the binbot REST client's :class:`BinbotError`
carries ``.message`` as the pybinbot original does; :class:`AutotradeError`
is a bot launch the backend refused; :class:`WebSocketError` a connector
with nothing to subscribe, :class:`RestartStreaming` a forced reconnect of
one; :class:`InvalidSymbol` a symbol the exchange does not list;
:class:`BufferCapacityError` a full symbol registry.
"""

from __future__ import annotations


class BinquantError(Exception):
    """Base class for the port's errors."""


class ConfigurationError(BinquantError):
    pass


class WebSocketError(BinquantError):
    pass


class RestartStreaming(BinquantError):
    """Raised to force a websocket reconnect-and-resubscribe cycle."""


class AutotradeError(BinquantError):
    pass


class BinbotError(BinquantError):
    """Backend API error; carries ``.message``."""

    def __init__(self, message: str = "", *args) -> None:
        super().__init__(message, *args)
        self.message = message


class InvalidSymbol(BinquantError):
    pass


class BufferCapacityError(BinquantError):
    """Symbol registry is full — raise S (BQT_MAX_SYMBOLS) or evict."""
