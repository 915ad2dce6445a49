"""The port's exception hierarchy.

Its own copy of the part of ``binquant_tpu/exceptions.py`` the service
around the tick, the sinks and the live clients raise: the binbot REST
client's :class:`BinbotError` carries ``.message`` as the pybinbot original
does; :class:`AutotradeError` is a bot launch the backend refused;
:class:`WebSocketError` a connector with nothing to subscribe;
:class:`BufferCapacityError` a full symbol registry.
"""

from __future__ import annotations


class BinquantError(Exception):
    """Base class for the port's errors."""


class WebSocketError(BinquantError):
    pass


class AutotradeError(BinquantError):
    pass


class BinbotError(BinquantError):
    """Backend API error; carries ``.message``."""

    def __init__(self, message: str = "", *args) -> None:
        super().__init__(message, *args)
        self.message = message


class BufferCapacityError(BinquantError):
    """Symbol registry is full — raise S (BQT_MAX_SYMBOLS) or evict."""
