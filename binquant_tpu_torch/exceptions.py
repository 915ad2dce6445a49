"""The port's exception hierarchy.

Its own copy of the part of ``binquant_tpu/exceptions.py`` the service
around the tick raises: the binbot REST client's :class:`BinbotError`
carries ``.message`` as the pybinbot original does.
"""

from __future__ import annotations


class BinquantError(Exception):
    """Base class for the port's errors."""


class BinbotError(BinquantError):
    """Backend API error; carries ``.message``."""

    def __init__(self, message: str = "", *args) -> None:
        super().__init__(message, *args)
        self.message = message
