"""Ring buffer, the classic tick step and state conversion."""
