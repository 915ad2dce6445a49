"""Market context, regime routing and the host-edge policies."""
