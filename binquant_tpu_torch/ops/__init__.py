"""Rolling-window primitives, indicators and the quantile-tail kernel."""
