"""Feature packs and the five live strategies."""
