"""Sylvie's Low-bit Module, halo exchange and staleness state."""
