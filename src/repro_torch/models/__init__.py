"""Models, layers and parameter conversion."""
