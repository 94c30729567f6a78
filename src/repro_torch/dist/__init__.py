"""Runtime facade and halo-exchange backends."""
