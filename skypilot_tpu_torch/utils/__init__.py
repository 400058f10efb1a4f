"""Host utilities of the port (stdlib only)."""
