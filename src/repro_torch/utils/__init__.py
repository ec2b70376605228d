"""Host-side helpers of the port (stdlib only)."""
