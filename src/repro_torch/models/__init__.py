"""Model definitions of the port (dense decoder family so far)."""
