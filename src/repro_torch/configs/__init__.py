"""Per-model configurations of the port."""
