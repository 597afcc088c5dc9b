"""DreamerV1."""
