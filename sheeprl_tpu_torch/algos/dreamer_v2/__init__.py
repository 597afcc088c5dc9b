"""DreamerV2."""
