"""Algorithms of the port (DreamerV3 serving so far)."""
