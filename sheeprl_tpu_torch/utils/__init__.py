"""Utilities of the port: config containers, numerics, distributions, env factory."""
