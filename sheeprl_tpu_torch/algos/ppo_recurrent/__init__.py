"""Recurrent PPO."""
