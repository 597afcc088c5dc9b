"""DreamerV3 agent."""
