"""PPO helpers shared by the serving players."""
