"""SAC: the agent, its losses and utilities, the off-policy training loop DroQ and SAC-AE share, evaluation."""
