"""PPO: the agent, its losses and utilities, the training loop the on-policy algorithms share, evaluation."""
