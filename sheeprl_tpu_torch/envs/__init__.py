"""Environments of the port: the dummy envs and their spaces and wrappers."""
