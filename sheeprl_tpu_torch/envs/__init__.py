"""Environments of the port: the dummy envs, their spaces and wrappers, the
device envs (``device/``) and the adapters of gymnasium and DMC envs."""
