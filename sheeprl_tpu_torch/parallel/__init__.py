"""Execution layers of the port (counterpart of ``sheeprl_tpu/parallel/``):
the compile-once layer, :mod:`.compile`.  The mesh, sharding and pipeline
layers come with the scale layer (ROADMAP.md, queue A item 5)."""
