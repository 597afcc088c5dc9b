"""Execution layers of the port (counterpart of ``sheeprl_tpu/parallel/``):
the compile-once layer, :mod:`.compile`; the one-device half of the
pipeline layer, :mod:`.pipeline`; the decoupled topology, :mod:`.topology`.
The mesh, sharding and multi-process layers come with the scale layer above
one device (ROADMAP.md, queue A item 5(b))."""
