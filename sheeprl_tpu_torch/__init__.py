"""sheeprl_tpu_torch: the PyTorch + CUDA port of sheeprl_tpu for NVIDIA Hopper.

The JAX package ``sheeprl_tpu`` is the reference; this package mirrors its
layout and names and imports none of it.  Its hand-written kernels live in
``csrc/`` and are bound by ``ops/``.
"""
