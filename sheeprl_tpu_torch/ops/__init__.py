"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each op launches its CUDA kernel for CUDA tensors and computes its plain
version for CPU tensors; ``LAUNCHES`` counts the kernel launches of each.
A captured CUDA graph (``parallel/compile.py``) credits every replay with
the launches it recorded at capture, so the counts stay true under graphs.
"""

from sheeprl_tpu_torch.ops import gru, rssm
from sheeprl_tpu_torch.ops.gru import fused_layernorm_gru, layernorm_gru_reference
from sheeprl_tpu_torch.ops.rssm import fused_rssm_recurrent, rssm_recurrent_reference

#: every kernel's launch count
LAUNCH_COUNTERS = (rssm.LAUNCHES, gru.LAUNCHES)

__all__ = [
    "LAUNCH_COUNTERS",
    "fused_layernorm_gru",
    "fused_rssm_recurrent",
    "layernorm_gru_reference",
    "rssm_recurrent_reference",
]
