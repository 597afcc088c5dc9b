"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each op launches its CUDA kernel for CUDA tensors and computes its plain
version for CPU tensors; ``LAUNCHES`` counts the kernel launches of each.
"""

from sheeprl_tpu_torch.ops.gru import fused_layernorm_gru, layernorm_gru_reference
from sheeprl_tpu_torch.ops.rssm import fused_rssm_recurrent, rssm_recurrent_reference

__all__ = [
    "fused_layernorm_gru",
    "fused_rssm_recurrent",
    "layernorm_gru_reference",
    "rssm_recurrent_reference",
]
