"""Device and precision for the port (a small counterpart of
``sheeprl_tpu/parallel/fabric.py``: one device, no mesh).

``fabric.accelerator`` ``auto`` or ``gpu``/``cuda`` means ``cuda:0`` and
raises when no GPU is present; only ``cpu`` gives the CPU.  ``32-true`` is
full fp32: TF32 is switched off for matrix products and for cuDNN's
convolutions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Union

import torch


@dataclass(frozen=True)
class Fabric:
    device: torch.device
    precision: str = "32-true"

    def load(self, path: Union[str, os.PathLike]) -> Dict[str, Any]:
        """State of a committed snapshot directory, tensors on this device."""
        from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir

        return load_step_dir(path, rank=0, map_location=self.device)


def _device(accelerator: str) -> torch.device:
    accelerator = str(accelerator or "auto").lower()
    if accelerator == "cpu":
        return torch.device("cpu")
    if accelerator in ("auto", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"fabric.accelerator={accelerator} needs a CUDA GPU and none is available; "
                "pass fabric.accelerator=cpu to run on the CPU"
            )
        return torch.device("cuda", 0)
    raise ValueError(f"fabric.accelerator={accelerator}: choose auto, gpu or cpu")


def build_fabric(cfg: Any) -> Fabric:
    fabric_cfg = cfg.get("fabric") or {}
    if int(fabric_cfg.get("devices", 1) or 1) != 1 or int(fabric_cfg.get("num_nodes", 1) or 1) != 1:
        raise NotImplementedError("sheeprl_tpu_torch runs on one device (fabric.devices=1, num_nodes=1)")
    precision = str(fabric_cfg.get("precision", "32-true"))
    if precision != "32-true":
        raise NotImplementedError(
            f"fabric.precision={precision}: the port runs 32-true only; bf16 is deferred "
            "(ROADMAP.md, queue A item 1)"
        )
    device = _device(fabric_cfg.get("accelerator", "auto"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Fabric(device=device, precision=precision)
