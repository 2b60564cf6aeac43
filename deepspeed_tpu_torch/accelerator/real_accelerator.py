"""Device resolution and device facts for the port.

The port runs on the GPU unless a caller asks for the CPU explicitly:
``resolve_device(None)`` is ``cuda`` and raises when no GPU is visible —
it never carries on on the CPU behind the caller's back.
"""
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` is honoured only when asked for.
    A CUDA device without a visible GPU raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch: no CUDA device is available; this port "
            "runs on an NVIDIA GPU.  Pass device='cpu' explicitly to run "
            "the plain PyTorch versions on the CPU (tests do).")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"deepspeed_tpu_torch: unsupported device {dev}")
    return dev


def device_name(device: Optional[torch.device] = None) -> str:
    """Card name (``torch.cuda.get_device_name``) or ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def memory_stats(device: Optional[torch.device] = None) -> dict:
    """Allocated / reserved / peak bytes on a CUDA device; empty on CPU
    (there is no device allocator to ask)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    return {"allocated_bytes": torch.cuda.memory_allocated(dev),
            "reserved_bytes": torch.cuda.memory_reserved(dev),
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev)}
