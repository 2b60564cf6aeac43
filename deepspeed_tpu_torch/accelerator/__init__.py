from deepspeed_tpu_torch.accelerator.real_accelerator import (  # noqa: F401
    device_name, memory_stats, resolve_device)
