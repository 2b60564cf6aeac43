from deepspeed_tpu_torch.utils.logging import logger, warning_once  # noqa: F401
