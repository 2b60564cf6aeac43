"""Continuous-batching serving: paged KV pool, iteration-level
scheduler, HTTP front-end."""
from deepspeed_tpu_torch.serving.block_manager import BlockManager  # noqa: F401
from deepspeed_tpu_torch.serving.request import (  # noqa: F401
    AdmissionError, QueueFullError, RequestState, RequestTooLongError,
    SamplingParams, ServeRequest)
from deepspeed_tpu_torch.serving.scheduler import \
    ContinuousBatchingScheduler  # noqa: F401
