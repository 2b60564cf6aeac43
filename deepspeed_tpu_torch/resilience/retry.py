"""Shared retry policy for checkpoint I/O (a copy of
``deepspeed_tpu/resilience/retry.py`` ``retry_call``): exponential backoff
with full jitter and a wall-clock deadline.  Checkpoint writes see
transient storage errors; unbounded retries wedge a save, zero retries
tear checkpoints.  The reference also counts each retry in its telemetry
registry, which the port does not have yet (ROADMAP.md Queue A:
telemetry); here a retry is logged."""
import random
import time
from typing import Callable, Optional, Tuple, Type

from deepspeed_tpu_torch.utils.logging import logger


class RetryDeadlineExceeded(RuntimeError):
    """Deadline elapsed before an attempt succeeded; chains the last
    underlying error via ``__cause__``."""


def retry_call(fn: Callable, *args,
               attempts: int = 4,
               base_delay_s: float = 0.05,
               max_delay_s: float = 2.0,
               deadline_s: Optional[float] = None,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               rng: Optional[random.Random] = None,
               describe: str = "",
               _sleep: Callable[[float], None] = time.sleep,
               **kwargs):
    """Call ``fn(*args, **kwargs)``; on ``retry_on`` errors back off
    exponentially (full jitter: U(0, min(max_delay, base*2^k))) and retry
    up to ``attempts`` total tries or until ``deadline_s`` of wall clock
    has elapsed, whichever is sooner.  Non-matching exceptions propagate
    immediately."""
    if attempts < 1:
        raise ValueError(f"attempts={attempts}: must be >= 1")
    rng = rng if rng is not None else random.Random()
    t0 = time.monotonic()
    what = describe or getattr(fn, "__name__", repr(fn))
    for k in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            elapsed = time.monotonic() - t0
            if k + 1 >= attempts:
                raise
            if deadline_s is not None and elapsed >= deadline_s:
                raise RetryDeadlineExceeded(
                    f"{what}: deadline {deadline_s}s exceeded after "
                    f"{k + 1} attempts") from e
            delay = rng.uniform(0.0, min(max_delay_s,
                                         base_delay_s * (2 ** k)))
            if deadline_s is not None:
                delay = min(delay, max(0.0, deadline_s - elapsed))
            logger.warning(f"retry_call: {what} failed "
                           f"(attempt {k + 1}/{attempts}: {e}); "
                           f"retrying in {delay:.3f}s")
            _sleep(delay)
