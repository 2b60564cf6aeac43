"""Package logger and ``warning_once`` (counterpart of
``deepspeed_tpu/utils/logging.py``)."""
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str = "deepspeed_tpu_torch",
                   level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
        lg.addHandler(handler)
    env_level = os.environ.get("DEEPSPEED_TPU_LOG_LEVEL")
    if env_level:
        lg.setLevel(LOG_LEVELS.get(env_level.lower(), logging.INFO))
    return lg


logger = _create_logger()


def warning_once_factory():
    seen = set()

    def warning_once(message: str):
        if message not in seen:
            seen.add(message)
            logger.warning(message)

    return warning_once


warning_once = warning_once_factory()
