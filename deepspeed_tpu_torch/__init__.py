"""PyTorch/CUDA port of deepspeed_tpu's serving path.

The JAX package ``deepspeed_tpu`` stays the reference; this package runs
the same serving stack (inference engine -> continuous-batching
scheduler -> HTTP server) on an NVIDIA GPU, with the two attention
kernels of that path written by hand in CUDA C++ (``csrc/``).  Nothing
here imports JAX or ``deepspeed_tpu``.

Entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``, which the tests do); with no GPU and no explicit
``device="cpu"`` they raise.
"""

__version__ = "0.1.0"


def init_inference(model=None, config=None, device=None, **kwargs):
    """Create an inference engine (counterpart of
    ``deepspeed_tpu.init_inference``).  ``config`` is a dict or a
    :class:`DeepSpeedInferenceConfig`; keyword arguments merge into a
    dict config.  ``device=None`` resolves to ``"cuda"``."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    if config is None:
        config = kwargs
    elif kwargs:
        config = {**config, **kwargs}
    cfg = (DeepSpeedInferenceConfig(**config) if isinstance(config, dict)
           else config)
    return InferenceEngine(model, cfg, device=device)
