"""PyTorch/CUDA port of deepspeed_tpu's serving and training paths.

The JAX package ``deepspeed_tpu`` stays the reference; this package runs
the same serving stack (inference engine -> continuous-batching
scheduler -> HTTP server) and the single-device training engine
(``initialize`` -> ``DeepSpeedEngine.train_batch``) on an NVIDIA GPU,
with the attention kernels of those paths written by hand in CUDA C++
(``csrc/``).  Nothing here imports JAX or ``deepspeed_tpu``.

Entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``, which the tests do); with no GPU and no explicit
``device="cpu"`` they raise.
"""

__version__ = "0.1.0"


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mesh=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, mpu=None, device=None):
    """Create a training engine (counterpart of
    ``deepspeed_tpu.initialize``).  Returns ``(engine, optimizer,
    dataloader, lr_scheduler)``.  ``config`` is a dict or a JSON path
    (``config_params`` or ``args.deepspeed_config`` when absent);
    ``device=None`` resolves to ``"cuda"``.  One device only: ``mesh``,
    ``mpu`` and ``dist_init_required`` are refused."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    for name, value in (("mesh", mesh), ("mpu", mpu),
                        ("dist_init_required", dist_init_required)):
        if value is not None:
            raise NotImplementedError(
                f"initialize({name}=...): not ported to deepspeed_tpu_torch "
                "yet (ROADMAP.md Queue A: data parallel, ZeRO and model "
                "parallelism); the port trains on one device")
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("deepspeed_tpu_torch.initialize: a config dict or "
                         "path is required")
    engine = DeepSpeedEngine(config=config, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler,
                             collate_fn=collate_fn, device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def init_inference(model=None, config=None, device=None, **kwargs):
    """Create an inference engine (counterpart of
    ``deepspeed_tpu.init_inference``).  ``config`` is a dict or a
    :class:`DeepSpeedInferenceConfig`; keyword arguments merge into a
    dict config, e.g. ``quant={"enabled": True}`` (int8 weights) and
    ``kv_cache_dtype="int8"``.  ``device=None`` resolves to ``"cuda"``."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    if config is None:
        config = kwargs
    elif kwargs:
        config = {**config, **kwargs}
    cfg = (DeepSpeedInferenceConfig(**config) if isinstance(config, dict)
           else config)
    return InferenceEngine(model, cfg, device=device)
