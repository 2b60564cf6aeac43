"""Model protocol for the port's engines (counterpart of
``deepspeed_tpu/models/model.py`` ``Model``, serving surface only).

A model is a set of plain functions over a params dict of tensors with
the reference's names and stacked ``[L, ...]`` block layout, so weights
carry across from the JAX package unchanged
(``checkpoint/jax_params.py``)."""
from dataclasses import dataclass
from typing import Any, Callable, Optional


def resolve_size(sizes: dict, size: str, family: str) -> dict:
    """Look up a size preset, refusing typos; ``size="custom"`` opts into
    the config defaults + overrides explicitly."""
    if size in sizes:
        return dict(sizes[size])
    if size == "custom":
        return {}
    raise ValueError(
        f"{family}: unknown size {size!r}; valid sizes: "
        f"{sorted(sizes)} or 'custom' (config defaults + overrides)")


@dataclass
class Model:
    config: Any = None
    #: (seed) -> numpy params dict, the reference's host initializer
    #: (the same values ``deepspeed_tpu`` draws for the same seed)
    numpy_init_fn: Optional[Callable] = None
    #: (numpy params dict, device, dtype) -> torch params dict
    params_from_numpy_fn: Optional[Callable] = None
    #: (params, batch) -> logits [B, S, V]
    apply_fn: Callable = None
    #: KV-cache serving surface:
    #: init_cache_fn(batch_size, max_len, dtype, device) -> cache dict;
    #: prefill_fn(params, batch, cache) -> (logits [B, S, V], cache);
    #: decode_fn(params, tokens [B], cache, lengths [B]) ->
    #: (logits [B, V], cache), writing the new K/V into ``cache`` in place
    init_cache_fn: Optional[Callable] = None
    prefill_fn: Optional[Callable] = None
    decode_fn: Optional[Callable] = None

    def init(self, seed: int = 0, device=None, dtype=None):
        """Params from the reference's seeded host init, placed on
        ``device`` in ``dtype`` (floating leaves)."""
        return self.params_from_numpy_fn(self.numpy_init_fn(seed), device,
                                         dtype)

    def apply(self, params, batch):
        return self.apply_fn(params, batch)
