"""Inference config: a copy of ``deepspeed_tpu/inference/config.py``
``DeepSpeedInferenceConfig`` (dtype, kv_cache_dtype, tensor_parallel,
moe, quant, ...), same field names and defaults.  The engine refuses the
settings this port does not serve yet (tensor parallelism, a float KV
cache in another dtype than the compute dtype)."""
from typing import Any, Dict, Optional

from pydantic import Field

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class DeepSpeedTPConfig(DeepSpeedConfigModel):
    enabled: bool = True
    tp_size: int = 1


class DeepSpeedMoEConfig(DeepSpeedConfigModel):
    enabled: bool = True
    ep_size: int = 1
    moe_experts: list = Field(default_factory=lambda: [1])


class QuantizationConfig(DeepSpeedConfigModel):
    enabled: bool = False
    bits: int = 8


class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    dtype: str = "bfloat16"
    #: "int8" = quantized KV cache (int8 codes plus one fp32 scale per
    #: cached head vector); None = compute dtype
    kv_cache_dtype: Optional[str] = None
    tensor_parallel: DeepSpeedTPConfig = Field(
        default_factory=DeepSpeedTPConfig, alias="tp")
    moe: DeepSpeedMoEConfig = Field(default_factory=DeepSpeedMoEConfig)
    quant: QuantizationConfig = Field(default_factory=QuantizationConfig)
    checkpoint: Optional[str] = None
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_tokens: int = Field(1024, alias="max_out_tokens_alias")
    replace_with_kernel_inject: bool = False
    enable_cuda_graph: bool = False
    mp_size: int = Field(1, json_schema_extra={"deprecated": True,
                                               "new_param": "tensor_parallel"})
    config_dict: Dict[str, Any] = Field(default_factory=dict)

    def __init__(self, **data):
        if ("mp_size" in data and "tensor_parallel" not in data
                and "tp" not in data):
            data["tensor_parallel"] = {"tp_size": data["mp_size"]}
        super().__init__(**data)
