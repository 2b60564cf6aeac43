"""Pydantic config base: a copy of ``deepspeed_tpu/runtime/config_utils.py``
``DeepSpeedConfigModel`` (tolerant of unknown keys, deprecated-field
migration via ``json_schema_extra={"deprecated": True, "new_param": ...}``).
"""
from typing import Any, Dict

from pydantic import BaseModel, ConfigDict

from deepspeed_tpu_torch.utils.logging import logger


class DeepSpeedConfigModel(BaseModel):
    model_config = ConfigDict(extra="allow", populate_by_name=True,
                              arbitrary_types_allowed=True)

    def __init__(self, strict: bool = False, **data):
        data = self._migrate_deprecated(data)
        super().__init__(**data)

    @classmethod
    def _migrate_deprecated(cls, data: Dict[str, Any]) -> Dict[str, Any]:
        for name, field in cls.model_fields.items():
            extra = field.json_schema_extra or {}
            if not isinstance(extra, dict) or not extra.get("deprecated"):
                continue
            key = field.alias or name
            if key in data:
                new_param = extra.get("new_param")
                if new_param and new_param not in data:
                    logger.warning(
                        f"Config param {key} is deprecated, use {new_param} "
                        "instead")
                    data[new_param] = data[key]
        return data
