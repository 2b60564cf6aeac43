from deepspeed_tpu_torch.models.bert import (  # noqa: F401
    BertConfig, bert_model)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, gpt2_model  # noqa: F401
from deepspeed_tpu_torch.models.model import Model  # noqa: F401
