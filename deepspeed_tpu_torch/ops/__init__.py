"""The port's ops: attention dispatch (``attention``), block-sparse
attention (``sparse_attention``) and the hand-written CUDA kernels with
their plain versions (``kernels``)."""
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, SparseSelfAttention, SparsityConfig,
    VariableSparsityConfig, layout_to_mask, sparse_self_attention)

__all__ = ["BigBirdSparsityConfig", "BSLongformerSparsityConfig",
           "DenseSparsityConfig", "FixedSparsityConfig",
           "SparseSelfAttention", "SparsityConfig", "VariableSparsityConfig",
           "layout_to_mask", "sparse_self_attention"]
