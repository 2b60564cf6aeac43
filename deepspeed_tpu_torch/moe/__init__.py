"""Mixture-of-experts layer of the port (counterpart of
``deepspeed_tpu/moe``): top-k routing and gating, the grouped (drop-free)
dispatch through the grouped-GEMM kernels and the einsum (GShard
capacity) dispatch, for serving and training."""
