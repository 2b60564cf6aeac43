"""Hand-written CUDA kernels of the port and their wrappers: decode
attention, flash attention forward and backward, the int8 quantizer and
GEMM, the fused decode layer, the grouped MoE GEMMs and block-sparse
attention forward and backward.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its kernel for a CUDA tensor (or raises); ``<wrapper>.launches``
counts kernel launches."""
