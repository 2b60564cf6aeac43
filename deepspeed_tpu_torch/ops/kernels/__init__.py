"""Hand-written CUDA kernels of the serving path and their wrappers.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its kernel for a CUDA tensor (or raises); ``<wrapper>.launches``
counts kernel launches."""
