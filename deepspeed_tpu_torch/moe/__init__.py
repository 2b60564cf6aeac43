"""Mixture-of-experts layer of the port (counterpart of
``deepspeed_tpu/moe``): top-k routing and the grouped (drop-free)
dispatch of the serving path."""
