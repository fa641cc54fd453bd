"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

hier_aggregate  K1 grouped mean, K2 segment mean, K6 fused int8 decode and
                segment mean
quantize        K4 blockwise int8 quantize, K5 dequantize
megakernel      K3 fused edge interval
flash_attention K7 causal windowed GQA attention
rglru_scan      K8 RG-LRU linear recurrence
ops             the public entry points; ref the plain versions under the
                JAX package's oracle names

Importing builds nothing: each wrapper builds (``_build``) and loads its
library on its first CUDA call.
"""
from repro_torch.kernels import flash_attention, hier_aggregate, megakernel, ops, quantize, ref, rglru_scan

__all__ = ["flash_attention", "hier_aggregate", "megakernel", "ops", "quantize", "ref", "rglru_scan"]
