"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

  ref     — plain PyTorch versions (the CPU path and the on-card oracle)
  rmsnorm — CUDA RMSNorm (port of ``repro.kernels.rmsnorm.rmsnorm_pallas``)
  flash   — CUDA flash attention (port of ``repro.kernels.flash.flash_attention``)
  ssd     — CUDA Mamba-2 SSD scan (port of ``repro.kernels.ssd.ssd_pallas``)
  wkv6    — CUDA RWKV6 WKV scan (port of ``repro.kernels.wkv6.wkv6_pallas``)
  ops     — backend dispatch and the launch counters
  _build  — builds ``csrc/*.cu`` with nvcc at first use, never at import
"""
