"""PyTorch/CUDA port of the Lagom reproduction (``repro``), for NVIDIA Hopper.

The layout mirrors ``repro`` module for module; the JAX package is the
reference each module is tested against.  This package imports neither
``jax`` nor ``repro``, and importing it builds nothing: the CUDA kernels
under ``kernels/csrc`` are compiled at their first launch.

  configs  — ModelConfig and the registry (llama3-8b)
  kernels  — CUDA RMSNorm and flash attention, their plain versions, dispatch
  models   — the dense GQA decoder (layers, trunk, model API)
  serving  — the fixed-batch engine
  launch   — ``python -m repro_torch.launch.serve``
  convert  — reference parameters -> the port's state_dict
"""
