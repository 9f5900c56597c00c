"""PyTorch/CUDA port of the Lagom reproduction (``repro``), for NVIDIA Hopper.

The layout mirrors ``repro`` module for module; the JAX package is the
reference each module is tested against.  This package imports neither
``jax`` nor ``repro``, and importing it builds nothing: the CUDA kernels
under ``kernels/csrc`` are compiled at their first launch.

  configs  — ModelConfig and the registry (llama3-8b, zamba2-7b, rwkv6-1.6b)
  kernels  — CUDA RMSNorm, flash attention, SSD and WKV6 scans (RMSNorm and
             flash with backward kernels), their plain versions, dispatch
  models   — the dense GQA decoder, the zamba2 hybrid (mamba2 + shared
             attention) and rwkv6 trunks, the model API
  serving  — the fixed-batch engine
  launch   — ``python -m repro_torch.launch.serve``
  train    — ``make_train_step`` (plain, grad_accum, microbatches, ACCO),
             ``train_loop``, step FLOPs and MFU; ``optim`` (AdamW,
             schedules) and ``data`` (the synthetic corpus) beside it
  convert  — reference parameters -> the port's state_dict
"""
