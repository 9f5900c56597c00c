"""The port's models: the dense GQA decoder family (``llama3-8b``).

  layers — norms, RoPE, GQA attention with its KV cache, SwiGLU MLP, embeddings
  dense  — one decoder layer and the per-layer trunk
  model  — ``init_params`` / ``forward_hidden`` / ``init_caches`` / ``decode_step``
"""
