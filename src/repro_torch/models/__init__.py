"""The port's models: the dense GQA decoder (``llama3-8b``), the zamba2 hybrid
(``zamba2-7b``) and rwkv6 (``rwkv6-1.6b``).

  layers — norms, RoPE, GQA attention with its KV cache, SwiGLU MLP, embeddings
  dense  — one decoder layer and the per-layer trunk
  mamba2 — the Mamba2 (SSD) block with its causal conv
  zamba2 — Mamba2 layers with a shared attention block every k layers
  rwkv6  — time-mix (WKV6) and channel-mix layers
  model  — ``init_params`` / ``forward_hidden`` / ``init_caches`` / ``decode_step``
"""
