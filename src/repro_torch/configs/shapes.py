"""The port's own copy of ``repro.configs.shapes``.

Assigned input shapes.  Decode shapes lower ``serve_step`` (one new token
against a ``seq_len`` KV/state cache); the others lower ``train_step`` /
prefill."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": InputShape("prefill_32k", seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  InputShape("decode_32k",  seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   InputShape("long_500k",   seq_len=524_288, global_batch=1,   kind="decode"),
}


def shape_applicable(cfg, shape: InputShape) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention (see DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, (f"{cfg.name} is pure full-attention; long_500k decode "
                       "requires sub-quadratic attention (SSM/hybrid/SWA)")
    return True, ""
