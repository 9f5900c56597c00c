"""Stand-ins for every model input and parameter, with no allocation
(counterpart of ``repro.launch.specs``): the dry run runs against these.

Each function makes its tensors with ``torch.empty`` on ``device``: on the
``meta`` device by default (shapes and dtypes only, the reference's
``ShapeDtypeStruct``), and inside a ``FakeTensorMode`` on any device as
fake tensors, which ``launch.dryrun`` runs the program on.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import model as M



def _dtype(name) -> torch.dtype:
    return getattr(torch, name) if isinstance(name, str) else name


def input_specs(cfg, shape, *, device="meta", batch: Optional[int] = None,
                ) -> Dict[str, torch.Tensor]:
    """The batch of a train/prefill step: ``batch`` rows (default the
    shape's global batch) of ``shape.seq_len``."""
    B, S = batch or shape.global_batch, shape.seq_len

    def empty(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    out = {"tokens": empty((B, S), torch.int32), "targets": empty((B, S), torch.int32),
           "mask": empty((B, S), torch.float32)}
    if cfg.family == "audio":
        out["frames"] = empty((B, cfg.encoder_seq, cfg.d_model), _dtype(cfg.dtype))
    if cfg.family == "vlm":
        out["patches"] = empty((B, M.N_PATCHES, cfg.d_model), _dtype(cfg.dtype))
    return out


def decode_input_specs(cfg, shape, cache_dtype=None, *, device="meta",
                       batch: Optional[int] = None) -> Dict[str, object]:
    """(tokens, caches) of a serve step with a ``seq_len``-deep cache;
    ``cache_dtype`` overrides the KV/state cache precision."""
    B, S = batch or shape.global_batch, shape.seq_len
    trunk = M._trunk(cfg).init_trunk_caches(
        cfg, B, S, dtype=_dtype(cache_dtype or cfg.dtype), device=torch.device(device))
    caches = {"trunk": trunk, "pos": 0}
    if cfg.family == "audio":
        caches["memory"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                       dtype=_dtype(cfg.dtype), device=device)
    return {"tokens": torch.empty((B, 1), dtype=torch.int32, device=device),
            "caches": caches}


def param_specs(cfg, *, ep_pad: int = 1, device="meta") -> M.Model:
    """The model of ``cfg`` (its experts padded by ``ep_pad``) with every
    parameter and buffer an empty tensor on ``device``, never drawn."""
    with torch.device("meta"):
        model = M.Model(cfg, ep_pad=ep_pad, dtype=_dtype(cfg.dtype))
    if torch.device(device).type == "meta":
        return model
    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, nn.Parameter(torch.empty(p.shape, dtype=p.dtype, device=device),
                                            requires_grad=p.requires_grad))
        for name, b in list(mod.named_buffers(recurse=False)):
            setattr(mod, name, torch.empty(b.shape, dtype=b.dtype, device=device))
    return model


def param_specs_shapes(cfg, *, ep_pad: int = 1) -> Dict[str, torch.Size]:
    """Each parameter's shape, by state-dict name (no allocation)."""
    return {n: p.shape for n, p in param_specs(cfg, ep_pad=ep_pad).named_parameters()}


__all__ = ["decode_input_specs", "input_specs", "param_specs", "param_specs_shapes"]
