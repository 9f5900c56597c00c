"""Shared serving types (the port's own copy of ``repro.serving.types``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Request:
    """One generation request: ``rid`` caller-chosen id, ``prompt`` (S,)
    int32 token ids, ``max_new`` the decode budget, ``out`` the generated
    tokens (appended in place by the engines)."""

    rid: int = 0
    prompt: Optional[np.ndarray] = None
    max_new: int = 32
    out: List[int] = field(default_factory=list)
