"""The port's own copy of ``repro.core.comm_params``.

Tunable collective-communication parameters (the paper's ``s_j``).

Six parameters per AutoCCL/Lagom: implementation-related (Algorithm,
Protocol, Transport — divide-and-conquer subspaces) and resource-related
(NC = channels, NT = threads, C = chunk size — the contention dials).
The per-communication space exceeds 10^6 configurations (Sec. 3.1).

TPU reinterpretation is documented per-knob in DESIGN.md §2; the dataclass
is hardware-neutral.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Iterator, Tuple

ALGORITHMS = ("ring", "tree", "bidir")       # TPU: decomposition strategy
PROTOCOLS = ("latency", "mixed", "bulk")     # NCCL LL / LL128 / Simple
TRANSPORTS = ("p2p", "shm", "net")           # TPU: ici / ici+dcn paths

NC_MIN, NC_MAX = 1, 64
NT_MIN, NT_MAX = 64, 640
C_MIN_KB, C_MAX_KB = 32, 8192


@dataclass(frozen=True)
class CommConfig:
    algorithm: str = "ring"
    protocol: str = "mixed"
    transport: str = "p2p"
    nc: int = 8          # number of channels
    nt: int = 256        # threads per channel (negligible — Sec. 3.2)
    chunk_kb: int = 2048 # C

    done: bool = False   # Algorithm 2 termination flag

    def clamp(self) -> "CommConfig":
        return self.with_()         # with_ applies the dial bounds

    def with_(self, **kw) -> "CommConfig":
        # fused replace+clamp: one construction instead of two (this runs
        # once per candidate dial in the tuner hot loop)
        d = dict(self.__dict__)
        d.update(kw)
        for f, lo, hi in (("nc", NC_MIN, NC_MAX), ("nt", NT_MIN, NT_MAX),
                          ("chunk_kb", C_MIN_KB, C_MAX_KB)):
            v = d[f]
            if type(v) is not int:
                v = int(round(v))
            d[f] = lo if v < lo else hi if v > hi else v
        return CommConfig(**d)


def min_config(base: "CommConfig | None" = None) -> CommConfig:
    """Algorithm 2 lines 1–3: start from minimal resource usage."""
    base = base or CommConfig()
    return base.with_(nc=NC_MIN, nt=NT_MIN, chunk_kb=C_MIN_KB, done=False)


def vendor_default(hw, kind: str = "allreduce") -> CommConfig:
    """NCCL-like defaults (what the un-tuned baseline runs)."""
    return CommConfig(nc=hw.default_nc, nt=256, chunk_kb=hw.default_chunk_kb)


def space_size() -> int:
    nc = NC_MAX - NC_MIN + 1
    nt = (NT_MAX - NT_MIN) // 32 + 1
    c = C_MAX_KB - C_MIN_KB + 1
    return len(ALGORITHMS) * len(PROTOCOLS) * len(TRANSPORTS) * nc * nt * c


def subspaces() -> Iterator[Tuple[str, str, str]]:
    """Implementation-related subspaces for divide-and-conquer (Sec. 2.2)."""
    return itertools.product(ALGORITHMS, PROTOCOLS, TRANSPORTS)
