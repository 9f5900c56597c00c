"""The port's own copy of ``repro.core.hardware``.

Hardware profiles for the contention model / overlap simulator.

The paper evaluates on two 16×A40 clusters (NVLink and PCIe variants);
those profiles drive the paper-faithful reproduction.  The TPU v5e profile
drives the deployment-target tuning (DESIGN.md §2): λ becomes the pool of
concurrent occupancy slots (VMEM-resident tile slots) and "channels" become
concurrent DMA streams that consume slots + HBM bandwidth.  The H100 SXM
profile is the port's deployment target; most of its fields are
placeholders until a multi-card sweep fits them (see ``H100_SXM``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, fields
from typing import Dict, List


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per chip, bf16/fp16 (theoretical)
    gemm_eff: float            # achieved fraction of peak on real kernels
    hbm_bw: float              # B̄: peak global memory bandwidth (B/s)
    link_bw: float             # achieved interconnect bus bandwidth (B/s)
    num_slots: int             # λ: SMs (GPU) / occupancy slots (TPU)
    chan_bw: float             # per-channel link bandwidth (B/s)
    chunk_half_kb: float       # chunk size at which a channel hits 50% efficiency
    launch_us: float           # per-collective launch overhead (µs)
    chunk_us: float            # per-chunk processing overhead (µs)
    comm_comp_beta: float = 0.15   # comm slowdown fraction when compute is active
    default_nc: int = 8        # vendor-default channels (NCCL: 8; larger on NVLink)
    default_chunk_kb: int = 2048
    # staging-footprint interference: NC·C bytes of communication staging
    # buffers evict the compute working set from L2 (GPU) / VMEM (TPU),
    # stalling compute pipelines by up to ``interference_gamma``.
    cache_kb: int = 6144
    interference_gamma: float = 0.35
    # per-algorithm-step fabric latency (µs) on top of the fixed 1µs step
    # cost — 0 on pod-local fabrics; the pod-joining tiers of
    # ``core.topology`` carry their cross-pod RTT here.
    hop_us: float = 0.0

    @property
    def achieved_flops(self) -> float:
        return self.peak_flops * self.gemm_eff

    # -- serialization (named-profile registry round-trip) -----------------
    def to_dict(self) -> Dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: Dict) -> "Hardware":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown Hardware fields {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        return cls(**d)

    def to_json(self, *, indent=2) -> str:
        return json.dumps(self.to_dict(), indent=indent, allow_nan=False)

    @classmethod
    def from_json(cls, text: str) -> "Hardware":
        return cls.from_dict(json.loads(text))


# Calibration anchors (paper Fig. 3, 8×A40): with λ=84 SMs and one resident
# block per SM, the wave model gives (84−16)/(84−32) = +30.8% FFN slowdown
# for NC 16→32 — the paper measures +30.2%.  Link numbers are achieved NCCL
# bus bandwidths, not line rates.
A40_PCIE = Hardware(
    name="a40-pcie",
    peak_flops=149.7e12 / 2,       # dense fp16 tensor
    gemm_eff=0.55,
    hbm_bw=696e9,
    link_bw=16e9,                  # PCIe 4.0 x16 achieved busbw
    num_slots=84,                  # GA102 SMs
    chan_bw=3.5e9,
    chunk_half_kb=128.0,
    launch_us=12.0,
    chunk_us=1.5,
    default_nc=8,
    default_chunk_kb=2048,
)

A40_NVLINK = Hardware(
    name="a40-nvlink",
    peak_flops=149.7e12 / 2,
    gemm_eff=0.55,
    hbm_bw=696e9,
    link_bw=20e9,                  # 400 Gbps NVLink achieved busbw
    num_slots=84,
    chan_bw=6e9,
    chunk_half_kb=96.0,
    launch_us=8.0,
    chunk_us=1.0,
    default_nc=16,                 # NCCL widens channels on NVLink (Sec. 4.2)
    default_chunk_kb=4096,
)

TPU_V5E = Hardware(
    name="tpu-v5e",
    peak_flops=197e12,             # bf16
    gemm_eff=0.55,
    hbm_bw=819e9,
    link_bw=42e9,                  # ICI achieved (~0.85 × 50 GB/s)
    num_slots=128,                 # VMEM-resident tile slots (occupancy pool)
    chan_bw=12.5e9,                # one ICI link direction
    chunk_half_kb=256.0,
    launch_us=2.0,
    chunk_us=0.6,
    default_nc=4,                  # XLA default: all links, bulk chunks
    default_chunk_kb=4096,
)

# The port's deployment target: one NVIDIA H100 SXM5 per rank, NVLink 4
# between the cards.  peak_flops, hbm_bw, num_slots and cache_kb are the
# data sheet's.  gemm_eff is measured on the card by ``chip_smoke.py``'s
# phase 6 (bf16 ``torch.matmul`` at the GEMM shapes of llama3-8b's tp:8
# workload).  Every other field is a PLACEHOLDER taken by analogy with
# A40_NVLINK until a contention sweep on several H100s fits it, as the A40
# profiles were fitted: the bandwidths (link_bw, chan_bw) are scaled by 9,
# NVLink 4's 450 GB/s a direction over the A40 bridge's 50 GB/s, and
# chunk_half_kb with chan_bw (the same per-chunk cost at 9x the rate);
# launch_us, chunk_us, comm_comp_beta, interference_gamma, default_nc and
# default_chunk_kb are A40_NVLINK's as they are.
H100_SXM = Hardware(
    name="h100-sxm",
    peak_flops=989.4e12,           # dense bf16 tensor
    gemm_eff=0.7285,               # chip_smoke.py phase 6 on an NVIDIA H100 80GB
                                   # HBM3 at a 700.00 W limit, torch 2.11.0+cu128
    hbm_bw=3.35e12,
    link_bw=180e9,                 # placeholder: 9 x A40_NVLINK's 20e9
    num_slots=132,                 # SMs
    chan_bw=54e9,                  # placeholder: 9 x A40_NVLINK's 6e9
    chunk_half_kb=864.0,           # placeholder: 9 x A40_NVLINK's 96.0
    launch_us=8.0,                 # placeholder: A40_NVLINK's
    chunk_us=1.0,                  # placeholder: A40_NVLINK's
    comm_comp_beta=0.15,           # placeholder: A40_NVLINK's (the default)
    default_nc=16,                 # placeholder: A40_NVLINK's
    default_chunk_kb=4096,         # placeholder: A40_NVLINK's
    cache_kb=51200,                # 50 MB L2
    interference_gamma=0.35,       # placeholder: A40_NVLINK's (the default)
)

PROFILES = {h.name: h for h in (A40_PCIE, A40_NVLINK, TPU_V5E, H100_SXM)}


# ---------------------------------------------------------------------------
# named-profile registry: launchers, fault specs and --plan-hardware resolve
# profiles by name instead of importing module constants
# ---------------------------------------------------------------------------

def by_name(name: str) -> Hardware:
    """The registered profile called ``name`` — the one lookup every
    by-name surface (``session.tune(workload, "tpu-v5e")``, the launchers'
    ``--plan-hardware``, benchmark hardware columns) goes through.

    Raises:
        KeyError: unknown name; the message lists ``profiles()``.
    """
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown hardware profile {name!r}; registered: "
                       f"{profiles()}") from None


def profiles() -> List[str]:
    """Sorted names of every registered profile."""
    return sorted(PROFILES)


def register_profile(hw: Hardware, *, overwrite: bool = False) -> Hardware:
    """Add ``hw`` to the registry under ``hw.name`` (refusing silent
    replacement unless ``overwrite=True``); returns ``hw`` so custom
    profiles register inline::

        hw = register_profile(Hardware(name="my-pod", ...))
    """
    if hw.name in PROFILES and not overwrite:
        raise ValueError(f"hardware profile {hw.name!r} already registered "
                         "(pass overwrite=True to replace it)")
    PROFILES[hw.name] = hw
    return hw
