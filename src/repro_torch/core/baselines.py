"""The port's own copy of ``repro.core.baselines``.

Un-tuned baseline configurations (NCCL defaults / XLA defaults)."""
from __future__ import annotations

from repro_torch.core.comm_params import vendor_default
from repro_torch.core.workload import ConfigSet, Workload


def nccl_defaults(wl: Workload, hw) -> ConfigSet:
    cfg = vendor_default(hw)
    return {site: cfg for site in wl.comm_sites()}
