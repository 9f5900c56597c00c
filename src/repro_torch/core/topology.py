"""The port's own copy of ``repro.core.topology``.

Hierarchical (pod-aware) hardware model: fast islands × a slow fabric.

The paper evaluates on *flat* clusters — one interconnect tier, one
``Hardware`` profile.  Geo-distributed and bandwidth-starved training is
hierarchical: N pods, each a fast NVLink/ICI island described by an
existing :class:`~repro_torch.core.hardware.Hardware` profile, joined by a much
slower pod-to-pod fabric (DCN, WAN, a PCIe switch complex) with its own
bandwidth, channel, launch and *latency* terms.  This module makes that
second tier a first-class cost-model citizen:

:class:`Fabric`
    The pod-joining interconnect tier: ``link_bw``/``chan_bw``/
    ``launch_us``/``chunk_us``/``chunk_half_kb`` exactly as on
    ``Hardware``, plus ``hop_us`` — a per-algorithm-step latency term
    (cross-pod RTT) the contention model adds on top of the fixed 1 µs
    step cost (``contention.comm_time``).  Built-ins live in ``FABRICS``
    (``"dcn"``, ``"wan"``, ``"pcie-switch"``).

:class:`HierarchicalHardware`
    ``pods`` copies of an ``island`` profile joined by a ``fabric``.
    Every :class:`~repro_torch.core.workload.CommOp` carries a ``tier`` —
    ``""`` (pod-local, priced on the island) or ``"inter"`` (pod-spanning,
    priced on :meth:`inter_hardware`: the island's *compute* side with the
    fabric's link terms, so cross-pod communication still contends with
    island compute through Eqs. 4–6).  ``flat(hw)`` is the degenerate
    single-pod case — the simulator normalizes it away entirely, so flat
    tuning stays **bit-identical** to the single-fabric path.

Plans tuned under a topology record its :meth:`fingerprint` as provenance
(``TunedPlan.topology``) and refuse to evaluate under a different one —
a cross-pod plan applied to a flat fabric is exactly as unsound as a plan
for the wrong model.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, fields, replace
from functools import cached_property
from typing import Dict, List, Optional, Union

from repro_torch.core.hardware import Hardware, by_name

# CommOp.tier values: "" = pod-local (island), "inter" = pod-spanning.
TIERS = ("", "inter")


@dataclass(frozen=True)
class Fabric:
    """The pod-joining interconnect tier (see module docstring)."""

    name: str
    link_bw: float  # achieved pod-to-pod bus bandwidth (B/s)
    chan_bw: float  # per-channel bandwidth (B/s)
    launch_us: float  # per-collective launch overhead (µs)
    hop_us: float = 0.0  # per-algorithm-step latency (µs): ~RTT
    chunk_half_kb: float = 1024.0
    chunk_us: float = 2.0  # per-chunk processing overhead (µs)
    default_nc: int = 4
    default_chunk_kb: int = 8192

    def __post_init__(self):
        if self.link_bw <= 0 or self.chan_bw <= 0:
            raise ValueError(f"fabric {self.name!r} needs positive link_bw/chan_bw")
        if self.hop_us < 0 or self.launch_us < 0:
            raise ValueError(f"fabric {self.name!r} latency terms must be >= 0")

    def to_dict(self) -> Dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: Dict) -> "Fabric":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown Fabric fields {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        return cls(**d)


# Built-in pod-joining fabrics.  Bandwidths are achieved busbw per chip,
# not line rates — same convention as the Hardware profiles.
DCN_400G = Fabric(
    name="dcn",
    link_bw=6.25e9,  # 400 Gbps pod uplink, ~1/8 landing per chip
    chan_bw=3.125e9,
    launch_us=25.0,
    hop_us=12.0,  # same-campus pod-to-pod RTT per step
    chunk_half_kb=1024.0,
    chunk_us=2.0,
    default_nc=4,
    default_chunk_kb=8192,
)

WAN_10G = Fabric(
    name="wan",
    link_bw=1.0e9,  # cross-DC 10 Gbps effective
    chan_bw=0.5e9,
    launch_us=80.0,
    hop_us=500.0,  # cross-region RTT per step
    chunk_half_kb=4096.0,
    chunk_us=4.0,
    default_nc=2,
    default_chunk_kb=8192,
)

PCIE_SWITCH = Fabric(
    name="pcie-switch",
    link_bw=12e9,  # host PCIe complex joining NVLink islands
    chan_bw=3.0e9,
    launch_us=15.0,
    hop_us=3.0,
    chunk_half_kb=256.0,
    chunk_us=1.8,
    default_nc=8,
    default_chunk_kb=4096,
)

FABRICS: Dict[str, Fabric] = {f.name: f for f in (DCN_400G, WAN_10G, PCIE_SWITCH)}


def fabric_by_name(name: str) -> Fabric:
    """The registered fabric called ``name`` (``sorted(FABRICS)`` lists
    the built-ins); raises ``KeyError`` naming them otherwise."""
    try:
        return FABRICS[name]
    except KeyError:
        raise KeyError(
            f"unknown inter-pod fabric {name!r}; registered: "
            f"{sorted(FABRICS)}"
        ) from None


def _as_fabric(fabric: Union[Fabric, str, None]) -> Optional[Fabric]:
    if fabric is None or isinstance(fabric, Fabric):
        return fabric
    return fabric_by_name(fabric)


def _as_island(island: Union[Hardware, str]) -> Hardware:
    return by_name(island) if isinstance(island, str) else island


@dataclass(frozen=True)
class HierarchicalHardware:
    """``pods`` islands of ``island`` joined by ``fabric`` (see module
    docstring).  ``pods == 1`` is the flat degenerate case: no fabric is
    required, ``name`` collapses to the island's, and the simulator
    treats it exactly like the bare ``Hardware`` profile."""

    island: Hardware
    pods: int = 1
    fabric: Optional[Fabric] = None

    def __post_init__(self):
        if not isinstance(self.island, Hardware):
            raise TypeError(
                "island must be a Hardware profile, got "
                f"{type(self.island).__name__}"
            )
        if self.pods < 1:
            raise ValueError(f"pods must be >= 1, got {self.pods}")
        if self.pods > 1 and self.fabric is None:
            raise ValueError(
                f"{self.pods} pods need an inter-pod fabric; pass fabric= "
                f"(one of {sorted(FABRICS)} or a Fabric)"
            )

    # -- identity ----------------------------------------------------------
    @property
    def is_flat(self) -> bool:
        return self.pods == 1

    @property
    def name(self) -> str:
        """Repo-key-safe identity: the bare island name when flat (so flat
        plans key identically to single-fabric ones), else
        ``<island>-x<pods>-<fabric>``."""
        if self.is_flat:
            return self.island.name
        return f"{self.island.name}-x{self.pods}-{self.fabric.name}"

    def fingerprint(self) -> str:
        """Content hash of the full topology (island + pod count + fabric
        terms) — what ``TunedPlan.topology`` records and
        ``check_topology`` refuses mismatches on."""
        payload = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()

    # -- tier pricing ------------------------------------------------------
    @cached_property
    def inter_hardware(self) -> Hardware:
        """The pod-spanning pricing profile: the island's compute side
        (FLOPs, HBM, slots, interference) with the fabric's link terms —
        a cross-pod collective still contends with island compute for
        memory bandwidth and SM slots, it just moves bytes over the slow
        tier and pays its per-step latency."""
        if self.is_flat:
            return self.island
        f = self.fabric
        return replace(
            self.island,
            name=f"{self.island.name}@{f.name}",
            link_bw=f.link_bw,
            chan_bw=f.chan_bw,
            launch_us=f.launch_us,
            chunk_us=f.chunk_us,
            chunk_half_kb=f.chunk_half_kb,
            hop_us=f.hop_us,
            default_nc=f.default_nc,
            default_chunk_kb=f.default_chunk_kb,
        )

    def tier_hardware(self, tier: str) -> Hardware:
        """The pricing profile for one ``CommOp.tier`` value."""
        if tier not in TIERS:
            raise ValueError(f"unknown fabric tier {tier!r}; known: {TIERS}")
        return self.inter_hardware if tier == "inter" else self.island

    def comm_hardware(self, op) -> Hardware:
        """The pricing profile for one ``CommOp`` — the fabric tier its
        site spans (the simulator's per-comm hook)."""
        return self.tier_hardware(op.tier)

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "island": self.island.to_dict(),
            "pods": self.pods,
            "fabric": None if self.fabric is None else self.fabric.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "HierarchicalHardware":
        fab = d.get("fabric")
        return cls(
            island=Hardware.from_dict(d["island"]),
            pods=int(d.get("pods", 1)),
            fabric=None if fab is None else Fabric.from_dict(fab),
        )

    def to_json(self, *, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, allow_nan=False)

    @classmethod
    def from_json(cls, text: str) -> "HierarchicalHardware":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "HierarchicalHardware":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def flat(island: Union[Hardware, str]) -> HierarchicalHardware:
    """The degenerate single-pod topology: bit-identical to tuning on the
    bare ``island`` profile (the simulator normalizes it away)."""
    return HierarchicalHardware(island=_as_island(island), pods=1)


def hierarchical(
    island: Union[Hardware, str],
    pods: int,
    fabric: Union[Fabric, str, None] = "dcn",
) -> HierarchicalHardware:
    """``pods`` islands of ``island`` joined by ``fabric`` (a ``Fabric``
    or a ``FABRICS`` name); ``pods == 1`` ignores the fabric and returns
    the flat topology."""
    island = _as_island(island)
    if pods == 1:
        return flat(island)
    return HierarchicalHardware(island=island, pods=pods, fabric=_as_fabric(fabric))


def two_pod(
    island: Union[Hardware, str] = "tpu-v5e",
    fabric: Union[Fabric, str] = "dcn",
) -> HierarchicalHardware:
    """The canonical hierarchical scenario: two islands over one slow
    fabric — the smallest topology where ``acc.*``/``outer.*`` cross-pod
    sites price differently from pod-local ones."""
    return hierarchical(island, 2, fabric)


def resolve_topology(
    topo: Union["HierarchicalHardware", Dict, str, None],
) -> Optional[HierarchicalHardware]:
    """Normalize a topology argument: ``None`` passes through, dicts are
    ``from_dict`` specs, strings are paths to saved topology JSON, and
    ``HierarchicalHardware`` instances are returned as-is."""
    if topo is None or isinstance(topo, HierarchicalHardware):
        return topo
    if isinstance(topo, dict):
        return HierarchicalHardware.from_dict(topo)
    if isinstance(topo, str):
        return HierarchicalHardware.load(topo)
    raise TypeError(
        "topology must be a HierarchicalHardware, a to_dict() spec, a "
        f"path to saved topology JSON, or None; got {type(topo).__name__}"
    )


def site_tier(site: str) -> str:
    """Fallback tier classification for sites whose ``CommOp`` predates
    the ``tier`` field (deserialized metadata): ``outer.*`` sync and
    ``acc.*.ar_grads`` span pods, everything else is pod-local."""
    if site.startswith("outer."):
        return "inter"
    if site.startswith("acc.") and site.endswith(".ar_grads"):
        return "inter"
    return ""
