"""Analysis of plan artifacts: the overlap-materialization verifier and the
deployment linter (counterpart of ``repro.analysis``).

A ``TunedPlan`` only earns its speedup if the program actually issues the
chunk structure it promises, and only deploys safely if its entries,
provenance and lineage are coherent.  This package checks both without
running a training step:

``analysis.ir``
    Collective/compute op graphs of one run: the record of what the host
    issued (``capture``, a ``TorchDispatchMode``) and the profile of what
    the card ran (a ``torch.profiler`` trace), one chunk loop a helper call
    (the shared op table; ``collective_bytes`` is the dry run's count).

``analysis.overlap``
    The verifier: run under the plan with the resolution recorder armed,
    then judge every consulted tuned site ``MATERIALIZED | DEGRADED |
    ABSENT``.

``analysis.lint``
    The linter: registered ``LAG0xx`` rules over ``TunedPlan × Workload ×
    Topology`` (dead entries, shadowed rules, indivisible chunks, tier
    mismatches, provenance drift, band-unservable shapes, malformed
    lineage).

``analysis.exercise``
    Model-free verification: synthetic per-site programs sized so the
    plan's chunking divides, over a fake world of 8 ranks (the
    ``verify-overlap`` CLI body).

Front doors: ``python -m repro_torch.analysis lint|verify-overlap``,
``launch/dryrun.py --lint``, ``session.tune(lint=...)``,
``PlanRepository.put(lint=...)`` and the ``serving.plans.PlanBinding``
ERROR-refusal gate.
"""

from repro_torch.analysis.exercise import exercise_and_report, exercise_plan
from repro_torch.analysis.ir import (COLLECTIVE_OPS, ChunkLoop, CollectiveOp, OpGraph,
                                     capture, collective_bytes, graph_from_profile,
                                     graph_from_record)
from repro_torch.analysis.lint import (Finding, PlanLintError, check_plan, errors,
                                       format_findings, lint_plan, rule, rules)
from repro_torch.analysis.overlap import (OverlapReport, SiteVerdict, trace_and_verify,
                                          verify, verify_profile)

__all__ = [
    "COLLECTIVE_OPS", "ChunkLoop", "CollectiveOp", "Finding", "OpGraph",
    "OverlapReport", "PlanLintError", "SiteVerdict", "capture", "check_plan",
    "collective_bytes", "errors", "exercise_and_report", "exercise_plan",
    "format_findings", "graph_from_profile", "graph_from_record", "lint_plan",
    "rule", "rules", "trace_and_verify", "verify", "verify_profile",
]
