"""Static analysis of plan artifacts: the port's deployment linter.

``analysis.lint``
    Registered ``LAG0xx`` rules over ``TunedPlan × Workload × Topology``
    (dead entries, shadowed rules, indivisible chunks, tier mismatches,
    provenance drift, band-unservable shapes, malformed lineage).

The reference's overlap verifier (``ir``, ``overlap``, ``exercise`` and
its CLI) arrives with the port's analysis slice (ROADMAP.md, queue 1).
"""

from repro_torch.analysis.lint import (Finding, PlanLintError, check_plan, errors,
                                       format_findings, lint_plan, rule, rules)

__all__ = ["Finding", "PlanLintError", "check_plan", "errors",
           "format_findings", "lint_plan", "rule", "rules"]
