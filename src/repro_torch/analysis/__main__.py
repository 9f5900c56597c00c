"""CLI front door for the plan static-analysis subsystem.

    PYTHONPATH=src python -m repro_torch.analysis lint PLAN.json [...]
    PYTHONPATH=src python -m repro_torch.analysis verify-overlap PLAN.json [...]

(counterpart of ``python -m repro.analysis``, its arguments and exit codes.)

``lint`` runs the deployment linter.  Exit codes: 0 = no
ERROR-severity findings, 1 = at least one ERROR, 2 = unreadable plan.
``--expect CODES`` inverts the contract for seeded-broken CI fixtures:
exit 0 iff the set of finding codes equals the comma-separated list.

``verify-overlap`` runs every tuned site's production chunked helper
under the plan over a fake world of 8 ranks (``analysis.exercise``) and
judges materialization from the record of what it issued.  Exit
codes: 0 = every site MATERIALIZED (``--allow-degraded`` tolerates
DEGRADED), 1 = a site is ABSENT/DEGRADED, 2 = unreadable plan.
"""

import argparse
import sys

_LOAD_ERRORS = (OSError, ValueError, KeyError, TypeError)


def _load(path: str):
    from repro_torch.core.session import TunedPlan

    try:
        return TunedPlan.load(path)
    except _LOAD_ERRORS as e:
        print(f"error: {path}: not a readable TunedPlan artifact "
              f"({e.__class__.__name__}: {e})", file=sys.stderr)
        return None


def _cmd_lint(args) -> int:
    from repro_torch.analysis.lint import errors, format_findings, lint_plan

    worst = 0
    for path in args.plans:
        plan = _load(path)
        if plan is None:
            return 2
        findings = lint_plan(plan)
        print(format_findings(findings, label=path))
        if args.expect is not None:
            want = {c for c in args.expect.split(",") if c}
            got = {f.code for f in findings}
            if got != want:
                print(f"expected codes {sorted(want)} but found "
                      f"{sorted(got)}", file=sys.stderr)
                worst = max(worst, 1)
        elif errors(findings):
            worst = max(worst, 1)
    return worst


def _cmd_verify(args) -> int:
    from repro_torch.analysis.exercise import exercise_and_report

    worst = 0
    for path in args.plans:
        plan = _load(path)
        if plan is None:
            return 2
        ok, text = exercise_and_report(
            plan, allow_degraded=args.allow_degraded, label=path)
        print(text)
        if not ok:
            worst = max(worst, 1)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="TunedPlan static analysis: deployment linter and "
                    "overlap-materialization verifier")
    sub = ap.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("lint", help="run the LAG0xx rule catalog over "
                                     "saved plans")
    lp.add_argument("plans", nargs="+", help="TunedPlan JSON path(s)")
    lp.add_argument("--expect", default=None,
                    help="comma-separated finding codes this plan must "
                         "produce exactly (CI fixture contract)")
    lp.set_defaults(fn=_cmd_lint)

    vp = sub.add_parser("verify-overlap",
                        help="run each tuned site's chunked helper "
                             "under the plan and judge materialization")
    vp.add_argument("plans", nargs="+", help="TunedPlan JSON path(s)")
    vp.add_argument("--allow-degraded", action="store_true",
                    help="tolerate DEGRADED (monolithic-fallback) sites")
    vp.set_defaults(fn=_cmd_verify)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
