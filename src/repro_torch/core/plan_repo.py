"""The port's own copy of ``repro.core.plan_repo``.

PlanRepository: a directory store of ``TunedPlan`` artifacts keyed on
(workload structural fingerprint × hardware name).

The paper's deployment story is "co-tune once, deploy the plan"; the
repository is the *once* made operational.  ``session.tune(..., repo=...)``
auto-``put``s every tuned plan, and the launchers' ``--plan-repo`` flag
``resolve``s the current (workload, hardware) pair at startup — a hit
installs the stored plan with zero tuning work, a miss launches untuned
with a warning.

Layout: one strict-RFC JSON file per key, named
``<fingerprint>__<hardware>.json`` (the fingerprint is the sha256 hex
``session.workload_fingerprint`` emits; hardware is ``Hardware.name``).
``get`` re-verifies the loaded plan's own provenance against the key and
refuses misfiled or tampered entries (``PlanRepoError``) rather than
installing configs tuned for a different structure.

``resolve(band=...)`` extends the exact lookup to a *tolerance band*: a
serving fleet's decode batch drifts under traffic, so an exact-shape miss
that is a structural hit (same ``session.structure_fingerprint``) at a
nearby (seq, global_batch) resolves to the nearest tuned shape instead of
launching untuned.  Provenance is still verified entry by entry — but a
corrupt/misfiled *neighbor* found mid-scan is quarantined to
``<name>.corrupt`` and skipped with a ``RuntimeWarning`` instead of
aborting the lookup; only the direct ``get`` of an entry you explicitly
asked for stays strict.
"""
from __future__ import annotations

import math
import os
import warnings
from typing import Iterable, List, Optional, Tuple, Union

from repro_torch.core.hardware import Hardware
from repro_torch.core.session import (TunedPlan, structure_fingerprint,
                                      workload_fingerprint, workload_shape)
from repro_torch.core.workload import Workload


class PlanRepoError(ValueError):
    """A repository entry's content does not match its (fingerprint,
    hardware) key — misfiled, tampered, or hand-edited; refuse to apply."""


def _hw_name(hardware: Union[Hardware, str]) -> str:
    return hardware.name if isinstance(hardware, Hardware) else str(hardware)


class PlanRepository:
    """Directory-backed ``TunedPlan`` store keyed on (fingerprint, hardware)."""

    def __init__(self, root: Union[str, os.PathLike]):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    # -- keys --------------------------------------------------------------
    def path_for(self, fingerprint: str, hardware: Union[Hardware, str]) -> str:
        return os.path.join(self.root, f"{fingerprint}__{_hw_name(hardware)}.json")

    def entries(self) -> List[Tuple[str, str, str]]:
        """Sorted ``(fingerprint, hardware, path)`` rows for every entry."""
        rows = []
        for fn in sorted(os.listdir(self.root)):
            if fn.endswith(".json") and "__" in fn:
                fp, hw = fn[: -len(".json")].split("__", 1)
                rows.append((fp, hw, os.path.join(self.root, fn)))
        return rows

    def __len__(self) -> int:
        return len(self.entries())

    def __contains__(self, key: Iterable[str]) -> bool:
        fp, hw = key
        return os.path.exists(self.path_for(fp, hw))

    # -- store / fetch -----------------------------------------------------
    def put(self, plan: TunedPlan, *, overwrite: bool = True,
            lint: Optional[str] = None) -> str:
        """Store ``plan`` under its own (fingerprint, hardware) provenance;
        returns the entry path.  ``lint="error"`` refuses to publish a
        plan with ERROR-severity deployment-lint findings
        (``repro_torch.analysis.lint.PlanLintError``); ``lint="warn"`` surfaces
        findings as one ``RuntimeWarning`` but publishes anyway."""
        if lint not in (None, "off"):
            if lint not in ("warn", "error"):
                raise ValueError(f"lint= must be None, 'off', 'warn' or "
                                 f"'error', got {lint!r}")
            from repro_torch.analysis.lint import (PlanLintError, errors,
                                                   format_findings, lint_plan)

            findings = lint_plan(plan)
            if lint == "error" and errors(findings):
                raise PlanLintError(
                    findings,
                    label=f"repository entry ({plan.fingerprint[:12]}…, "
                          f"{plan.hardware})")
            if findings:
                import warnings

                warnings.warn(
                    format_findings(findings,
                                    label=f"put({plan.workload!r})"),
                    RuntimeWarning, stacklevel=2)
        path = self.path_for(plan.fingerprint, plan.hardware)
        if not overwrite and os.path.exists(path):
            raise FileExistsError(
                f"plan repository already holds an entry for "
                f"({plan.fingerprint[:12]}…, {plan.hardware}); pass "
                "overwrite=True to replace it"
            )
        # atomic publish: an interrupted tune must never leave a truncated
        # entry that later launches trip over
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            plan.save(tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path

    def get(
        self, fingerprint: str, hardware: Union[Hardware, str]
    ) -> Optional[TunedPlan]:
        """The stored plan for the key, or ``None`` on a miss (including a
        stale-hardware miss: same fingerprint tuned for other hardware).
        Raises ``PlanRepoError`` when the entry's own provenance disagrees
        with the key it is filed under."""
        hw = _hw_name(hardware)
        path = self.path_for(fingerprint, hw)
        if not os.path.exists(path):
            return None
        try:
            plan = TunedPlan.load(path)
        except (ValueError, KeyError, TypeError) as e:
            raise PlanRepoError(
                f"repository entry {path} is not a readable TunedPlan "
                f"({type(e).__name__}: {e}) — truncated or corrupt; "
                "delete it or re-put"
            ) from e
        if plan.fingerprint != fingerprint or plan.hardware != hw:
            raise PlanRepoError(
                f"repository entry {path} is filed under "
                f"({fingerprint[:12]}…, {hw}) but carries provenance "
                f"({plan.fingerprint[:12]}…, {plan.hardware}) — refusing "
                "to apply a misfiled/tampered plan; re-tune or re-put"
            )
        return plan

    def resolve(
        self, wl: Workload, hardware: Union[Hardware, str], *,
        band: float = 0.0
    ) -> Optional[TunedPlan]:
        """The stored plan matching ``wl``'s structural fingerprint on
        ``hardware``, or ``None`` — the launch-time lookup.

        ``band`` > 0 widens an exact-fingerprint miss into a *tolerance
        band*: entries with the same shape-free ``structure_fingerprint``
        (same model, parallel degrees, SiteIds — only batch/seq differ)
        whose tuned (seq, global_batch) each sit within a relative
        deviation of ``band`` (e.g. 0.5 = up to 1.5× off) are candidates,
        nearest shape wins.  Every candidate is still provenance-verified
        through ``get`` — banding relaxes the shape, never the trust
        model.  ``band=0.0`` is the exact pre-band behavior.

        Args:
            wl: the live workload to resolve a plan for.
            hardware: profile (or name) keying the lookup.
            band: relative shape tolerance; 0 = exact fingerprint only.

        Returns:
            The stored ``TunedPlan``, or ``None`` on a miss.

        Raises:
            PlanRepoError: the *exact* entry for the key exists but its
                provenance disagrees with its filename (corrupt banded
                neighbors are quarantined, not raised).

        Example::

            >>> import tempfile
            >>> from repro_torch.configs import get_smoke_config
            >>> from repro_torch.core import (ParallelPlan,
            ...                         extract_decode_workload, tune)
            >>> wl = extract_decode_workload(
            ...     get_smoke_config("llama3-8b"),
            ...     ParallelPlan(kind="tp", tp=2), global_batch=8, seq=64)
            >>> repo = PlanRepository(tempfile.mkdtemp())
            >>> plan = tune(wl, "h100-sxm", method="nccl", repo=repo)
            >>> repo.resolve(wl, "h100-sxm").fingerprint == plan.fingerprint
            True
        """
        plan, _ = self.resolve_explain(wl, hardware, band=band)
        return plan

    def resolve_explain(
        self, wl: Workload, hardware: Union[Hardware, str], *,
        band: float = 0.0
    ) -> Tuple[Optional[TunedPlan], str]:
        """``resolve`` plus how the hit happened: ``(plan, "exact")``,
        ``(plan, "banded")`` or ``(None, "miss")`` — what serving engines
        record in their plan stats and the CI smoke asserts on."""
        hw = _hw_name(hardware)
        fp = workload_fingerprint(wl)
        plan = self.get(fp, hw)
        if plan is not None:
            return plan, "exact"
        if band <= 0.0:
            return None, "miss"
        want_struct = structure_fingerprint(wl)
        want_shape = workload_shape(wl)
        best: Optional[TunedPlan] = None
        best_d = math.inf
        for efp, ehw, path in self.entries():
            if ehw != hw or efp == fp:
                continue
            try:
                cand = self.get(efp, ehw)   # provenance re-verified
            except PlanRepoError as e:
                # one bad neighbor must not abort the whole banded scan:
                # quarantine it and keep looking.  Direct ``get`` stays
                # strict — only the opportunistic scan degrades gracefully.
                self._quarantine(path, f"during banded resolve: {e}")
                continue
            if cand is None:
                continue
            if not cand.structure or cand.structure != want_struct:
                continue
            d = _shape_distance(cand.shape, want_shape, band)
            if d is not None and d < best_d:
                best, best_d = cand, d
        return (best, "banded") if best is not None else (None, "miss")

    # -- lineage -----------------------------------------------------------
    def _quarantine(self, path: str, why: str) -> str:
        """Move a bad entry aside as ``<path>.corrupt`` (dropping it from
        ``entries()``) and warn — the graceful-degradation path shared by
        banded scans and lineage walks."""
        quarantined = f"{path}.corrupt"
        os.replace(path, quarantined)
        warnings.warn(
            f"skipping corrupt plan repository entry {why}; quarantined "
            f"to {quarantined}",
            RuntimeWarning,
            stacklevel=3,
        )
        return quarantined

    def retune_chain(
        self, fingerprint: str, hardware: Union[Hardware, str]
    ) -> List[str]:
        """The retune ancestry of the stored entry for the key, newest
        first: ``[entry_digest, parent_digest, grandparent_digest, ...]``.

        ``put`` overwrites one (fingerprint, hardware) key in place, so
        ancestors live only as the embedded ``lineage["chain"]`` digests
        — this walks them without needing the ancestor artifacts.  A
        cold-tuned entry returns a single-element chain; a missing key
        returns ``[]``.  A corrupt entry or malformed lineage is
        quarantined (same ``.corrupt`` path as banded scans) and returns
        ``[]`` instead of breaking the walk.

        Args:
            fingerprint: the workload fingerprint keying the entry.
            hardware: profile (or name) keying the entry.

        Returns:
            Artifact digests, newest (the stored entry itself) first.
        """
        hw = _hw_name(hardware)
        path = self.path_for(fingerprint, hw)
        try:
            plan = self.get(fingerprint, hw)
        except PlanRepoError as e:
            self._quarantine(path, f"during retune-chain walk: {e}")
            return []
        if plan is None:
            return []
        lineage = plan.lineage or {}
        chain = lineage.get("chain", [])
        parent = lineage.get("retuned_from")
        malformed = (
            not isinstance(chain, list)
            or not all(isinstance(d, str) for d in chain)
            or (parent is not None and not isinstance(parent, str))
            or (chain and parent != chain[0])
            or (parent is not None and not chain)
        )
        if malformed:
            self._quarantine(
                path,
                f"during retune-chain walk: lineage of "
                f"({fingerprint[:12]}…, {hw}) is malformed "
                f"(retuned_from={parent!r}, chain={chain!r})",
            )
            return []
        return [plan.artifact_digest()] + list(chain)


def _shape_distance(tuned: dict, want: dict, band: float) -> Optional[float]:
    """Log-scale distance between two banded shape records, or ``None``
    when any dimension is missing, non-positive, or deviates beyond
    ``band`` (relative: max/min − 1 ≤ band must hold per dimension)."""
    total = 0.0
    for key in ("seq", "global_batch"):
        a, b = tuned.get(key), want.get(key)
        if not a or not b or a <= 0 or b <= 0:
            return None
        ratio = max(a, b) / min(a, b)
        if ratio - 1.0 > band + 1e-12:
            return None
        total += abs(math.log(ratio))
    return total


def as_repository(repo: Union[str, os.PathLike, PlanRepository]) -> PlanRepository:
    """Coerce a directory path (or an existing repository) to a
    ``PlanRepository`` — what ``session.tune(repo=...)`` accepts."""
    return repo if isinstance(repo, PlanRepository) else PlanRepository(repo)
