"""The plan bridge of the port (``repro_torch.core.apply``, the plan half of
``repro_torch.parallel.collectives``, ``repro_torch.analysis.lint``) against
the reference's on the same inputs.

Tolerance: exact equality throughout.  Plans cross between the packages
as their JSON files; lowered plans compare entry by entry as (SiteId,
strategy, num_chunks), site resolutions as (strategy, num_chunks,
matched key, tier), lint findings as (code, severity, site, message).
"""
import copy
import importlib.util
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

from repro import configs as JC
from repro import core as J
from repro.analysis import lint as JL
from repro.core import apply as JA
from repro.core import plan_repo as JR
from repro.core import session as JS
from repro.parallel import collectives as JCOL
from repro_torch import configs as TC
from repro_torch import core as T
from repro_torch.analysis import lint as TL
from repro_torch.core import apply as TA
from repro_torch.core import plan_repo as TR
from repro_torch.core import session as TS
from repro_torch.parallel import collectives as TCOL

ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)
# package -> (configs, core, apply, collectives, lint, session, plan_repo)
PKGS = {"reference": (JC, J, JA, JCOL, JL, JS, JR),
        "port": (TC, T, TA, TCOL, TL, TS, TR)}
SEQ, BATCH = 2048, 16


@pytest.fixture(autouse=True)
def _clean_plan_state():
    yield
    for pkg in PKGS.values():
        pkg[3].install_runtime_plan({})
        pkg[3].reset_degraded_warnings()


def _wl(pkg, arch="llama3-8b", layers=2, **spec):
    C, X = PKGS[pkg][:2]
    return X.extract_workload(C.get_config(arch),
                              X.ParallelPlan(**(spec or dict(kind="fsdp", dp=8))),
                              seq=SEQ, global_batch=BATCH, layers=layers)


def _lowered(rt) -> dict:
    return {k: (v.strategy, v.num_chunks) for k, v in rt.items()}


def _findings(findings) -> list:
    return [(f.code, f.severity, f.site, f.message) for f in findings]


# ---------------------------------------------------------------------------
# plans cross between the packages as their JSON files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fsdp:8", "tp:8"])
@pytest.mark.parametrize("arch", JC.ALL_ARCHS)
def test_plan_files_cross_both_ways(tmp_path, arch, kind):
    spec = {"fsdp:8": dict(kind="fsdp", dp=8), "tp:8": dict(kind="tp", tp=8)}[kind]
    for src, dst in (("reference", "port"), ("port", "reference")):
        _, X, A, _, Lint, _, _ = PKGS[src]
        _, _, B, _, Lint2, S2, _ = PKGS[dst]
        wl = _wl(src, arch, **spec)
        plan = X.tune(wl, "a40-nvlink", method="lagom")
        path = tmp_path / f"{src}.json"
        plan.save(str(path))
        back = S2.TunedPlan.load(str(path))
        assert back.to_json() == plan.to_json()
        rt, rt2 = plan.runtime_plan(), back.runtime_plan(_wl(dst, arch, **spec))
        assert _lowered(rt2) == _lowered(rt)
        assert B.plan_digest(rt2) == A.plan_digest(rt)
        assert _findings(Lint2.lint_plan(back)) == _findings(Lint.lint_plan(plan))


@pytest.mark.parametrize("src", ["reference", "port"])
def test_plan_repository_crosses(tmp_path, src):
    dst = "port" if src == "reference" else "reference"
    repo = PKGS[src][6].PlanRepository(tmp_path)
    plan = PKGS[src][1].tune(_wl(src), "tpu-v5e", method="lagom", repo=repo)
    got = PKGS[dst][6].PlanRepository(tmp_path).resolve(_wl(dst), "tpu-v5e")
    assert got is not None and got.to_json() == plan.to_json()
    # a shape in the band resolves alike in both
    near = [PKGS[p][6].PlanRepository(tmp_path).resolve(
        _wl(p, kind="fsdp", dp=8), "tpu-v5e", band=0.5) for p in (src, dst)]
    assert near[0].to_json() == near[1].to_json()


def test_session_diff_cli_matches(tmp_path, capsys):
    wl = _wl("reference")
    a, b, bad = tmp_path / "a.json", tmp_path / "b.json", tmp_path / "bad.json"
    J.tune(wl, "a40-nvlink", method="lagom").save(str(a))
    J.tune(wl, "a40-nvlink", method="nccl").save(str(b))
    bad.write_text("{oops")
    cases = [(a, a, 0), (a, b, 1), (a, bad, 2), (a, tmp_path / "missing.json", 2)]
    for x, y, code in cases:
        outs = []
        for S in (JS, TS):
            assert S._main(["diff", str(x), str(y)]) == code
            outs.append(capsys.readouterr())
        assert outs[1].out == outs[0].out
        assert outs[1].err == outs[0].err
    res = subprocess.run([sys.executable, "-m", "repro_torch.core.session", "diff",
                          str(a), str(b)], capture_output=True, text=True,
                         cwd=str(ROOT), env={"PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert res.returncode == 1 and "site(s) changed" in res.stdout, res.stderr


# ---------------------------------------------------------------------------
# resolution: the reference's edge cases, each answer held against it
# ---------------------------------------------------------------------------

def _resolve_all(plan_spec: dict, queries) -> dict:
    """Each package's answers to ``queries`` under ``plan_spec`` (a map of
    key -> (strategy, num_chunks)), as plain tuples."""
    out = {}
    for pkg, mods in PKGS.items():
        C = mods[3]
        plan = {k: C.CollectiveRuntime(*v) for k, v in plan_spec.items()}
        with C.use_runtime_plan(plan):
            out[pkg] = [(r.strategy, r.num_chunks, key, tier)
                        for r, key, tier in (C.resolve_runtime(s, c) for s, c in queries)]
    assert out["port"] == out["reference"]
    return dict(zip(queries, out["port"]))


def test_resolve_classless_acc_and_outer_sites():
    plan = {"acc": ("chunked", 4), "outer": ("ring", 2)}
    q = [("acc.step3.rs_grads", "acc"), ("", "acc"),
         ("outer.round1.sync.w", "outer"), ("", "outer")]
    got = _resolve_all(plan, q)
    assert got[q[0]] == ("chunked", 4, "acc", "prefix")
    assert got[q[1]] == ("chunked", 4, "acc", "class")
    assert got[q[2]] == ("ring", 2, "outer", "prefix")
    assert got[q[3]] == ("ring", 2, "outer", "class")
    for pkg in PKGS.values():
        assert pkg[3].site_class("acc.step3.rs_grads") == "acc"


def test_resolve_exact_beats_prefix_beats_class_with_empty_class():
    plan = {"a.b.c": ("ring", 8), "a.b": ("ring", 4), "": ("chunked", 2)}
    q = [("a.b.c", ""), ("a.b.d", ""), ("z.y", ""), ("", ""), ("z.y", None)]
    got = _resolve_all(plan, q)
    assert got[q[0]][2:] == ("a.b.c", "exact")
    assert got[q[1]][2:] == ("a.b", "prefix")
    assert got[q[2]] == ("chunked", 2, "", "class")
    assert got[q[3]][3] == "class"
    assert got[q[4]] == ("xla", 1, "", "default")


def test_resolve_prefix_shadowed_by_exhaustive_exact_entries():
    plan = {f"tp.layer{i}.mlp.ag": ("ring", i + 2) for i in range(3)}
    plan["tp"] = ("chunked", 16)
    q = [(f"tp.layer{i}.mlp.ag", "ag") for i in range(3)] + [("tp.layer9.mlp.ag", "ag")]
    got = _resolve_all(plan, q)
    for i in range(3):
        assert got[q[i]] == ("ring", i + 2, f"tp.layer{i}.mlp.ag", "exact")
    assert got[q[3]] == ("chunked", 16, "tp", "prefix")


def test_record_site_resolutions_tiers_and_nesting():
    rows = {}
    for pkg, mods in PKGS.items():
        C = mods[3]
        with C.use_runtime_plan({"a.b": C.CollectiveRuntime("chunked", 2)}):
            with C.record_site_resolutions() as outer:
                C.runtime_for("a.b.c", "rs")
                with C.record_site_resolutions() as inner:
                    C.runtime_for("zz", "rs")
                C.runtime_for("a.b", None)
        rows[pkg] = [[(r.site, r.cls, r.strategy, r.num_chunks, r.matched_key, r.tier)
                      for r in log] for log in (outer, inner)]
    assert rows["port"] == rows["reference"]
    assert [(r[0], r[5]) for r in rows["port"][0]] == [("a.b.c", "prefix"),
                                                      ("a.b", "exact")]


def _scopes(pkg, tmp_path) -> list:
    """What ``runtime_for`` answers through activate, nested applied()
    scopes and an exception inside one."""
    C, X, A, COL = PKGS[pkg][0], PKGS[pkg][1], PKGS[pkg][2], PKGS[pkg][3]
    fsdp = X.tune(_wl(pkg), "a40-nvlink", method="lagom")
    tp = X.tune(_wl(pkg, kind="tp", tp=8), "a40-nvlink", method="lagom")
    nccl = X.tune(_wl(pkg, kind="tp", tp=8), "a40-nvlink", method="nccl")
    path = tmp_path / f"{pkg}-fsdp.json"
    fsdp.save(str(path))
    sites = [(f"tp.layer{i}.mlp.{leg}", leg) for i in range(2) for leg in ("ag", "rs")]

    def seen(tag):
        return (tag, [(*COL.resolve_runtime(s, c)[1:], COL.runtime_for(s, c).num_chunks,
                       COL.runtime_for(s, c).strategy) for s, c in sites])

    log = [seen("empty")]
    base = A.activate(str(path))
    log.append(seen("base"))
    with tp.applied() as rt:
        log.append(seen("tp"))
        assert COL.active_runtime_plan() == rt
        with nccl.applied():
            log.append(seen("nested nccl"))
        log.append(seen("tp again"))
        with pytest.raises(RuntimeError):
            with nccl.applied():
                raise RuntimeError("inside a scope")
        log.append(seen("tp after the exception"))
    log.append(seen("base again"))
    assert COL.active_runtime_plan() == base
    with pytest.warns(DeprecationWarning, match="set_runtime_plan"):
        COL.set_runtime_plan(tp.runtime_plan())
    log.append(seen("installed by the shim"))
    return log


def test_applied_scopes_nest_and_restore(tmp_path):
    ref, port = _scopes("reference", tmp_path), _scopes("port", tmp_path)
    assert port == ref
    by_tag = dict(port)
    assert by_tag["empty"][0] == ("", "default", 1, "xla")
    assert by_tag["base"][0][:2] == ("ag", "class")
    assert by_tag["tp"][0][:2] == ("tp.layer0.mlp", "prefix")
    assert by_tag["tp again"] == by_tag["tp after the exception"] == by_tag["tp"]
    assert by_tag["base again"] == by_tag["base"]
    assert by_tag["installed by the shim"] == by_tag["tp"]


def test_degraded_warning_dedupes_per_site():
    msgs = {}
    for pkg, mods in PKGS.items():
        C = mods[3]
        got = []
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            C.warn_degraded("acc.step0.rs_grads", "num_chunks=2 does not divide 5")
            C.warn_degraded("acc.step0.rs_grads", "num_chunks=2 does not divide 5")
            C._warn_unchunked("tp.layer0.mlp.ag", 4, "the 6-row shard")
            C.reset_degraded_warnings()
            C.warn_degraded("acc.step0.rs_grads", "num_chunks=2 does not divide 5")
        for w in rec:
            assert isinstance(w.message, C.CollectiveDegradedWarning)
            got.append((w.message.code, w.message.site, str(w.message)))
        msgs[pkg] = got
    assert msgs["port"] == msgs["reference"]
    assert [m[1] for m in msgs["port"]] == ["acc.step0.rs_grads", "tp.layer0.mlp.ag",
                                            "acc.step0.rs_grads"]
    assert all(m[0] == "LAG010" and "[LAG010]" in m[2] for m in msgs["port"])


# ---------------------------------------------------------------------------
# lint: the reference's hand-broken plans give the same findings
# ---------------------------------------------------------------------------

def _lag003_004(p, X):
    first = p.sites[0]
    dup = dict(first, group="dup-group")
    p.configs[("dup-group", dup["comm"])] = X.CommConfig(algorithm="ring",
                                                         chunk_kb=1 << 20)
    p.sites.append(dup)


def _lag010(p, X):
    row = next(s for s in p.sites if s["kind"] != "reducescatter")
    row["bytes"] = 1000003.0
    p.configs[(row["group"], row["comm"])] = X.CommConfig(algorithm="ring",
                                                          chunk_kb=256)


MUTATIONS = {
    "healthy": lambda p, X: None,
    "LAG001": lambda p, X: p.configs.__setitem__((999, 0), X.CommConfig()),
    "LAG002": lambda p, X: p.configs.pop(next(iter(p.configs))),
    "LAG003+LAG004": _lag003_004,
    "LAG010": _lag010,
    "LAG020": lambda p, X: p.sites[0].__setitem__("tier", "inter"),
    "LAG021": lambda p, X: setattr(p, "topology", {"fingerprint": "f" * 12,
                                                   "name": "two_pod",
                                                   "spec": {"pods": 2}}),
    "LAG031-structure": lambda p, X: setattr(p, "structure", ""),
    "LAG031-shape": lambda p, X: setattr(p, "shape", {"seq": 0, "global_batch": 16}),
    "LAG040-good": lambda p, X: setattr(p, "lineage", {"retuned_from": "abc",
                                                       "chain": ["abc"],
                                                       "generation": 1}),
    "LAG040-head": lambda p, X: setattr(p, "lineage", {"retuned_from": "b",
                                                       "chain": ["a"]}),
    "LAG040-empty": lambda p, X: setattr(p, "lineage", {"retuned_from": "b",
                                                        "chain": []}),
    "LAG040-orphan": lambda p, X: setattr(p, "lineage", {"retuned_from": None,
                                                         "chain": ["a"]}),
    "LAG040-type": lambda p, X: setattr(p, "lineage", {"chain": "not-a-list"}),
}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_lint_findings_match(mutation):
    got = {}
    for pkg, mods in PKGS.items():
        X, Lint = mods[1], mods[4]
        wl = _wl(pkg)
        plan = copy.deepcopy(X.tune(wl, "tpu-v5e", method="nccl"))
        MUTATIONS[mutation](plan, X)
        got[pkg] = [_findings(Lint.lint_plan(plan)),
                    _findings(Lint.lint_plan(plan, workload=wl)),
                    _findings(Lint.lint_plan(plan, workload=_wl(pkg, layers=4))),
                    _findings(Lint.lint_plan(plan, topology=X.two_pod("tpu-v5e", "dcn")))]
    assert got["port"] == got["reference"]
    codes = {f[0] for f in got["port"][0]}
    want = {c for c in mutation.split("-")[0].split("+") if c.startswith("LAG")}
    if mutation in ("healthy", "LAG040-good"):
        assert got["port"][0] == []
    else:
        assert want <= codes, (want, codes)


def test_lint_hand_edited_topology_matches():
    got = {}
    for pkg, mods in PKGS.items():
        X, Lint = mods[1], mods[4]
        wl = _wl(pkg, kind="fsdp", dp=8, pods=2, accum_steps=2)
        plan = X.tune(wl, topology=X.two_pod("tpu-v5e", "dcn"), method="nccl")
        edited = copy.deepcopy(plan)
        edited.topology["fingerprint"] = "deadbeef"
        got[pkg] = [_findings(Lint.lint_plan(p, select=["LAG030"])) for p in (plan, edited)]
    assert got["port"] == got["reference"]
    assert got["port"][0] == [] and "hand-edited" in got["port"][1][0][3]


@pytest.mark.parametrize("arch", JC.ALL_ARCHS)
def test_zoo_plans_lint_alike(arch):
    got = {}
    for pkg, mods in PKGS.items():
        X, Lint = mods[1], mods[4]
        got[pkg] = []
        for spec in (dict(kind="tp", tp=8), dict(kind="ep", ep=16),
                     dict(kind="fsdp", dp=8, pods=2, accum_steps=2, outer_frags=2)):
            wl = _wl(pkg, arch, **spec)
            plan = X.tune(wl, "a40-nvlink", method="lagom")
            got[pkg].append(_findings(Lint.lint_plan(plan, workload=wl)))
    assert got["port"] == got["reference"]


def test_rule_catalogs_match():
    ref, port = JL.rules(), TL.rules()
    assert [(c, r.severity, r.doc) for c, r in port.items()] == \
        [(c, r.severity, r.doc.replace("``repro.", "``repro_torch."))
         for c, r in ref.items()]


def test_lint_gates_refuse_alike(tmp_path):
    """``tune(lint="error")`` refuses a flat-tuned plan with inter-pod sites
    (LAG020) in both packages; ``PlanRepository.put(lint="error")`` refuses a
    plan with a dead entry (LAG001)."""
    msgs = []
    for pkg, mods in PKGS.items():
        X, Lint, R = mods[1], mods[4], mods[6]
        wl = _wl(pkg, kind="fsdp", dp=8, pods=2, accum_steps=2)
        with pytest.raises(Lint.PlanLintError, match="LAG020") as ei:
            X.tune(wl, "a40-nvlink", method="nccl", lint="error")
        msgs.append(str(ei.value))
        with pytest.warns(RuntimeWarning, match="LAG020"):
            X.tune(wl, "a40-nvlink", method="nccl", lint="warn")
        with pytest.raises(ValueError, match="lint="):
            X.tune(wl, "a40-nvlink", method="nccl", lint="bogus")
        healthy = X.tune(_wl(pkg), "a40-nvlink", method="nccl", lint="error")
        broken = copy.deepcopy(healthy)
        broken.configs[(999, 0)] = X.CommConfig()
        repo = R.PlanRepository(tmp_path / pkg)
        with pytest.raises(Lint.PlanLintError, match="LAG001") as ei:
            repo.put(broken, lint="error")
        msgs.append(str(ei.value))
        with pytest.raises(Lint.PlanLintError, match="LAG001"):
            Lint.check_plan(broken, label="unit plan")
        repo.put(healthy, lint="error")
    assert msgs[2:] == msgs[:2]


# ---------------------------------------------------------------------------
# the constants phase 6 of chip_smoke.py holds the port to
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(chip_smoke.PLAN_WORKLOADS))
def test_chip_smoke_plan_constants_are_the_reference(name):
    wl = J.extract_workload(JC.get_config(chip_smoke.PLAN_ARCH),
                            J.ParallelPlan(**chip_smoke.PLAN_WORKLOADS[name]),
                            seq=chip_smoke.PLAN_SEQ, global_batch=chip_smoke.PLAN_BATCH)
    plan = J.tune(wl, "a40-nvlink", method="lagom")
    got = chip_smoke.plan_fingerprint(plan, JA.plan_digest(plan.runtime_plan()))
    assert got == chip_smoke.REFERENCE_A40_PLANS[name]
