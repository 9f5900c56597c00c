"""The fault-aware plan lifecycle and the online re-tune loop of the port
against the reference's, on smoke ``llama3-8b`` in fp32 on the CPU with the
reference's weights converted: on the same fault schedule, the engines'
``health_events`` (less the measured ``step_s``), the demoted sites, the
health report and ``retune_service.report()`` must equal the reference's,
and the tokens too; a demotion whose apply fails rolls back alike; and
``python -m repro_torch.launch.serve`` prints the reference CLI's plan,
health and re-tune lines.

Tolerance: exact equality.
"""
import doctest
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import core as J  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import collectives as JC  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import make_engine as jmake_engine  # noqa: E402
from repro.serving.plans import PlanBinding as JBinding  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.serving import Request, make_engine  # noqa: E402
from repro_torch.serving.plans import PlanBinding  # noqa: E402

ARCH = "llama3-8b"
CFG = get_smoke_config(ARCH)
BATCH, MAX_SEQ = 8, 64
DEGRADE_AT_2 = "degrade,site=serve,scale=0.1,start=2"
DEGRADE_L0_AT_2 = "degrade,site=serve.layer0,scale=0.1,start=2"


@pytest.fixture(autouse=True)
def _clean_plan_state():
    yield
    for pkg in (C, JC):
        pkg.install_runtime_plan({})
        pkg.reset_degraded_warnings()


@pytest.fixture(scope="module")
def pair():
    jcfg = jget_smoke(ARCH)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
    model = M.init_params(CFG, 0, device="cpu")
    model.load_state_dict(params_from_jax(CFG, jax.tree.map(np.asarray, jp)))
    return jcfg, jp, model


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """Decode plans tuned by the reference (tp:2, batch 8, seq 64) and saved:
    both packages load the same JSON file."""
    tmp = tmp_path_factory.mktemp("plans")
    wl = J.extract_decode_workload(jget_smoke(ARCH), J.ParallelPlan(kind="tp", tp=2),
                                   global_batch=BATCH, seq=MAX_SEQ)
    out = {}
    for method in ("nccl", "lagom"):
        out[method] = str(tmp / f"{method}.json")
        J.tune(wl, "tpu-v5e", method=method).save(out[method])
    return out


def _prompts(n, size=8):
    rs = np.random.default_rng(0)
    return [rs.integers(0, CFG.vocab_size, size=size).astype(np.int32) for _ in range(n)]


def _events(eng):
    return [{k: v for k, v in e.items() if k != "step_s"} for e in eng.health_events]


def _fixed(pair, max_new=8, **kw):
    """(port engine, reference engine), each having served one batch."""
    jcfg, jp, model = pair
    engs = (make_engine(CFG, model, mode="fixed", batch_size=BATCH, max_seq=MAX_SEQ, **kw),
            jmake_engine(jcfg, jp, mode="fixed", batch_size=BATCH, max_seq=MAX_SEQ, **kw))
    outs = [e.generate(_prompts(BATCH), max_new=max_new) for e in engs]
    assert outs[0] == outs[1]
    assert all(len(o) == max_new for o in outs[0])   # generation completed
    return engs


def _continuous(pair, **kw):
    jcfg, jp, model = pair
    engs = (make_engine(CFG, model, mode="continuous", slots=BATCH, max_seq=MAX_SEQ, **kw),
            jmake_engine(jcfg, jp, mode="continuous", slots=BATCH, max_seq=MAX_SEQ, **kw))
    outs = []
    for eng, req in zip(engs, (Request, JRequest)):
        for i, p in enumerate(_prompts(BATCH)):
            eng.submit(req(rid=i, prompt=p, max_new=8))
        outs.append({r.rid: r.out for r in eng.run()})
    assert outs[0] == outs[1] and len(outs[0]) == BATCH
    return engs


def _same_lifecycle(port, ref):
    assert _events(port) == _events(ref)
    assert port._binding.demoted == ref._binding.demoted
    assert port.health_report() == ref.health_report()
    if ref.retune_service is not None:
        assert port.retune_service.report() == ref.retune_service.report()


# ---------------------------------------------------------------------------
# drift -> demotion
# ---------------------------------------------------------------------------

def test_fixed_engine_detects_and_demotes_mid_generate(pair, plans):
    port, ref = _fixed(pair, plan=plans["nccl"], fault_schedule=DEGRADE_AT_2,
                       health_window=2, health_tolerance=0.25)
    _same_lifecycle(port, ref)
    drift = next(e for e in port.health_events if e["event"] == "drift")
    assert drift["batch"] == 3      # fault at batch 2; window 2 flags on the second
    demo = next(e for e in port.health_events if e["event"] == "demotion")
    assert not demo["rolled_back"] and demo["sites"]
    rt = port._binding.current
    for sid in demo["sites"]:
        assert rt[sid] == C.CollectiveRuntime()
        with port._binding.scope(rt):
            got, src = C.explain_runtime(sid, C.site_class(sid))
            assert src == sid and got.strategy == "xla"
    assert len(port._fns) == len(ref._fns) == 2     # one step per plan digest
    assert "demoted" in port.health_report()


def test_continuous_engine_demotes_between_ticks(pair, plans):
    port, ref = _continuous(pair, plan=plans["nccl"], fault_schedule=DEGRADE_AT_2,
                            health_window=2, health_tolerance=0.25)
    _same_lifecycle(port, ref)
    assert port._binding.demoted


def test_engine_without_schedule_reports_healthy(pair):
    port, ref = _fixed(pair, max_new=4)
    _same_lifecycle(port, ref)
    assert port.health_events == []
    assert "no drift detected" in port.health_report()


def test_demotion_rolls_back_when_apply_fails(plans):
    bindings = (PlanBinding(CFG, plan=plans["nccl"]),
                JBinding(jget_smoke(ARCH), plan=plans["nccl"]))
    logs = []
    for b, pkg in zip(bindings, (C, JC)):
        before = dict(b.current)
        sid = sorted(s for s in before if s.startswith("serve.layer0"))[0]

        def bad_apply(rt):
            raise RuntimeError("apply boom")

        with pytest.raises(RuntimeError, match="apply boom"):
            b.demote([sid], apply=bad_apply)
        assert b.current == before and sid not in b.demoted
        seen = []
        b.demote([sid], apply=seen.append)
        assert seen[0][sid] == pkg.CollectiveRuntime() and sid in b.demoted
        logs.append(b.events)
    assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
# drift -> online re-tune (demotion when the service declines)
# ---------------------------------------------------------------------------

def test_fixed_engine_retunes_mid_generate(pair, plans):
    port, ref = _fixed(pair, plan=plans["lagom"], plan_parallel="tp:2",
                       fault_schedule=DEGRADE_L0_AT_2, health_window=2,
                       health_tolerance=0.25, retune=True)
    _same_lifecycle(port, ref)
    kinds = [e["event"] for e in port.health_events]
    assert "retune" in kinds and "demotion" not in kinds
    ev = next(e for e in port.health_events if e["event"] == "retune")
    assert ev["batch"] == 4 and ev["generation"] == 1
    assert port._binding._plan.lineage["retuned_from"] == ref._binding._plan.lineage[
        "retuned_from"]


def test_continuous_engine_retunes_between_ticks(pair, plans):
    port, ref = _continuous(pair, plan=plans["lagom"], plan_parallel="tp:2",
                            fault_schedule=DEGRADE_L0_AT_2, health_window=2,
                            health_tolerance=0.25, retune=True)
    _same_lifecycle(port, ref)
    assert port.retune_service.retunes == 1
    assert len(port.telemetry) == len(ref.telemetry) > 0


def test_engine_demotes_when_budget_spent(pair, plans):
    """A declining service (its one re-tune spent) hands the later drift of
    layer 1 back to demotion, in both packages."""
    port, ref = _fixed(pair, max_new=12, plan=plans["lagom"], plan_parallel="tp:2",
                       fault_schedule=f"{DEGRADE_L0_AT_2};degrade,site=serve.layer1,"
                                      "scale=0.1,start=8",
                       health_window=2, health_tolerance=0.25,
                       retune=dict(max_retunes=1))
    _same_lifecycle(port, ref)
    kinds = [e["event"] for e in port.health_events]
    assert {"retune", "retune_skipped", "demotion"} <= set(kinds)
    assert any(s.startswith("serve.layer1") for s in port._binding.demoted)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_prints_the_reference_lines(tmp_path, capsys):
    """The command of the verify notes (tp:2): the plan, health and re-tune
    lines equal the reference CLI's; the token lines differ (each package
    draws its own random weights)."""
    wl = J.extract_decode_workload(jget_smoke(ARCH), J.ParallelPlan(kind="tp", tp=2),
                                   global_batch=32, seq=128)
    path = str(tmp_path / "plan.json")
    J.tune(wl, "tpu-v5e", method="lagom").save(path)
    argv = ["--arch", ARCH, "--smoke", "--batch", "32", "--prompt-len", "8",
            "--max-new", "8", "--max-seq", "128", "--tuned-plan", path,
            "--plan-parallel", "tp:2",
            "--fault-schedule", DEGRADE_L0_AT_2, "--health-window", "2",
            "--retune", "--retune-max", "2"]
    outs = []
    for main, extra in ((serve.main, ["--device", "cpu"]), (jserve.main, [])):
        main(argv + extra)
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if not ln.startswith(("request ", "decode throughput"))])
    assert outs[0] == outs[1]
    assert outs[0][0].startswith(f"tuned plan {path}: lagom/")
    assert outs[0][1] == "health: 8 batches, 0 site(s) demoted"
    assert outs[0][2].startswith("retune: 1 re-tune(s)")


@pytest.mark.parametrize("modname", ["repro_torch.serving.plans", "repro_torch.serving.health",
                                     "repro_torch.serving.telemetry"])
def test_copied_doctests_run(modname):
    """The examples the copies carry from the reference run on the port."""
    result = doctest.testmod(importlib.import_module(modname), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0
