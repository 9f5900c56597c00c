"""The port's own copies of the framework-free core and of the configs
(``repro_torch.core``, ``repro_torch.configs``) against the reference
(``repro.core``, ``repro.configs``) on the same inputs.

Tolerance: exact equality throughout.  The copies are the same numpy
code on the same inputs, so workloads compare as dataclasses, and plans
compare as the bytes of ``TunedPlan.to_json()`` (traces included).
Workloads are cut to a few layers (``layers=``), as the reference's
noise tests cut them, so that the whole zoo tunes in seconds.
"""
import dataclasses
import doctest
import importlib
import warnings

import pytest

from repro import configs as JC
from repro import core as J
from repro.core import contention as JCT
from repro.core import session as JS
from repro.parallel import collectives as JCOL
from repro_torch import configs as TC
from repro_torch import core as T
from repro_torch.core import contention as TCT
from repro_torch.core import session as TS
from repro_torch.parallel import collectives as TCOL

ARCHS = JC.ALL_ARCHS
# parallel plans: the four kinds of ``parse_parallel``, one ACCO case
# (gradient accumulation) and one two-pod Streaming-DiLoCo case
KINDS = {
    "fsdp:8": dict(kind="fsdp", dp=8),
    "tp:8": dict(kind="tp", tp=8),
    "ep:16": dict(kind="ep", ep=16),
    "pp:4:8": dict(kind="pp", pp=4, microbatches=8),
    "fsdp:8+acc4": dict(kind="fsdp", dp=8, accum_steps=4),
    "fsdp:8+pods2": dict(kind="fsdp", dp=8, pods=2, accum_steps=2, outer_frags=2),
}
METHODS = ("lagom", "autoccl", "nccl")
HARDWARE = ("a40-pcie", "a40-nvlink", "tpu-v5e")
SEQ, BATCH = 2048, 16


@pytest.fixture(autouse=True)
def _clean_plan_state():
    yield
    JCOL.install_runtime_plan({})
    TCOL.install_runtime_plan({})


def _layers(cfg) -> int:
    """Two layers, or two past the dense prefix of a MoE model."""
    return max(2, cfg.first_dense_layers + 2) if cfg.is_moe else 2


def workloads(arch: str, kind: str, decode: bool = False):
    """The same workload extracted by the reference and by the port."""
    out = []
    for C, X in ((JC, J), (TC, T)):
        cfg = C.get_config(arch)
        plan = X.ParallelPlan(**KINDS[kind])
        if decode:
            out.append(X.extract_decode_workload(cfg, plan, global_batch=BATCH,
                                                 seq=SEQ))
        else:
            out.append(X.extract_workload(cfg, plan, seq=SEQ, global_batch=BATCH,
                                          layers=_layers(cfg)))
    return out


def outcome(fn):
    """What a call gives: its plan's JSON, or the exception it raised."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return ("ok", fn().to_json())
    except Exception as e:  # noqa: BLE001 - the exception is the outcome
        return ("raised", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_and_shapes_match_the_reference():
    assert TC.ALL_ARCHS == JC.ALL_ARCHS and len(TC.ALL_ARCHS) == 15
    assert TC.ASSIGNED_ARCHS == JC.ASSIGNED_ARCHS
    assert TC.PAPER_ARCHS == JC.PAPER_ARCHS
    assert ({k: dataclasses.asdict(v) for k, v in TC.INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in JC.INPUT_SHAPES.items()})
    for arch in ARCHS:
        for name in JC.INPUT_SHAPES:
            assert (TC.shape_applicable(TC.get_config(arch), TC.INPUT_SHAPES[name])
                    == JC.shape_applicable(JC.get_config(arch), JC.INPUT_SHAPES[name]))


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_workloads_match(arch, kind):
    for decode in (False, True):
        jwl, twl = workloads(arch, kind, decode=decode)
        assert dataclasses.asdict(twl) == dataclasses.asdict(jwl)
        assert TS.workload_fingerprint(twl) == JS.workload_fingerprint(jwl)
        assert TS.structure_fingerprint(twl) == JS.structure_fingerprint(jwl)
        assert T.workload.comm_site_meta(twl) == J.workload.comm_site_meta(jwl)
        assert TS.workload_shape(twl) == JS.workload_shape(jwl)


def test_parse_parallel_matches():
    for spec in ("fsdp:8", "tp:4", "ep:16", "pp:4:8", "tp"):
        assert (dataclasses.asdict(T.parse_parallel(spec))
                == dataclasses.asdict(J.parse_parallel(spec)))
    for P in (J.parse_parallel, T.parse_parallel):
        with pytest.raises(ValueError, match="unknown parallel kind"):
            P("dp:8")


# ---------------------------------------------------------------------------
# tuning: every method, mode, hardware profile and noise mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_tune_matches(arch, kind):
    """Every method under every schedule mode, noiseless on a40-nvlink; a
    mode the simulator cannot run (none here) must raise alike."""
    jwl, twl = workloads(arch, kind)
    for method in METHODS:
        for mode in J.session.MODES:
            want = outcome(lambda: J.tune(jwl, "a40-nvlink", method=method, mode=mode))
            got = outcome(lambda: T.tune(twl, "a40-nvlink", method=method, mode=mode))
            assert want[0] == "ok", want
            assert got == want, (method, mode)


@pytest.mark.parametrize("noise_mode", ["default", "crn"])
@pytest.mark.parametrize("hw", HARDWARE)
def test_tune_noisy_matches_on_every_profile(hw, noise_mode):
    """Lagom and AutoCCL with 1 % noise on the reference's three profiles,
    every architecture, the kinds taken in turn; ``mode="shared"`` under
    default noise is refused, and must be refused alike."""
    assert noise_mode in J.noise.NOISE_MODES
    kinds = list(KINDS)
    for i, arch in enumerate(ARCHS):
        jwl, twl = workloads(arch, kinds[i % len(kinds)])
        for method, mode in (("lagom", "interleaved"), ("autoccl", "serial"),
                             ("lagom", "shared")):
            kw = dict(method=method, mode=mode, noise=0.01, noise_mode=noise_mode,
                      seed=3)
            want = outcome(lambda: J.tune(jwl, hw, **kw))
            got = outcome(lambda: T.tune(twl, hw, **kw))
            assert got == want, (arch, method, mode)
            assert want[0] == ("raised" if (mode, noise_mode) == ("shared", "default")
                               else "ok"), want


def _fsdp_smoke():
    """The fault tests' workload: smoke llama3-8b under fsdp:8."""
    return [X.extract_workload(C.get_smoke_config("llama3-8b"),
                               X.ParallelPlan(kind="fsdp", dp=8), seq=64,
                               global_batch=4)
            for C, X in ((JC, J), (TC, T))]


def _two_pod_acc():
    """The topology tests' workload: llama3-8b, fsdp:8 on two pods, ACCO."""
    return [X.extract_workload(C.get_config("llama3-8b"),
                               X.ParallelPlan(kind="fsdp", dp=8, pods=2, accum_steps=2),
                               seq=SEQ, global_batch=BATCH, layers=2)
            for C, X in ((JC, J), (TC, T))]


# the specs of the reference's fault and topology tests; a topology is
# given as two_pod's (island, fabric) and built in each package
FAULT_SPECS = ["degrade,scale=0.5", "straggler,scale=2.0", "seed=1;jitter,sigma=0.3", ""]
ENSEMBLE = ["degrade,scale=0.25", "straggler,scale=1.5"]
ROBUST_CASES = {
    "faults": [dict(hardware="tpu-v5e", method=m, faults=s)
               for s in FAULT_SPECS for m in METHODS],
    "fault_ensemble": [dict(hardware="tpu-v5e", method=m, fault_ensemble=ENSEMBLE)
                       for m in ("nccl", "lagom")],
    "topology": [dict(topology=("tpu-v5e", "dcn"), method="lagom"),
                 dict(topology=("a40-nvlink", "wan"), method="nccl")],
}


@pytest.mark.parametrize("case", list(ROBUST_CASES))
def test_tune_under_faults_and_topology_matches(case):
    wls = _two_pod_acc() if case == "topology" else _fsdp_smoke()
    for kw in ROBUST_CASES[case]:
        runs = []
        for X, wl in zip((J, T), wls):
            args = dict(kw)
            if "topology" in args:
                args["topology"] = X.two_pod(*args["topology"])
            runs.append(outcome(lambda: X.tune(wl, **args)))
        assert runs[0][0] == "ok" and runs[1] == runs[0], kw


def _degraded_costs(X, CT, plan, wl, sites, scale):
    """The retune tests' telemetry: observed costs of ``sites`` on a fabric
    at ``scale`` bandwidth under the plan's configs."""
    deg = X.faults.degraded_hardware(X.by_name("tpu-v5e"), scale)
    return {op.site_id: CT.comm_time(op, plan.configs[(gi, ci)], deg,
                                     compute_active=False)
            for gi, g in enumerate(wl.groups) for ci, op in enumerate(g.comms)
            if op.site_id in sites}


def test_retune_matches():
    outs = []
    for C, X, CT in ((JC, J, JCT), (TC, T, TCT)):
        wl = X.extract_decode_workload(C.get_smoke_config("llama3-8b"),
                                       X.ParallelPlan(kind="tp", tp=2),
                                       global_batch=32, seq=128)
        parent = X.tune(wl, "tpu-v5e", method="lagom")
        sites = sorted(op.site_id for g in wl.groups[:2] for op in g.comms)
        observed = _degraded_costs(X, CT, parent, wl, sites, 0.1)
        child = X.retune(parent, wl, sites=sites, telemetry=observed)
        grand = X.retune(child, wl, sites=sites[:1],
                         telemetry=_degraded_costs(X, CT, child, wl, sites, 0.05))
        outs.append([p.to_json() for p in (parent, child, grand)])
        assert child.lineage["retuned_from"] == parent.artifact_digest()
    assert outs[1] == outs[0]


def test_unknown_names_raise_alike():
    """No silent fallback: an unknown profile or method raises the
    reference's KeyError (the port's list of profiles adds h100-sxm)."""
    jwl, twl = _fsdp_smoke()
    for kw in (dict(hardware="h200"), dict(hardware="a40-nvlink", method="bogus")):
        want, got = outcome(lambda: J.tune(jwl, **kw)), outcome(lambda: T.tune(twl, **kw))
        assert want[:2] == got[:2] == ("raised", "KeyError")
        assert got[2].replace("'h100-sxm', ", "") == want[2]


# ---------------------------------------------------------------------------
# the port's deployment target
# ---------------------------------------------------------------------------

def test_h100_sxm_profile():
    hw = T.by_name("h100-sxm")
    assert hw is T.H100_SXM and T.PROFILES["h100-sxm"] is hw
    assert (hw.peak_flops, hw.hbm_bw, hw.num_slots, hw.cache_kb) == (
        989.4e12, 3.35e12, 132, 51200)
    assert 0 < hw.gemm_eff <= 1
    assert T.Hardware.from_json(hw.to_json()) == hw
    # the reference's three profiles are the port's, field for field
    for name in J.profiles():
        assert T.by_name(name).to_dict() == J.by_name(name).to_dict()
    assert T.profiles() == sorted(J.profiles() + ["h100-sxm"])
    twl = workloads("llama3-8b", "tp:8")[1]
    plan = T.tune(twl, "h100-sxm", lint="error")
    assert plan.hardware == "h100-sxm" and plan.runtime_plan()


# ---------------------------------------------------------------------------
# the port's own doctests (they name repro_torch)
# ---------------------------------------------------------------------------

DOCTEST_MODULES = ["repro_torch.core.session", "repro_torch.core.plan_repo",
                   "repro_torch.core.retune"]


@pytest.mark.parametrize("modname", DOCTEST_MODULES)
def test_module_doctests(modname):
    """The port's copies carry the reference's examples, naming the port."""
    mod = importlib.import_module(modname)
    ref = importlib.import_module(modname.replace("repro_torch.", "repro."))
    examples = [e.source for t in doctest.DocTestFinder().find(mod) for e in t.examples]
    assert len(examples) == sum(len(t.examples)
                                for t in doctest.DocTestFinder().find(ref))
    assert not any("repro." in src for src in examples)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # tune() may warn benignly
        result = doctest.testmod(mod, verbose=False, optionflags=doctest.ELLIPSIS)
    assert result.attempted == len(examples)
    assert result.failed == 0, f"{modname}: {result.failed} doctest failures"
