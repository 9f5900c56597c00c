"""The port's overlap verifier (``repro_torch.analysis``: ``ir``,
``overlap``, ``exercise`` and the CLI) against the reference's.

Tolerance: exact equality throughout.  The verdict cases are the
reference's own (``tests/test_analysis.py``), each graph built in both
packages from one description and judged by both ``verify()``s: verdicts
and details must be equal.  Plans cross between the packages as their
JSON files.  The exerciser runs over a fake world of 8 ranks
(``launch.mesh.fake_world``), which it makes and destroys itself; the
reference's own exerciser test judges by the jaxpr path and misses the
chunked psum, so the port's is held to that test's contract instead.
"""
import json
import warnings

import pytest

from repro.analysis import ir as JIR
from repro.analysis import exercise as JEX
from repro.analysis import overlap as JOV
from repro.core import session as JS
from repro.parallel import collectives as JC
from repro_torch.analysis import exercise as TEX
from repro_torch.analysis import ir as TIR
from repro_torch.analysis import overlap as TOV
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.configs import get_config
from repro_torch.core import ParallelPlan, extract_workload, tune
from repro_torch.core import session as TS
from repro_torch.core.comm_params import CommConfig
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.parallel import collectives as TC

PKGS = {"reference": (JIR, JOV, JC), "port": (TIR, TOV, TC)}
ZOO = {
    "llama3-8b/fsdp": ("llama3-8b", dict(kind="fsdp", dp=8), dict(layers=2)),
    "deepseek-moe-16b/ep": ("deepseek-moe-16b", dict(kind="ep", ep=8), dict(layers=3)),
    "yi-34b/pp": ("yi-34b", dict(kind="pp", pp=4, microbatches=4), dict()),
}


@pytest.fixture(autouse=True)
def _clean_plan_state():
    yield
    for _, _, C in PKGS.values():
        C.install_runtime_plan({})
        C.reset_degraded_warnings()


@pytest.fixture(scope="module")
def zoo_plans(tmp_path_factory):
    """Each zoo workload tuned by the port (``analysis_gate.py``'s), saved."""
    out = {}
    for name, (arch, spec, kw) in ZOO.items():
        wl = extract_workload(get_config(arch), ParallelPlan(**spec), seq=2048,
                              global_batch=16, **kw)
        path = tmp_path_factory.mktemp("zoo") / (name.replace("/", "_") + ".json")
        tune(wl, "tpu-v5e").save(str(path))
        out[name] = str(path)
    return out


# ---------------------------------------------------------------------------
# verify(): the reference's verdict cases, judged by both packages
# ---------------------------------------------------------------------------

def _graph(pkg, desc):
    """An OpGraph of ``pkg`` from ``(source, [(kind, raw)], [(trip, kinds,
    n_collectives, has_compute)])``."""
    ir = PKGS[pkg][0]
    source, colls, loops = desc
    return ir.OpGraph(source=source,
                      collectives=[ir.CollectiveOp(kind=k, raw=r) for k, r in colls],
                      loops=[ir.ChunkLoop(trip=t, kinds=ks, n_collectives=n,
                                          has_compute=c, depth=0) for t, ks, n, c in loops])


RS_LOOP4 = (4, ("reducescatter",), 1, True)
RS_LOOP2 = (2, ("reducescatter",), 1, True)
CASES = {
    # (plan {site: (strategy, nc)}, graph, rows [(site, cls, strategy, nc, tier)])
    "materialized": ({"tp.l0.rs": ("chunked", 4)},
                     ("hlo", [("reducescatter", "reduce-scatter")], [RS_LOOP4]),
                     [("tp.l0.rs", "rs", "chunked", 4, "exact")]),
    "degraded_monolithic": ({"tp.l0.rs": ("chunked", 4)},
                            ("hlo", [("reducescatter", "reduce-scatter")], []),
                            [("tp.l0.rs", "rs", "chunked", 4, "exact")]),
    "absent_no_collective": ({"tp.l0.rs": ("chunked", 4)}, ("hlo", [], []),
                             [("tp.l0.rs", "rs", "chunked", 4, "exact")]),
    "absent_plan_not_installed": ({"tp.l0.rs": ("chunked", 4)},
                                  ("jaxpr", [("reducescatter", "rs")], [RS_LOOP4]),
                                  [("tp.l0.rs", "rs", "xla", 1, "default")]),
    "nc1_and_untuned": ({"tp.l0.rs": ("chunked", 1)}, ("jaxpr", [], []),
                        [("tp.l0.rs", "rs", "chunked", 1, "exact"),
                         ("other.ar", "ar", "xla", 1, "default")]),
    "two_sites_one_loop": ({"a.rs": ("chunked", 2), "b.rs": ("chunked", 2)},
                           ("hlo", [("reducescatter", "rs")], [RS_LOOP2]),
                           [("a.rs", "rs", "chunked", 2, "exact"),
                            ("b.rs", "rs", "chunked", 2, "exact")]),
    "two_sites_two_loops": ({"a.rs": ("chunked", 2), "b.rs": ("chunked", 2)},
                            ("hlo", [("reducescatter", "rs")] * 2, [RS_LOOP2] * 2),
                            [("a.rs", "rs", "chunked", 2, "exact"),
                             ("b.rs", "rs", "chunked", 2, "exact")]),
    "ag_needs_the_ring": ({"tp.l0.ag": ("ring", 2)},
                          ("record", [], [(2, (), 0, True)]),
                          [("tp.l0.ag", "ag", "ring", 2, "exact")]),
    "ag_inside_the_ring": ({"tp.l0.ag": ("ring", 2)},
                           ("record", [("permute", "send/recv")], [(2, (), 0, True)]),
                           [("tp.l0.ag", "ag", "ring", 2, "exact")]),
    "unknown_class_any_loop": ({"zz.x": ("chunked", 2)},
                               ("record", [("alltoall", "a")], [(2, ("alltoall",), 1, False)]),
                               [("zz.x", "zz", "chunked", 2, "exact")]),
    "wild_trip": ({"acc.s0": ("chunked", 4)},
                  ("profile", [("allreduce", "AllReduce")], [(0, ("allreduce",), 1, False)]),
                  [("acc.s0", "acc", "chunked", 4, "exact")]),
}


def _judge(pkg, case):
    plan, desc, rows = CASES[case]
    _, ov, C = PKGS[pkg]
    rt = {s: C.CollectiveRuntime(st, nc) for s, (st, nc) in plan.items()}
    res = [C.SiteResolution(site=s, cls=c, strategy=st, num_chunks=nc, matched_key=s,
                            tier=t) for s, c, st, nc, t in rows]
    rep = ov.verify(rt, _graph(pkg, desc), res)
    return ([(v.site, v.cls, v.strategy, v.num_chunks, v.verdict, v.detail,
              v.resolution_tier) for v in rep.verdicts],
            rep.untuned, rep.unobserved, rep.ok(), rep.ok(allow_degraded=True))


@pytest.mark.parametrize("case", sorted(CASES))
def test_verdicts_match_the_reference(case):
    port = _judge("port", case)
    assert port == _judge("reference", case)
    assert port[0], "every case judges at least one site"


def test_verdict_cases_cover_every_verdict():
    seen = {v[4] for case in CASES for v in _judge("port", case)[0]}
    assert seen == set(TOV.VERDICTS)


def test_unobserved_plan_sites_are_not_false_positives(zoo_plans):
    path = zoo_plans["llama3-8b/fsdp"]
    got = {}
    for pkg, plan in (("reference", JS.TunedPlan.load(path)),
                      ("port", TS.TunedPlan.load(path))):
        rep = PKGS[pkg][1].verify(plan, PKGS[pkg][0].OpGraph(source="record"), [])
        got[pkg] = (rep.verdicts, rep.unobserved, rep.ok())
    assert got["port"] == got["reference"]
    assert got["port"][1] and got["port"][2]


# ---------------------------------------------------------------------------
# the exerciser: the reference's site specs, and every tuned site MATERIALIZED
# over a fake world of 8 ranks (ABSENT with the plan not installed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ZOO))
def test_site_specs_match_the_reference(zoo_plans, name):
    path = zoo_plans[name]
    port = TEX._site_specs(TS.TunedPlan.load(path))
    assert port == JEX._site_specs(JS.TunedPlan.load(path))
    assert any(nc > 1 for _, _, nc in port)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_exercise_plan_materializes_and_control_is_absent(zoo_plans, name):
    plan = TS.TunedPlan.load(zoo_plans[name])
    rep = TEX.exercise_plan(plan)
    assert rep.verdicts and rep.ok(), rep.format()
    assert {v.site for v in rep.verdicts} == {s for s, _, _ in TEX._site_specs(plan)}
    assert all(v.verdict == "MATERIALIZED" for v in rep.verdicts), rep.format()
    off = TEX.exercise_plan(plan, install=False)
    assert off.verdicts and all(v.verdict == "ABSENT" for v in off.verdicts), off.format()


def test_exercise_plan_judges_the_chunked_psum():
    """The allreduce site class (``psum_tree_chunked``), which the reference's
    jaxpr path misses: a two-pod ACCO plan's ``acc.step{k}.ar_grads`` and
    Streaming-DiLoCo ``outer.round{r}.sync.frag{f}`` sites (``acc`` and
    ``outer`` classes), one of them at an odd chunk count."""
    from repro_torch.core.topology import two_pod

    wl = extract_workload(get_config("llama3-8b"),
                          ParallelPlan(kind="fsdp", dp=8, pods=2, accum_steps=2,
                                       outer_frags=2),
                          seq=2048, global_batch=64, layers=2)
    plan = tune(wl, topology=two_pod("tpu-v5e", "dcn"))
    specs = TEX._site_specs(plan)
    assert {TC.site_class(s) for s, kind, nc in specs
            if kind == "allreduce" and nc > 1} == {"acc", "outer"}
    rep = TEX.exercise_plan(plan)
    assert rep.ok() and len(rep.materialized) == len(specs), rep.format()
    assert {v.cls for v in rep.verdicts} >= {"acc", "outer"}


def test_exercise_plan_refuses_over_an_existing_group():
    with fake_world(2):
        with pytest.raises(RuntimeError, match="default process group exists"):
            TEX.exercise_plan(object())


# ---------------------------------------------------------------------------
# trace_and_verify on a real run (the fake world)
# ---------------------------------------------------------------------------

def _mm_rs_program(mesh, T):
    import torch

    def fn():
        return TC.mm_reduce_scatter(torch.ones(T, 4), torch.ones(4, 8), mesh,
                                    site="tp.layer0.mlp.rs")
    return fn


def test_trace_and_verify_roundtrip_and_no_install_control():
    plan = {"tp.layer0.mlp.rs": TC.CollectiveRuntime("chunked", 4)}
    with fake_world(8):
        mesh = make_mesh()
        rep = TOV.trace_and_verify(plan, _mm_rs_program(mesh, 32))
        off = TOV.trace_and_verify(plan, _mm_rs_program(mesh, 32), install=False)
    assert rep.verdict_for("tp.layer0.mlp.rs") == "MATERIALIZED"
    assert off.verdict_for("tp.layer0.mlp.rs") == "ABSENT"


def test_indivisible_payload_is_degraded():
    plan = {"tp.layer0.mlp.rs": TC.CollectiveRuntime("chunked", 4)}
    with fake_world(8), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = TOV.trace_and_verify(plan, _mm_rs_program(make_mesh(), 40))
    v = rep.verdicts[0]
    assert v.verdict == "DEGRADED" and "monolithic fallback" in v.detail, rep.format()
    assert any(isinstance(w.message, TC.CollectiveDegradedWarning) for w in caught)


def test_record_loops_and_bytes_of_one_ring():
    """The ring all-gather matmul at 8 ranks and 2 chunks: a compute-only
    loop of trip 2, 7 hops of (2, 4) fp32 as permutes, and the backward's
    loop (chunked reduce-scatter of dx plus the weight gradient's ring)."""
    import torch

    with fake_world(8):
        mesh = make_mesh()
        x = torch.ones(2, 4, requires_grad=True)
        w = torch.ones(4, 3, requires_grad=True)
        with TIR.capture() as cap:
            TC.ring_ag_matmul(x, w, mesh, num_chunks=2, site="tp.ag").sum().backward()
    g = TIR.graph_from_record(cap)
    fwd, bwd = g.loops
    assert (fwd.trip, fwd.kinds, fwd.has_compute, fwd.source) == (2, (), True,
                                                                  "ring_ag_matmul")
    assert (bwd.trip, bwd.kinds, bwd.source) == (2, ("permute", "reducescatter"),
                                                 "ring_ag_matmul.bwd")
    assert g.count("permute") == 14 and g.count("reducescatter") == 2
    out = TIR.collective_bytes(cap)
    assert out["collective-permute"] == 14 * 2 * 4 * 4
    assert out["reduce-scatter"] == 2 * 1 * 4 * 4           # each chunk's (1, 4) tile
    assert out["count"] == 16


def test_record_disagreeing_with_the_issued_row_raises():
    cap = TIR.Capture()
    call = TIR.Call("mm_reduce_scatter", "s", events=[
        ("mm", "mm"), ("coll", "reducescatter", "_reduce_scatter_base_", 8.0)],
        issued=TC.Issued("s", "mm_reduce_scatter", 2, 2, 2))
    cap.events.append(("call", call))
    with pytest.raises(ValueError, match="1 chunk"):
        TIR.graph_from_record(cap)


# ---------------------------------------------------------------------------
# the profile: a chrome trace the test writes
# ---------------------------------------------------------------------------

def _trace():
    """One ``mm_reduce_scatter`` call of 2 chunks at one rank (NCCL runs a
    copy inside each ``nccl:`` range, under the next chunk's GEMM, whose
    launch the first range, open until its copy is done, holds), an
    ``all_to_all`` call of 2 chunks at 4 ranks (a ``SendRecv`` kernel each,
    launched outside a range) and a psum of 2 in-place all-reduces that run
    nothing on the card, and so are no collectives of the profile."""
    ev, corr = [], [0]

    def span(name, ts, dur, tid=1):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                   "dur": dur, "tid": tid, "pid": 1})

    def launch(ts, kname, kts, kdur, cat="kernel", stream=7):
        corr[0] += 1
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                   "dur": 1, "tid": 1, "pid": 1, "args": {"correlation": corr[0]}})
        ev.append({"ph": "X", "cat": cat, "name": kname, "ts": kts, "dur": kdur, "tid": stream,
                   "pid": 0, "args": {"correlation": corr[0], "stream": stream}})

    span("repro_torch/mm_reduce_scatter@tp.layer0.mlp.rs", 0, 100)
    launch(1, "sm90_xmma_gemm_f32", 10, 20)
    span("nccl:_reduce_scatter_base", 5, 9)     # open until its work is done,
    launch(6, "Memcpy DtoD (Device -> Device)", 30, 10, cat="gpu_memcpy", stream=16)
    launch(12, "sm90_xmma_gemm_f32", 31, 20)      # over the next product's launch
    span("nccl:_reduce_scatter_base", 14, 5)
    launch(15, "Memcpy DtoD (Device -> Device)", 60, 10, cat="gpu_memcpy", stream=16)
    span("repro_torch/all_to_all@ep.layer0.moe.a2a_disp", 200, 50)
    launch(201, "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", 210, 8, stream=16)
    launch(202, "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", 220, 8, stream=16)
    span("repro_torch/psum@acc.step0.rs_grads", 300, 50)
    span("nccl:all_reduce", 301, 5)
    span("nccl:all_reduce", 310, 5)
    return {"traceEvents": ev}


def test_graph_from_profile_of_a_trace_fixture(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace()))
    g = TIR.graph_from_profile(str(path))
    rs, a2a, psum = g.loops
    assert (rs.trip, rs.kinds, rs.has_compute) == (2, ("reducescatter",), True)
    assert (a2a.trip, a2a.kinds, a2a.has_compute) == (2, ("alltoall",), False)
    assert (psum.trip, psum.kinds, psum.n_collectives) == (0, (), 0)
    plan = {"tp.layer0.mlp.rs": TC.CollectiveRuntime("chunked", 2),
            "ep.layer0.moe.a2a_disp": TC.CollectiveRuntime("chunked", 2),
            "acc.step0.rs_grads": TC.CollectiveRuntime("chunked", 2)}
    rows = [TC.SiteResolution(s, c, "chunked", 2, s, "exact") for s, c in (
        ("tp.layer0.mlp.rs", "rs"), ("ep.layer0.moe.a2a_disp", "a2a"),
        ("acc.step0.rs_grads", "acc"))]
    rep = TOV.verify_profile(plan, str(path), rows)
    verdicts = {v.site: v.verdict for v in rep.verdicts}
    assert rep.source == "profile" and verdicts == {
        "tp.layer0.mlp.rs": "MATERIALIZED", "ep.layer0.moe.a2a_disp": "MATERIALIZED",
        "acc.step0.rs_grads": "ABSENT"}, rep.format()
    over = {r["op"]: r for r in TIR.nccl_overlap(str(path))}
    # the first copy (30-40) runs under the second GEMM (31-51); the second
    # (60-70) under nothing
    assert over["mm_reduce_scatter"]["nccl_ms"] == pytest.approx(0.020)
    assert over["mm_reduce_scatter"]["under_compute_ms"] == pytest.approx(0.009)
    assert over["all_to_all"]["nccl_ms"] == pytest.approx(0.016)
    assert "psum" not in over


def test_graph_from_profile_refuses_a_trace_without_device_activity():
    """Launches with none of the card's events (the profiler lost them)."""
    trace = _trace()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e["cat"] not in ("kernel", "gpu_memcpy")]
    with pytest.raises(ValueError, match="no device activity"):
        TIR.graph_from_profile(trace)


# ---------------------------------------------------------------------------
# the CLI: exit codes and --expect
# ---------------------------------------------------------------------------

def _broken(path, out):
    plan = TS.TunedPlan.load(path)
    plan.configs[(999, 0)] = CommConfig()             # one LAG001 ERROR
    plan.save(str(out))
    return str(out)


def test_cli_exit_codes(zoo_plans, tmp_path, capsys):
    good = zoo_plans["llama3-8b/fsdp"]
    assert analysis_main(["lint", good]) == 0
    assert analysis_main(["verify-overlap", good, zoo_plans["yi-34b/pp"]]) == 0
    out = capsys.readouterr().out
    assert f"overlap[{good}]" in out and "MATERIALIZED" in out
    broken = _broken(good, tmp_path / "broken.json")
    assert analysis_main(["lint", broken]) == 1
    assert analysis_main(["lint", broken, "--expect", "LAG001"]) == 0
    assert analysis_main(["lint", broken, "--expect", "LAG001,LAG002"]) == 1
    mangled = tmp_path / "mangled.json"
    mangled.write_text("{this is not a plan")
    for cmd in ("lint", "verify-overlap"):
        assert analysis_main([cmd, str(mangled)]) == 2
    assert "not a readable TunedPlan artifact" in capsys.readouterr().err


def test_cli_verify_overlap_exits_1_on_an_absent_site(zoo_plans, monkeypatch, capsys):
    """A site the run never hands its knobs (the plan shadowed by an empty
    scope inside the program) is ABSENT: exit 1."""
    real = TEX._exercise_one

    def shadowed(*a, **kw):
        with TC.use_runtime_plan({}):
            return real(*a, **kw)

    monkeypatch.setattr(TEX, "_exercise_one", shadowed)
    assert analysis_main(["verify-overlap", zoo_plans["deepseek-moe-16b/ep"]]) == 1
    assert "ABSENT" in capsys.readouterr().out
