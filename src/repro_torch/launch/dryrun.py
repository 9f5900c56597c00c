"""Dry run of the port on the production meshes, with no devices
(counterpart of ``repro.launch.dryrun``): run one train step, prefill or
decode step of every (architecture × input shape), placed on the
reference's production mesh, and record its parameters, its operations,
its peak memory and its collective bytes by op kind.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Outputs one JSON per combination under experiments/dryrun_torch/.

Where the reference lowers and compiles against 512 host devices, the
port runs the program eagerly on fake tensors (``FakeTensorMode``: shapes,
dtypes and autograd, no data) over a fake world of 256 or 512 ranks
(``launch.mesh.fake_world``), in one process that is rank 0 of the
production mesh: the program is SPMD, so one rank's issue is every
rank's.  What it records:

* ``params``: the model's parameters (``specs.param_specs_shapes``), the
  reference's ``eval_shape`` count; ``params_rank``: the rank's share of
  them once placed;
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  rank's aten ops, plus each kernel's own work (``kernels.work``, the
  formulas behind ``PERF.md``'s bounds), which no aten op shows: under fake
  tensors a kernel's call returns empty outputs (``kernels.ops``);
* ``memory``: the rank's peak bytes, by ``MemTracker`` in fake mode, under
  the reference's keys (``argument_bytes``: the step's inputs; ``temp_bytes``:
  the peak above them);
* ``collectives``: the payload bytes of every collective the rank issued
  (``analysis.ir.collective_bytes``), under the reference's HLO opcodes;
* ``trace_s``: seconds the run took, in place of ``lower_s`` / ``compile_s``.

The fake tensors lie on the CPU, whatever torch was built with: a torch
without CUDA cannot run autograd over fake CUDA tensors (its device guard
aborts the process).  The kernels' fake route is keyed on the fake tensor
type, not the device, so the program is the card's: flash attention's and
RMSNorm's autograd functions, never a plain attention's S × S scores.

A combination the port does not run yet raises its usual error, naming
its ROADMAP item, and becomes an ``error`` record (the reference's
``_DRYRUN_ERRORS``); none is dropped from the matrix.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.analysis.ir import capture, collective_bytes
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, shape_applicable
from repro_torch.kernels import ops
from repro_torch.launch.mesh import axis_mesh, fake_world, mesh_axes, production_shape
from repro_torch.launch.specs import (decode_input_specs, input_specs, param_specs,
                                      param_specs_shapes)
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import constraints as CT
from repro_torch.train.trainer import TrainConfig, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

FAKE_DEVICE = "cpu"

# what a failing run raises: shape/spec mismatches (ValueError/TypeError),
# bad axis/param lookups (KeyError/IndexError), model-side invariants
# (AssertionError), the port's unported paths (NotImplementedError) and
# runtime refusals (RuntimeError).  Anything else propagates.
_DRYRUN_ERRORS = (ValueError, TypeError, KeyError, IndexError,
                  AssertionError, NotImplementedError, RuntimeError)


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def grad_accum_for(cfg, shape, dp: int) -> int:
    """The reference's automatic gradient accumulation: bound the live
    per-microbatch residuals (≈ 3·L·S·D bytes a sample with bf16 + remat
    bookkeeping, four times that for MoE) to about 3.5 GB."""
    b_loc = max(1, shape.global_batch // dp)
    per_sample = 3 * cfg.num_layers * shape.seq_len * cfg.d_model * 2
    if cfg.is_moe:
        per_sample *= 4
    b_mb = max(1, int(3.5e9 // per_sample))
    ga = 1
    while b_loc // ga > b_mb and ga < b_loc:
        ga *= 2
    return ga


def _mesh_of(sharding: str, multi_pod: bool):
    """(shape, axes, data-parallel axes, tensor-parallel axis or None)."""
    if sharding.startswith("hybrid"):
        # same 256 ranks, tensor parallelism of degree t: the rest of the
        # model axis becomes another data axis
        t = int(sharding[len("hybrid"):])
        if multi_pod:
            raise ValueError("the hybrid variants are single-pod")
        return (16, 16 // t, t), ("data", "extra", "model"), ("data", "extra"), "model"
    shape, axes = production_shape(multi_pod=multi_pod)
    dp_axes, tp_axis = mesh_axes(axes)
    if sharding == "fsdp":
        return shape, axes, dp_axes + (tp_axis,), None
    return shape, axes, dp_axes, tp_axis


def build_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
                 dtype: str = "bfloat16", microbatches: int = 1, sharding: str = "2d",
                 remat: bool = True, swa: int = 0, cache_dtype: str = "",
                 extra_tags: str = "", layers: int = 0) -> Dict[str, Any]:
    """Run the combination on fake tensors; returns the record (raises on
    failure).  ``sharding`` as the reference's: ``"2d"`` (FSDP over the data
    axes × tensor parallelism over ``model``), ``"fsdp"`` (the model axis
    joins the data axes) or ``"hybrid{t}"`` (tensor parallelism of degree
    t).  ``layers`` > 0 cuts the depth to that many layers (recorded)."""
    cfg = get_config(arch).replace(dtype=dtype)
    if swa:
        cfg = cfg.replace(sliding_window=swa)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    shape = INPUT_SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "why": why}

    mshape, axes, dp_axes, tp_axis = _mesh_of(sharding, multi_pod)
    dp = math.prod(mshape[axes.index(a)] for a in dp_axes)
    tp = mshape[axes.index(tp_axis)] if tp_axis else 1
    ep_pad = 16 if cfg.is_moe else 1
    # sequence parallelism when even one sample's residuals exceed budget
    seq_shard = (shape.kind == "train"
                 and 3 * cfg.num_layers * shape.seq_len * cfg.d_model * 2 > 3.5e9)
    rows = shape.global_batch // dp if shape.global_batch % dp == 0 else shape.global_batch
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": "x".join(map(str, mshape)),
        "multi_pod": multi_pod, "dtype": dtype, "sharding": sharding,
        "layers": cfg.num_layers,
        "params": int(sum(math.prod(s) for s in
                          param_specs_shapes(cfg, ep_pad=ep_pad).values())),
        "tags": extra_tags, "seq_shard": seq_shard, "rows": rows,
    }

    t0 = time.time()
    with fake_world(math.prod(mshape)):
        meshes = {"data": axis_mesh(mshape, axes, dp_axes, "data")}
        if tp_axis:
            meshes["model"] = axis_mesh(mshape, axes, (tp_axis,), "model")
        sited = meshes.get("model") if tp > 1 else None
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed._tools.mem_tracker import MemTracker
        from torch.utils.flop_counter import FlopCounterMode

        with FakeTensorMode():
            model = M.shard_(cfg, param_specs(cfg, ep_pad=ep_pad, device=FAKE_DEVICE), meshes)
            record["params_rank"] = sum(p.numel() for p in model.parameters())
            args, run = _program(cfg, shape, model, meshes, sited, rows=rows, dp=dp, tp=tp,
                                 remat=remat, microbatches=microbatches,
                                 cache_dtype=cache_dtype, record=record)
            record["memory"] = {"argument_bytes": _nbytes(list(model.parameters()))
                                + _nbytes(args)}
            mt = _peak_tracker(MemTracker)
            mt.track_external(model, *_tensors(args))
            kernel0 = dict(ops.FAKE_FLOPS)
            flops = FlopCounterMode(display=False)
            with mt, flops, capture() as cap:
                out = run()
            peak = mt.get_tracker_snapshot("peak")
    record["trace_s"] = round(time.time() - t0, 1)
    kernel = {k: ops.FAKE_FLOPS[k] - kernel0[k] for k in kernel0
              if ops.FAKE_FLOPS[k] != kernel0[k]}
    record["flops"] = float(flops.get_total_flops() + sum(kernel.values()))
    record["kernel_flops"] = kernel
    total = sum(int(v.get("Total", 0)) for v in peak.values())
    by_kind: Dict[str, int] = {}
    for v in peak.values():
        for k, n in v.items():
            if k != "Total":
                name = getattr(k, "value", str(k))
                by_kind[name] = by_kind.get(name, 0) + int(n)
    record["memory"].update({"output_bytes": _nbytes(out), "peak_bytes": total,
                             "temp_bytes": total - record["memory"]["argument_bytes"],
                             "peak_by_kind": by_kind})
    record["collectives"] = collective_bytes(cap)
    record["status"] = "ok"
    return record


def _peak_tracker(MemTracker):
    """A ``MemTracker`` that tracks the tensors alone, not each module's
    stats: its module hooks refuse a module called again at top level, as
    ``grad_accum``'s microbatches call every layer, and the record needs
    only the peak (``get_tracker_snapshot("peak")``)."""

    class PeakTracker(MemTracker):
        def _pre_fw_hook(self, *args):
            pass

        def _post_fw_hook(self, *args):
            pass

        def _pre_bw_hook(self, *args):
            pass

        def _post_bw_hook(self, *args):
            pass

    return PeakTracker()


def _program(cfg, shape, model, meshes, sited, *, rows, dp, tp, remat, microbatches,
             cache_dtype, record):
    """(the step's inputs, a thunk running it) for the shape's kind."""
    if shape.kind == "train":
        ga = grad_accum_for(cfg, shape, dp)
        record["grad_accum"] = ga
        tcfg = TrainConfig(remat=remat, microbatches=microbatches, grad_accum=ga,
                           sited_mesh=sited, data_axis=meshes["data"])
        step = make_train_step(cfg, tcfg)
        opt = adamw.init_state(dict(model.named_parameters()))
        batch = input_specs(cfg, shape, device=FAKE_DEVICE, batch=rows)
        sizes = {"data": dp, "model": tp}

        def run():
            with CT.use_axes(("data",), "model", sizes=sizes, batch=shape.global_batch):
                return step(model, opt, batch, 0)[2]

        return (opt, batch), run
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape, device=FAKE_DEVICE, batch=rows)
        batch = {k: v for k, v in batch.items() if k not in ("targets", "mask")}

        def run():
            with torch.no_grad():
                x, _, _ = M.forward_hidden(cfg, model, batch, remat=False, mesh=sited)
                return M._unembed(cfg, model, x[:, -1:])

        return batch, run
    dspec = decode_input_specs(cfg, shape, cache_dtype or None, device=FAKE_DEVICE,
                               batch=rows)

    def run():
        with torch.no_grad():
            return M.decode_step(cfg, model, dspec["tokens"], dspec["caches"], mesh=sited)[0]

    return dspec, run


def run_one(arch, shape_name, multi_pod, out_dir=OUT_DIR, **kw):
    tag = "pod2" if multi_pod else "pod1"
    try:
        rec = build_dryrun(arch, shape_name, multi_pod=multi_pod, **kw)
    except _DRYRUN_ERRORS as e:
        rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    os.makedirs(out_dir, exist_ok=True)
    suffix = kw.get("extra_tags", "")
    suffix = f"_{suffix}" if suffix else ""
    path = os.path.join(out_dir, f"{arch}_{shape_name}_{tag}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    status = rec["status"]
    extra = "" if status != "ok" else (
        f" peak={rec['memory']['peak_bytes']/2**30:.2f}GiB/dev "
        f"flops={rec['flops']:.3g} coll={rec['collectives']['count']}")
    print(f"[{status:7s}] {arch} × {shape_name} × {tag}{suffix}{extra}", flush=True)
    if status == "error":
        print(rec["error"], flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sharding", default="2d",
                    choices=["2d", "fsdp", "hybrid2", "hybrid4", "hybrid8"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--swa", type=int, default=0,
                    help="override: sliding-window variant (enables long_500k)")
    ap.add_argument("--cache-dtype", default="",
                    help="KV/state cache dtype override (e.g. float8_e4m3fn)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the config's)")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--tuned-plan", default=None,
                    help="saved TunedPlan JSON: install it and print the resolved "
                         "per-site runtime table (site id -> knobs -> source plan "
                         "key) before the runs, so operators can audit what the "
                         "plan actually changes at launch")
    ap.add_argument("--demote", default="",
                    help="comma-separated SiteIds to demote to default knobs after "
                         "installing --tuned-plan (the table grows a 'health' "
                         "column marking them)")
    ap.add_argument("--lint", action="store_true",
                    help="run the deployment linter (repro_torch.analysis.lint) on "
                         "--tuned-plan and exit before anything runs: exits 1 on "
                         "ERROR-severity findings, 0 otherwise")
    args = ap.parse_args(argv)

    if args.lint and not args.tuned_plan:
        ap.error("--lint requires --tuned-plan")
    if args.tuned_plan and args.lint:
        from repro_torch.analysis.lint import errors, format_findings, lint_plan
        from repro_torch.core.session import TunedPlan
        findings = lint_plan(TunedPlan.load(args.tuned_plan))
        print(format_findings(findings, label=args.tuned_plan), flush=True)
        sys.exit(1 if errors(findings) else 0)

    if args.tuned_plan:
        from repro_torch.core.apply import activate
        from repro_torch.core.session import TunedPlan
        from repro_torch.launch.plan import print_runtime_table
        from repro_torch.parallel import collectives as C
        plan = TunedPlan.load(args.tuned_plan)
        rt = activate(plan)
        demoted = [s for s in args.demote.split(",") if s.strip()]
        if demoted:
            rt = dict(rt)
            rt.update({s: C.CollectiveRuntime() for s in demoted})
            C.install_runtime_plan(rt)
        print_runtime_table(plan, demoted=demoted)
    elif args.demote:
        ap.error("--demote requires --tuned-plan")

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                rec = run_one(a, s, mp, out_dir=args.out_dir,
                              microbatches=args.microbatches, sharding=args.sharding,
                              remat=not args.no_remat, swa=args.swa,
                              cache_dtype=args.cache_dtype, extra_tags=args.tag,
                              layers=args.layers)
                failures += rec["status"] == "error"
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
