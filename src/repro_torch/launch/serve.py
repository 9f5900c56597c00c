"""Serving launcher of the port: batched greedy decoding with a prefilled
KV cache, on one card by default.

    python -m repro_torch.launch.serve --arch llama3-8b --batch 8 \
        --prompt-len 512 --max-new 32 --max-seq 1024
    python -m repro_torch.launch.serve --arch zamba2-7b --smoke --device cpu

``--arch`` is any registered config: llama3-8b, zamba2-7b, rwkv6-1.6b,
the MoE models olmoe-1b-7b, deepseek-moe-16b, qwen2-moe-a2.7b and
deepseek-v2-lite-16b (MLA), the dense models phi2-2b, mpt-7b,
phi4-mini-3.8b, stablelm-3b, yi-34b and h2o-danube-1.8b (a sliding
window: its cache is a ring of ``min(--max-seq, window)`` slots, which a
prompt must fit), qwen2-vl-72b (M-RoPE, served on text) and whisper-small
(``--engine fixed`` only: its frames (B, encoder_seq, D) are drawn from
the seed as the reference's launcher draws them, N(0, 0.02²)).  The
weights are random, drawn from ``--seed``; so are the prompts, all
``--prompt-len`` long (the recurrent families need equal lengths).

Plan-aware, as the reference's launcher: ``--tuned-plan`` / ``--plan-repo``
hand the plan to the engine, which decodes a dense or MoE model under it
through the sited explicit-collective path (``serve.layer{i}.*`` SiteIds).
``--engine continuous`` swaps in the continuous-batching engine, which
re-resolves the repository plan as the in-flight batch shape drifts.
``--fault-schedule`` arms per-site drift detection and demotion, and
``--retune`` the online re-tuning loop; a report line for each prints at
exit.  The mesh is ``launch.mesh.make_mesh()``: a process group the caller
initialised, or one process alone.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.plan import apply_tuned_plan, resolve_plan_repo
from repro_torch.models import model as M
from repro_torch.serving import Request, available_engines, make_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", default="fixed", choices=available_engines(),
                    help="fixed: lockstep batch decode; continuous: per-slot "
                         "caches with admit-time plan re-resolution")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch size (fixed engine) / slot count (continuous)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for ('cpu')")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights, the prompts and whisper's frames")
    ap.add_argument("--tuned-plan", default=None,
                    help="saved TunedPlan JSON: lowered to per-site collective "
                         "knobs and installed process-wide; the engine decodes "
                         "under it via the sited serve.layer{i}.* path (dense "
                         "family).  With --retune this is the starting plan")
    ap.add_argument("--plan-repo", default=None,
                    help="PlanRepository directory: the engine re-resolves a "
                         "stored plan for the decode-shape workload "
                         "(fingerprint x hardware, exact first then the "
                         "--plan-band tolerance band); untuned with a warning "
                         "on a miss")
    ap.add_argument("--plan-band", type=float, default=0.0,
                    help="tolerance band for --plan-repo decode lookups "
                         "(0 = exact only)")
    ap.add_argument("--plan-parallel", default="fsdp:8",
                    help="parallel spec for the repo lookup: "
                         "kind[:degree[:microbatches]]")
    ap.add_argument("--plan-hardware", default="h100-sxm",
                    help="hardware profile name for the repo lookup key")
    ap.add_argument("--fault-schedule", default=None,
                    help="arm per-site drift detection against a scripted "
                         "fault schedule: a JSON schedule file, or an inline "
                         "spec like 'degrade,site=serve,scale=0.25,start=4'")
    ap.add_argument("--health-window", type=int, default=3,
                    help="consecutive drifted batches before a site is demoted")
    ap.add_argument("--health-tolerance", type=float, default=0.25,
                    help="relative per-site cost drift that counts as a "
                         "drifted batch")
    ap.add_argument("--retune", action="store_true",
                    help="arm the online re-tuning loop: sustained drift "
                         "triggers a drift-scoped warm re-tune, hot-swapped "
                         "between batches; demotion stays the fallback")
    ap.add_argument("--retune-interval", type=int, default=1,
                    help="minimum batches between re-tune publishes")
    ap.add_argument("--retune-drift", type=float, default=None,
                    help="minimum relative drift before re-tuning instead of "
                         "demoting (default: any flagged drift re-tunes)")
    ap.add_argument("--retune-max", type=int, default=4,
                    help="maximum re-tunes per run")
    ap.add_argument("--no-plan-lint", action="store_true",
                    help="serve a --tuned-plan even when the linter finds "
                         "ERROR-severity defects in it")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    plan_kw = {}
    if args.tuned_plan:
        apply_tuned_plan(args.tuned_plan, expect_arch=cfg.name)
        # the re-tune loop rebuilds the decode workload with the deployed
        # topology, so a pinned plan carries --plan-parallel too
        plan_kw = dict(plan=args.tuned_plan, plan_parallel=args.plan_parallel)
    elif args.plan_repo:
        resolve_plan_repo(args.plan_repo, cfg, parallel=args.plan_parallel,
                          hardware=args.plan_hardware, seq=args.max_seq,
                          global_batch=args.batch, serve=True, band=args.plan_band)
        plan_kw = dict(repo=args.plan_repo, plan_hardware=args.plan_hardware,
                       plan_parallel=args.plan_parallel, plan_band=args.plan_band)
    plan_kw["plan_lint"] = "off" if args.no_plan_lint else "error"
    if args.fault_schedule:
        plan_kw.update(fault_schedule=args.fault_schedule,
                       health_window=args.health_window,
                       health_tolerance=args.health_tolerance)
    if args.retune:
        plan_kw.update(retune=dict(interval=args.retune_interval,
                                   max_retunes=args.retune_max,
                                   drift_threshold=args.retune_drift))
    params = M.init_params(cfg, args.seed, device=args.device)
    rs = np.random.default_rng(args.seed)
    prompts = [rs.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
               for _ in range(args.batch)]

    if args.engine == "continuous":
        engine = make_engine(cfg, params, mode="continuous", slots=args.batch,
                             max_seq=args.max_seq, **plan_kw)
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=p, max_new=args.max_new))
        for r in sorted(engine.run(), key=lambda r: r.rid):
            print(f"request {r.rid}: {r.out}")
    else:
        engine = make_engine(cfg, params, mode="fixed", batch_size=args.batch,
                             max_seq=args.max_seq, **plan_kw)
        frames = None
        if cfg.family == "audio":
            frames = rs.standard_normal(
                (args.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
        outs = engine.generate(prompts, max_new=args.max_new, frames=frames)
        for i, o in enumerate(outs):
            print(f"request {i}: {o}")
        probe = engine.throughput_probe()
        print(f"decode throughput: {probe['tokens_per_s']:.1f} tok/s "
              f"({probe['s_per_token']*1e3:.2f} ms/step, batch {args.batch}, "
              f"{engine.device.type})")
    stats = engine.plan_stats
    if args.plan_repo:
        print(f"plan resolution: {stats['exact']} exact, {stats['banded']} "
              f"banded, {stats['miss']} miss ({stats['swaps']} hot-swaps)")
    if args.fault_schedule:
        print(engine.health_report())
    if args.retune:
        print(engine.retune_service.report())


if __name__ == "__main__":
    main()
