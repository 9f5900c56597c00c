#!/usr/bin/env python3
"""Where a plan-bound decode step of llama3-8b spends its time on one card:

    python3 tools/plan_decode_profile.py [--layers 32] [--src src]

llama3-8b at full width (``--layers`` deep, random weights from seed 0,
fp32, TF32 off) serves ``chip_smoke.py``'s eight ragged prompts on a
1-rank NCCL mesh (a ``FileStore`` rendezvous), unplanned and under
``chip_smoke.py``'s plans (a) and (b).  For each engine it prints:
  * the median decode step, by the host's clock around each step and its
    token read-back (as ``Engine.generate`` times it), over 32 steps;
  * a ``cProfile`` of 8 decode steps: the functions with the most time of
    their own;
  * a ``torch.profiler`` trace of 4 decode steps: device time by kernel
    class (GEMMs, NCCL, the port's kernels, the rest) beside the host's
    wall time.
``--src`` picks the tree whose ``repro_torch`` is imported.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(run) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {"gemm": 0.0, "nccl": 0.0, "rmsnorm": 0.0, "flash": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        kind = ("nccl" if "nccl" in name else "rmsnorm" if "rmsnorm_kernel" in name else
                "flash" if "flash_fwd_kernel" in name else
                "gemm" if ("gemm" in name or "gemv" in name) else "other")
        out[kind] += ev.self_device_time_total / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("plan_decode_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    import chip_smoke as CS
    from repro_torch.models import model as M
    from repro_torch.parallel import collectives
    from repro_torch.serving import make_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, torch.__version__, flush=True)
    cfg = CS.get_config(CS.PLAN_ARCH).replace(num_layers=args.layers)
    prompts = CS.make_prompts(cfg)
    model = M.init_params(cfg, CS.SEED, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        mesh = CS.nccl_mesh(tmp)
        try:
            wl = CS.extract_decode_workload(CS.get_config(CS.PLAN_ARCH),
                                            CS.parse_parallel("tp:8"),
                                            global_batch=CS.BATCH, seq=CS.MAX_SEQ)
            plans = {"none": None, "a": CS.tune(wl, "h100-sxm", method="lagom"),
                     "b": {k: collectives.CollectiveRuntime(*v)
                           for k, v in CS.PLAN_B.items()}}
            for name, plan in plans.items():
                kw = {} if plan is None else dict(plan=plan, mesh=mesh)
                engine = make_engine(cfg, model, batch_size=CS.BATCH, max_seq=CS.MAX_SEQ, **kw)
                engine.generate(prompts, max_new=2)
                engine.generate(prompts, max_new=CS.MAX_NEW)
                step_ms = statistics.median(engine.last_timing["decode_s"]) * 1e3
                prof = cProfile.Profile()
                prof.enable()
                engine.generate(prompts, max_new=9)
                prof.disable()
                text = io.StringIO()
                pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(14)
                runs = {n: device_ms(lambda: engine.generate(prompts, max_new=n)) for n in (1, 5)}
                dev = {k: runs[5][k] - runs[1][k] for k in runs[1]}
                print(f"== plan {name}: decode {step_ms:.2f} ms/step (median of "
                      f"{CS.MAX_NEW}), {args.layers} layers ({card})")
                print(f"4 decode steps, device ms by class: "
                      + ", ".join(f"{k} {v:.2f}" for k, v in dev.items())
                      + f"; busy {sum(dev.values()):.2f}")
                print("cProfile of a prefill and 9 decode steps, by own time:")
                print("\n".join(ln for ln in text.getvalue().splitlines()[6:] if ln.strip()))
                del engine
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
