#!/usr/bin/env python3
"""The port's chunked collectives and its sited trunk across four ranks,
one card each, over NCCL:

    python3 tools/four_rank_check.py            # four cards, llama3-8b widths
    python3 tools/four_rank_check.py --smoke    # the CPU, gloo, smoke widths

It starts four worker processes (``tcp://localhost`` rendezvous on a free
port) and waits for them.  Each rank:
  * holds ``ring_ag_matmul``, ``mm_reduce_scatter``, ``chunked_all_to_all``
    and ``psum_tree_chunked`` with 1, 2 and 4 chunks, on its shards of
    llama3-8b's MLP shapes (4096 rows, d_model 4096, d_ff 14336, sharded
    4 ways), against the ``*_ref`` oracles within the reference's bounds
    (1e-4, 1e-3, 1e-6, 1e-6);
  * times (CUDA events, median of 5 means of 2 calls) the ring at each
    chunk count beside its parts alone: the local product of the whole
    sequence, the all-gather alone, and the all-gather followed by the
    product (no overlap); and ``mm_reduce_scatter`` beside the product
    followed by one reduce-scatter;
  * runs llama3-8b at full width cut to 2 layers (random weights from
    seed 0, fp32, TF32 off) through the sited trunk under a plan that
    chunks layer 0's and layer 1's gate/up ring by 2 and 4, a forward of
    8 x 512 tokens without a cache and a cached prefill with 2 decode
    steps, beside the unsited trunk: the logits' max abs difference.
Rank 0 prints one JSON line with every rank's results; the exit code is
1 if a check failed on any rank.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

N = 4
BOUNDS = {"ring_ag_matmul": 1e-4, "mm_reduce_scatter": 1e-3, "chunked_all_to_all": 1e-6,
          "psum_tree_chunked": 1e-6}
TRUNK_BOUND = 1e-4
WAIT_S = 330                      # the workers' time, after which they are stopped
PLAN = {"tp.layer0.mlp.ag": ("ring", 2), "tp.layer1.mlp.ag": ("ring", 4),
        "serve.layer0.mlp.ag": ("ring", 2), "serve.layer1.mlp.ag": ("ring", 4)}


def timed(fn, dev) -> float:
    """Median of 5 means of 2 calls, by CUDA events (host clock on the CPU)."""
    for _ in range(2):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 2)
    return statistics.median(times)


def worker(rank: int, port: int, smoke: bool, out: str) -> int:
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel import collectives as C

    faulthandler.dump_traceback_later(WAIT_S - 60, exit=True)   # a hang shows its stack
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu") if smoke else torch.device("cuda", rank)
    kw = {}
    if not smoke:
        # NCCL's batch_isend_irecv (the ring) and the port's kernels use the
        # current device: it must be this rank's card
        torch.cuda.set_device(dev)
        kw = dict(device_id=dev)
    dist.init_process_group("gloo" if smoke else "nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=N, timeout=timedelta(seconds=180), **kw)
    res = {"rank": rank, "helpers": [], "failed": []}
    try:
        mesh = make_mesh()
        cfg = get_smoke_config("llama3-8b") if smoke else get_config("llama3-8b")
        D, F, T = cfg.d_model, cfg.d_ff, (64 if smoke else 4096)
        gen = torch.Generator(device=dev).manual_seed(0)     # the same on every rank
        x = torch.randn((1, T, D), generator=gen, device=dev)
        w = torch.randn((D, F), generator=gen, device=dev) / D ** 0.5
        h = torch.randn((1, T, F), generator=gen, device=dev)
        wd = torch.randn((F, D), generator=gen, device=dev) / F ** 0.5
        tl, fl = T // N, F // N
        xl = x[:, rank * tl:(rank + 1) * tl].contiguous()
        wl = w[:, rank * fl:(rank + 1) * fl].contiguous()
        hl = h[..., rank * fl:(rank + 1) * fl].contiguous()
        wdl = wd[rank * fl:(rank + 1) * fl].contiguous()
        leaves = {"gate": wl, "down": wdl}
        want = {"ring_ag_matmul": C.ag_matmul_ref(x, wl),
                "mm_reduce_scatter": C.mm_rs_ref(h, wd)[:, rank * tl:(rank + 1) * tl],
                "chunked_all_to_all": torch.cat([t.chunk(N, 1)[rank] for t in
                                                 (x[:, j * tl:(j + 1) * tl] for j in range(N))], 0),
                "psum_tree_chunked": {"gate": sum(w.split(fl, 1)), "down": sum(wd.split(fl, 0))}}
        for nc in (1, 2, 4):
            calls = {"ring_ag_matmul": lambda: C.ring_ag_matmul(xl, wl, mesh, num_chunks=nc),
                     "mm_reduce_scatter": lambda: C.mm_reduce_scatter(hl, wdl, mesh,
                                                                      num_chunks=nc),
                     "chunked_all_to_all": lambda: C.chunked_all_to_all(
                         xl, mesh, split_axis=1, concat_axis=0, num_chunks=nc),
                     "psum_tree_chunked": lambda: C.psum_tree_chunked(leaves, mesh,
                                                                      num_chunks=nc)}
            for name, fn in calls.items():
                y = fn()
                if isinstance(y, dict):
                    err = max((y[k] - want[name][k]).abs().max().item() for k in y)
                else:
                    err = (y - want[name]).abs().max().item()
                row = {"helper": name, "num_chunks": nc, "max_abs_err": err,
                       "ms": timed(fn, dev)}
                res["helpers"].append(row)
                if not err <= BOUNDS[name]:
                    res["failed"].append(f"{name} x{nc}: err {err}")
        res["parts_ms"] = {
            "product of the whole sequence": timed(lambda: x @ wl, dev),
            "all-gather alone": timed(lambda: C.all_gather_rows(xl, mesh), dev),
            "all-gather, then product": timed(lambda: C.all_gather_rows(xl, mesh) @ wl, dev),
            "product (down)": timed(lambda: hl @ wdl, dev),
            "product, then one reduce-scatter": timed(
                lambda: C.mm_reduce_scatter(hl, wdl, mesh, num_chunks=1), dev)}
        del x, w, h, wd, xl, wl, hl, wdl, leaves, want

        cfg2 = cfg.replace(num_layers=2)
        model = M.init_params(cfg2, 0, device=dev)
        g = torch.Generator().manual_seed(1)
        B, S = (4, 16) if smoke else (8, 512)
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g).to(dev)
        nxt = torch.randint(0, cfg.vocab_size, (B, 2), generator=g).to(dev)
        plan = {k: C.CollectiveRuntime(*v) for k, v in PLAN.items()}

        def served(m):
            caches = M.init_caches(cfg2, B, S + 4, device=dev)
            caches = M.forward_hidden(cfg2, model, {"tokens": toks}, caches, mesh=m)[1]
            cur, outs = toks[:, -1:], []
            for j in range(2):
                logits, caches = M.decode_step(cfg2, model, cur, caches, mesh=m)
                outs.append(logits[:, -1])
                cur = nxt[:, j:j + 1]
            return torch.stack(outs, 1)

        with torch.inference_mode(), C.use_runtime_plan(plan), C.record_issued() as rows:
            tp = M._unembed(cfg2, model, M.forward_hidden(cfg2, model, {"tokens": toks},
                                                          mesh=mesh)[0])
            tp_plain = M._unembed(cfg2, model, M.forward_hidden(cfg2, model,
                                                                {"tokens": toks})[0])
            sv, sv_plain = served(mesh), served(None)
        res["trunk"] = {"tp_logits_err": (tp - tp_plain).abs().max().item(),
                        "serve_logits_err": (sv - sv_plain).abs().max().item(),
                        "issued": sorted({(r.site, r.op, r.num_chunks, r.collectives)
                                          for r in rows})}
        for key in ("tp_logits_err", "serve_logits_err"):
            if not res["trunk"][key] <= TRUNK_BOUND:
                res["failed"].append(f"trunk {key} {res['trunk'][key]}")
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="on the CPU over gloo, at the smoke config's widths")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.rank is not None:
        return worker(args.rank, args.port, args.smoke, args.out)
    if not args.smoke and torch.cuda.device_count() < N:
        print(f"four_rank_check: needs {N} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    if not args.smoke:       # build the kernels once, before the workers load them
        from repro_torch.kernels import _build

        _build.library()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    card = "" if args.smoke else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().replace("\n", "; ")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(N)]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(N)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   "--port", str(port), "--out", outs[r]]
                                  + (["--smoke"] if args.smoke else []),
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(N)]
        deadline = time.monotonic() + WAIT_S
        try:
            codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
        except subprocess.TimeoutExpired:
            codes = None
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if codes is None or any(codes):
            for r, f in enumerate(logs):
                f.seek(0)
                print(f"--- rank {r}:\n{f.read()[-3000:]}", file=sys.stderr)
            print(f"four_rank_check: worker exit codes {codes} (None: stopped after "
                  f"{WAIT_S} s)", file=sys.stderr)
            return 1
        for f in logs:
            f.close()
        ranks = []
        for o in outs:
            with open(o) as f:
                ranks.append(json.load(f))
    print(json.dumps({"cards": card, "ranks": ranks}))
    failed = [f for r in ranks for f in r["failed"]]
    if failed:
        print(f"four_rank_check: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
