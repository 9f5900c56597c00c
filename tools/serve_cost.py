#!/usr/bin/env python3
"""Unplanned serving, as ``chip_smoke.py`` phases 4 and 11 drive it, for
one tree of the repo, so that two trees can be compared in one run on the
same card:

    python3 tools/serve_cost.py --src src                 # this tree
    python3 tools/serve_cost.py --src /path/to/other/src  # another tree
    python3 tools/serve_cost.py --arch phi2-2b,mpt-7b,h2o-danube-1.8b

It imports ``repro_torch`` from ``--src`` and, for each model of
``--arch`` (llama3-8b by default), makes it at full size (random weights
from seed 0, fp32, TF32 off) and serves eight ragged prompts through the
fixed-batch engine with no plan: 384-512 tokens at ``max_seq`` 1024 as
phase 4 serves, or for h2o-danube-1.8b 4064-4080 tokens at ``max_seq``
4160 as phase 11 serves it (decode wraps its 4096-slot ring); 32 new
tokens, one warm-up batch, then ``--runs`` batches.  It prints one JSON
line a model with each batch's prefill time and median decode step (the
engine's own host clocks, ending in a synchronize or a token read-back)
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

BATCH, MAX_NEW, MAX_SEQ, LENS, SEED = 8, 32, 1024, (384, 512), 0
# chip_smoke.SWA_ARCH, SWA_PROMPT_LENS, SWA_MAX_SEQ
LONG = {"h2o-danube-1.8b": ((4064, 4080), 4160)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--arch", default="llama3-8b", help="models, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import make_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    for arch in args.arch.split(","):
        cfg = get_config(arch)
        lens_range, max_seq = LONG.get(arch, (LENS, MAX_SEQ))
        rs = np.random.default_rng(SEED)            # chip_smoke.make_prompts' recipe
        lens = rs.integers(lens_range[0], lens_range[1] + 1, size=BATCH)
        lens[0] = lens_range[1]
        prompts = [rs.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
        model = M.init_params(cfg, SEED, device="cuda")
        engine = make_engine(cfg, model, mode="fixed", batch_size=BATCH, max_seq=max_seq)
        engine.generate(prompts, max_new=2)
        out = {"src": args.src, "arch": arch, "card": card, "prefill_ms": [],
               "decode_ms": []}
        for _ in range(args.runs):
            engine.generate(prompts, max_new=MAX_NEW)
            out["prefill_ms"].append(engine.last_timing["prefill_s"] * 1e3)
            out["decode_ms"].append(statistics.median(engine.last_timing["decode_s"]) * 1e3)
        print(json.dumps(out), flush=True)
        del engine, model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
