"""Serving launcher of the port: batched greedy decoding with a prefilled
KV cache, on one card by default.

    python -m repro_torch.launch.serve --arch llama3-8b --batch 8 \
        --prompt-len 512 --max-new 32 --max-seq 1024
    python -m repro_torch.launch.serve --arch zamba2-7b --smoke --device cpu

``--arch`` is one of llama3-8b, zamba2-7b and rwkv6-1.6b.  The weights are
random, drawn from ``--seed``; so are the prompts, all ``--prompt-len``
long (the recurrent families need equal lengths).  The
reference's plan, fault and re-tune flags arrive with the port's
tensor-parallel serving slice.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as M
from repro_torch.serving import make_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for ('cpu')")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the prompts")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = M.init_params(cfg, args.seed, device=args.device)
    rs = np.random.default_rng(args.seed)
    prompts = [rs.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
               for _ in range(args.batch)]

    engine = make_engine(cfg, params, mode="fixed", batch_size=args.batch,
                         max_seq=args.max_seq)
    outs = engine.generate(prompts, max_new=args.max_new)
    for i, o in enumerate(outs):
        print(f"request {i}: {o}")
    probe = engine.throughput_probe()
    print(f"decode throughput: {probe['tokens_per_s']:.1f} tok/s "
          f"({probe['s_per_token']*1e3:.2f} ms/step, batch {args.batch}, "
          f"{engine.device.type})")


if __name__ == "__main__":
    main()
