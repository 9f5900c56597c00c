#!/usr/bin/env python3
"""Per-call cost of the port's SSD decode path and chunked forward, of flash
attention (forward and backward), of the WKV6 scan and of the RMSNorm kernels on one card,
for one tree of the repo, so that two trees can be compared in one run on
the same card:

    python3 tools/call_cost.py --src src                 # this tree
    python3 tools/call_cost.py --src /path/to/other/src  # another tree
    python3 tools/call_cost.py --src src --only rmsnorm  # one section

It imports ``repro_torch`` from ``--src`` and prints one JSON line, with
the sections named in ``--only`` (all by default):
  * ``ssd``: ``ssd_call_ms``, one ``ops.ssd`` decode call (S = 1) at
    zamba2-7b's shape (B = 8, H = 112, P = N = 64, fp32, with a state),
    back to back by CUDA events (the median of 25 means of 5 calls, as
    ``chip_smoke.py`` times a call), in the layout that tree's Mamba2 block
    passes: B and C expanded to the heads and x contiguous where
    ``ops.ssd`` has no ``out_state``, else x, B and C as views of one
    conv-output buffer with one group and the state written in place;
    ``ssd_host_us``, the host's time in that call, by the host's clock over
    2000 calls (the kernel is shorter, so the card never holds the host);
    ``layer_ms``, one decode step of zamba2-7b's Mamba layers through the
    trunk's ``_mamba_stack`` over 4 layers at full width with random
    weights and a stacked cache, per layer, by CUDA events as above;
  * ``ssd_fwd``: ``ssd_fwd_ms``, the chunked SSD forward's device time (the
    mean over 50 calls from a torch.profiler trace) at zamba2-7b's served
    prefill (B = 8, S = 512) and training (B = 4, S = 2048) shapes, by
    ``"BxS"`` (H = 112, P = N = 64, fp32, no state, x, B and C as views of
    one conv-output buffer with one group, A = −linspace(1, 16, H) as
    zamba2-7b's initial decays); ``"BxS+states"`` the same call writing each
    chunk's start state for the backward, where that tree's ``ssd_cuda``
    has ``save_states``; ``ssd_fwd_decay_err``, by S, y's largest error of
    max|y| against the step oracle in fp64 at those decays (B = 2, H = 16,
    P = N = 64, S = 64 and 500, one group), as
    ``tests/test_torch_ops.py::test_ssd_kernels_at_zamba2_decays`` holds it
    within 2e-5;
  * ``flash``: ``flash_ms``, ``ops.flash_attention`` at llama3-8b's served
    prefill shape (B = 8, S = 512, 32 / 8 heads of 128, causal, fp32), by
    CUDA events as above;
  * ``wkv6``: ``wkv6_ms`` and ``wkv6_decode_ms``, ``ops.wkv6`` at
    rwkv6-1.6b's served shape (B = 8, H = 32, K = V = 64, fp32, with a
    state, written in place where ``ops.wkv6`` has ``out_state``) at S =
    512 and S = 1: the mean device time of the WKV6 kernels over 50 calls
    from a torch.profiler trace (a decode call's kernel is shorter than its
    host call), and ``wkv6_call_ms`` / ``wkv6_decode_call_ms`` the calls by
    CUDA events as above;
  * ``flash_bwd``: ``flash_bwd_ms``, ``flash_attention_bwd_cuda`` at
    llama3-8b's training shape (B = 4, S = 2048, 32 / 8 heads of 128,
    causal, fp32), from the forward's o and lse, by CUDA events (the median
    of 10 means of 2 calls);
  * ``rmsnorm_bwd``: ``rmsnorm_bwd_ms``, ``rmsnorm_bwd_cuda`` at llama3-8b's
    training rows (8192 x 4096, fp32), by CUDA events as above;
  * ``rmsnorm``: ``rmsnorm_ms``, the RMSNorm forward through ``ops.rmsnorm``
    at every (rows, D) fp32 the main paths launch at full size
    (``RMSNORM_SHAPES``), by shape ``"rowsxD"``: the kernel's device time
    (``ms``, the mean over 60 calls from a torch.profiler trace),
    ``F.rms_norm``'s device time on the same inputs (``library_ms``, the
    sum of every kernel it launches, by the same trace method), and the
    bytes bound (``bound_ms``: x read and y written once, the scale read
    once, at 3.35 TB/s).  Each call reads another x and writes another y
    of a rotation that holds at least ``ROTATE_BYTES`` in all, so no call
    finds its input in the 50 MB L2.
"""
from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import time

SECTIONS = ("ssd", "ssd_fwd", "flash", "wkv6", "flash_bwd", "rmsnorm_bwd", "rmsnorm")
# the RMSNorm forward's (rows, D) on the main paths: prefill's 4096 rows at
# each d_model and latent width served, olmoe-1b-7b's qk_norm over 8 x 512
# tokens x 16 heads of 128, and the training rows of llama3-8b and yi-34b
RMSNORM_SHAPES = ((4096, 512), (4096, 2048), (4096, 3072), (4096, 3584), (4096, 4096),
                  (4096, 7168), (4096, 8192), (65536, 128), (8192, 4096), (8192, 7168))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
ROTATE_BYTES = 4 * 50 * 10**6      # four times the H100's 50 MB L2


def time_ms(fn, *, samples: int = 25, per_sample: int = 5, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def device_ms(fn, name: str, calls: int = 50, attempts: int = 3) -> float:
    """Mean device time of the kernels whose names hold ``name`` over
    ``calls`` calls of ``fn``, from a torch.profiler trace: a call's device
    time where ``fn`` launches one kernel of that name a call.  Where
    ``name`` is empty, a call's device time over every kernel it launches:
    the mean time of a kernel times the kernels a call (the count over
    ``calls``, rounded, at least 1).  The profiler can lose kernel records:
    a trace that holds fewer than ``calls`` kernels is taken again, up to
    ``attempts`` times, and the fullest one is used."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = (0.0, 0)
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA and name in ev.key:
                total += ev.self_device_time_total
                count += ev.count
        if count > best[1]:
            best = (total, count)
        if count == calls or (not name and count > calls):
            break
    total, count = best
    if not count:
        return float("nan")
    return total / count * (max(1, round(count / calls)) if not name else 1) / 1e3


def rmsnorm_ms(ops, dev, gen) -> dict:
    """The ``rmsnorm`` section (module docstring)."""
    import torch

    out = {}
    for rows, D in RMSNORM_SHAPES:
        nbytes = 2 * rows * D * 4
        nbuf = max(1, math.ceil(ROTATE_BYTES / nbytes))
        xs = [torch.randn((rows, D), generator=gen, device=dev) for _ in range(nbuf)]
        ys = [None] * nbuf
        scale = torch.linspace(0.5, 1.5, D, device=dev)
        turn = [0]

        def call(f):
            i = turn[0] = (turn[0] + 1) % nbuf
            ys[i] = None                 # y's buffer of this turn, rotated as x is
            ys[i] = f(xs[i])
        calls = 60
        ms = device_ms(lambda: call(lambda x: ops.rmsnorm(x, scale, backend="cuda")),
                       "rmsnorm_kernel", calls)
        lib = device_ms(lambda: call(
            lambda x: torch.nn.functional.rms_norm(x, (D,), scale, 1e-5)), "", calls)
        bound = (nbytes + D * 4) / HBM_BYTES_PER_S * 1e3
        out[f"{rows}x{D}"] = {"ms": ms, "library_ms": lib, "bound_ms": bound,
                              "share": bound / ms, "rotation": nbuf}
        del xs, ys
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(__file__), "..", "src"),
                    help="the src directory of the tree to import repro_torch from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help=f"comma-separated sections to run, of {', '.join(SECTIONS)}")
    args = ap.parse_args()
    only = args.only.split(",")
    unknown = sorted(set(only) - set(SECTIONS))
    if unknown:
        ap.error(f"unknown sections {unknown}; known: {', '.join(SECTIONS)}")
    import torch

    if not torch.cuda.is_available():
        print("call_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash import flash_attention_bwd_cuda, flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda
    from repro_torch.kernels.ssd import ssd_cuda
    from repro_torch.models import mamba2, zamba2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    _build.library()
    cfg = get_config("zamba2-7b")
    B, H, P, N = 8, cfg.ssm_heads, mamba2.head_p(cfg), cfg.ssm_state
    dev = "cuda"
    out = {"src": args.src}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    with torch.no_grad():
        if "ssd" in only:
            in_place = "out_state" in inspect.signature(ops.ssd).parameters
            dt = torch.nn.functional.softplus(randn(B, 1, H))
            A, D = -torch.exp(randn(H) * 0.3), torch.ones(H, device=dev)
            state = randn(B, H, P, N)
            if in_place:
                buf = randn(B, 1, H * P + 2 * N)
                x, Bm, Cm = torch.split(buf, [H * P, N, N], dim=-1)
                x, Bm, Cm = (x.unflatten(-1, (H, P)), Bm.unflatten(-1, (1, N)),
                             Cm.unflatten(-1, (1, N)))

                def ssd():
                    return ops.ssd(x, dt, A, Bm, Cm, D, state, out_state=state,
                                   backend="cuda")
            else:
                x, Bm, Cm = randn(B, 1, H, P), randn(B, 1, H, N), randn(B, 1, H, N)

                def ssd():
                    return ops.ssd(x, dt, A, Bm, Cm, D, state, backend="cuda")

            out["ssd_in_place"] = in_place
            out["ssd_call_ms"] = time_ms(ssd)
            torch.cuda.synchronize()
            calls = 2000
            t0 = time.perf_counter()
            for _ in range(calls):
                ssd()
            out["ssd_host_us"] = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()

            layers = torch.nn.ModuleList(zamba2.MambaLayer(cfg, device=dev) for _ in range(4))
            for lp in layers:
                lp.mamba.init_weights(gen)
            one = mamba2.init_cache(cfg, B, device=dev)
            seg = {name: a.expand(len(layers), *a.shape).clone() for name, a in one.items()}
            h = randn(B, 1, cfg.d_model) * 0.1
            out["layer_ms"] = time_ms(
                lambda: zamba2._mamba_stack(layers, cfg, h, seg, ())) / len(layers)
            del layers, seg

        if "ssd_fwd" in only:
            out["ssd_fwd_ms"], out["ssd_fwd_decay_err"] = {}, {}

            def views(Bb, S, Hh):
                buf = randn(Bb, S, Hh * P + 2 * N)
                x, Bm, Cm = torch.split(buf, [Hh * P, N, N], dim=-1)
                return (x.unflatten(-1, (Hh, P)), torch.nn.functional.softplus(randn(Bb, S, Hh)),
                        -torch.linspace(1.0, 16.0, Hh, device=dev), Bm.unflatten(-1, (1, N)),
                        Cm.unflatten(-1, (1, N)), 1.0 + 0.5 * randn(Hh))

            saves = "save_states" in inspect.signature(ssd_cuda).parameters
            for Bb, S in ((8, 512), (4, 2048)):
                args = views(Bb, S, H)
                for states in (False, True) if saves else (False,):
                    kw = {"save_states": True} if states else {}
                    key = f"{Bb}x{S}" + ("+states" if states else "")
                    out["ssd_fwd_ms"][key] = device_ms(lambda: ssd_cuda(*args, **kw),
                                                       "ssd_fwd_kernel")
                del args
            for S in (64, 500):
                args = views(2, S, 16)
                y = ssd_cuda(*args)[0]
                y64 = ops.ssd(*(a.double() for a in args), backend="ref")[0]
                out["ssd_fwd_decay_err"][S] = ((y.double() - y64).abs().max()
                                               / y64.abs().max()).item()
                del args, y, y64

        if "flash" in only:
            q = randn(8, 512, 32, 128)
            k, v = randn(8, 512, 8, 128), randn(8, 512, 8, 128)
            out["flash_ms"] = time_ms(
                lambda: ops.flash_attention(q, k, v, causal=True, backend="cuda"))
            del q, k, v

        if "wkv6" in only:
            rcfg = get_config("rwkv6-1.6b")
            Hr, Kd = rcfg.num_heads, rcfg.head_dim
            wkv6_in_place = "out_state" in inspect.signature(ops.wkv6).parameters
            wkv = {}
            for S in (512, 1):
                r, kk, vv = randn(B, S, Hr, Kd), randn(B, S, Hr, Kd), randn(B, S, Hr, Kd)
                w = -torch.exp(randn(B, S, Hr, Kd) * 0.5)
                u, st = randn(Hr, Kd) * 0.1, randn(B, Hr, Kd, Kd)
                kw = {"out_state": st} if wkv6_in_place else {}

                def call():
                    return ops.wkv6(r, kk, vv, w, u, st, backend="cuda", **kw)
                wkv[S] = (device_ms(call, "wkv6_"), time_ms(call))
            del r, kk, vv, w, u, st
            out.update(wkv6_in_place=wkv6_in_place, wkv6_ms=wkv[512][0],
                       wkv6_call_ms=wkv[512][1], wkv6_decode_ms=wkv[1][0],
                       wkv6_decode_call_ms=wkv[1][1])

        if "flash_bwd" in only:
            q, do = randn(4, 2048, 32, 128), randn(4, 2048, 32, 128)
            k, v = randn(4, 2048, 8, 128), randn(4, 2048, 8, 128)
            o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
            out["flash_bwd_ms"] = time_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do),
                                          samples=10, per_sample=2)
            del q, do, k, v, o, lse

        if "rmsnorm_bwd" in only:
            x, dy = randn(8192, 4096), randn(8192, 4096)
            scale = torch.linspace(0.5, 1.5, 4096, device=dev)
            out["rmsnorm_bwd_ms"] = time_ms(lambda: rmsnorm_bwd_cuda(x, scale, dy))
            del x, dy

        if "rmsnorm" in only:
            out["rmsnorm_ms"] = rmsnorm_ms(ops, dev, gen)

    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
