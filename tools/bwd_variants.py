#!/usr/bin/env python3
"""The backward kernels' design choices, measured on one card.

    python3 tools/bwd_variants.py            # on a machine with the card and nvcc

It writes variants of ``src/repro_torch/kernels/csrc/flash_bwd.cu`` and
``rmsnorm.cu`` into ``build/bwd_variants/`` by exact-text edits of the
sources, builds each alone with nvcc (the port's flags, ``-Xptxas -v``,
plain C interface), prints what ptxas reports for its main instantiations
(flash: the dK/dV and dQ kernels at <fp32, 112> and <fp32, 128>; RMSNorm:
the backward at <fp32, 4 vectors>), then:

  * flash backward, from the port's forward's o and lse: each variant's
    error against autograd of the plain version in fp64 (batch element 0),
    as a share of max|g| over dq, dk and dv, at llama3-8b's training shape
    (B = 4, S = 2048, Hq = 32, Hkv = 8, h = 128, causal fp32) and at
    (1, 8192, 8, 2, 128); then its time at the training shape by CUDA
    events, the variants in turns, forward and back, twice (the median of
    10 means of 2 calls each time).  Variants: ``pairs`` (the source: each
    gradient tile's sum taken in the MMA from zero, two column steps at a
    time, and added in fp32), ``single`` (one column step at a time) and
    ``in_mma`` (the gradients summed in the MMA's accumulate across all
    tiles);
  * RMSNorm backward at (8192, 4096) fp32: ``two`` (the source: the
    register path held to two blocks an SM, and one such wave launched)
    and ``three``, in turns as above (the median of 25 means of 5 calls).

Where an edit no longer matches the source, the tool names it and exits
with 1 before building anything: a change to the kernels' text there must
be carried into ``FLASH`` and ``RMSNORM``.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "bwd_variants")
FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC]

# variant: [(text in the source, what replaces it)]
FLASH = {
    "pairs": [],
    "single": [("  constexpr int NG = NH == 14 ? 1 : 2;\n", "  constexpr int NG = 1;\n")],
    "in_mma": [
        ("      for (int j = 0; j < NG; ++j) mma3(t[j], big, small, b.at(c, n0 + j));",
         "      for (int j = 0; j < NG; ++j) mma3(acc[n0 + j], big, small, b.at(c, n0 + j));"),
        ("      for (int i = 0; i < 4; ++i) acc[n0 + j][i] += t[j][i];",
         "      for (int i = 0; i < 4; ++i) (void)t[j][i];"),
    ],
}
RMSNORM = {
    "two": [],
    "three": [("constexpr int kBwdBlocksPerSM = 2;", "constexpr int kBwdBlocksPerSM = 3;")],
}


def variants(source: str, table: dict) -> dict:
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    out = {}
    for name, edits in table.items():
        t = text
        for old, new in edits:
            if t.count(old) != 1:
                print(f"bwd_variants: {source} {name}: the edit of {old.strip()!r} no "
                      "longer matches the source", file=sys.stderr)
                sys.exit(1)
            t = t.replace(old, new)
        out[name] = t
    return out


def build(tag: str, source: str, text: str):
    """Start nvcc on one variant; returns (process, path of the library)."""
    d = os.path.join(OUT, tag)
    os.makedirs(d, exist_ok=True)
    src = os.path.join(d, source)
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(d, "lib.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    proc = subprocess.Popen([nvcc, *FLAGS, "-o", so, src], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, so


def ptxas(stderr: str, pattern) -> list:
    rows, name = [], None
    for line in stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "Used" in line and "registers" in line and pattern(name):
            regs = int(line.split("Used ")[1].split(" registers")[0])
            rows.append((name, regs))
        elif name and "spill stores" in line and pattern(name):
            rows.append((name, line.strip()))
    return rows


def time_ms(fn, samples: int, per: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / per)
    return statistics.median(ts)


def in_turns(calls: dict, samples: int, per: int) -> dict:
    names = list(calls)
    res = {n: [] for n in names}
    for _ in range(2):
        for n in names + names[::-1]:
            res[n].append(time_ms(calls[n], samples, per))
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    flash_src = variants("flash_bwd.cu", FLASH)
    rms_src = variants("rmsnorm.cu", RMSNORM)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash import flash_attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    jobs = {("flash", n): build(f"flash_{n}", "flash_bwd.cu", t) for n, t in flash_src.items()}
    jobs.update({("rms", n): build(f"rms_{n}", "rmsnorm.cu", t) for n, t in rms_src.items()})
    _build.library()
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for (kind, name), (proc, so) in jobs.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode:
            print(err[-4000:], file=sys.stderr)
            return 1
        if kind == "flash":
            pick = lambda k: "IfLi128ELb0E" in k or "IfLi112ELb0E" in k  # noqa: E731
        else:
            pick = lambda k: "rmsnorm_bwd_kernelIffLi4E" in k  # noqa: E731
        for kernel, what in ptxas(err, pick):
            short = kernel.split("flash_bwd_")[-1][:24] if kind == "flash" else "bwd <fp32, 4>"
            print(f"ptxas {kind} {name} {short}: {what}", flush=True)
        lib = ctypes.CDLL(so)
        if kind == "flash":
            lib.rt_flash_attention_bwd.argtypes = [p] * 11 + [i] * 8 + [f, i, p]
        else:
            lib.rt_rmsnorm_bwd.argtypes = [p] * 6 + [i, i, i, f, i, i, p]
            lib.rt_rmsnorm_bwd_blocks.argtypes = [i]
        libs[kind, name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  check=True).stdout.strip().splitlines()[0]}

    def flash_call(lib, q, k, v, o, lse, do):
        B, S, Hq, h = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        scratch = torch.empty((B, Hq, S), device="cuda")
        rc = lib.rt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), None, scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, S, Hq, k.shape[2], h, 1, 0, 1.0 / math.sqrt(h), 0, stream)
        assert rc == 0, rc
        return dq, dk, dv

    for B, S, Hq, Hkv, h in ((4, 2048, 32, 8, 128), (1, 8192, 8, 2, 128)):
        q, do = (torch.randn(B, S, Hq, h, device="cuda", generator=gen) for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, h, device="cuda", generator=gen) for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
        leaves = [t[:1].double().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention_ref(*leaves, causal=True), leaves,
                                   do[:1].double())
        gmax = max(w.abs().max().item() for w in want)
        del leaves
        errs = {}
        for name in FLASH:
            got = flash_call(libs["flash", name], q, k, v, o, lse, do)
            errs[name] = [(g[:1].double() - w).abs().max().item() / gmax
                          for g, w in zip(got, want)]
            print(f"flash {name} {(B, S, Hq, Hkv, h)}: err of max|g| (dq, dk, dv) "
                  f"{errs[name]}", flush=True)
        out[f"flash_err_{S}"] = errs
        del want
        if S == 2048:
            out["flash_ms"] = in_turns(
                {n: (lambda lib=libs["flash", n]: flash_call(lib, q, k, v, o, lse, do))
                 for n in FLASH}, 10, 2)
            print(f"flash ms: {out['flash_ms']}", flush=True)
        del q, do, k, v, o, lse
        torch.cuda.empty_cache()

    rows, D = 8192, 4096
    x, dy = (torch.randn(rows, D, device="cuda", generator=gen) for _ in range(2))
    scale = torch.linspace(0.5, 1.5, D, device="cuda")
    calls = {}
    for name in RMSNORM:
        lib = libs["rms", name]
        nb = lib.rt_rmsnorm_bwd_blocks(rows)
        part = torch.empty(nb, D, device="cuda")
        dx, ds = torch.empty_like(x), torch.empty_like(scale)

        def call(lib=lib, nb=nb, part=part, dx=dx, ds=ds):
            rc = lib.rt_rmsnorm_bwd(x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                                    dx.data_ptr(), ds.data_ptr(), part.data_ptr(), rows, D,
                                    nb, 1e-5, 0, 0, stream)
            assert rc == 0, rc
        calls[name] = call
    out["rmsnorm_bwd_ms"] = in_turns(calls, 25, 5)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
