#!/usr/bin/env python3
"""The RMSNorm forward kernel's design choices, measured on one card.

    python3 tools/rmsnorm_fwd_variants.py     # on a machine with the card and nvcc

It writes variants of ``src/repro_torch/kernels/csrc/rmsnorm.cu`` into
``build/rmsnorm_fwd_variants/`` by edits of its forward constants and code
(each must match the source once), builds each alone with nvcc (the port's
flags, ``-Xptxas -v``, plain C interface), prints what ptxas reports for
its fp32 forward instantiations, holds each variant within 1e-5 of the
plain version at every shape, then times each at every (rows, D) fp32 of
``call_cost.RMSNORM_SHAPES`` by its device time (``call_cost.device_ms``:
60 calls, each on another x and y of a rotation larger than the L2), the
variants in turns, forward and back, twice.  Variants:

  * ``source``: the kernel as it is: a warp a row (a persistent grid) fed
    by the ring of bulk copies (TMA) where a lane holds one vector of a
    row, by registers above; a block a row, as many blocks as rows;
  * ``narrow_regs``, ``narrow_ring``: the warp-a-row path fed by registers
    (the next rows loaded into a second set before the current ones are
    reduced), or by the ring, at every width;
  * ``ring_2``, ``ring_16k``: ``narrow_ring`` with 2 stages, or with stages
    of 16 KB, in place of 3 stages of 32 KB;
  * ``narrow_row_blocks``: ``narrow_regs`` without the persistent grid (a
    block for each 8 warps' rows);
  * ``wide_persistent``: the block-a-row path on a persistent grid (as
    many blocks as fit, block b taking rows b, b + gridDim.x, ...);
  * ``stream``: y stored with the streaming cache hint (``st.global.cs``);
  * ``wide_nv``, ``wide_256``: the block-a-row path holding the fewest
    vectors a thread that cover the row with 256 threads (3 at D = 3072, 7
    at 7168), in a block cut to the vectors' warps or of 256 threads.

It prints a line a shape (each variant's median over the four turns) and
one JSON line: ``ptxas`` by variant, ``max_abs_err`` by variant and shape,
``ms`` by shape and variant (the four turns' device times), ``bound_ms`` by
shape and the card.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "rmsnorm_fwd_variants")
FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC]
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from call_cost import HBM_BYTES_PER_S, RMSNORM_SHAPES, ROTATE_BYTES, device_ms  # noqa: E402

PATTERNS = {"ring_max_nv": r"constexpr int kRingMaxNV = \d+;",
            "stages": r"constexpr int kRingStages = \d+;",
            "stage_bytes": r"constexpr int kStageBytes = [^;]+;"}

# code edits (each must match the source once): the warp-a-row path
# without the persistent grid (a block for each 8 warps' rows); the
# block-a-row path with one (as many blocks as fit, each taking rows b,
# b + gridDim.x, ...); y stored with the streaming cache hint
NARROW_ROW_BLOCKS = [("    const int nblocks0 = units < fit ? units : fit;",
                      "    const int nblocks0 = units;")]
_LAUNCH = "  kernel<<<nblocks, threads, smem, stream>>>(static_cast<const T*>(x),"
WIDE_PERSISTENT = [(_LAUNCH, "  if (!WARP_ROWS) {\n    const int fit = blocks_per_sm("
                    "reinterpret_cast<const void*>(kernel), threads, 0) * sm_count();\n"
                    "    if (nblocks > fit) nblocks = fit;\n  }\n" + _LAUNCH)]
STREAM = [("            yv[static_cast<size_t>(g + k) * nvec + c] = o;",
           "            __stcs(reinterpret_cast<float4*>(yv + static_cast<size_t>(g + k) * nvec"
           " + c), reinterpret_cast<const float4&>(o));")]
# the block-a-row path's vectors a thread: the fewest that cover the row with
# 256 threads (3 at D = 3072, 7 at 7168), its block cut to the vectors' warps
# (WIDE_NV) or kept at 256 threads (WIDE_256)
_WIDE = """  const int nv = nvec <= 2 * kMaxThreads ? 2 : nvec <= 4 * kMaxThreads ? 4 : 8;
  const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
  switch (nv) {
    case 2: return run<T, S, 2, false, kRegs>(RT_ARGS, threads, stream);
    case 4: return run<T, S, 4, false, kRegs>(RT_ARGS, threads, stream);
    default: return run<T, S, 8, false, kRegs>(RT_ARGS, threads, stream);
  }
"""
_WIDE_ANY = """  const int nv = (nvec + kMaxThreads - 1) / kMaxThreads;
  const int threads = %s;
  switch (nv) {
    case 2: return run<T, S, 2, false, kRegs>(RT_ARGS, threads, stream);
    case 3: return run<T, S, 3, false, kRegs>(RT_ARGS, threads, stream);
    case 4: return run<T, S, 4, false, kRegs>(RT_ARGS, threads, stream);
    case 5: return run<T, S, 5, false, kRegs>(RT_ARGS, threads, stream);
    case 6: return run<T, S, 6, false, kRegs>(RT_ARGS, threads, stream);
    case 7: return run<T, S, 7, false, kRegs>(RT_ARGS, threads, stream);
    default: return run<T, S, 8, false, kRegs>(RT_ARGS, threads, stream);
  }
"""
WIDE_NV = [(_WIDE, _WIDE_ANY % "((nvec + nv - 1) / nv + 31) / 32 * 32")]
WIDE_256 = [(_WIDE, _WIDE_ANY % "kMaxThreads")]

VARIANTS = {"source": {},
            "narrow_regs": {"ring_max_nv": "constexpr int kRingMaxNV = 0;"},
            "narrow_ring": {"ring_max_nv": "constexpr int kRingMaxNV = 8;"},
            "ring_2": {"ring_max_nv": "constexpr int kRingMaxNV = 8;",
                       "stages": "constexpr int kRingStages = 2;"},
            "ring_16k": {"ring_max_nv": "constexpr int kRingMaxNV = 8;",
                         "stage_bytes": "constexpr int kStageBytes = 16 * 1024;"},
            "narrow_row_blocks": {"ring_max_nv": "constexpr int kRingMaxNV = 0;",
                                  "code": NARROW_ROW_BLOCKS},
            "wide_persistent": {"code": WIDE_PERSISTENT},
            "stream": {"code": STREAM},
            "wide_nv": {"code": WIDE_NV}, "wide_256": {"code": WIDE_256}}


def variant_text(text: str, edits: dict) -> str:
    """The source with a variant's constants set and its code edits made
    (each must match once, or the tool exits with 1)."""
    for key, new in edits.items():
        for old, repl in new if key == "code" else [(PATTERNS[key], new)]:
            text, n = (re.subn(old, repl, text) if key != "code"
                       else (text.replace(old, repl), text.count(old)))
            if n != 1:
                print(f"rmsnorm_fwd_variants: {old[:60]!r} matches the source {n} times",
                      file=sys.stderr)
                sys.exit(1)
    return text


def build(name: str, text: str):
    """Start nvcc on one variant; returns (process, path of the library)."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    src = os.path.join(d, "rmsnorm.cu")
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(d, "lib.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    proc = subprocess.Popen([nvcc, *FLAGS, "-o", so, src], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, so


def fp32_forward_ptxas(stderr: str) -> dict:
    """{"<NV>/<warp|block>/<regs|ring>": "registers, spills"} of the fp32
    forward instantiations."""
    out, name = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"rmsnorm_kernelIffLi(\d+)ELb([01])ELi([01])E", m.group(1))
            name = (f"{k.group(1)}/{'warp' if k.group(2) == '1' else 'block'}/"
                    f"{'ring' if k.group(3) == '1' else 'regs'}") if k else None
        elif name and "spill stores" in line:
            out[name] = line.strip()
        elif name and "Used" in line and "registers" in line:
            out[name] = f"{out.get(name, '')}; {line.strip()}"
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("rmsnorm_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(CSRC, "rmsnorm.cu")) as f:
        text = f.read()
    jobs = {name: build(name, variant_text(text, edits)) for name, edits in VARIANTS.items()}
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import ref

    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs, out = {}, {"ptxas": {}, "max_abs_err": {}, "ms": {}, "bound_ms": {}}
    for name, (proc, so) in jobs.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode:
            print(err[-4000:], file=sys.stderr)
            return 1
        out["ptxas"][name] = fp32_forward_ptxas(err)
        lib = ctypes.CDLL(so)
        lib.rt_rmsnorm.argtypes = [p, p, p, i, i, fl, i, i, p]
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for rows, D in RMSNORM_SHAPES:
        key = f"{rows}x{D}"
        nbytes = 2 * rows * D * 4
        nbuf = max(1, -(-ROTATE_BYTES // nbytes))
        xs = [torch.randn((rows, D), generator=gen, device="cuda") for _ in range(nbuf)]
        ys = [torch.empty_like(xs[0]) for _ in range(nbuf)]
        scale = torch.linspace(0.5, 1.5, D, device="cuda")
        want = ref.rmsnorm_ref(xs[0], scale)
        calls, turn = {}, [0]
        for name, lib in libs.items():
            def call(lib=lib):
                j = turn[0] = (turn[0] + 1) % nbuf
                rc = lib.rt_rmsnorm(xs[j].data_ptr(), scale.data_ptr(), ys[j].data_ptr(), rows,
                                    D, 1e-5, 0, 0, stream)
                assert rc == 0, rc
            turn[0] = nbuf - 1
            call()
            torch.cuda.synchronize()
            err = (ys[0] - want).abs().max().item()
            out["max_abs_err"].setdefault(name, {})[key] = err
            if not err <= 1e-5:
                print(f"rmsnorm_fwd_variants: {name} at {key}: max abs err {err}",
                      file=sys.stderr)
                return 1
            calls[name] = call
        names = list(calls)
        out["ms"][key] = {n: [] for n in names}
        for _ in range(2):
            for n in names + names[::-1]:
                out["ms"][key][n].append(device_ms(calls[n], "rmsnorm_kernel", 60))
        out["bound_ms"][key] = (nbytes + D * 4) / HBM_BYTES_PER_S * 1e3
        print(key, {n: round(statistics.median(t), 5) for n, t in out["ms"][key].items()},
              f"bound {out['bound_ms'][key]:.5f}", flush=True)
        del xs, ys, want
        torch.cuda.empty_cache()
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
