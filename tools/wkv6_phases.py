#!/usr/bin/env python3
"""Where the chunked WKV6 kernel's time goes, by phase, on one card.

    python3 tools/wkv6_phases.py            # on a machine with the card and nvcc

It copies ``src/repro_torch/kernels/csrc/wkv6.cu`` into ``build/wkv6_phases/``
with ``clock64()`` stamps added, taken by lane 0 of every warp at four
points of every chunk: after the top barrier (and the next chunk's copies
issued), and when the warp has done phase 1, phase 2 and phase 3 (each
before the barrier that ends the phase).  It builds that copy with nvcc
(the port's flags, plain C interface), runs it at rwkv6-1.6b's prefill
shape (B = 8, S = 512, H = 32, K = V = 64, fp32, a state written in place)
with sub-chunks of 8 rows (what ``rt_wkv6`` runs) and of 16 (the kernel is
templated on the sub-chunk; the copy adds an entry that launches it at
<fp32, 64, 64, 16>), and prints, in SM cycles per chunk
(mean over blocks and chunks), each phase's span from the last warp done
with the one before to the last warp done with it, each warp's own time
in phases 2 and 3, and the wait at the top of a chunk (the copies and the
barrier).  Then it times both, with the stamps, by CUDA events in turns
(8, 16, 16, 8; the median of 25 samples of 5 launches back to back).  The
stamps cost a few instructions a chunk; the kernel's own time is
``chip_smoke.py``'s.

The stamps go in by exact-text edits of wkv6.cu (``EDITS``): a change to
the kernel's text there must be carried into ``EDITS``.  Where one no
longer matches, the tool names it and exits with 1, before building
anything.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "wkv6_phases")

STAMP = ("#define STAMP(p) do { if ((threadIdx.x & 31) == 0) stamps[(((size_t)(blockIdx.y "
         "* gridDim.x + blockIdx.x) * 64 + n) * 8 + (threadIdx.x >> 5)) * 4 + (p)] = "
         "clock64(); } while (0)")
# (text in wkv6.cu, what replaces it)
EDITS = [
    ("T* __restrict__ y, float* sf, int S, int H) {",
     "T* __restrict__ y, float* sf, int S, int H, long long* stamps) {\n" + STAMP),
    ("      cp_async_commit();\n    } else {", "      cp_async_commit();\n      STAMP(0);\n    } else {"),
    ("    __syncthreads();\n\n    // ---- phase 2", "    STAMP(1);\n    __syncthreads();\n\n    // ---- phase 2"),
    ("    __syncthreads();\n\n    // ---- phase 3", "    STAMP(2);\n    __syncthreads();\n\n    // ---- phase 3"),
    ("          st4f(p, s);\n        }\n      }\n    }\n", "          st4f(p, s);\n        }\n      }\n    }\n    STAMP(3);\n"),
    ("      s0, static_cast<T*>(y), sf, S, H);", "      s0, static_cast<T*>(y), sf, S, H, g_stamps);"),
    ("namespace {\n", "namespace {\nlong long* g_stamps = nullptr;\n"),
]


PROBE = """
extern "C" void probe_set(void* p) { g_stamps = static_cast<long long*>(p); }
extern "C" int probe_wkv6_sub16(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* s0, void* y, void* sf, int B,
                                int S, int H, void* stream) {
  return launch<float, 64, 64, 16>(r, k, v, static_cast<const float*>(w),
                                   static_cast<const float*>(u),
                                   static_cast<const float*>(s0), y,
                                   static_cast<float*>(sf), B, S, H,
                                   static_cast<cudaStream_t>(stream));
}
"""


def build() -> str | None:
    src = open(os.path.join(CSRC, "wkv6.cu")).read()
    for old, new in EDITS:
        if src.count(old) != 1:
            print(f"wkv6_phases: wkv6.cu no longer has exactly one {old!r}; carry the "
                  f"change into EDITS", file=sys.stderr)
            return None
        src = src.replace(old, new)
    src += PROBE
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "wkv6_phases.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(OUT, "libwkv6_phases.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-shared",
                    "-Xcompiler", "-fPIC", "-I", CSRC, "-o", so, cu,
                    os.path.join(CSRC, "runtime.cu")], check=True)
    return so


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("wkv6_phases: no CUDA device", file=sys.stderr)
        return 2
    so = build()
    if so is None:
        return 1
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_wkv6.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.rt_wkv6.restype = i
    lib.probe_wkv6_sub16.argtypes = [p] * 8 + [i] * 3 + [p]
    lib.probe_wkv6_sub16.restype = i
    lib.probe_set.argtypes = [p]
    B, S, H, K = 8, 512, 32, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = (torch.randn(B, S, H, K, device="cuda", generator=g) for _ in range(3))
    w = -torch.exp(torch.randn(B, S, H, K, device="cuda", generator=g) * 0.5)
    u = torch.randn(H, K, device="cuda", generator=g) * 0.1
    st = torch.randn(B, H, K, K, device="cuda", generator=g)
    y = torch.empty_like(v)
    stamps = torch.zeros(B * H * 64 * 8 * 4, dtype=torch.int64, device="cuda")
    lib.probe_set(stamps.data_ptr())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"card": card, "shape": [B, S, H, K, K]}
    ptrs = [t.data_ptr() for t in (r, k, v, w, u, st, y, st)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch(sub):
        if sub == 8:
            rc = lib.rt_wkv6(*ptrs, B, S, H, K, K, 0, stream)
        else:
            rc = lib.probe_wkv6_sub16(*ptrs, B, S, H, stream)
        if rc != 0:
            raise SystemExit(f"wkv6_phases: launch failed ({rc})")

    def time_ms(sub, samples=25, per_sample=5):
        times = []
        for _ in range(samples):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_sample):
                launch(sub)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / per_sample)
        return float(np.median(times))

    for sub in (8, 16):
        for _ in range(5):
            launch(sub)
        torch.cuda.synchronize()
        a = stamps.view(B * H, 64, 8, 4)[:, :S // 32].cpu().numpy().astype(np.float64)
        top = a[..., 0].max(2)
        done = [a[..., j] for j in (1, 2, 3)]
        last = [d.max(2) for d in done]
        res = {"phase1": float((last[0] - top).mean()),
               "phase2": float((last[1] - last[0]).mean()),
               "phase3": float((last[2] - last[1]).mean()),
               "top_wait": float((top[:, 1:] - last[2][:, :-1]).mean()),
               "chunk": float(((last[2][:, -1] - a[:, 0, :, 0].min(1)) / (S // 32)).mean()),
               "phase2_by_warp": [float((done[1][..., j] - last[0]).mean()) for j in range(8)],
               "phase3_by_warp": [float((done[2][..., j] - last[1]).mean()) for j in range(8)]}
        out[f"sub{sub}"] = res
        print(f"sub-chunks of {sub}: cycles a chunk: phase 1 {res['phase1']:.0f}, phase 2 "
              f"{res['phase2']:.0f}, phase 3 {res['phase3']:.0f}, top wait {res['top_wait']:.0f}; "
              f"a chunk in all {res['chunk']:.0f}", flush=True)
        print("  phase 2 by warp " + " ".join(f"{x:.0f}" for x in res["phase2_by_warp"])
              + "; phase 3 by warp " + " ".join(f"{x:.0f}" for x in res["phase3_by_warp"]))
    ms = {8: [], 16: []}
    for sub in (8, 16, 16, 8):          # in turns, on the one card
        ms[sub].append(time_ms(sub))
    out["ms"] = {str(sub): t for sub, t in ms.items()}
    print(f"ms a launch (with the stamps), median of 25 samples of 5 back to back, in turns: "
          f"sub-chunks of 8 {ms[8]}, of 16 {ms[16]}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
