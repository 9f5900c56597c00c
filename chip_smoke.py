#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repo root, on a machine with a card

Phases, each of which exits non-zero on a failed check:
  1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
  2. the build of the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     sm_90a), timed; what ptxas reports (one nvcc a source, all started at
     once beside the build's) for flash attention's fp32 forward
     instantiations at h = 80, 112 and 128 (with and without lse and
     ALiBi), for the SSD backward kernel at both of its (P, N) and its
     group sum, and for every instantiation
     of both backward kernels (each dtype and head dim, ALiBi's fp32 ones;
     each beside its dynamic shared memory), for every instantiation of
     the RMSNorm forward, for the RMSNorm backward's fp32 register-path
     instantiations, for the SSD kernels' at P = N = 64
     and for the WKV6 kernels' at K = V = 64 (registers, spills, which fail
     the run but for the half types' flash dK/dV kernel at h = 128, held
     within ``FLASH_BWD_SPILL_CAP``) beside the shared memory of their layouts and the blocks per
     SM that these allow, and for the chunked scans' other fp32
     instantiations;
  3. kernel parity: each kernel (RMSNorm, flash attention at h = 128 and at
     zamba2's h = 112, the SSD and WKV6 scans at prefill lengths 512 and 500
     and at decode's 1; SSD with x, B and C as views of one conv-output
     buffer with one group, as the Mamba2 block passes them, head-expanded,
     and writing its state in place; WKV6 writing its state in place and at
     strong decays) against its plain PyTorch version on the card (the scans
     also against their step oracles in fp64, within 2e-5 of max|y|, which
     one TF32 product per chunk product in SSD would not meet), and
     its time (CUDA events; for the scans and the RMSNorm forward, the
     kernel's device time from the profiler, since a decode step's kernel
     is shorter than its host call, with the call's time beside it; the
     RMSNorm forward's inputs rotated past the L2, and also at D = 128,
     2048, 3072, 3584 and 7168) beside the plain version, one PyTorch library call that
     computes the same function where there is one (a yardstick only, never
     used by the port; SDPA pinned to its memory-efficient backend, so it
     raises rather than fall back to the math path; ``F.rms_norm`` by its
     device time) and the least time the
     card could take (bytes over
     3.35 TB/s or operations over the peak rate of their type, whichever is
     larger; the fp32 products of flash and of SSD's chunked kernel are
     fp32-exact on the tensor cores as 3 TF32 products at 495 TFLOP/s, and
     their bound on the CUDA cores' 67 TFLOP/s is printed beside it); and
     the two backward kernels, which the TPU kernels do not have (RMSNorm's
     and flash attention's, each with ptxas's report and its time split
     by kernel from the profiler), against
     autograd of the plain versions in fp64 on the card, timed at
     llama3-8b's training shapes (8192 x 4096 rows; B = 4, S = 2048) beside
     the plain versions' backward, a library call's backward (autograd of
     ``F.rms_norm``; SDPA's efficient backend, forward and backward less
     forward) and their bounds (bytes; five products as 3xTF32 at
     495 TFLOP/s, the rate of the backward's tensor-core products); and
     flash forward and backward at the heads a rank of llama3-8b's
     tensor-parallel 1x4 placement runs (B 4, S 2048, 8 query over 2 KV
     heads, h 128), each against its plain version, beside SDPA's efficient
     backend and its bound, entries of their own in the kernels line;
  4. serving, one model at a time, each freed before the next: ``llama3-8b``
     (eight ragged prompts of 384-512 tokens), ``zamba2-7b`` and
     ``rwkv6-1.6b`` (eight prompts of 512 tokens: the recurrent families need
     equal lengths), each at full width and depth in fp32 with random
     weights, 32 new tokens, through ``repro_torch.serving.make_engine``; the
     kernels' launch counters are set to 0 just before each served batch and
     read just after, and must equal the counts from the code;
  5. slice parity, per model: a cut-depth model at full width (llama3-8b at
     2 layers, zamba2-7b at 7, which keeps one shared-block application and
     a tail layer, rwkv6-1.6b at 2) serves the same prompts through the
     kernels and through ``backend="ref"``; the teacher-forced logits must
     agree within 1e-3 absolute;
  6. the plan: the port tunes llama3-8b at full size under fsdp:8 and tp:8
     (seq 2048, global batch 16) for a40-nvlink (method lagom) and for
     h100-sxm, each tune's host wall time printed; the a40-nvlink plans must
     reproduce the reference's lowered ``plan_digest`` and tuned configs
     (stored below as sha256 constants, which a CPU test holds equal to what
     the reference computes); both plans go through JSON and back, the fsdp
     plan is activated as the base plan and the tp plan used under
     ``applied()``, where every ``tp.layer{i}.mlp.ag|rs`` site must resolve to
     the tp plan's lowered knobs and, outside, to the base plan's; the
     linter's findings are printed; and bf16 ``torch.matmul`` is timed at the
     tp:8 workload's GEMM shapes, its achieved share of the 989.4 TFLOP/s
     peak printed beside the h100-sxm profile's ``gemm_eff``.
  7. plans drive the collectives, on phase 4's llama3-8b weights before
     they are freed, over a 1-rank NCCL process group (a failed init fails
     the run); ``ring_ag_matmul``,
     ``mm_reduce_scatter``, ``chunked_all_to_all`` and
     ``psum_tree_chunked`` at llama3-8b's MLP shapes (4096 rows, d_model
     4096, d_ff 14336) with 1, 2 and 4 chunks over it, each against its
     ``*_ref`` within the reference's bounds and timed beside the plain
     product; then llama3-8b served at full size on that mesh through
     ``make_engine(..., plan=...)`` under plan (a), tuned by the port for
     tp:8 decode (batch 8, seq 1024) on h100-sxm, and plan (b), which
     chunks layer 0's and layer 1's gate/up ring by 2 and 4, beside the
     unplanned engine in turns: prefill and decode times, the
     teacher-forced logits' difference from the unplanned engine (within
     1e-4), whether the tokens are equal, the issued structure by site
     and the ``CollectiveDegradedWarning`` count; the kernels' launches
     are counted on each planned batch.
  8. training: llama3-8b at full width and 4 layers (fp32 AdamW keeps
     16 B a parameter: 128 GB at 32 layers), fp32, batch 4 x seq 2048 from
     the port's ``SyntheticCorpus``, remat, ``warmup_cosine``: three steps
     each of plain, ``grad_accum=2``, ``microbatches=2`` and ACCO
     (``grad_accum=2`` over the 1-rank NCCL group, under a plan the port
     tunes for fsdp:8 with two accumulation steps on h100-sxm; only its
     ``acc.step{k}.rs_grads`` sites issue): step time, tokens/s, MFU
     against the fp32 and the bf16 peak, peak memory, loss and grad_norm,
     and the kernels' launches, which must equal the counts from the code
     (forward, remat recompute, backward); every parameter must move; a
     profiler trace of one plain step by kernel class; then, at 2 layers,
     B = 1, S = 512, one step through the kernels, one through
     ``backend="ref"`` and one through the sited trunk on the 1-rank group
     under that plan, each held to the first: updated parameters within
     1e-4, AdamW's ``mu`` within 1e-4 of its max per parameter, loss and
     grad_norm within 1e-5 relative.
  9. the training launcher: ``repro_torch.launch.train.main`` with a run
     config (llama3-8b at full width, 2 layers, seq 2048, batch 4, 3
     steps, phase 8's lr), ``--mesh 1x1`` over the 1-rank NCCL group (the model
     placed on it: every FSDP gather runs, and must issue no collective),
     ``--tuned-plan`` the tp:8 plan the port tunes for h100-sxm, and ``--ckpt``: step time,
     tokens/s, peak memory, the checkpoint's write and read seconds; gated
     on finite losses, every parameter moving, the kernels' launches and
     each site's forward and backward ``Issued`` rows equal to the code's,
     and no placement all-reduce (attention's, the vocabulary's) issued on
     the model axis of one rank;
     the checkpoint restored by ``train.checkpoint`` must equal the trained
     parameters, also past a torn newer step; then one sited forward and
     backward of the model placed on the 1-rank (data, model) mesh, through
     the collectives' backwards, beside the unsited one from the same
     weights (B = 1, S = 2048): the loss and every gradient within 1e-5 (of
     max|g|), no placement all-reduce, its flash launches counted for the
     1x4-rank entries of phase 3 (at the 1-rank group's 32/8 heads: the
     same instantiations, fp32, h 128, causal, with lse).  On one rank
     nothing is split over ``model``, so this phase runs none of the
     placement's split code (a rank's heads, the vocabulary-parallel
     embedding and loss, the all-reduces): that runs only on four cards,
     in ``tools/four_rank_check.py``.
  10. the MoE family: the kernels at the path's new shapes against their
     plain versions (RMSNorm over qk_norm's rows of head_dim 128, forward
     and backward; flash attention at a GQA group of 1, Hq = Hkv = 16,
     h = 128, forward timed, backward against autograd in fp64);
     ``olmoe-1b-7b`` served at full width and all 16 layers with phase
     4's prompts, as phase 4 serves (launches equal to the code's; the
     profile gives the MoE dispatch and combine a class of their own);
     then on the 1-rank NCCL group under plan (a), the port's tune of its
     ep:8 decode workload for h100-sxm, and plan (b), which chunks layer
     0's and layer 1's dispatch by 2 and 4, beside the unplanned engine in
     turns: teacher-forced logits within 1e-4, each
     ``serve.layer{i}.moe.a2a_*`` site's ``Issued`` rows at its plan's
     chunk count; slice parity of olmoe-1b-7b at 2 layers and
     ``deepseek-moe-16b`` at 4 (full width) against ``backend="ref"``
     within 1e-3, the plain run replaying the kernels' routing
     (``layers.record_routing``: two candidate experts' probabilities can
     differ by less than the runs' rounding; the choices the plain run
     makes differently on its own are printed); one training step of
     olmoe-1b-7b at 2 layers (B = 1, S = 512) against ``backend="ref"``
     and the sited trunk under a plan of 1, 2 and 4 chunks, phase 8's
     parity bounds.
  11. the dense families: the flash kernel's new variants against their
     plain versions, each timed beside SDPA's efficient backend (with
     ``is_causal`` where the mask is causal only, else the equivalent
     float mask) and bounded by the pairs inside the mask (head dim 80 at
     phi2-2b's prefill, B 8, S 512, 32/32 heads; ALiBi at mpt-7b's, h 128;
     a window of 256 at S 2048 on h2o-danube's 32/8 heads, h 80; and
     h2o-danube's served prefill, S 4080 under its window of 4096, at
     B 2); ``phi2-2b`` (parallel block, GELU with biases), ``mpt-7b``
     (ALiBi), ``phi4-mini-3.8b``, ``stablelm-3b`` and ``h2o-danube-1.8b``
     served at full width and depth as phase 4 serves (h2o-danube over
     eight prompts of 4064-4080 tokens at max_seq 4160, so decode wraps its
     4096-slot ring), launches equal to the code's (none of RMSNorm in the
     LayerNorm models); phi2-2b under plan (b) on the 1-rank NCCL group
     beside the unplanned engine (logits within 1e-4, layer 0 and 1 at
     their chunks); slice parity of each at 2 layers against
     ``backend="ref"`` within 1e-3, and of h2o-danube with its window cut
     to 256 over prompts of 200-256 tokens, so its ring wraps there too.
  12. the dense families' training: the flash backward's new variants from
     the forward's o and lse, each against autograd of the plain version in
     fp64 within 1e-4 of max|g| (with o and lse), timed beside the plain
     version's backward, SDPA's efficient backward (``is_causal`` where the
     mask is causal only, else the equivalent float mask) and five products
     over the pairs inside the mask at the 3xTF32 rate: head dim 80 at
     phi2-2b's training shape (B 4, S 2048, 32/32 heads), ALiBi at mpt-7b's
     (h 128), a window of 256 at S 2048 on h2o-danube's 32/8 heads, and
     danube's window of 4096 at its training shape, B 2, S 8192 (held on
     KV head 0's group: fp64 scores of all heads take 34 GB); then each
     family at full width trained for three plain steps as phase 8 trains
     (``phi2-2b`` at all 32 layers, B 4 x S 2048; ``h2o-danube-1.8b`` at all
     24, B 2 x S 8192, its window masking keys in both backward kernels,
     with a profiler trace of a fourth step by kernel class; ``mpt-7b``,
     ``phi4-mini-3.8b``, ``stablelm-3b`` at 4 layers): step time, tokens/s,
     MFU, peak memory, loss and grad_norm, gated on finite losses, every
     parameter moving and launches equal to the code's (no RMSNorm in the
     LayerNorm models); then one step of each at 2 layers (B 1, S 512, and
     h2o-danube also with its window cut to 256) against ``backend="ref"``
     within phase 8's parity bounds.
  13. the pipeline: the kernels at yi-34b's shapes against their plain
     versions, timed beside them, the library call and their bounds
     (RMSNorm forward and backward at (8192, 7168), where the backward takes
     its 8-vector register path, whose ptxas report is printed; flash
     forward and backward at B 4, S 2048, 56 query heads over 8 KV heads, a
     GQA group of 7, h 128, causal); then ``yi-34b`` at full width cut to 2
     layers (seed 0, B 4 x S 2048 from the port's ``SyntheticCorpus``, M 4,
     remat) through ``models.model.pipeline_loss`` on a stage mesh of the
     1-rank NCCL group (one stage: no transfer is issued), its loss within
     1e-5 relative and every gradient within 1e-4 of its max|g| of the
     unpipelined ``loss_and_metrics`` on the same weights and batch; the
     kernels' launches equal to the code's (each microbatch's layers as a
     train pass, the final norm once), forward and backward ms pipelined
     and not, peak memory and a profile by kernel class;
  14. analysis: phase 6's fsdp:8 and tp:8 plans for h100-sxm saved as JSON
     and judged by ``python -m repro_torch.analysis verify-overlap`` in a
     subprocess (exit 0, every site MATERIALIZED over the fake world of 8
     ranks) and the ``install=False`` control (every site ABSENT);
     ``trace_and_verify(..., profile=True)`` of phase 7's
     ``mm_reduce_scatter``, ``chunked_all_to_all`` and ``psum_tree_chunked``
     at 2 and 4 chunks on a 1-rank NCCL group, in a process of its own
     (in this one, after the phases' profiles, torch 2.11's profiler
     returned launches without device activity), each site MATERIALIZED in
     the record and the first two in the profile (on one rank the psum's
     in-place all-reduce runs nothing on the card, and the ring issues no
     hop, so neither is judged there), and, from a profile without the
     record, each call's NCCL device ms beside the ms of it under another
     kernel; and the dry run of llama3-8b's train_4k at 8 layers on the
     16 x 16 fake mesh (``python -m repro_torch.launch.dryrun``, which needs
     no card: started right after the build, it runs beside the phases), its
     record ``ok`` with ``grad_accum`` > 1 and its depth's parameter
     count, and the full depth's count from ``launch.specs`` held to the
     reference's;
  15. the other families, run right after phase 3 (early, where the
     profiler is fresh): flash against its plain version at whisper-small's
     shapes (h = 64: the encoder, full, over 1500 frames; the decoder's
     cached prefill, causal; cross-attention, full, from the prompt and
     from a decode step's one query to the 1500 frames) and qwen2-vl-72b's
     prefill (a GQA group of 8), RMSNorm at deepseek-v2-lite-16b's latent
     (D = 512) and qwen2-vl-72b's D = 8192, each timed beside the plain
     version, SDPA or ``F.rms_norm`` and its bound, entries of their own;
     then ``whisper-small`` (whole; frames from the seed),
     ``deepseek-v2-lite-16b`` (MLA, all 27 layers) and ``qwen2-vl-72b`` at
     full width and 8 of its 80 layers, served as phase 4 serves (the
     profile splits out MLA's plain attention by its ranges); one forward
     of qwen2-vl-72b with 256 image patches against ``backend="ref"``; and
     slice parity of each at 2 layers against ``backend="ref"``, tokens
     equal (the MoE routing of the kernels' run replayed) and logits within
     1e-3.
  16. the other families' training, right after phase 15 (its profiles
     before the long phases): the flash backward at whisper-small's
     training shapes (h = 64, B 8, 12/12 heads: the encoder, full, 1500 x
     1500; the decoder, causal, S 448; cross-attention, full, 448 x 1500)
     and at qwen2-vl-72b's (B 2, S 1024, 64/8 heads, h 128, causal), from
     the forward's o and lse against autograd of the plain version in fp64
     within 1e-4 of max|g|, timed beside the plain version's backward,
     SDPA's efficient backward (forward and backward less forward) and five
     products over the pairs inside the mask at the 3xTF32 rate; the
     RMSNorm backward at (8192, 512) (deepseek-v2-lite-16b's latent at B 4
     x S 2048), (8192, 2048) and (2048, 8192) (qwen2-vl-72b's at B 2 x S
     1024) against autograd of its plain version in fp64 within 1e-5 of
     max|g|, timed by its device time beside autograd of ``F.rms_norm``;
     then ``whisper-small`` whole (B 8 x S 448 over 1500 stub frames),
     ``deepseek-v2-lite-16b`` at 4 layers (1 dense + 3 MoE, B 4 x S 2048)
     and ``qwen2-vl-72b`` at 2 layers (B 2 x S 1024, 256 patches at the
     head of each row) trained three plain steps each as phase 12 trains
     (profiles of whisper's and qwen2-vl's fourth step by kernel class),
     gated on finite losses, every parameter moving and launches equal to
     the code's; one step of each at 2 layers (whisper's encoder too;
     B 1, S 512, with frames or patches) against ``backend="ref"``, the MoE
     routing replayed, within phase 8's parity bounds; flash forward and
     backward at a 1x4 rank's heads (whisper's 3/3: the encoder, the
     decoder, cross-attention; qwen2-vl-72b's 16/2), each held to its plain
     version, timed beside it, SDPA and its bound, their launches those of
     their shape class in the trained runs (the same instantiations at
     whole heads: a 1x4 rank's launches are ``tools/four_rank_check.py``'s
     to count); and, on phase 7's 1-rank NCCL group after phase 13,
     whisper (2 + 2 layers) and deepseek (2) placed by ``init_placed``, one
     step each against its unplaced step within phase 8's parity bounds,
     the placement issuing no collective of its own.  On a model axis of one
     rank every leaf stays whole, so these steps check the placed model's
     own glue (its mesh, its sites, the data axis's averages, ``dec_pos``
     read through ``_weight``), not the split by heads.
  17. the recurrent-training slice, right after phase 16: the SSD backward
     kernel (``csrc/ssd_bwd.cu``, which no TPU kernel has: the reference
     trains through ``jax.grad`` of its jnp scans) at zamba2-7b's training
     shape for one layer (B 4, S 2048, 112 heads, P = N = 64, one group, x,
     B and C views of one conv buffer), the very call it times held within
     1e-5 of each gradient's max|g| to fp64 autograd of the step oracle
     (batch element by batch element, dA and dD summed) and to the plain
     backward ``ref.ssd_chunked_bwd_ref`` in fp64; at S 500 and with an
     initial state and a final-state gradient through ``ops.ssd`` under
     grad (``SSDFn``), held to both; timed by its device time beside the
     plain version's backward (autograd of the chunked scan) and its bound
     (bytes at 3.35 TB/s, or its operations over the causal pairs at fp32
     as 3xTF32's 165 TFLOP/s, the card's fastest fp32-exact rate, as for
     the SSD forward; the bound on the fp32 CUDA cores it runs on, 67
     TFLOP/s, printed beside); no library call
     computes it; the flash backward at zamba2-7b's training shape (B 4, S
     2048, 32/32 heads, h 112), as phase 16 holds and times its shapes;
     ``zamba2-7b`` at full width and 13 layers (two shared-block
     applications and one tail layer, B 4 x S 2048, remat, fp32) trained
     three plain steps as phase 12 trains, gated on finite losses, every
     parameter moving and launches equal to the code's, a profile of a
     fourth step by kernel class with the SSD backward a class of its own;
     and one step at 7 layers (one group of six, the shared block, one
     tail layer; B 1, S 512) against ``backend="ref"`` (phase 12's
     ``family_train_parity``): its updated parameters and loss within phase
     8's parity bounds, and its gradients and grad_norm held to the plain
     versions' in fp64 within fixed limits (1e-3 of max|g|, 3e-5
     relative), the fp32 plain versions' distance printed beside, and a
     control, the kernels' step with TF32 on, that must miss them (at this
     depth the fp32 plain step is itself 3.0e-4 of max|g| from fp64, beyond
     the 1e-4 mu bound, so two fp32 steps cannot agree within it).
Each serving phase ends with a torch.profiler trace of the prefill and of
four decode steps: device time by kernel class beside the host's wall time.
Phases 7 to 13 share one 1-rank NCCL group from a ``FileStore``.  Then it
prints one ``{"plan": ...}`` line, one ``{"plan_serving": ...}`` line, one
``{"train": ...}`` line, one ``{"launch": ...}`` line, one ``{"moe": ...}``
line, one ``{"families": ...}`` line, one ``{"families_train": ...}`` line,
one ``{"pipeline": ...}`` line, one ``{"analysis": ...}`` line, one
``{"other_families": ...}`` line, one ``{"other_families_train": ...}``
line, one ``{"recurrent_train": ...}`` line, one ``{"kernels": [...]}`` line
(the flash kernels' instantiations of
phases 11 and 12, forward and backward at h = 80 and with ALiBi, as
entries of their own with the launches of the models that run them,
served and trained, which the base flash entries do not count again; the
h = 80 entries carry their window checks; phase 13's entries at yi-34b's
shapes carry the pipelined run's launches, phase 3's at a 1x4 rank's heads
those of phase 9's placed step at its 32/8 heads, the same instantiations,
since no phase here runs 8/2 heads; phase 15's entries carry the launches
of their shape class, as the wrappers count them (``ops.LAUNCHES_BY_SHAPE``),
in the runs of the models that run them, phase 16's training runs
included; phase 16's backward entries likewise, from its training runs;
phase 17's SSD backward and flash backward at h = 112, and the base
RMSNorm, flash forward and SSD entries, the launches of zamba2-7b's
trained run) and, last, the device line.
TF32 is off in every phase (fp32 matrix products run in full fp32).
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.analysis import errors, format_findings, lint_plan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ParallelPlan, TunedPlan, by_name,  # noqa: E402
                              extract_decode_workload, extract_workload,
                              parse_parallel, tune)
from repro_torch.core.apply import activate, plan_digest  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import work as _work  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.serving import make_engine  # noqa: E402

SEED = 0
ARCHS = ("llama3-8b", "zamba2-7b", "rwkv6-1.6b")
BATCH, MAX_NEW, MAX_SEQ = 8, 32, 1024
PROMPT_LENS = (384, 512)          # ragged prompt lengths, inclusive range
PARITY_LAYERS = {"llama3-8b": 2, "zamba2-7b": 7, "rwkv6-1.6b": 2}

# H100 SXM, NVIDIA data sheet (dense rates, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.float16: 989e12}
# fp32 work done fp32-exact on the TF32 tensor cores (495 TFLOP/s): three TF32
# products per fp32 product (3xTF32), as flash attention's kernel does it
FP32_AS_3XTF32 = "fp32 as 3xTF32"
PEAK_FLOPS[FP32_AS_3XTF32] = 495e12 / 3
# an SM of the H100: shared memory (1 KB of it kept per resident block),
# registers, threads
SM_SMEM, SM_SMEM_PER_BLOCK, SM_REGS, SM_THREADS = 228 * 1024, 1024, 65536, 2048

RMS_BOUND, RMS_BOUND_F32 = 2e-2, 1e-5     # the reference's bound; a tighter fp32 one
FLASH_BOUND = 1e-4                        # the reference's fp32 bound
SCAN_RTOL = 1e-3                          # the reference's fp32 bound for SSD and WKV6,
                                          # relative to max|y| (state: max(1, max|state|))
SSD_EXACT_RTOL = 2e-5                     # SSD against its plain version in fp64, as
                                          # SCAN_RTOL: the fp32-exact products err by
                                          # ~4e-6, one TF32 product per chunk product
                                          # by ~8e-4
WKV6_EXACT_RTOL = 2e-5                    # WKV6 against its step oracle in fp64, as
                                          # SSD_EXACT_RTOL: its exponents are sums over
                                          # the rows they span
SLICE_LOGITS_BOUND = 1e-3                 # kernels vs plain versions, cut depth, fp32
NO_LAUNCHES = {"rmsnorm": 0, "flash_attention": 0, "ssd": 0, "wkv6": 0, "rmsnorm_bwd": 0,
               "flash_attention_bwd": 0, "ssd_bwd": 0}
# the backward kernels against autograd of their plain versions in fp64 on
# the card, relative to max|g| (RMSNorm per gradient; flash over dq, dk, dv)
RMS_GRAD_BOUND, FLASH_GRAD_BOUND, HALF_GRAD_BOUND = 1e-5, 1e-4, 2e-2

# phase 6: llama3-8b's workloads (Lagom's Table 2 model; fsdp:8 at this shape
# is the reference's examples/quickstart.py workload)
PLAN_ARCH, PLAN_SEQ, PLAN_BATCH = "llama3-8b", 2048, 16
PLAN_WORKLOADS = {"fsdp:8": dict(kind="fsdp", dp=8), "tp:8": dict(kind="tp", tp=8)}
# What the reference (``repro.core``) gives for them on a40-nvlink with
# method="lagom": sha256 of its lowered plan_digest and of its tuned configs
# (``plan_fingerprint``), with the count of configs; ``artifact_digest`` is
# for information only (the traces carry floats from np.exp and np.log,
# whose last bits may differ on another CPU).  tests/test_torch_plan.py
# holds these equal to what the reference computes.
REFERENCE_A40_PLANS = {
    "fsdp:8": {
        "sites": 96,
        "configs": "c091449d795b08e19ae3e7a6f9507daea283a3408261f19bcfec91ccc68b0964",
        "plan_digest": "277aa903754e21ee95abcc26386bab67837327e07f5ed6d0b0f3559b042280d6",
        "artifact_digest":
            "6952439100ad467f81eec2d4963f630ed3bd2cc24b4764d74acad7196d0e206b",
    },
    "tp:8": {
        "sites": 256,
        "configs": "065f22feedaa6c44d1d90754edfa81cfed75246ece6da12d61cdf5f6858db189",
        "plan_digest": "1418cdcb1ada90ec808abde284cab743995d365cadb1aec24b2cf8a918bf14f6",
        "artifact_digest":
            "f0fb77a63068e57351a2acab61acf94aed79e0516e1115c67b18122496adb8c2",
    },
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, *, samples: int = 25, per_sample: int = 5, warmup: int = 3) -> float:
    """Median over ``samples`` of the mean time of ``per_sample`` back-to-back
    calls, by CUDA events.  Back to back, the host enqueues while the card
    works, so the launch overhead of the Python wrapper stays hidden only
    where the kernel takes longer than the wrapper; where it does not, this
    times the host (``kernel_ms`` then gives the kernel's own time)."""
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


def kernel_ms(fn, kernel: str, *, calls: int = 50, warmup: int = 3,
              attempts: int = 3) -> float:
    """Mean device time of one launch of the kernels whose names hold
    ``kernel``, over ``calls`` calls of ``fn``, from a torch.profiler trace:
    the kernel's own time, which a decode-sized kernel's back-to-back CUDA
    events cannot show (the host's wrapper takes longer than the kernel, so
    they time the host).

    The profiler can lose kernel records (on the H100 a trace of 50 WKV6
    decode calls once held 38).  A trace that holds fewer than ``calls`` is
    taken again, up to ``attempts`` times; then the fullest one is used if
    it holds at least half of them, and the mean is over the launches it
    holds.  The calls must have launched ``calls`` kernels of the port, by
    the wrappers' counts, and a trace that holds more fails the run."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = (0.0, 0)
    for _ in range(attempts):
        launched = sum(ops.LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = sum(ops.LAUNCHES.values()) - launched
        check(launched == calls, f"{calls} calls launched {launched} kernels of the port")
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA and kernel in ev.key:
                total += ev.self_device_time_total
                count += ev.count
        check(count <= calls, f"profiler saw {count} launches of {kernel}, "
                              f"more than the {calls} calls")
        if count > best[1]:
            best = (total, count)
        if count == calls:
            break
        say(f"profiler saw {count} of {calls} launches of {kernel}")
    total, count = best
    check(2 * count >= calls, f"profiler saw at most {count} launches of {kernel} "
                              f"in {attempts} traces of {calls} calls")
    return total / count / 1e3


def device_ms_a_call(fn, *, calls: int = 50, attempts: int = 3) -> float:
    """Mean device time of one call of ``fn`` over ``calls`` calls, from a
    torch.profiler trace: every kernel the calls launch, whatever their
    names (a library call's, whose kernels the port does not name).  The
    profiler can lose records (late in a long process most of them): a
    trace that holds fewer kernels than calls is taken again, up to
    ``attempts`` times, and the fullest one gives the mean time of a
    kernel times the kernels a call (its count over ``calls``, rounded, at
    least 1)."""
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
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        total, count = (sum(ev.self_device_time_total for ev in events),
                        sum(ev.count for ev in events))
        if count > best[1]:
            best = (total, count)
        if count >= calls:
            break
        say(f"profiler saw {count} kernels in {calls} calls")
    total, count = best
    check(count > 0, "profiler saw no device time")
    return total / count * max(1, round(count / calls)) / 1e3


def device_ms_split(fn, names, *, calls: int = 5, attempts: int = 3) -> dict:
    """Mean device time of one launch of the kernels whose names hold each
    of ``names`` (``fn`` launches each once), from a torch.profiler trace
    of ``calls`` calls: where a wrapper's time goes among its kernels.  The
    mean is over the launches the trace holds, since a trace can lose
    records: a trace that holds fewer than ``calls`` of some kernel is
    taken again, up to ``attempts`` times, and the one whose scarcest
    kernel has the most records is used (NaN where it holds none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                for name in names:
                    if name in ev.key:
                        total[name] += ev.self_device_time_total / 1e3
                        count[name] += ev.count
        if best is None or min(count.values()) > min(best[1].values()):
            best = (total, count)
        if min(count.values()) >= calls:
            break
        say(f"profiler saw {count} launches in {calls} calls")
    total, count = best
    return {name: total[name] / count[name] if count[name] else float("nan")
            for name in names}


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# the inputs and outputs of one rotation, which a timed RMSNorm call walks:
# four times the H100's 50 MB L2, so no call finds its x there
ROTATE_BYTES = 4 * 50 * 10**6


def rmsnorm_fwd_times(gen, rows: int, D: int) -> dict:
    """The RMSNorm forward kernel's times at (rows, D) fp32: ``ms`` its
    device time (``kernel_ms``), ``ms_a_call`` back-to-back calls through
    ``ops.rmsnorm`` by CUDA events (``time_ms``), ``plain_ms`` the plain
    version's, ``library_ms`` ``F.rms_norm``'s device time (every kernel it
    launches, ``device_ms_a_call``) and the bytes bound (x read and y
    written once, the scale read once).  Each call takes the next x of a
    rotation of ``ROTATE_BYTES`` with its y, so every call reads x from
    device memory, as the bound assumes."""
    nbytes = 2 * rows * D * 4
    nbuf = max(1, math.ceil(ROTATE_BYTES / nbytes))
    xs = [randn((rows, D), torch.float32, gen) for _ in range(nbuf)]
    ys = [None] * nbuf
    scale = torch.linspace(0.5, 1.5, D, device="cuda")
    turn = [0]

    def rotated(f):
        def call():
            i = turn[0] = (turn[0] + 1) % nbuf
            ys[i] = None             # this turn's y is freed, then allocated again
            ys[i] = f(xs[i])
        return call
    kernel = rotated(lambda x: ops.rmsnorm(x, scale, backend="cuda"))
    out = {"ms": kernel_ms(kernel, "rmsnorm_kernel"), "ms_a_call": time_ms(kernel),
           "plain_ms": time_ms(rotated(lambda x: ref.rmsnorm_ref(x, scale))),
           "library_ms": device_ms_a_call(rotated(
               lambda x: torch.nn.functional.rms_norm(x, (D,), scale, 1e-5))),
           "library": "F.rms_norm (device time)", "rotation": nbuf}
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes + D * 4, _work.rmsnorm_flops(rows, D),
                                                torch.float32)
    del xs, ys
    free()
    return out


def say_rmsnorm_fwd(what: str, err: float, t: dict) -> None:
    say(f"{what}: max abs err {err:.3e}; {t['ms']:.4f} ms on the card ({t['ms_a_call']:.4f} a "
        f"call); plain {t['plain_ms']:.4f} ms; F.rms_norm {t['library_ms']:.4f} ms on the card; "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}; {t['bound_ms'] / t['ms']:.1%} of it "
        f"reached)")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def rmsnorm_phase(gen) -> dict:
    cases = []
    for shape, dtype in (((8, 4096), torch.float32), ((4096, 4096), torch.float32),
                         ((2, 7, 128), torch.bfloat16)):
        x = randn(shape, dtype, gen)
        scale = torch.linspace(0.5, 1.5, shape[-1], device="cuda")
        y = ops.rmsnorm(x, scale, backend="cuda")
        torch.cuda.synchronize()
        err = (y.float() - ref.rmsnorm_ref(x, scale).float()).abs().max().item()
        bnd = RMS_BOUND_F32 if dtype == torch.float32 else RMS_BOUND
        check(y.shape == x.shape and y.dtype == dtype, f"rmsnorm {shape}: bad output")
        check(err <= bnd, f"rmsnorm {shape} {dtype}: max abs err {err} > {bnd}")
        cases.append({"shape": list(shape), "dtype": str(dtype).split(".")[1],
                      "max_abs_err": err, "bound": bnd})
        say(f"rmsnorm {tuple(shape)} {dtype}: max abs err {err:.3e} (bound {bnd})")

    # timed at the prefill shape of phase 4: B*S rows of d_model
    rows, D = 4096, 4096
    t = rmsnorm_fwd_times(gen, rows, D)
    err = max(c["max_abs_err"] for c in cases)
    say_rmsnorm_fwd(f"rmsnorm ({rows}, {D}) fp32", err, t)
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:25",
            "shape": [rows, D], "dtype": "float32",
            "max_abs_err": err, "bound": RMS_BOUND, **t, "cases": cases}


# the RMSNorm forward at the main paths' widths that no other entry times,
# each at the rows of a served prefill: (rows, D, tag)
RMSNORM_WIDTHS = ((BATCH * PROMPT_LENS[1] * 16, 128, "olmoe-1b-7b qk_norm, D = 128"),
                  (4096, 2048, "D = 2048"), (4096, 3072, "phi4-mini-3.8b, D = 3072"),
                  (4096, 3584, "zamba2-7b, D = 3584"),
                  (4096, 7168, "zamba2-7b's gated norm, D = 7168"))


def rmsnorm_widths_phase(gen) -> list:
    """An entry of the kernels line for each of ``RMSNORM_WIDTHS``
    (``rmsnorm_fwd_at``); ``main`` adds each one's launches of its shape
    class in the served runs of phases 4, 10 and 11."""
    return [rmsnorm_fwd_at(gen, *w) for w in RMSNORM_WIDTHS]


causal_pairs = _work.causal_pairs


def sdpa_efficient(q, k, v, causal):
    """``scaled_dot_product_attention`` pinned to its memory-efficient backend,
    on (B, H, S, h) views with K and V already expanded to the query heads:
    where that backend does not take the inputs it raises, rather than fall
    back to the math path."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)


SDPA_BACKEND = "EFFICIENT_ATTENTION"


def flash_phase(gen) -> dict:
    cases = []
    for B, S, causal in ((2, 512, True), (2, 300, True), (2, 512, False)):
        q = randn((B, S, 32, 128), torch.float32, gen)
        k = randn((B, S, 8, 128), torch.float32, gen)
        v = randn((B, S, 8, 128), torch.float32, gen)
        o = ops.flash_attention(q, k, v, causal=causal, backend="cuda")
        torch.cuda.synchronize()
        err = (o - ref.flash_attention_ref(q, k, v, causal=causal)).abs().max().item()
        check(o.shape == q.shape and bool(torch.isfinite(o).all()), "flash: bad output")
        check(err <= FLASH_BOUND, f"flash B={B} S={S} causal={causal}: "
                                  f"max abs err {err} > {FLASH_BOUND}")
        cases.append({"shape": [B, S, 32, 8, 128], "causal": causal, "dtype": "float32",
                      "max_abs_err": err, "bound": FLASH_BOUND})
        say(f"flash B={B} S={S} Hq=32 Hkv=8 h=128 causal={causal} fp32: "
            f"max abs err {err:.3e} (bound {FLASH_BOUND})")

    # timed at the prefill shapes of phase 4: llama3-8b's and zamba2-7b's
    h128 = flash_timed(gen, BATCH, PROMPT_LENS[1], 32, 8, 128)
    h112 = flash_timed(gen, BATCH, PROMPT_LENS[1], 32, 32, 112)
    cases += [h128.pop("case"), h112.pop("case")]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash.cu",
            "replaces": "src/repro/kernels/flash.py:65", "dtype": "float32",
            "max_abs_err": max(c["max_abs_err"] for c in cases), "bound": FLASH_BOUND,
            **h128, "at_h112": h112, "cases": cases}


def flash_timed(gen, B, S, Hq, Hkv, h) -> dict:
    """Flash at a served model's prefill shape, causal fp32: held against its
    plain version, then timed beside it and beside SDPA on its efficient
    backend, with the bound on the CUDA cores' fp32 rate and the bound of
    the kernel's own route (3 TF32 products per fp32 product at the TF32
    rate)."""
    q = randn((B, S, Hq, h), torch.float32, gen)
    k = randn((B, S, Hkv, h), torch.float32, gen)
    v = randn((B, S, Hkv, h), torch.float32, gen)
    o = ops.flash_attention(q, k, v, causal=True, backend="cuda")
    torch.cuda.synchronize()
    o_ref = ref.flash_attention_ref(q, k, v, causal=True)
    err = (o - o_ref).abs().max().item()
    check(o.shape == q.shape and bool(torch.isfinite(o).all()), f"flash h={h}: bad output")
    check(err <= FLASH_BOUND, f"flash h={h}: max abs err {err} > {FLASH_BOUND}")
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True, backend="cuda"))
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    G = Hq // Hkv
    qt, kt, vt = (x.transpose(1, 2) for x in
                  (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    lib = time_ms(lambda: sdpa_efficient(qt, kt, vt, True))
    err_lib = (sdpa_efficient(qt, kt, vt, True).transpose(1, 2) - o_ref).abs().max().item()
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * h * B * Hq * causal_pairs(S, S)
    b_ms, b_by = bound_ms(nbytes, flops, FP32_AS_3XTF32)
    b_cores, by_cores = bound_ms(nbytes, flops, torch.float32)
    say(f"flash B={B} S={S} Hq={Hq} Hkv={Hkv} h={h} causal fp32: max abs err {err:.3e} "
        f"(bound {FLASH_BOUND}); {ms:.4f} ms; plain {plain:.4f} ms; "
        f"sdpa[{SDPA_BACKEND}] {lib:.4f} ms (its err vs plain {err_lib:.1e}); "
        f"bound {b_ms:.4f} ms ({b_by}, 3xTF32 tensor cores; {b_ms / ms:.1%} of it "
        f"reached); on the fp32 CUDA cores it would be {b_cores:.4f} ms ({by_cores})")
    return {"shape": [B, S, Hq, Hkv, h], "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib,
            "library_backend": SDPA_BACKEND, "library_max_abs_err": err_lib,
            "case": {"shape": [B, S, Hq, Hkv, h], "causal": True, "dtype": "float32",
                     "max_abs_err": err, "bound": FLASH_BOUND}}


# the backward kernels (phase 3): each against autograd of its plain version,
# timed at llama3-8b's training shapes (phase 8: B = 4, S = 2048)
TRAIN_B, TRAIN_S = 4, 2048
TP_RANKS = 4               # the model axis of the four-card tensor-parallel placement


def grads_of(fn, inputs, dout):
    """Autograd's gradients of ``fn(*inputs)`` for the output gradient
    ``dout``, on leaf copies of ``inputs``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, dout.to(out.dtype))


def backward_ms(fn, inputs, dout, **kw) -> float:
    """The backward's share of ``fn``: forward and backward by autograd,
    less the forward alone (the yardstick for a plain version or a library
    call, whose backward cannot be called alone)."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    both = time_ms(lambda: torch.autograd.grad(fn(*leaves), leaves, dout), **kw)
    fwd = time_ms(lambda: fn(*leaves), **kw)
    return both - fwd


def rmsnorm_bwd_phase(gen) -> dict:
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda

    cases = []
    for shape, dtype in (((8, 4096), torch.float32), ((4096, 4096), torch.float32),
                         ((300, 4096), torch.bfloat16), ((2, 7, 128), torch.bfloat16)):
        x, dy = randn(shape, dtype, gen), randn(shape, dtype, gen)
        scale = torch.linspace(0.5, 1.5, shape[-1], device="cuda")
        got = grads_of(lambda a, b: ops.rmsnorm(a, b, backend="cuda"), (x, scale), dy)
        want = grads_of(ref.rmsnorm_ref, (x.double(), scale.double()), dy.double())
        torch.cuda.synchronize()
        bnd = RMS_GRAD_BOUND if dtype == torch.float32 else HALF_GRAD_BOUND
        errs = [(g.double() - w).abs().max().item() for g, w in zip(got, want)]
        rel = max(e / w.abs().max().item() for e, w in zip(errs, want))
        check(rel <= bnd, f"rmsnorm backward {shape} {dtype}: err {rel} of max|g| > {bnd}")
        cases.append({"shape": list(shape), "dtype": str(dtype).split(".")[1],
                      "max_abs_err": max(errs), "err_of_max_g": rel, "bound": bnd})
        say(f"rmsnorm backward {tuple(shape)} {dtype}: max abs err {max(errs):.3e}, "
            f"{rel:.3e} of max|g| (bound {bnd}) against autograd of the plain version "
            f"in fp64")

    rows, D = TRAIN_B * TRAIN_S, 4096          # llama3-8b's training rows of d_model
    x, dy = randn((rows, D), torch.float32, gen), randn((rows, D), torch.float32, gen)
    scale = torch.linspace(0.5, 1.5, D, device="cuda")
    got = rmsnorm_bwd_cuda(x, scale, dy)       # the call timed below, held first
    want = grads_of(ref.rmsnorm_ref, (x.double(), scale.double()), dy.double())
    errs = [(g.double() - w).abs().max().item() for g, w in zip(got, want)]
    rel = max(e / w.abs().max().item() for e, w in zip(errs, want))
    check(rel <= RMS_GRAD_BOUND, f"rmsnorm backward ({rows}, {D}): err {rel} of max|g| "
                                 f"> {RMS_GRAD_BOUND}")
    cases.append({"shape": [rows, D], "dtype": "float32", "max_abs_err": max(errs),
                  "err_of_max_g": rel, "bound": RMS_GRAD_BOUND, "timed": True})
    say(f"rmsnorm backward ({rows}, {D}) fp32, the timed call: max abs err "
        f"{max(errs):.3e}, {rel:.3e} of max|g| (bound {RMS_GRAD_BOUND}) against autograd "
        f"of the plain version in fp64")
    del got, want
    ms = time_ms(lambda: rmsnorm_bwd_cuda(x, scale, dy))
    plain = backward_ms(ref.rmsnorm_ref, (x, scale), dy)
    lib = backward_ms(lambda a, b: torch.nn.functional.rms_norm(a, (D,), b, 1e-5),
                      (x, scale), dy)
    b_ms, b_by = bound_ms(4 * (3 * rows * D + 2 * D), 8 * rows * D, torch.float32)
    split = device_ms_split(lambda: rmsnorm_bwd_cuda(x, scale, dy),
                            ("rmsnorm_bwd_kernel", "rmsnorm_dscale_kernel"))
    say(f"rmsnorm backward ({rows}, {D}) fp32: {ms:.4f} ms; plain (autograd) {plain:.4f} "
        f"ms; F.rms_norm's backward {lib:.4f} ms; bound {b_ms:.4f} ms ({b_by}; "
        f"{b_ms / ms:.1%} of it reached); on the card by kernel: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
    return {"name": "rmsnorm_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:25", "shape": [rows, D],
            "dtype": "float32",
            "max_abs_err": max(c["max_abs_err"] for c in cases if c["dtype"] == "float32"),
            "bound": RMS_GRAD_BOUND, "bound_of": "max|g|", "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib, "library": "autograd of F.rms_norm",
            "device_ms_by_kernel": split, "cases": cases}


def flash_bwd_phase(gen) -> dict:
    from repro_torch.kernels.flash import flash_attention_bwd_cuda, flash_attention_cuda

    cases = []
    for B, S, Hq, Hkv, h, causal in ((2, 512, 32, 8, 128, True), (2, 512, 32, 8, 128, False),
                                     (2, 300, 32, 8, 128, True), (1, 200, 8, 8, 112, True)):
        q, do = randn((B, S, Hq, h), torch.float32, gen), randn((B, S, Hq, h), torch.float32, gen)
        k, v = randn((B, S, Hkv, h), torch.float32, gen), randn((B, S, Hkv, h), torch.float32, gen)
        got = grads_of(lambda *a: ops.flash_attention(*a, causal=causal, backend="cuda"),
                       (q, k, v), do)
        want = grads_of(lambda *a: ref.flash_attention_ref(*a, causal=causal),
                        (q.double(), k.double(), v.double()), do.double())
        torch.cuda.synchronize()
        gmax = max(w.abs().max().item() for w in want)
        err = max((g.double() - w).abs().max().item() for g, w in zip(got, want))
        check(all(bool(torch.isfinite(g).all()) for g in got), "flash backward: non-finite")
        check(err <= FLASH_GRAD_BOUND * gmax, f"flash backward B={B} S={S} h={h} "
              f"causal={causal}: err {err} > {FLASH_GRAD_BOUND} x max|g| {gmax}")
        cases.append({"shape": [B, S, Hq, Hkv, h], "causal": causal, "dtype": "float32",
                      "max_abs_err": err, "err_of_max_g": err / gmax,
                      "bound": FLASH_GRAD_BOUND})
        say(f"flash backward B={B} S={S} Hq={Hq} Hkv={Hkv} h={h} causal={causal} fp32: "
            f"max abs err {err:.3e}, {err / gmax:.3e} of max|g| (bound {FLASH_GRAD_BOUND}) "
            f"against autograd of the plain version in fp64")

    B, S, Hq, Hkv, h = TRAIN_B, TRAIN_S, 32, 8, 128     # llama3-8b's training shape
    q, do = randn((B, S, Hq, h), torch.float32, gen), randn((B, S, Hq, h), torch.float32, gen)
    k, v = randn((B, S, Hkv, h), torch.float32, gen), randn((B, S, Hkv, h), torch.float32, gen)
    o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    held = flash_train_shape_errs(q, k, v, do, o, lse,
                                  flash_attention_bwd_cuda(q, k, v, o, lse, do))
    cases.append({"shape": [B, S, Hq, Hkv, h], "causal": True, "dtype": "float32",
                  "max_abs_err": held["grad_err"], "err_of_max_g": held["grad_err_of_max_g"],
                  "bound": FLASH_GRAD_BOUND, "timed": True,
                  "o_max_abs_err": held["o_err"], "lse_max_abs_err": held["lse_err"]})
    ms = time_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do), samples=10,
                 per_sample=2)
    plain = backward_ms(lambda *a: ref.flash_attention_ref(*a, causal=True), (q, k, v), do,
                        samples=5, per_sample=1)
    G = Hq // Hkv
    qt, kt, vt, dot = (x.transpose(1, 2) for x in
                       (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2), do))
    lib = backward_ms(lambda *a: sdpa_efficient(*a, True), (qt, kt, vt), dot, samples=10,
                      per_sample=2)
    pairs = causal_pairs(S, S) * B * Hq
    nbytes = 4 * (4 * q.numel() + 4 * k.numel() + lse.numel())   # q o dO dq, k v dk dv
    # the least time: five products, fp32-exact at the card's 3xTF32 rate,
    # the kernels' route (as the forward is bounded); the design's own floor,
    # seven products (the dQ kernel recomputes S and dP), is printed beside it
    b_ms, b_by = bound_ms(nbytes, 5 * 2 * h * pairs, FP32_AS_3XTF32)
    b_cores, by_cores = bound_ms(nbytes, 5 * 2 * h * pairs, torch.float32)
    floor7, _ = bound_ms(nbytes, 7 * 2 * h * pairs, FP32_AS_3XTF32)
    # by kernel, each beside the floor of its own products (dK/dV: Sᵀ, dPᵀ,
    # dV, dK; dQ: S, dP, dQ)
    split = device_ms_split(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do),
                            ("flash_bwd_dot_kernel", "flash_bwd_dkdv_kernel",
                             "flash_bwd_dq_kernel"), calls=3)
    for name, products in (("flash_bwd_dkdv_kernel", 4), ("flash_bwd_dq_kernel", 3)):
        own = products * 2 * h * pairs / PEAK_FLOPS[FP32_AS_3XTF32] * 1e3
        say(f"flash backward {name}: {split[name]:.4f} ms on the card, "
            f"{own / split[name]:.1%} of its {products} products' {own:.4f} ms")
    say(f"flash backward flash_bwd_dot_kernel: {split['flash_bwd_dot_kernel']:.4f} ms")
    say(f"flash backward B={B} S={S} Hq={Hq} Hkv={Hkv} h={h} causal fp32: {ms:.4f} ms; "
        f"plain (autograd) {plain:.4f} ms; sdpa[{SDPA_BACKEND}] backward {lib:.4f} ms; "
        f"bound {b_ms:.4f} ms ({b_by}, five products as 3xTF32 on the tensor cores; "
        f"{b_ms / ms:.1%} of it reached); the design's seven products {floor7:.4f} ms "
        f"({floor7 / ms:.1%} of it reached); on the fp32 CUDA cores it would be "
        f"{b_cores:.4f} ms ({by_cores})")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "replaces": "src/repro/kernels/flash.py:65", "shape": [B, S, Hq, Hkv, h],
            "dtype": "float32", "max_abs_err": max(c["max_abs_err"] for c in cases),
            "bound": FLASH_GRAD_BOUND, "bound_of": "max|g| over dq, dk, dv", "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_seven_products": floor7, "bound_ms_fp32_cores": b_cores,
            "device_ms_by_kernel": split, "library_ms": lib,
            "library": f"sdpa[{SDPA_BACKEND}] forward+backward less forward",
            "cases": cases}


def flash_train_shape_errs(q, k, v, do, o, lse, grads, *, window: int = 0, slopes=None,
                           group=None, what: str = "flash at the training shape",
                           causal: bool = True) -> dict:
    """The forward's o and lse and the backward's (dq, dk, dv) at a training
    shape, causal or full (over Sk keys, as many as the queries or not),
    with ``window`` and the ALiBi ``slopes`` given, each
    against the plain version in fp64 (autograd of it for the gradients),
    one batch element at a time (each one's fp64 scores take 1 GB at
    S 2048 and 32 heads); with ``group`` (a KV head), on that head's group
    of query heads alone.  Fails the run past FLASH_BOUND (o, lse) or
    FLASH_GRAD_BOUND of max|g| over dq, dk and dv."""
    B, S, Hq, h = q.shape
    G = Hq // k.shape[2]
    hq = slice(None) if group is None else slice(group * G, (group + 1) * G)
    hk = slice(None) if group is None else slice(group, group + 1)
    sl = None if slopes is None else slopes[hq].double()
    kw = dict(causal=causal, window=window, alibi_slopes=sl)
    dist = (torch.arange(k.shape[1], device=q.device)[None, :]
            - torch.arange(S, device=q.device)[:, None])          # kpos - qpos
    keep = dist <= 0 if causal else torch.ones_like(dist, dtype=torch.bool)
    if window:
        keep &= -dist < window
    o_err = lse_err = g_err = g_max = 0.0
    for b in range(B):
        leaves = [t[b:b + 1, :, hs].double().requires_grad_()
                  for t, hs in ((q, hq), (k, hk), (v, hk))]
        ob = ref.flash_attention_ref(*leaves, **kw)
        want = torch.autograd.grad(ob, leaves, do[b:b + 1, :, hq].double())
        got = (grads[0][b:b + 1, :, hq], grads[1][b:b + 1, :, hk], grads[2][b:b + 1, :, hk])
        o_err = max(o_err, (o[b:b + 1, :, hq].double() - ob.detach()).abs().max().item())
        g_err = max(g_err, max((g.double() - w).abs().max().item() for g, w in zip(got, want)))
        g_max = max(g_max, max(w.abs().max().item() for w in want))
        del leaves, ob, want
        sc = torch.einsum("qhd,shd->hqs", q[b, :, hq].double(),
                          k[b, :, hk].double().repeat_interleave(G, dim=1)) / h ** 0.5
        if sl is not None:
            sc += sl.view(-1, 1, 1) * dist.double()
        lse_ref = torch.logsumexp(sc.masked_fill_(~keep, ref.NEG_INF), dim=-1)
        lse_err = max(lse_err, (lse[b, hq].double() - lse_ref).abs().max().item())
        del sc, lse_ref
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"{what}: non-finite gradients")
    check(o_err <= FLASH_BOUND and lse_err <= FLASH_BOUND,
          f"{what}: o err {o_err}, lse err {lse_err} > {FLASH_BOUND}")
    check(g_err <= FLASH_GRAD_BOUND * g_max, f"{what}: backward err {g_err} > "
                                             f"{FLASH_GRAD_BOUND} x max|g| {g_max}")
    held = "" if group is None else f", KV head {group}'s group of {G} query heads"
    say(f"{what} {tuple(q.shape)} / {tuple(k.shape)} {'causal' if causal else 'full'} "
        f"window={window} "
        f"alibi={slopes is not None} fp32, the timed calls{held}: o max abs err {o_err:.3e}, "
        f"lse {lse_err:.3e} (bound {FLASH_BOUND}); dq, dk, dv max abs err {g_err:.3e}, "
        f"{g_err / g_max:.3e} of max|g| (bound {FLASH_GRAD_BOUND}) against the plain version "
        f"in fp64")
    return {"o_err": o_err, "lse_err": lse_err, "grad_err": g_err,
            "grad_err_of_max_g": g_err / g_max}


def flash_bwd_smem_bytes(kind: str, h: int) -> int:
    """Dynamic shared memory of flash_bwd.cu's kernels: rows of h + 8 floats;
    the dQ kernel keeps Q and dO of 128 rows and double-buffers K and V
    tiles of 32 keys; the dK/dV kernel keeps K and V of 128 keys and
    double-buffers Q and dO tiles of 32 queries with their lse and D."""
    return 4 * ((h + 8) * (2 * 128 + 4 * 32) + (4 * 32 if kind == "dkdv" else 0))


# the mangled template arguments of flash_bwd.cu's kernels: <T, HD, ALIBI>
FLASH_BWD_KERNEL = re.compile(r"flash_bwd_(dkdv|dq)_kernelI(f|13__nv_bfloat16|6__half)Li(\d+)"
                              r"ELb([01])E")
FLASH_BWD_TYPES = {"f": "fp32", "13__nv_bfloat16": "bf16", "6__half": "fp16"}
# the backward instantiations that may spill, with the most bytes (stores and
# loads) each may: the half types' dK/dV kernel at h = 128 spilled 28 B
# before the window's tests (unchecked then) and spills 64 B with them; no
# model trains in bf16 or fp16 (ROADMAP queue 2 item 2).  Every other one
# must not spill.
FLASH_BWD_SPILL_CAP = {"dkdv <bf16, 128>": 64, "dkdv <fp16, 128>": 64}


def flash_bwd_build_report(entries=None) -> dict:
    """What ptxas reports for every instantiation of the backward kernels
    (dK/dV and dQ at each dtype and head dim, and ALiBi's, fp32 only):
    registers, spills (any fails the run, but the half types' dK/dV
    kernel's within ``FLASH_BWD_SPILL_CAP``) and stack, each beside its
    dynamic shared memory, named ``dkdv <fp32, 80>``, ``dq <fp32, 128,
    ALiBi>`` and so on; the fp32 ones printed one a line, the half types'
    in one line, all kept beside the phase's numbers."""
    from repro_torch.kernels.flash import HEAD_DIMS

    report = {}
    for entry in entries if entries is not None else ptxas_report("flash_bwd.cu"):
        m = FLASH_BWD_KERNEL.search(entry["kernel"])
        if not m:
            continue
        kind, dtype, h, alibi = m.group(1), FLASH_BWD_TYPES[m.group(2)], int(m.group(3)), \
            m.group(4) == "1"
        name = f"{kind} <{dtype}, {h}{', ALiBi' if alibi else ''}>"
        smem = flash_bwd_smem_bytes(kind, h)
        report[name] = {**{k: v for k, v in entry.items() if k != "kernel"},
                        "smem_dynamic": smem}
        if dtype == "fp32":
            say(f"ptxas flash backward {name}: {entry['registers']} registers, "
                f"{entry['spill_stores']} B spill stores, {entry['spill_loads']} B spill "
                f"loads, {entry['stack']} B stack; {smem} B of dynamic shared memory")
    say("ptxas flash backward, half types, registers / spill stores / spill loads (B): " +
        ", ".join(f"{n} {e['registers']}/{e['spill_stores']}/{e['spill_loads']}"
                  for n, e in report.items() if "fp32" not in n))
    spills = {n: e["spill_stores"] + e["spill_loads"] for n, e in report.items()}
    over = {n: b for n, b in spills.items() if b > FLASH_BWD_SPILL_CAP.get(n, 0)}
    check(not over, f"flash backward instantiations spill (B): {over}, allowed "
                    f"{FLASH_BWD_SPILL_CAP}")
    want = {f"{kind} <{dtype}, {h}>" for kind in ("dkdv", "dq") for h in HEAD_DIMS
            for dtype in FLASH_BWD_TYPES.values()}
    want |= {f"{kind} <fp32, {h}, ALiBi>" for kind in ("dkdv", "dq") for h in HEAD_DIMS}
    check(set(report) == want, f"ptxas reported the backward kernels {sorted(report)}, "
                               f"expected {sorted(want)}")
    return report


# the RMSNorm forward's instantiations by the mangled types: x's, then the
# scale's where it is not x's
RMS_FWD_TYPES = {"ff": "fp32", "13__nv_bfloat16S1_": "bf16", "13__nv_bfloat16f": "bf16/fp32",
                 "6__halfS1_": "fp16", "6__halff": "fp16/fp32"}


def rmsnorm_fwd_build_report(entries=None) -> dict:
    """What ptxas reports for every instantiation of the RMSNorm forward:
    for each dtype pair the generic path (0 vectors), the warp-a-row path
    holding 1, 2, 4 or 8 vectors a lane and the block-a-row path holding
    2, 4 or 8 a thread, each with its feed.  Fails on a spill of any, or
    where one is missing."""
    report = {}
    for entry in entries if entries is not None else ptxas_report("rmsnorm.cu"):
        m = re.search(r"rmsnorm_kernelI(\w+?)Li(\d+)ELb([01])ELi([01])E", entry["kernel"])
        if not m:
            continue
        key = (f"{RMS_FWD_TYPES[m.group(1)]} {m.group(2)}/{'warp' if m.group(3) == '1' else 'block'}"
               f"/{'ring' if m.group(4) == '1' else 'regs'}")
        report[key] = {k: v for k, v in entry.items() if k != "kernel"}
        if key.startswith("fp32 "):
            say(f"ptxas rmsnorm forward <{key}>: {entry['registers']} registers, "
                f"{entry['spill_stores']} B spill stores, {entry['spill_loads']} B spill loads")
        check(entry["spill_stores"] == 0 and entry["spill_loads"] == 0,
              f"rmsnorm forward <{key}> spills")
    check(len(report) == 8 * len(RMS_FWD_TYPES),
          f"ptxas reported {len(report)} rmsnorm forward instantiations: {sorted(report)}")
    return report


def rmsnorm_bwd_build_report(entries=None) -> dict:
    """What ptxas reports for the RMSNorm backward's fp32 instantiations:
    the register path holding 1, 2, 4 or 8 vectors a thread (fails on a
    spill) and the generic path (0)."""
    report = {}
    for entry in entries if entries is not None else ptxas_report("rmsnorm.cu"):
        m = re.search(r"rmsnorm_bwd_kernelIffLi(\d+)E", entry["kernel"])
        if not m:
            continue
        nv = int(m.group(1))
        report[nv] = {k: v for k, v in entry.items() if k != "kernel"}
        say(f"ptxas rmsnorm backward <fp32, {nv} vectors>: {entry['registers']} registers, "
            f"{entry['spill_stores']} B spill stores, {entry['spill_loads']} B spill loads")
        check(nv == 0 or (entry["spill_stores"] == 0 and entry["spill_loads"] == 0),
              f"rmsnorm backward <fp32, {nv}> spills")
    check(sorted(report) == [0, 1, 2, 4, 8],
          f"ptxas reported the rmsnorm backward for {sorted(report)}")
    return report


def ptxas_reports(*sources: str) -> dict:
    """What ptxas reports for each of ``sources`` of the port's ``csrc``,
    each compiled to a cubin with ``-Xptxas -v`` (the build's flags), one
    nvcc a source, all started at once: ``{source: [{"kernel",
    "registers", "smem_static", "stack", "spill_stores", "spill_loads"},
    ...]}``, in bytes where not a count."""
    return ptxas_collect(ptxas_start(*sources))


def ptxas_start(*sources: str) -> dict:
    """Starts ``ptxas_reports``'s nvccs (``main`` runs them beside the
    build) and returns them for ``ptxas_collect``."""
    from torch.utils.cpp_extension import CUDA_HOME

    check(CUDA_HOME is not None, "ptxas report: the CUDA toolkit was not found")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in sources:
        out = _build.BUILD_DIR / (os.path.splitext(source)[0] + ".cubin")
        log = out.with_suffix(".ptxas.txt")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [nvcc, *_build.CUDA_FLAGS, "-std=c++17", "-cubin", "-Xptxas", "-v", "-o",
                 str(out), str(_build.CSRC / source)], stdout=subprocess.DEVNULL, stderr=f)
        jobs[source] = (proc, log)
    return jobs


def ptxas_collect(jobs: dict) -> dict:
    """Waits for ``ptxas_start``'s nvccs (killing them on a failure) and
    parses what ptxas said, by source."""
    try:
        for proc, _ in jobs.values():
            proc.wait(timeout=600)
    finally:
        for proc, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for source, (proc, log) in jobs.items():
        err = log.read_text()
        if proc.returncode:
            raise subprocess.CalledProcessError(proc.returncode, proc.args, stderr=err)
        out[source] = _parse_ptxas(err)
    return out


def ptxas_report(source: str) -> list:
    """What ptxas reports for one source (``ptxas_reports``)."""
    return ptxas_reports(source)[source]


def _parse_ptxas(err: str) -> list:
    found = []
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            found.append({"kernel": m.group(1)})
            continue
        if not found:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            found[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            found[-1]["smem_static"] = int(sm.group(1)) if sm else 0
    return found


def flash_smem_bytes(h: int) -> int:
    """Dynamic shared memory of flash.cu's ``Layout<h>``: a 128-row Q tile and
    two buffers each of a 64-key K and V tile, rows padded to h + 8 floats (Q,
    K) and h + 4 (V)."""
    return 4 * (128 * (h + 8) + 2 * 64 * ((h + 8) + (h + 4)))


FLASH_FWD_HEAD_DIMS = (80, 112, 128)        # the main paths' head dims


def flash_build_report(entries=None) -> dict:
    """What ptxas reports for the fp32 instantiations of the main paths'
    head dims, each with and without lse and ALiBi and named so (``<fp32,
    80, lse, ALiBi>``; fails on a spill), beside the shared memory of the
    kernel's layout and the blocks of 256 threads per SM that it and the
    registers allow."""
    report = {}
    for entry in entries if entries is not None else ptxas_report("flash.cu"):
        m = re.search(r"flash_fwd_kernelIfLi(\d+)ELb([01])ELb([01])E", entry["kernel"])
        if not m or int(m.group(1)) not in FLASH_FWD_HEAD_DIMS:
            continue
        h = int(m.group(1))
        name = (f"<fp32, {h}{', lse' if m.group(2) == '1' else ''}"
                f"{', ALiBi' if m.group(3) == '1' else ''}>")
        smem = flash_smem_bytes(h)
        regs = -(-entry["registers"] // 8) * 8     # allocated in units of 8 a thread
        blocks = min(SM_SMEM // (smem + SM_SMEM_PER_BLOCK), SM_REGS // (regs * 256),
                     SM_THREADS // 256)
        report[name] = {**{k: v for k, v in entry.items() if k != "kernel"},
                        "smem_dynamic": smem, "blocks_per_sm": blocks}
        say(f"ptxas flash {name}: {entry['registers']} registers, "
            f"{entry['spill_stores']} B spill stores, {entry['spill_loads']} B spill loads, "
            f"{entry['stack']} B stack; its layout takes {smem} B of dynamic shared "
            f"memory, so {blocks} block(s) per SM")
        check(entry["spill_stores"] == 0 and entry["spill_loads"] == 0, f"flash {name} spills")
    check(len(report) == 4 * len(FLASH_FWD_HEAD_DIMS),
          f"ptxas reported the flash kernels {sorted(report)}")
    return report


def ssd_build_report(entries=None) -> dict:
    """What ptxas reports for the fp32 SSD kernels at the main path's P = N = 64
    (the chunked kernel of 128 threads and the decode step of 256; fails on a
    spill), beside the blocks per SM that shared memory (the chunked kernel's
    layout, as ssd.cu gives it) and registers allow; and, for every other
    fp32 instantiation of the chunked kernel, its registers and spills (one
    buffer rather than two at P = N = 128)."""
    lib = _build.library()
    report, others = {}, {}
    for entry in entries if entries is not None else ptxas_report("ssd.cu"):
        name = entry["kernel"]
        fields = {k: v for k, v in entry.items() if k != "kernel"}
        m = re.search(r"ssd_fwd_kernelIfLi(\d+)ELi(\d+)EE", name)
        if m and (m.group(1), m.group(2)) != ("64", "64"):
            P, N = int(m.group(1)), int(m.group(2))
            others[f"{P},{N}"] = dict(fields, smem_dynamic=lib.rt_ssd_smem_bytes(P, N))
            continue
        if m:
            kind, threads, smem = "chunked", 128, lib.rt_ssd_smem_bytes(64, 64)
            check(smem > 0, "ssd chunked: no shared memory size for <64, 64>")
        elif "ssd_step_kernelIfLi64EE" in name:
            kind, threads, smem = "decode", 256, entry["smem_static"]
        else:
            continue
        report[kind] = fields
        regs = -(-entry["registers"] // 8) * 8     # allocated in units of 8 a thread
        blocks = min(SM_SMEM // (smem + SM_SMEM_PER_BLOCK), SM_REGS // (regs * threads),
                     SM_THREADS // threads)
        report[kind].update(smem_dynamic=smem if kind == "chunked" else 0, blocks_per_sm=blocks)
        say(f"ptxas ssd {kind} <fp32, 64, 64>: {entry['registers']} registers, "
            f"{entry['spill_stores']} B spill stores, {entry['spill_loads']} B spill loads, "
            f"{entry['stack']} B stack; {smem} B of shared memory and {threads} threads a "
            f"block, so {blocks} block(s) per SM")
        check(entry["spill_stores"] == 0 and entry["spill_loads"] == 0,
              f"ssd {kind} <fp32, 64, 64> spills")
    check(sorted(report) == ["chunked", "decode"], f"ptxas reported no ssd kernel for "
                                                   f"{sorted(report)}")
    check(len(others) == 15, f"ptxas reported {len(others)} other chunked instantiations")
    say("ptxas ssd chunked <fp32, P, N>, registers / spill stores / spill loads (B) / "
        "shared memory (B): " + ", ".join(
            f"<{pn}> {e['registers']}/{e['spill_stores']}/{e['spill_loads']}/{e['smem_dynamic']}"
            for pn, e in sorted(others.items(), key=lambda kv: tuple(map(int, kv[0].split(","))))))
    report["chunked_other"] = others
    return report


def wkv6_build_report(entries=None) -> dict:
    """What ptxas reports for the fp32 WKV6 kernels at the main path's K = V =
    64 (the chunked kernel, 256 threads; the decode step, 4 V = 256 threads;
    fails on a spill), beside the blocks
    per SM that shared memory (the chunked kernel's layout, as wkv6.cu gives
    it) and registers allow; and, for every other fp32 instantiation of the
    chunked kernel, its registers, spills and shared memory."""
    lib = _build.library()
    report, others = {}, {}
    if entries is None:
        found = ptxas_reports("wkv6.cu", "wkv6_step.cu")
        entries = found["wkv6.cu"] + found["wkv6_step.cu"]
    for entry in entries:
        name = entry["kernel"]
        fields = {k: v for k, v in entry.items() if k != "kernel"}
        m = re.search(r"wkv6_fwd_kernelIfLi(\d+)ELi(\d+)ELi\d+EE", name)
        if m and m.groups() != ("64", "64"):
            K, V = (int(g) for g in m.groups())
            others[f"{K},{V}"] = dict(fields, smem_dynamic=lib.rt_wkv6_smem_bytes(K, V))
            continue
        if m:
            kind, threads, smem = "chunked", 256, lib.rt_wkv6_smem_bytes(64, 64)
            check(smem > 0, "wkv6 chunked: no shared memory size for <64, 64>")
        elif "wkv6_step_kernelIfLi64ELi64EE" in name:
            kind, threads, smem = "decode", 256, entry["smem_static"]
        else:
            continue
        regs = -(-entry["registers"] // 8) * 8     # allocated in units of 8 a thread
        blocks = min(SM_SMEM // (smem + SM_SMEM_PER_BLOCK), SM_REGS // (regs * threads),
                     SM_THREADS // threads)
        report[kind] = dict(fields, smem_dynamic=0 if kind == "decode" else smem,
                            blocks_per_sm=blocks)
        say(f"ptxas wkv6 {kind} <fp32, 64, 64>: {entry['registers']} registers, "
            f"{entry['spill_stores']} B spill stores, {entry['spill_loads']} B spill loads, "
            f"{entry['stack']} B stack; {smem} B of shared memory and {threads} threads a "
            f"block, so {blocks} block(s) per SM")
        check(entry["spill_stores"] == 0 and entry["spill_loads"] == 0,
              f"wkv6 {kind} <fp32, 64, 64> spills")
    check(sorted(report) == ["chunked", "decode"],
          f"ptxas reported no wkv6 kernel for {sorted(report)}")
    check(len(others) == 15, f"ptxas reported {len(others)} other chunked instantiations")
    say("ptxas wkv6 chunked <fp32, K, V>, registers / spill stores / spill loads (B) / "
        "shared memory (B): " + ", ".join(
            f"<{kv}> {e['registers']}/{e['spill_stores']}/{e['spill_loads']}/{e['smem_dynamic']}"
            for kv, e in sorted(others.items(), key=lambda kv: tuple(map(int, kv[0].split(","))))))
    report["chunked_other"] = others
    return report


# the scans: (B, H, P, N) of zamba2-7b's Mamba2 layers, (B, H, K, V) of rwkv6-1.6b
SSD_SHAPE = (BATCH, 112, 64, 64)
WKV6_SHAPE = (BATCH, 32, 64, 64)


def ssd_work(B, S, H, P, N, with_state: bool, G: int) -> tuple:
    """(bytes, flops) of one SSD call: each input read once and each output
    written once, B and C at their G groups; the operations as
    ``kernels.work.ssd_flops`` counts them (the four chunk products over
    the causal pairs s <= t this call's rows have, the decays, the D x
    skip)."""
    nbytes = 4 * (2 * B * S * H * P + 2 * B * S * G * N + B * S * H + 2 * H
                  + B * H * P * N * (2 if with_state else 1))
    return nbytes, _work.ssd_flops(B, S, H, P, N)


def wkv6_work(B, S, H, K, V, with_state: bool) -> tuple:
    """(bytes, flops) of one WKV6 call, counted as ``ssd_work`` counts (the
    operations: ``kernels.work.wkv6_flops``)."""
    nbytes = 4 * (3 * B * S * H * K + 2 * B * S * H * V + H * K
                  + B * H * K * V * (2 if with_state else 1))
    return nbytes, _work.wkv6_flops(B, S, H, K, V)


def _scan_err(y, st, y_ref, st_ref, what) -> tuple:
    y_ref, st_ref = y_ref.float(), st_ref.float()
    err = (y.float() - y_ref).abs().max().item()
    err_s = (st - st_ref).abs().max().item()
    bnd = SCAN_RTOL * (y_ref.abs().max().item() or 1.0)
    bnd_s = SCAN_RTOL * max(1.0, st_ref.abs().max().item())
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all()),
          f"{what}: non-finite output")
    check(err <= bnd, f"{what}: y max abs err {err} > {bnd}")
    check(err_s <= bnd_s, f"{what}: state max abs err {err_s} > {bnd_s}")
    return err, bnd


def wkv6_phase(gen) -> dict:
    """WKV6 at rwkv6-1.6b's shape: the chunked kernel at the prefill length
    S = 512 and at S = 500 (not a chunk multiple) with a state, the decode
    step at S = 1 with a state, out of place and in place (``out_state`` is
    ``state``), and both at strong decays (w_log = −exp(2 randn), steps of
    e^-1000 and less beside steps of about 1), against the plain version the
    CPU takes (chunked, padded; the step oracle at S = 1) within 1e-3 of
    max|y| and against the step oracle in fp64 within 2e-5.  Then timed in
    the main path's way (a state, written in place): the kernel's device
    time at S = 512 and at S = 1 from the profiler, beside a call's time
    back to back by CUDA events."""
    B, H, K, V = WKV6_SHAPE

    def inputs(S, with_state, spread=0.5):
        r, k = randn((B, S, H, K), torch.float32, gen), randn((B, S, H, K), torch.float32, gen)
        v = randn((B, S, H, V), torch.float32, gen)
        w = -torch.exp(randn((B, S, H, K), torch.float32, gen) * spread)
        return [r, k, v, w, randn((H, K), torch.float32, gen) * 0.1,
                randn((B, H, K, V), torch.float32, gen) if with_state else None]

    cases = []
    for S, with_state, in_place, spread in ((512, False, False, 0.5), (500, True, False, 0.5),
                                            (1, True, False, 0.5), (500, True, True, 0.5),
                                            (1, True, True, 0.5), (512, True, True, 2.0),
                                            (1, True, True, 2.0)):
        args = inputs(S, with_state, spread)
        y_ref, st_ref = ops.wkv6(*args, backend="chunked" if S > 1 else "ref")
        y64, st64 = ref.wkv6_ref(*(None if a is None else a.double() for a in args))
        if in_place:
            st_in = args[5].clone()
            y, st = ops.wkv6(*args[:5], st_in, out_state=st_in, backend="cuda")
            check(st is st_in, f"wkv6 S={S}: out_state was not the state it was given")
        else:
            y, st = ops.wkv6(*args, backend="cuda")
        torch.cuda.synchronize()
        what = (f"wkv6 S={S}" + (" in place" if in_place else "")
                + (" strong decays" if spread > 1 else ""))
        err, bnd = _scan_err(y, st, y_ref, st_ref, what)
        y_top, st_top = y64.abs().max().item() or 1.0, max(1.0, st64.abs().max().item())
        rel = (y.double() - y64).abs().max().item() / y_top
        rel_s = (st.double() - st64).abs().max().item() / st_top
        check(rel <= WKV6_EXACT_RTOL and rel_s <= WKV6_EXACT_RTOL,
              f"{what}: against fp64, y err {rel:.2e} x max|y|, state err {rel_s:.2e} x "
              f"max(1, max|state|) > {WKV6_EXACT_RTOL}")
        cases.append({"shape": [B, S, H, K, V], "state": with_state, "in_place": in_place,
                      "w_log_spread": spread, "dtype": "float32", "max_abs_err": err,
                      "bound": bnd, "rel_err_fp64": rel, "state_rel_err_fp64": rel_s,
                      "bound_fp64": WKV6_EXACT_RTOL, "min_w_log": args[3].min().item()})
        say(f"{what} B={B} H={H} dims=({K}, {V}) state={with_state} fp32: "
            f"y max abs err {err:.3e} (bound {bnd:.3e} = {SCAN_RTOL} x max|y|); against "
            f"fp64 {rel:.2e} x max|y|, state {rel_s:.2e} (bound {WKV6_EXACT_RTOL}); "
            f"min w_log {args[3].min().item():.1f}")

    timed = {}
    for S in (512, 1):
        args = inputs(S, True)
        state = args.pop()
        call = time_ms(lambda: ops.wkv6(*args, state, out_state=state, backend="cuda"))
        ms = kernel_ms(lambda: ops.wkv6(*args, state, out_state=state, backend="cuda"),
                       "wkv6_fwd_kernel" if S > 1 else "wkv6_step_kernel")
        plain = time_ms(lambda: ops.wkv6(*args, state, backend="chunked" if S > 1 else "ref"),
                        samples=5, per_sample=1)
        b_ms, b_by = bound_ms(*wkv6_work(B, S, H, K, V, True), torch.float32)
        timed[S] = {"shape": [B, S, H, K, V], "ms": ms, "call_ms": call, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        say(f"wkv6 B={B} S={S} H={H} dims=({K}, {V}) fp32 in place: {ms:.4f} ms on the card "
            f"({call:.4f} ms a call back to back); plain {plain:.4f} ms; "
            f"no single library call; bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} of it "
            f"reached)")
    timed[1]["source"] = "src/repro_torch/kernels/csrc/wkv6_step.cu"
    return {"name": "wkv6", "route": "cuda", "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:66", "dtype": "float32",
            "max_abs_err": max(c["max_abs_err"] for c in cases), "rtol": SCAN_RTOL,
            **timed[512], "at_decode": timed[1], "cases": cases}


def ssd_inputs(gen, S: int, G: int, with_state: bool):
    """SSD's inputs at zamba2-7b's shape: x (B,S,H,P), B and C (B,S,G,N) as
    views of one (B, S, H·P + 2·G·N) buffer, as the Mamba2 block passes its
    conv output; dt (B,S,H) after softplus, A < 0, D = 1; the state or
    None."""
    B, H, P, N = SSD_SHAPE
    buf = randn((B, S, H * P + 2 * G * N), torch.float32, gen)
    x, Bm, Cm = torch.split(buf, [H * P, G * N, G * N], dim=-1)
    dt = torch.nn.functional.softplus(randn((B, S, H), torch.float32, gen))
    A = -torch.exp(randn((H,), torch.float32, gen) * 0.3)
    args = [x.unflatten(-1, (H, P)), dt, A, Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N)),
            torch.ones(H, device="cuda")]
    return args, randn((B, H, P, N), torch.float32, gen) if with_state else None


def ssd_phase(gen) -> dict:
    """SSD at zamba2-7b's shape against the plain version the CPU takes
    (chunked, padded, groups expanded; the step oracle at S = 1): at
    S = 512 with one group (the main path's layout) and head-expanded
    (G = H), at S = 500 and 1 with a state, and writing the state in place
    (``out_state`` is ``state``) at S = 500 and 1.  Then timed, in the main
    path's layout, at S = 512 and at S = 1 in place: the kernel's device
    time from the profiler, beside the time of a call back to back by CUDA
    events, the bound at the kernel's own route (3xTF32 on the tensor cores
    for S > 1; the decode step runs on the CUDA cores) and the CUDA-core
    fp32 bound."""
    B, H, P, N = SSD_SHAPE
    cases = []
    for S, G, with_state, in_place in ((512, 1, False, False), (512, H, False, False),
                                       (500, 1, True, False), (1, 1, True, False),
                                       (500, 1, True, True), (1, 1, True, True)):
        args, state = ssd_inputs(gen, S, G, with_state)
        y_ref, st_ref = ops.ssd(*args, state, backend="chunked" if S > 1 else "ref")
        y64, st64 = ops.ssd(*(a.double() for a in args),
                            None if state is None else state.double(), backend="ref")
        if in_place:
            st_in = state.clone()
            y, st = ops.ssd(*args, st_in, out_state=st_in, backend="cuda")
            check(st is st_in, f"ssd S={S}: out_state was not the state it was given")
        else:
            y, st = ops.ssd(*args, state, backend="cuda")
        torch.cuda.synchronize()
        what = f"ssd S={S} G={G}" + (" in place" if in_place else "")
        err, bnd = _scan_err(y, st, y_ref, st_ref, what)
        # against fp64: fails a kernel whose products are not fp32-exact
        y_top, st_top = y64.abs().max().item() or 1.0, max(1.0, st64.abs().max().item())
        rel = (y.double() - y64).abs().max().item() / y_top
        rel_s = (st.double() - st64).abs().max().item() / st_top
        check(rel <= SSD_EXACT_RTOL and rel_s <= SSD_EXACT_RTOL,
              f"{what}: against fp64, y err {rel:.2e} x max|y|, state err {rel_s:.2e} x "
              f"max(1, max|state|) > {SSD_EXACT_RTOL}")
        cases.append({"shape": [B, S, H, P, N], "groups": G, "state": with_state,
                      "in_place": in_place, "dtype": "float32", "max_abs_err": err,
                      "bound": bnd, "rel_err_fp64": rel, "state_rel_err_fp64": rel_s,
                      "bound_fp64": SSD_EXACT_RTOL})
        say(f"{what} B={B} H={H} P={P} N={N} state={with_state} fp32: "
            f"y max abs err {err:.3e} (bound {bnd:.3e} = {SCAN_RTOL} x max|y|); against "
            f"fp64 {rel:.2e} x max|y|, state {rel_s:.2e} (bound {SSD_EXACT_RTOL})")

    timed = {}
    for S, with_state in ((512, False), (1, True)):
        args, state = ssd_inputs(gen, S, 1, with_state)
        call = time_ms(lambda: ops.ssd(*args, state, out_state=state, backend="cuda"))
        ms = kernel_ms(lambda: ops.ssd(*args, state, out_state=state, backend="cuda"),
                       "ssd_fwd_kernel" if S > 1 else "ssd_step_kernel")
        plain = time_ms(lambda: ops.ssd(*args, state, backend="chunked" if S > 1 else "ref"),
                        samples=5, per_sample=1)
        work = ssd_work(B, S, H, P, N, with_state, 1)
        b_ms, b_by = bound_ms(*work, FP32_AS_3XTF32 if S > 1 else torch.float32)
        b_cores, by_cores = bound_ms(*work, torch.float32)
        timed[S] = {"shape": [B, S, H, P, N], "groups": 1, "ms": ms, "call_ms": call,
                    "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        say(f"ssd B={B} S={S} H={H} P={P} N={N} G=1 fp32{' in place' if with_state else ''}: "
            f"{ms:.4f} ms on the card ({call:.4f} ms a call back to back); plain "
            f"{plain:.4f} ms; no single library call; bound {b_ms:.4f} ms "
            f"({b_by}{', 3xTF32 tensor cores' if S > 1 else ''}; {b_ms / ms:.1%} of it "
            f"reached); on the fp32 CUDA cores it would be {b_cores:.4f} ms ({by_cores})")
    return {"name": "ssd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:61", "dtype": "float32",
            "max_abs_err": max(c["max_abs_err"] for c in cases), "rtol": SCAN_RTOL,
            **timed[512], "at_decode": timed[1], "cases": cases}


# ---------------------------------------------------------------------------
# phases 4 and 5: serving
# ---------------------------------------------------------------------------

def make_prompts(cfg, lens=PROMPT_LENS):
    """Ragged prompts of 384-512 tokens (``lens``, inclusive) for the dense
    family; 512 each for the recurrent families, which need equal lengths."""
    rs = np.random.default_rng(SEED)
    n = rs.integers(lens[0], lens[1] + 1, size=BATCH)
    n[0] = lens[1]
    if cfg.family in ("ssm", "hybrid"):
        n[:] = lens[1]
    return [rs.integers(0, cfg.vocab_size, k).astype(np.int32) for k in n]


def expected_launches(cfg) -> dict:
    """Each kernel's launches for one served batch (a prefill and MAX_NEW
    decode steps), counted from the model code."""
    fwd, L = 1 + MAX_NEW, cfg.num_layers
    if cfg.family in ("dense", "moe", "vlm"):
        # per layer ln1 and ln2 (ln1 alone in a parallel block) where they are
        # RMSNorms (LayerNorms are plain PyTorch), qk_norm's two, MLA's latent
        # norm (and its q LoRA's), and ln_f; flash at prefill (not MLA's)
        rms = cfg.norm_kind == "rmsnorm"
        norms = (1 if cfg.parallel_block else 2) * rms + 2 * cfg.qk_norm
        mla = cfg.attn_kind == "mla"
        norms += mla * (1 + bool(cfg.q_lora_rank))
        return dict(NO_LAUNCHES, rmsnorm=(norms * L + rms) * fwd,
                    flash_attention=0 if mla else L)
    if cfg.family == "audio":      # LayerNorms; flash: the encoder and the decoder's
        # cached prefill once, cross-attention at every forward
        return dict(NO_LAUNCHES, flash_attention=cfg.encoder_layers + L + L * fwd)
    if cfg.family == "hybrid":     # ln and the gated inner norm per Mamba2 layer,
        groups = L // cfg.shared_attn_every    # ln1 and ln2 per shared-block application
        return dict(NO_LAUNCHES, rmsnorm=(2 * L + 2 * groups + 1) * fwd,
                    flash_attention=groups, ssd=L * fwd)
    return dict(NO_LAUNCHES, wkv6=L * fwd)    # rwkv6: LayerNorms are plain PyTorch


def check_outputs(outs, vocab: int, what: str) -> None:
    check(len(outs) == BATCH and all(len(o) == MAX_NEW for o in outs),
          f"{what}: wrong number of tokens")
    check(all(0 <= t < vocab for o in outs for t in o), f"{what}: token out of range")


def device_ms_by_kernel(run, extra=None, ranges=()) -> dict:
    """Device time of the kernels one call of ``run`` launches, by class, in
    ms, from a torch.profiler trace (kernels on one stream do not overlap,
    so the sum is the time the card was busy).  ``extra`` maps more
    classes to name fragments, looked up after the kernels' own.
    ``ranges`` are names of ``record_function`` ranges in the program
    whose kernels' device time is returned under ``"of which <range>"``:
    a split of time already counted in the classes, not a class."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {"gemm": 0.0, "flash_attention": 0.0, "rmsnorm": 0.0, "ssd": 0.0, "wkv6": 0.0,
           **{k: 0.0 for k in (extra or {})}, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        kind = ("flash_attention" if "flash_fwd_kernel" in name else
                "rmsnorm" if "rmsnorm_kernel" in name else
                "ssd" if ("ssd_fwd_kernel" in name or "ssd_step_kernel" in name) else
                "wkv6" if ("wkv6_fwd_kernel" in name or "wkv6_step_kernel" in name) else
                "gemm" if ("gemm" in name or "gemv" in name) else
                next((k for k, frags in (extra or {}).items()
                      if any(f in name for f in frags)), "other"))
        out[kind] += ev.self_device_time_total / 1e3
    for name in ranges:
        out[f"of which {name}"] = sum(ev.device_time_total for ev in prof.key_averages()
                                      if ev.key == name) / 1e3
    return out


def breakdown_phase(engine, prompts, tag: str, extra=None, frames=None, ranges=()) -> dict:
    """Where the time of a served batch goes: the prefill with one decode
    step, and four more decode steps (the difference of two profiled runs),
    device time by kernel class beside the host's wall time (with
    ``ranges``, the device time inside those program ranges beside it)."""
    runs = {}
    for n in (1, 5):
        dev = device_ms_by_kernel(lambda: engine.generate(prompts, max_new=n, frames=frames),
                                  extra, ranges)
        runs[n] = (dev, engine.last_timing)
    dev1, t1 = runs[1]
    dev5, t5 = runs[5]
    spans = {"prefill+1 step": (dev1, (t1["prefill_s"] + t1["decode_s"][0]) * 1e3),
             "4 decode steps": ({k: dev5[k] - dev1[k] for k in dev1},
                                sum(t5["decode_s"][1:]) * 1e3)}
    for span, (dev, wall) in spans.items():
        busy = sum(v for k, v in dev.items() if not k.startswith("of which"))
        if busy <= 0:      # the profiler saw no kernel: say so, time nothing
            say(f"profile {tag} {span}: wall {wall:.1f} ms, device time not measured")
            continue
        say(f"profile {tag} {span}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
            f"({busy / wall:.1%}); " + ", ".join(f"{k} {v:.1f} ms" for k, v in dev.items()))
    return {span: {"wall_ms": wall, "device_ms": dev} for span, (dev, wall) in spans.items()}


def init_model(cfg):
    """The served model at full size, random weights from SEED; returns it with
    its init time in seconds."""
    t0 = time.perf_counter()
    model = M.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def free() -> None:
    """Return what the caller has dropped to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def serving_phase(cfg, model, init_s: float, prompts, extra=None,
                  max_seq: int = MAX_SEQ, frames=None, ranges=()) -> dict:
    n_params = sum(p.numel() for p in model.parameters())
    engine = make_engine(cfg, model, mode="fixed", batch_size=BATCH, max_seq=max_seq)
    engine.generate(prompts, max_new=2, frames=frames)   # warm-up: cuBLAS handles, allocator

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    outs = engine.generate(prompts, max_new=MAX_NEW, frames=frames)
    launches = dict(ops.LAUNCHES)
    by_shape = dict(ops.LAUNCHES_BY_SHAPE)
    peak = torch.cuda.max_memory_allocated()

    L = cfg.num_layers
    want = expected_launches(cfg)
    timing = engine.last_timing
    prefill_ms = timing["prefill_s"] * 1e3
    decode_ms = statistics.median(timing["decode_s"]) * 1e3
    tok_s = BATCH * MAX_NEW / sum(timing["decode_s"])
    prompt_tokens = int(sum(len(p) for p in prompts))
    tag = f"serving {cfg.name}"
    say(f"{tag}: {n_params} params fp32, {L} layers, init {init_s:.2f} s")
    say(f"{tag}: batch {BATCH}, prompts {[len(p) for p in prompts]} "
        f"({prompt_tokens} tokens), max_new {MAX_NEW}, max_seq {max_seq}")
    say(f"{tag}: prefill {prefill_ms:.1f} ms ({prompt_tokens / timing['prefill_s']:.0f} "
        f"prompt tok/s); decode {decode_ms:.2f} ms/token (median step); "
        f"{tok_s:.1f} generated tok/s; peak memory {peak / 2**30:.2f} GiB")
    say(f"{tag}: launches {launches} (expected {want}); request 0: {outs[0][:8]}...")
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    check_outputs(outs, cfg.vocab_size, tag)
    forced = engine.teacher_forced_logits(prompts, outs, frames=frames)
    check(bool(torch.isfinite(forced).all()), f"{tag}: non-finite logits")
    check(forced.argmax(-1).tolist() == outs,
          f"{tag}: greedy tokens are not the argmax of their teacher-forced logits")
    profile = breakdown_phase(engine, prompts, tag, extra, frames, ranges)
    del engine, forced
    free()
    return {"arch": cfg.name, "launches": launches, "launches_by_shape": by_shape,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms, "tokens_per_s": tok_s, "peak_bytes": peak,
            "prompt_tokens": prompt_tokens, "max_seq": max_seq, "profile": profile}


def slice_parity_phase(cfg, prompts, *, layers=None, max_seq: int = MAX_SEQ) -> dict:
    cfg2 = cfg.replace(num_layers=layers or PARITY_LAYERS[cfg.name])
    model = M.init_params(cfg2, SEED + 1, device="cuda")
    kern = make_engine(cfg2, model, batch_size=BATCH, max_seq=max_seq)
    plain = make_engine(cfg2, model, batch_size=BATCH, max_seq=max_seq, backend="ref")
    outs_k = kern.generate(prompts, max_new=MAX_NEW)
    ops.reset_launches()
    outs_r = plain.generate(prompts, max_new=MAX_NEW)
    check(ops.LAUNCHES == NO_LAUNCHES, "backend='ref' launched a kernel")
    check_outputs(outs_k, cfg.vocab_size, "slice parity")
    lk = kern.teacher_forced_logits(prompts, outs_k)
    lr = plain.teacher_forced_logits(prompts, outs_k)
    err = (lk - lr).abs().max().item()
    same = float(np.mean(np.asarray(outs_k) == np.asarray(outs_r)))
    say(f"slice parity {cfg.name} ({cfg2.num_layers} layers, full width): "
        f"teacher-forced logits max abs err "
        f"{err:.3e} (bound {SLICE_LOGITS_BOUND}); greedy tokens equal: {same:.3f}")
    check(bool(torch.isfinite(lk).all()), "slice parity: non-finite logits")
    check(err <= SLICE_LOGITS_BOUND, f"slice parity: logits err {err} > {SLICE_LOGITS_BOUND}")
    del kern, plain, model
    free()
    return {"arch": cfg.name, "layers": cfg2.num_layers, "window": cfg2.sliding_window,
            "prompts": [len(p) for p in prompts], "max_seq": max_seq, "max_abs_err": err,
            "tokens_equal": same}


# ---------------------------------------------------------------------------
# phase 6: the tuner and the plan bridge
# ---------------------------------------------------------------------------

def plan_fingerprint(plan, digest) -> dict:
    """sha256 of a tuned plan's configs (as ``to_json`` writes them) and of
    the ``plan_digest`` of its lowering, with the count of configs: what
    ``REFERENCE_A40_PLANS`` stores for the reference's plans."""
    configs = json.loads(plan.to_json())["configs"]

    def sha(obj):
        text = json.dumps(obj, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(text.encode()).hexdigest()

    return {"configs": sha(configs), "plan_digest": sha([list(r) for r in digest]),
            "sites": len(configs), "artifact_digest": plan.artifact_digest()}


def gemm_shapes(cfg, wl, spec: dict) -> list:
    """(name, m, k, n) of the bf16 GEMMs of layer 0's forward groups of the
    tp workload ``wl``: k and n from the config at the tp degree, m from
    the CompOp's FLOPs, checked against its bytes."""
    pp = ParallelPlan(**spec)
    tp, mb = pp.tp, pp.microbatches
    hq, hkv, f = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.d_ff // tp
    kn = {"attn.qkv": (cfg.d_model, (hq + 2 * hkv) * cfg.head_dim),
          "attn.o": (hq * cfg.head_dim, cfg.d_model),
          "mlp.up0": (cfg.d_model, f), "mlp.up1": (cfg.d_model, f),
          "mlp.down": (f, cfg.d_model)}
    shapes = []
    for g in wl.groups:
        if g.name not in ("fwd.L0.attn", "fwd.L0.mlp"):
            continue
        for op in g.comps:
            name = op.name.removesuffix(".fwd")
            if name not in kn:
                continue                      # the attention core is no GEMM
            k, n = kn[name]
            m = round(op.flops / (2 * k * n * mb))     # rows of one microbatch
            check(op.flops == mb * 2.0 * m * k * n
                  and op.bytes_rw == mb * pp.dsize * float(m * k + k * n + m * n),
                  f"GEMM {op.name}: ({m}, {k}, {n}) does not give its CompOp")
            shapes.append((name, m, k, n))
    check(len(shapes) == len(kn), f"found GEMMs {shapes}")
    return shapes


def gemm_eff_phase(cfg, wl, spec: dict, card: str) -> dict:
    """Achieved share of the bf16 peak of ``torch.matmul`` at the tp
    workload's GEMM shapes, by CUDA events (a measurement for the h100-sxm
    profile's ``gemm_eff``; the port never calls it)."""
    peak = by_name("h100-sxm").peak_flops
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, flops, ms = [], 0.0, 0.0
    for name, m, k, n in gemm_shapes(cfg, wl, spec):
        a = randn((m, k), torch.bfloat16, gen)
        b = randn((k, n), torch.bfloat16, gen)
        t = time_ms(lambda: torch.matmul(a, b))
        f = 2.0 * m * k * n
        rows.append({"gemm": name, "m": m, "k": k, "n": n, "ms": t,
                     "eff": f / (t * 1e-3) / peak})
        flops, ms = flops + f, ms + t
        del a, b
    eff = flops / (ms * 1e-3) / peak
    for r in rows:
        say(f"plan: bf16 GEMM {r['gemm']} ({r['m']} x {r['k']} x {r['n']}): "
            f"{r['ms']:.4f} ms, {r['eff']:.4f} of {peak / 1e12:.1f} TFLOP/s")
    say(f"plan: gemm_eff measured {eff:.4f} (all five GEMMs), profile h100-sxm "
        f"{by_name('h100-sxm').gemm_eff} ({card})")
    torch.cuda.empty_cache()
    return {"gemm_eff": eff, "gemms": rows}


def plan_phase(card: str) -> dict:
    cfg = get_config(PLAN_ARCH)
    out = {"tune_ms": {}, "artifact_digest_matches": {}}
    wls, a40 = {}, {}
    for name, spec in PLAN_WORKLOADS.items():
        wls[name] = extract_workload(cfg, ParallelPlan(**spec), seq=PLAN_SEQ,
                                     global_batch=PLAN_BATCH)
        for hw in ("a40-nvlink", "h100-sxm"):
            t0 = time.perf_counter()
            plan = tune(wls[name], hw, method="lagom")
            dt = (time.perf_counter() - t0) * 1e3
            out["tune_ms"][f"{name} {hw}"] = dt
            say(f"plan: tune {PLAN_ARCH} {name} for {hw} (lagom): {dt:.1f} ms host "
                f"wall, {len(plan.configs)} sites, {plan.profile_count} profiles ({card})")
            if hw == "a40-nvlink":
                a40[name] = plan
        got = plan_fingerprint(a40[name], plan_digest(a40[name].runtime_plan()))
        want = REFERENCE_A40_PLANS[name]
        for key in ("sites", "configs", "plan_digest"):
            check(got[key] == want[key], f"plan {name} on a40-nvlink: the port's "
                  f"{key} {got[key]} is not the reference's {want[key]}")
        same = got["artifact_digest"] == want["artifact_digest"]
        out["artifact_digest_matches"][name] = same
        say(f"plan: {name} on a40-nvlink reproduces the reference's plan_digest and "
            f"configs; artifact_digest {'matches' if same else 'differs'} "
            "(information only)")

    with tempfile.TemporaryDirectory() as d:
        paths = {}
        for name, plan in a40.items():
            paths[name] = os.path.join(d, f"{name.replace(':', '')}.json")
            plan.save(paths[name])
            check(TunedPlan.load(paths[name]).to_json() == plan.to_json(),
                  f"plan {name} changed through its JSON file")
        base = activate(paths["fsdp:8"])
        scoped = TunedPlan.load(paths["tp:8"])
    wl = wls["tp:8"]
    sites = [(f"tp.layer{i}.mlp.{leg}", leg) for i in range(cfg.num_layers)
             for leg in ("ag", "rs")]
    with scoped.applied(wl) as rt:
        check(plan_digest(rt) == plan_digest(a40["tp:8"].runtime_plan()),
              "the tp plan lowers differently after its JSON round trip")
        for site, leg in sites:
            want = rt[site.rsplit(".", 1)[0]]
            check(collectives.runtime_for(site, leg) == want,
                  f"{site} under applied(): {collectives.runtime_for(site, leg)} "
                  f"is not the plan's {want}")
    for site, leg in sites:
        got = collectives.resolve_runtime(site, leg)
        check(got == (base[leg], leg, "class"),
              f"{site} outside applied(): {got} is not the base plan's {base[leg]}")
    check(collectives.active_runtime_plan() == base, "the base plan did not stay")
    collectives.install_runtime_plan(None)
    pairs = sorted({(r.strategy, r.num_chunks) for r in rt.values()})
    findings = lint_plan(scoped, workload=wl)
    check(not errors(findings), format_findings(findings, label="the tp plan"))
    say(f"plan: tp:8 lowered to {len(rt)} entries for {len(scoped.sites)} sites, "
        f"(strategy, num_chunks) pairs {pairs}; {2 * cfg.num_layers} "
        "tp.layer{i}.mlp.ag|rs sites resolve to it under applied() and to the "
        f"base fsdp plan outside")
    say(format_findings(findings, label="the tp plan"))
    out.update(sites=len(scoped.sites), entries=len(rt), pairs=pairs,
               findings=[f.code for f in findings])
    out.update(gemm_eff_phase(cfg, wl, PLAN_WORKLOADS["tp:8"], card))
    return out


# ---------------------------------------------------------------------------
# phase 7: plans drive the collectives (a 1-rank NCCL group)
# ---------------------------------------------------------------------------

AG_BOUND, RS_BOUND, A2A_BOUND = 1e-4, 1e-3, 1e-6   # the reference's, tests/test_collectives.py
PLAN_SERVE_BOUND = 1e-4                  # planned vs unplanned teacher-forced logits, fp32
# plan (b): layer 0 and layer 1 chunk their gate/up ring differently
# (the reference's tests/test_serving_plan.py:78)
PLAN_B = {"serve.layer0.mlp.ag": ("ring", 2), "serve.layer1.mlp.ag": ("ring", 4)}
HELPER_CHUNKS = (1, 2, 4)


def nccl_mesh(tmpdir: str):
    """A 1-rank NCCL process group from a FileStore, and the mesh over it:
    NCCL really launches, with no address or port.  A failed init raises."""
    import torch.distributed as dist

    store = dist.FileStore(os.path.join(tmpdir, "nccl_store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    mesh = make_mesh()
    check(mesh.size == 1 and mesh.group is not None, f"mesh {mesh}")
    return mesh


def _max_err(got, want) -> float:
    if isinstance(got, dict):
        return max(_max_err(got[k], want[k]) for k in got)
    check(got.shape == want.shape, f"shape {tuple(got.shape)}, expected {tuple(want.shape)}")
    return (got - want).abs().max().item()


def collective_helpers_phase(cfg, mesh, card: str) -> list:
    """Each chunked helper over the NCCL group, on CUDA fp32 tensors at
    llama3-8b's MLP shapes (prefill's 8 x 512 rows), held against its
    ``*_ref`` (at one rank the all-to-all and the summed tree are their
    inputs) and timed beside the plain product."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    D, F, T = cfg.d_model, cfg.d_ff, BATCH * PROMPT_LENS[1]
    x = randn((1, T, D), torch.float32, gen)
    w = randn((D, F), torch.float32, gen) / D ** 0.5
    h = randn((1, T, F), torch.float32, gen)
    wd = randn((F, D), torch.float32, gen) / F ** 0.5
    tree = {"gate": w, "down": wd}
    C = collectives
    refs = {"ring_ag_matmul": (lambda: C.ag_matmul_ref(x, w), AG_BOUND),
            "mm_reduce_scatter": (lambda: C.mm_rs_ref(h, wd), RS_BOUND),
            "chunked_all_to_all": (lambda: h, A2A_BOUND),
            "psum_tree_chunked": (lambda: C.psum_tree(tree, mesh), A2A_BOUND)}
    plain = {name: time_ms(fn, samples=5, per_sample=2) for name, (fn, _) in refs.items()
             if name in ("ring_ag_matmul", "mm_reduce_scatter")}
    rows = []
    for nc in HELPER_CHUNKS:
        calls = {"ring_ag_matmul": lambda: C.ring_ag_matmul(x, w, mesh, num_chunks=nc),
                 "mm_reduce_scatter": lambda: C.mm_reduce_scatter(h, wd, mesh, num_chunks=nc),
                 "chunked_all_to_all": lambda: C.chunked_all_to_all(
                     h, mesh, split_axis=1, concat_axis=1, num_chunks=nc),
                 "psum_tree_chunked": lambda: C.psum_tree_chunked(tree, mesh, num_chunks=nc)}
        for name, fn in calls.items():
            ref_fn, bound = refs[name]
            with C.record_issued() as issued:
                y = fn()
            torch.cuda.synchronize()
            err = _max_err(y, ref_fn())
            structure = [(r.num_chunks, r.matmuls, r.collectives) for r in issued]
            ms = time_ms(fn, samples=5, per_sample=2)
            say(f"plan serving: {name} num_chunks={nc} over NCCL: max abs err {err:.3e} "
                f"(bound {bound}); issued (chunks, matmuls, collectives) {structure}; "
                f"{ms:.4f} ms" + (f", plain product {plain[name]:.4f} ms" if name in plain
                                  else "") + f" ({card})")
            check(err <= bound, f"{name} num_chunks={nc}: max abs err {err} > {bound}")
            want_coll = 0 if name == "ring_ag_matmul" else nc      # no ring hop at one rank
            check(all(r.num_chunks == nc and r.collectives == want_coll for r in issued),
                  f"{name} num_chunks={nc} issued {issued}")
            rows.append({"helper": name, "num_chunks": nc, "max_abs_err": err, "bound": bound,
                         "ms": ms, "plain_ms": plain.get(name), "issued": structure})
    del x, w, h, wd, tree
    free()
    return rows


def issued_summary(rows) -> dict:
    """The issued structure of a served batch: for each (helper, chunks),
    the sites, the calls, and the matmuls and collectives they issued."""
    out = {}
    for r in rows:
        key = f"{r.op} x{r.num_chunks}"
        e = out.setdefault(key, {"sites": set(), "calls": 0, "matmuls": 0, "collectives": 0})
        e["sites"].add(r.site)
        e["calls"] += 1
        e["matmuls"] += r.matmuls
        e["collectives"] += r.collectives
    return {k: dict(v, sites=len(v["sites"])) for k, v in sorted(out.items())}


def plan_serving_phase(cfg, model, prompts, card: str, mesh) -> dict:
    """Phase 7: llama3-8b at full size on the 1-rank NCCL mesh under plan (a),
    tuned by the port for tp:8 decode on h100-sxm, and plan (b), beside the
    unplanned engine, in turns (none, a, b, b, a, none)."""
    helpers = collective_helpers_phase(cfg, mesh, card)
    wl = extract_decode_workload(cfg, parse_parallel("tp:8"), global_batch=BATCH,
                                 seq=MAX_SEQ)
    plans = {"a": tune(wl, "h100-sxm", method="lagom"),
             "b": {k: collectives.CollectiveRuntime(*v) for k, v in PLAN_B.items()}}
    engines = {"none": make_engine(cfg, model, batch_size=BATCH, max_seq=MAX_SEQ)}
    for name, plan in plans.items():
        engines[name] = make_engine(cfg, model, batch_size=BATCH, max_seq=MAX_SEQ,
                                    plan=plan, mesh=mesh)
    for e in engines.values():
        e.generate(prompts, max_new=2)          # warm-up
    times = {name: [] for name in engines}
    record = {}
    for name in ("none", "a", "b", "b", "a", "none"):
        engine = engines[name]
        collectives.reset_degraded_warnings()
        ops.reset_launches()
        with warnings.catch_warnings(record=True) as ws, \
                collectives.record_issued() as issued:
            warnings.simplefilter("always")
            outs = engine.generate(prompts, max_new=MAX_NEW)
        launches = dict(ops.LAUNCHES)
        t = engine.last_timing
        times[name].append((t["prefill_s"] * 1e3,
                            statistics.median(t["decode_s"]) * 1e3))
        if name not in record:
            degraded = sum(issubclass(w.category, collectives.CollectiveDegradedWarning)
                           for w in ws)
            record[name] = {"outs": outs, "launches": launches, "degraded": degraded,
                            "issued": issued_summary(issued), "rows": issued}
    base = record["none"]["outs"]
    check_outputs(base, cfg.vocab_size, "plan serving, unplanned")
    forced = {name: e.teacher_forced_logits(prompts, base)
              for name, e in engines.items()}
    want = expected_launches(cfg)
    out = {"helpers": helpers, "plans": {}, "card": card,
           "unplanned": {"prefill_ms": [p for p, _ in times["none"]],
                         "decode_ms": [d for _, d in times["none"]]}}
    say(f"plan serving: unplanned engine: prefill {times['none'][0][0]:.1f} / "
        f"{times['none'][1][0]:.1f} ms, decode {times['none'][0][1]:.2f} / "
        f"{times['none'][1][1]:.2f} ms/token (first / last turn) ({card})")
    for name in plans:
        r = record[name]
        err = (forced[name] - forced["none"]).abs().max().item()
        same = r["outs"] == base
        layers01 = sorted({(row.site, row.num_chunks) for row in r["rows"]
                           if row.site.startswith(("serve.layer0.", "serve.layer1."))})
        say(f"plan serving: plan ({name}): prefill {times[name][0][0]:.1f} / "
            f"{times[name][1][0]:.1f} ms, decode {times[name][0][1]:.2f} / "
            f"{times[name][1][1]:.2f} ms/token (unplanned {times['none'][0][0]:.1f}, "
            f"{times['none'][0][1]:.2f}); teacher-forced logits max abs diff from "
            f"unplanned {err:.3e} (bound {PLAN_SERVE_BOUND}); tokens equal: {same}; "
            f"CollectiveDegradedWarnings {r['degraded']}; launches {r['launches']} "
            f"({card})")
        say(f"plan serving: plan ({name}) issued {r['issued']}; layers 0-1 "
            f"(site, chunks) {layers01}")
        check(r["launches"] == want,
              f"plan ({name}): launches {r['launches']}, expected {want}")
        check(bool(torch.isfinite(forced[name]).all()), f"plan ({name}): non-finite")
        check(err <= PLAN_SERVE_BOUND,
              f"plan ({name}): logits differ by {err} > {PLAN_SERVE_BOUND}")
        check(r["issued"], f"plan ({name}): no collective helper ran")
        out["plans"][name] = {
            "prefill_ms": [p for p, _ in times[name]],
            "decode_ms": [d for _, d in times[name]], "max_abs_logit_diff": err,
            "tokens_equal": same, "degraded_warnings": r["degraded"],
            "launches": r["launches"], "issued": r["issued"], "layers01": layers01}
    check(dict(out["plans"]["b"]["layers01"])["serve.layer1.mlp.ag"] == 4
          and dict(out["plans"]["b"]["layers01"])["serve.layer0.mlp.ag"] == 2,
          "plan (b) did not chunk layers 0 and 1 as it says")
    del engines, forced
    free()
    return out


# ---------------------------------------------------------------------------
# phase 8: training (llama3-8b at full width, 4 layers)
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4         # fp32 AdamW keeps 16 B a parameter: 128 GB at 32 layers
TRAIN_STEPS = 3
TRAIN_MODES = {"plain": {}, "grad_accum=2": dict(grad_accum=2),
               "microbatches=2": dict(microbatches=2), "acco": dict(grad_accum=2)}
TRAIN_OPT = dict(lr=3e-5)   # a fresh AdamW state per mode: its first steps move every
                            # weight by about lr
# one step through the kernels against backend="ref" and against the sited
# trunk, fp32: updated parameters (abs), AdamW's mu (of its max per
# parameter: mu is 0.1 x the clipped gradient after one step, as the CPU
# tests bound gradients), loss and grad_norm (relative, as the CPU step tests)
PARITY_TRAIN = dict(layers=2, B=1, S=512, bound=1e-4, mu_bound=1e-4, rel_bound=1e-5)
# a parameter whose gradient is zero but for rounding (whisper's key biases:
# a bias adds the same q·b to every score of a row, and no rotary position
# tells the keys apart) has no relative error to hold: its mu, in the first
# step and the other, must stay below this share of the model's largest mu
PARITY_ZERO = 1e-6
# Adam's first step is sign(g) where |g| >> eps: a near-zero gradient element
# whose sign is rounding noise flips its update by 2 lr.  The parity step uses
# eps = 1e-3, which bounds the update's sensitivity to a gradient error by lr/eps.
PARITY_OPT = dict(lr=3e-4, eps=1e-3)


def expected_train_launches(cfg, passes: int) -> dict:
    """Each kernel's launches in one train step of ``passes`` forward and
    backward passes with per-layer remat: a layer's ln1, ln2 (ln1 alone in
    a parallel block) where they are RMSNorms (LayerNorms are plain
    PyTorch), qk_norm's two, MLA's latent norms (``kv_a_norm``, and
    ``q_a_norm`` with a q LoRA), and its flash calls (none under MLA, whose
    scores are plain; a decoder layer of the audio family two, self- and
    cross-attention, and each encoder layer one) run in the forward and
    again in its recompute, ln_f once; each backward pass runs each once."""
    if cfg.family == "hybrid":
        # zamba2: remat checkpoints each Mamba layer (its ln, gated norm and
        # SSD scan run in the forward and the recompute), not the shared
        # block (ln1, ln2 and flash once each way a group), ln_f once
        L, groups = cfg.num_layers, cfg.num_layers // cfg.shared_attn_every
        return dict(NO_LAUNCHES, rmsnorm=passes * (4 * L + 2 * groups + 1),
                    rmsnorm_bwd=passes * (2 * L + 2 * groups + 1), ssd=passes * 2 * L,
                    ssd_bwd=passes * L, flash_attention=passes * groups,
                    flash_attention_bwd=passes * groups)
    L, rms, mla = cfg.num_layers, cfg.norm_kind == "rmsnorm", cfg.attn_kind == "mla"
    n = ((1 if cfg.parallel_block else 2) * rms + 2 * cfg.qk_norm
         + mla * (1 + bool(cfg.q_lora_rank)))
    audio = cfg.family == "audio"
    f = (0 if mla else 1 + audio) * L + audio * cfg.encoder_layers
    return dict(NO_LAUNCHES, rmsnorm=passes * (2 * n * L + rms),
                rmsnorm_bwd=passes * (n * L + rms), flash_attention=passes * 2 * f,
                flash_attention_bwd=passes * f)


def train_ms_by_class(run) -> dict:
    """Device time of one call of ``run`` by kernel class, from a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {"gemm": 0.0, "flash_fwd": 0.0, "flash_bwd": 0.0, "rmsnorm_fwd": 0.0,
           "rmsnorm_bwd": 0.0, "ssd_fwd": 0.0, "ssd_bwd": 0.0, "nccl": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        kind = ("flash_bwd" if "flash_bwd_" in name else
                "flash_fwd" if "flash_fwd_kernel" in name else
                "rmsnorm_bwd" if ("rmsnorm_bwd_kernel" in name or "rmsnorm_dscale" in name) else
                "rmsnorm_fwd" if "rmsnorm_kernel" in name else
                "ssd_bwd" if "ssd_bwd_" in name else
                "ssd_fwd" if ("ssd_fwd_kernel" in name or "ssd_step_kernel" in name) else
                "nccl" if "nccl" in name else
                "gemm" if ("gemm" in name or "gemv" in name) else "other")
        out[kind] += ev.self_device_time_total / 1e3
    return out


def param_sums(model) -> dict:
    """Each parameter's sum in fp64: what shows that every parameter moved."""
    return {n: p.detach().double().sum().item() for n, p in model.named_parameters()}


def train_phase(card: str, mesh) -> dict:
    """Phase 8: llama3-8b at full width and 4 layers, fp32, trained for
    three steps in each mode from the port's SyntheticCorpus (batch 4 x seq
    2048, remat, warmup_cosine), ACCO's gradient sync over the 1-rank NCCL
    mesh under a plan the port tunes for fsdp:8 with two accumulation
    steps; then a profiler trace of one plain step and the parity steps."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.optim import adamw
    from repro_torch.train import metrics as MET, trainer as T

    cfg = get_config(PLAN_ARCH).replace(num_layers=TRAIN_LAYERS)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                        global_batch=TRAIN_B, seed=SEED))
    tokens = TRAIN_B * TRAIN_S
    t0 = time.perf_counter()
    model = M.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"train {cfg.name}: {TRAIN_LAYERS} layers at full width, {n_params} params fp32, "
        f"init {time.perf_counter() - t0:.2f} s; batch {TRAIN_B} x seq {TRAIN_S}, remat, "
        f"warmup_cosine ({card})")
    before = param_sums(model)
    pp = ParallelPlan(kind="fsdp", dp=8, accum_steps=2)
    t0 = time.perf_counter()
    plan = tune(extract_workload(cfg, pp, seq=TRAIN_S, global_batch=8 * TRAIN_B),
                "h100-sxm", method="lagom")
    with plan.applied():
        acc_knobs = {s: collectives.runtime_for(s).num_chunks
                     for s in ("acc.step0.rs_grads", "acc.step1.rs_grads")}
    say(f"train: plan tuned for fsdp:8 with 2 accumulation steps on h100-sxm in "
        f"{time.perf_counter() - t0:.1f} s; acc sites resolve to chunks {acc_knobs}")

    modes, step = {}, 0
    for name, kw in TRAIN_MODES.items():
        acco = name == "acco"
        tcfg = T.TrainConfig(opt=adamw.AdamWConfig(**TRAIN_OPT), warmup=2, total_steps=100,
                             accum_axis=mesh if acco else None, **kw)
        step_fn = T.make_train_step(cfg, tcfg)
        state = adamw.init_state(dict(model.named_parameters()))
        passes = kw.get("grad_accum", kw.get("microbatches", 1))
        times, losses, norms = [], [], []
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with plan.applied(), collectives.record_issued() as issued:
            for _ in range(TRAIN_STEPS):
                batch = {k: torch.as_tensor(v, device="cuda")
                         for k, v in corpus.batch(step).items()}
                torch.cuda.synchronize()
                t = time.perf_counter()
                model, state, m = step_fn(model, state, batch, step)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                step += 1
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        want = {k: TRAIN_STEPS * v for k, v in expected_train_launches(cfg, passes).items()}
        step_s = statistics.median(times[1:])
        tag = f"train {name}"
        sites = issued_summary(issued) if issued else {}
        say(f"{tag}: step {step_s * 1e3:.1f} ms (median of steps 2-3; all "
            f"{[round(t * 1e3, 1) for t in times]} ms), "
            f"{tokens / step_s:.0f} tok/s, MFU {MET.mfu(cfg, tokens, step_s, peak=MET.H100_FP32_PEAK):.4f} "
            f"of the fp32 CUDA-core peak (67 TFLOP/s), "
            f"{MET.mfu(cfg, tokens, step_s):.4f} of the bf16 tensor peak (989.4 TFLOP/s); "
            f"peak memory {peak / 2**30:.2f} GiB; loss {losses}, grad_norm {norms} ({card})")
        say(f"{tag}: launches {launches} (expected {want})" +
            (f"; issued {sites}" if sites else ""))
        check(launches == want, f"{tag}: launches {launches}, expected {want}")
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)), f"{tag}: non-finite")
        if acco:
            for k, nc in acc_knobs.items():
                rows = [r for r in issued if r.site == k]
                check(rows and all(r.num_chunks == nc and r.collectives == nc for r in rows),
                      f"{tag}: {k} issued {rows[:2]}, expected {nc} chunks")
            check(all(r.site in acc_knobs for r in issued),
                  f"{tag}: issued at sites other than the gradient sync: "
                  f"{sorted({r.site for r in issued} - set(acc_knobs))[:4]}")
        modes[name] = {"step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in times],
                       "tokens_per_s": tokens / step_s,
                       "mfu_fp32": MET.mfu(cfg, tokens, step_s, peak=MET.H100_FP32_PEAK),
                       "mfu_bf16": MET.mfu(cfg, tokens, step_s), "peak_bytes": peak,
                       "loss": losses, "grad_norm": norms, "launches": launches,
                       "issued": sites}
        del state, step_fn
        free()
    after = param_sums(model)
    still = [n for n in before if before[n] == after[n]]
    check(not still, f"train: parameters that did not move: {still[:5]}")

    # where a plain step's device time goes
    tcfg = T.TrainConfig(opt=adamw.AdamWConfig(**TRAIN_OPT), warmup=2, total_steps=100)
    step_fn = T.make_train_step(cfg, tcfg)
    state = adamw.init_state(dict(model.named_parameters()))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in corpus.batch(step).items()}
    t = time.perf_counter()
    dev = train_ms_by_class(lambda: step_fn(model, state, batch, step))
    wall = (time.perf_counter() - t) * 1e3
    busy = sum(dev.values())
    say(f"train profile, one plain step: wall {wall:.1f} ms (profiled), device busy "
        f"{busy:.1f} ms; " + ", ".join(f"{k} {v:.1f} ms" for k, v in dev.items()) +
        f" ({card})")
    check(busy > 0, "train profile: the profiler saw no kernel")
    del model, state, step_fn, batch
    free()
    return {"arch": cfg.name, "layers": TRAIN_LAYERS, "params": n_params,
            "batch": TRAIN_B, "seq": TRAIN_S, "acc_chunks": acc_knobs, "modes": modes,
            "profile_ms": dev, "profile_wall_ms": wall,
            "parity": train_parity_phase(card, plan, mesh),
            "card": card}


def parity_batch(cfg) -> dict:
    """The parity steps' batch (PARITY_TRAIN's B x S) on the card, with an
    audio model's frames and a vlm model's patches (``stub_inputs``)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, stub_inputs

    P = PARITY_TRAIN
    batch = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=P["S"],
                                       global_batch=P["B"], seed=SEED + 3)).batch(0)
    batch.update(stub_inputs(cfg, P["B"], seed=SEED + 3))
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def parity_step(cfg, batch, *, backend=None, sited_mesh=None, plan=None,
                placed=None) -> dict:
    """One train step of ``cfg`` from SEED + 2's weights on ``batch`` with
    PARITY_OPT, through ``backend`` (and on the sited trunk over
    ``sited_mesh`` under ``plan``; or placed on the (data, model) mesh
    ``placed``, ``models.model.init_placed``): the updated parameters
    (``params``), AdamW's ``mu``, ``loss``, ``grad_norm``, the kernels'
    ``launches`` and the ``issued`` collectives."""
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as T

    if placed is None:
        model = M.init_params(cfg, SEED + 2, device="cuda")
    else:
        model = M.init_placed(cfg, SEED + 2, placed, device="cuda")
        sited_mesh = placed["model"]
    state = adamw.init_state(dict(model.named_parameters()))
    step_fn = T.make_train_step(cfg, T.TrainConfig(
        opt=adamw.AdamWConfig(**PARITY_OPT), warmup=2, total_steps=100, backend=backend,
        sited_mesh=sited_mesh, data_axis=None if placed is None else placed["data"]))
    ops.reset_launches()
    with plan.applied() if plan is not None else contextlib.nullcontext(), \
            collectives.record_issued() as issued:
        model, state, m = step_fn(model, state, batch, 1)
    torch.cuda.synchronize()
    return {"params": {n: p.detach() for n, p in model.named_parameters()},
            "mu": state["mu"], "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "launches": dict(ops.LAUNCHES), "issued": list(issued)}


def parity_held(tag: str, name: str, first: dict, other: dict, card: str,
                note: str = "", *, mu_to_fp64: bool = False) -> dict:
    """``other``'s step (``parity_step``) held to ``first``'s within
    PARITY_TRAIN's bounds: updated parameters (abs), mu (of its max per
    parameter; a parameter whose mu is zero but for rounding, below
    PARITY_ZERO of the largest, stays below that in both), loss and
    grad_norm (relative); printed, and failing the run past a bound.  With
    ``mu_to_fp64``, mu and grad_norm are printed and not held here: the
    caller holds the gradients to fp64 (``fp64_grads_held``)."""
    P = PARITY_TRAIN
    e = parity_errors(first, other)
    zero = e["mu_zero_but_for_rounding"]
    zero_note = (f"; {len(zero)} zero but for rounding, below {e['mu_zero_floor']:.1e} in "
                 f"both (their max {e['mu_zero_max']:.1e})" if zero else "")
    to_fp64 = " (mu and grad_norm held to fp64 below)" if mu_to_fp64 else ""
    say(f"{tag}, kernels against {name}: updated parameters max abs diff "
        f"{e['max_abs_param_diff']:.3e} (bound {P['bound']}); mu {e['mu_err_of_max']:.3e} of "
        f"its max, at {e['mu_err_at']} (bound {P['mu_bound']}){zero_note}; loss "
        f"{first['loss']:.6f} / {other['loss']:.6f}, grad_norm {first['grad_norm']:.6f} / "
        f"{other['grad_norm']:.6f}, relative {e['loss_rel']:.2e} / {e['grad_norm_rel']:.2e} "
        f"(bound {P['rel_bound']}){to_fp64}{note} ({card})")
    check(e["max_abs_param_diff"] <= P["bound"],
          f"{tag} {name}: parameters differ by {e['max_abs_param_diff']}")
    check(e["loss_rel"] <= P["rel_bound"], f"{tag} {name}: loss differs by {e['loss_rel']}")
    if not mu_to_fp64:
        check(e["mu_err_of_max"] <= P["mu_bound"],
              f"{tag} {name}: mu differs by {e['mu_err_of_max']} of max")
        check(e["mu_zero_max"] <= e["mu_zero_floor"],
              f"{tag} {name}: mu of {zero} (zero but for rounding in the first step) reaches "
              f"{e['mu_zero_max']} > {e['mu_zero_floor']}")
        check(e["grad_norm_rel"] <= P["rel_bound"],
              f"{tag} {name}: grad_norm differs by {e['grad_norm_rel']}")
    return {k: v for k, v in e.items() if k != "mu_err_at"}


def parity_errors(first: dict, other: dict, key: str = "mu") -> dict:
    """How far ``other``'s step lies from ``first``'s (each a
    ``parity_step`` or a ``parity_grads``), as ``parity_held`` measures it:
    the updated parameters (max abs, where both have them); ``key``'s
    tensors (AdamW's ``mu`` or the ``grads``), each of its max per
    parameter in ``first``, over the parameters whose ``key`` is not zero
    but for rounding there (those are listed with their max in ``other``);
    loss and grad_norm (relative)."""
    a, b = first[key], other[key]
    top = {n: t.abs().max().item() for n, t in a.items()}
    floor = PARITY_ZERO * max(top.values())
    zero = sorted(n for n, v in top.items() if v <= floor)
    err, at = max((((t.to(b[n].device) - b[n]).abs().max() / top[n]).item(), n)
                  for n, t in a.items() if n not in zero)
    out = {f"{key}_err_of_max": err, f"{key}_err_at": at,
           f"{key}_zero_but_for_rounding": zero, f"{key}_zero_floor": floor,
           f"{key}_zero_max": max([b[n].abs().max().item() for n in zero] + [0.0]),
           "loss": other["loss"], "grad_norm": other["grad_norm"],
           "loss_rel": abs(other["loss"] - first["loss"]) / abs(first["loss"]),
           "grad_norm_rel": abs(other["grad_norm"] - first["grad_norm"]) / first["grad_norm"]}
    if "params" in first and "params" in other:
        p2 = other["params"]
        out["max_abs_param_diff"] = max((p.to(p2[n].device) - p2[n]).abs().max().item()
                                        for n, p in first["params"].items())
    return out


def train_parity_phase(card: str, plan, mesh) -> dict:
    """One train step through the kernels, then one through backend="ref"
    and one through the sited trunk on the 1-rank NCCL mesh under ``plan``
    (its ``tp.layer{i}.mlp`` sites chunk the MLP), on the card, from the
    same weights on the same batch: llama3-8b at full width and 2 layers,
    B = 1, S = 512.  Each is held to the first."""
    P = PARITY_TRAIN
    cfg = get_config(PLAN_ARCH).replace(num_layers=P["layers"])
    batch = parity_batch(cfg)
    first = parity_step(cfg, batch)
    loss, gnorm, launches, issued = (first[k] for k in ("loss", "grad_norm", "launches",
                                                        "issued"))
    check(np.isfinite(loss) and np.isfinite(gnorm), "train parity: non-finite loss")
    check(not issued, "train parity: the unsited step issued a collective")
    out = {"loss": loss, "grad_norm": gnorm}
    tag = f"train parity ({P['layers']} layers, full width, B={P['B']}, S={P['S']})"
    for name, kw in (("ref", dict(backend="ref")), ("sited", dict(sited_mesh=mesh, plan=plan))):
        other = parity_step(cfg, batch, **kw)
        launches2, issued2 = other["launches"], other["issued"]
        if name == "ref":
            check(launches2 == NO_LAUNCHES, "train parity: backend='ref' launched a kernel")
        else:
            check(launches2 == launches, f"train parity: the sited step launched "
                                         f"{launches2}, the unsited one {launches}")
            check(any(r.site.startswith("tp.layer") for r in issued2),
                  "train parity: the sited trunk issued nothing")
        out[name] = parity_held(tag, name, first, other, card,
                                f"; issued {issued_summary(issued2)}" if issued2 else "")
        del other
        free()
    del first
    free()
    return {**out, "bounds": {k: P[k] for k in ("bound", "mu_bound", "rel_bound")}}


# ---------------------------------------------------------------------------
# phase 9: the training launcher, its checkpoint, and a sited step through the
# collectives' backwards (the 1-rank NCCL group)
# ---------------------------------------------------------------------------

LAUNCH_LAYERS = 2
SITED_GRAD_BOUND = 1e-5      # sited against unsited, fp32: loss (relative) and each
                             # gradient (of its max|g|)
SITED_STEP = dict(B=1, S=2048)
# the sited step's plan: layers 0 and 1 chunk both sites differently
PLAN_TP = {"tp.layer0.mlp.ag": ("ring", 2), "tp.layer0.mlp.rs": ("chunked", 4),
           "tp.layer1.mlp.ag": ("ring", 4), "tp.layer1.mlp.rs": ("chunked", 2)}


def issued_by_site(rows) -> dict:
    """``{site: {op: [chunk counts, in call order]}}`` of ``Issued`` rows."""
    out: dict = {}
    for r in rows:
        out.setdefault(r.site, {}).setdefault(r.op, []).append(r.num_chunks)
    return out


def expected_issued(chunks: dict, passes: int) -> dict:
    """What ``issued_by_site`` reads after ``passes`` forward and backward
    passes with remat, each site at ``chunks[site]``: a layer's gate and up
    ring twice (forward, recompute) and once backward each; its down
    reduce-scatter twice and once backward."""
    per_pass = {"ag": {"ring_ag_matmul": 4, "ring_ag_matmul.bwd": 2},
                "rs": {"mm_reduce_scatter": 2, "mm_reduce_scatter.bwd": 1}}
    return {site: {op: [nc] * n * passes for op, n in per_pass[site[-2:]].items()}
            for site, nc in chunks.items()}


def placement_sites(rows) -> list:
    """The sites of the placement's all-reduces (attention's rows, whisper's
    cross-attention's, the shared experts', the vocabulary's) among
    ``Issued`` rows: none on a model axis of one rank."""
    return sorted({r.site for r in rows if r.site.startswith(("tp.embed", "tp.ce"))
                   or re.search(r"[._]attn\.", r.site) or ".shared." in r.site})


def fsdp_gathers(rows) -> dict:
    """``{site: {op: [calls, collectives issued]}}`` of the ``fsdp.*`` rows."""
    out: dict = {}
    for r in rows:
        if r.site.startswith("fsdp."):
            c = out.setdefault(r.site, {}).setdefault(r.op, [0, 0])
            c[0] += 1
            c[1] += r.collectives
    return out


def expected_gathers(cfg, model, passes: int) -> dict:
    """What ``fsdp_gathers`` reads after ``passes`` passes with remat on a
    model placed on a 1-rank data axis: each layer's data-split weights
    gathered twice (forward, recompute) and once in the backward, the
    embedding and the head once each way, and no collective issued."""
    place = model.placement
    split = sum(1 for n in place.specs
                if n.startswith("trunk.dense_layers.0.") and place.dim(n, "data") is not None)
    out = {f"fsdp.layer{i}.ag_params": {"all_gather": [2 * split * passes, 0],
                                        "all_gather.bwd": [split * passes, 0]}
           for i in range(cfg.num_layers)}
    out.update({f"fsdp.{k}.ag_params": {"all_gather": [passes, 0],
                                         "all_gather.bwd": [passes, 0]}
                for k in ("embed", "head")})
    return out


def launch_phase(card: str) -> dict:
    """Phase 9 on the 1-rank NCCL group: (a) ``repro_torch.launch.train.main``
    with a run config (llama3-8b at full width, 2 layers, seq 2048, batch 4,
    3 steps), ``--mesh 1x1``, the tp:8 plan the port tunes for h100-sxm
    and ``--ckpt``; (b) the checkpoint restored with ``train.checkpoint``,
    equal to the trained parameters, and again past a corrupted newest
    step; (c) one sited forward and backward of the model placed on the
    1-rank (data, model) mesh beside the unsited one from the same weights
    (B = 1, S = 2048) under ``PLAN_TP``, its kernels' launches counted.
    Neither (a) nor (c) may issue a placement all-reduce (``tp.*.attn.ar``,
    ``tp.embed.ar``, ``tp.ce.ar``) on a model axis of one rank."""
    from repro_torch.convert import params_to_jax
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch import train as LT
    from repro_torch.train import checkpoint

    cfg = get_config(PLAN_ARCH).replace(num_layers=LAUNCH_LAYERS)
    plan = tune(extract_workload(get_config(PLAN_ARCH), ParallelPlan(kind="tp", tp=8),
                                 seq=PLAN_SEQ, global_batch=PLAN_BATCH), "h100-sxm",
                method="lagom")
    sites = [f"tp.layer{i}.mlp.{k}" for i in range(LAUNCH_LAYERS) for k in ("ag", "rs")]
    with plan.applied():
        knobs = {s: collectives.runtime_for(s, s.rsplit(".", 1)[1]).num_chunks for s in sites}
    out = {"arch": cfg.name, "layers": LAUNCH_LAYERS, "batch": TRAIN_B, "seq": TRAIN_S,
           "steps": TRAIN_STEPS, "knobs": knobs, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        plan_path, run_path = os.path.join(tmp, "plan.json"), os.path.join(tmp, "run.json")
        ckpt = os.path.join(tmp, "ckpt")
        plan.save(plan_path)
        with open(run_path, "w") as f:
            # phase 8's lr: at the launcher's default 3e-4 a fresh AdamW's sign-like
            # first steps lift the third step's loss from 12.16 to 16.15 at full
            # width, unsited alike (NVIDIA H100 80GB HBM3, 700 W)
            json.dump({"arch": PLAN_ARCH, "overrides": {"num_layers": LAUNCH_LAYERS},
                       "seq": TRAIN_S, "batch": TRAIN_B, "steps": TRAIN_STEPS,
                       "lr": TRAIN_OPT["lr"]}, f)
        before = param_sums(M.init_params(cfg, 0, device="cuda"))     # the launcher's seed
        free()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with collectives.record_issued() as issued:
            run = LT.main(["--config", run_path, "--mesh", "1x1", "--tuned-plan", plan_path,
                           "--ckpt", ckpt, "--log-every", "1"])
        launches = dict(ops.LAUNCHES)
        collectives.install_runtime_plan(None)
        peak = torch.cuda.max_memory_allocated()
        model = run["model"]
        want = {k: TRAIN_STEPS * v for k, v in expected_train_launches(cfg, 1).items()}
        by_site = issued_by_site([r for r in issued if r.site.startswith("tp.")])
        want_sites = expected_issued(knobs, TRAIN_STEPS)
        gathers = fsdp_gathers(issued)
        want_gathers = expected_gathers(cfg, run["model"], TRAIN_STEPS)
        step_s = statistics.median(run["step_s"][1:])
        tokens = TRAIN_B * TRAIN_S
        moved = param_sums(model)
        still = [n for n in before if before[n] == moved[n]]
        say(f"launch.train --mesh 1x1 under the h100-sxm tp:8 plan ({cfg.name}, "
            f"{LAUNCH_LAYERS} layers at full width, B={TRAIN_B}, S={TRAIN_S}): step "
            f"{step_s * 1e3:.1f} ms (median of steps 2-3; all "
            f"{[round(t * 1e3, 1) for t in run['step_s']]} ms), {tokens / step_s:.0f} tok/s, "
            f"peak memory {peak / 2**30:.2f} GiB; losses {run['losses']}; checkpoint gathered "
            f"and written in {run['ckpt_s']:.2f} s; launches {launches} (expected {want}); "
            f"issued {by_site}; FSDP gathers on the 1-rank data axis (calls, collectives) "
            f"{gathers} ({card})")
        check(all(np.isfinite(run["losses"])), "launch: non-finite loss")
        check(not still, f"launch: parameters that did not move: {still[:5]}")
        check(launches == want, f"launch: launches {launches}, expected {want}")
        check(by_site == want_sites, f"launch: issued {by_site}, expected {want_sites}")
        check(not placement_sites(issued), f"launch: the placement issued "
                                           f"{placement_sites(issued)} on a model axis of 1")
        check(gathers == want_gathers,
              f"launch: FSDP gathers {gathers}, expected {want_gathers} (none a collective)")

        trained = params_to_jax(cfg, model)
        losses, steps_s, write_s = run["losses"], run["step_s"], run["ckpt_s"]
        del model, run
        free()
        t = time.perf_counter()
        tree, step = checkpoint.restore(ckpt, trained)
        read_s = time.perf_counter() - t
        same = all(np.array_equal(a, b) for a, b in zip(checkpoint.leaves(tree),
                                                          checkpoint.leaves(trained)))
        del tree
        newest = os.path.join(ckpt, f"step_{TRAIN_STEPS + 1:08d}")     # a torn newer step
        os.makedirs(newest)
        with open(os.path.join(ckpt, f"step_{TRAIN_STEPS:08d}", "arrays.npz"), "rb") as f:
            head = f.read(1 << 20)
        with open(os.path.join(newest, "arrays.npz"), "wb") as f:
            f.write(head)
        with open(os.path.join(newest, "manifest.json"), "w") as f:
            json.dump({"step": TRAIN_STEPS + 1}, f)
        with open(os.path.join(ckpt, "latest"), "w") as f:
            f.write(os.path.basename(newest))
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            tree, fell_to = checkpoint.restore(ckpt, trained)
        fell_same = all(np.array_equal(a, b) for a, b in zip(checkpoint.leaves(tree),
                                                               checkpoint.leaves(trained)))
        warned = [str(w.message) for w in ws if issubclass(w.category, RuntimeWarning)]
        del tree, trained
        say(f"launch checkpoint: written in {write_s:.2f} s (gathered and saved); restored "
            f"step {step} in {read_s:.2f} s, equal to the trained parameters: {same}; past a "
            f"torn step {TRAIN_STEPS + 1}: step {fell_to}, equal: {fell_same}; warned "
            f"{warned} ({card})")
        check(step == TRAIN_STEPS and same, "launch: the checkpoint differs from the model")
        check(fell_to == TRAIN_STEPS and fell_same and len(warned) == 1
              and f"falling back to step_{TRAIN_STEPS:08d}" in warned[0],
              "launch: no fallback past the torn step")
    free()
    out.update(step_ms=step_s * 1e3, step_ms_all=[x * 1e3 for x in steps_s],
               tokens_per_s=tokens / step_s, peak_bytes=peak, losses=losses,
               launches=launches, issued=by_site, fsdp_gathers=gathers,
               ckpt_write_s=write_s, ckpt_read_s=read_s,
               ckpt_fallback_step=fell_to)

    # (c) one sited forward and backward beside the unsited one, same weights
    model = M.init_params(cfg, SEED + 4, device="cuda")
    b = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=SITED_STEP["S"],
                                   global_batch=SITED_STEP["B"], seed=SEED + 5)).batch(0)
    b = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
    names, params = zip(*model.named_parameters())
    loss_u = M.loss_and_metrics(cfg, model, b)[0]
    g_u = torch.autograd.grad(loss_u, params)
    meshes = make_mesh((1, 1), ("data", "model"))
    model_mesh = meshes["model"]
    M.shard_(cfg, model, meshes)     # placed on the 1-rank group: every leaf stays whole
    plan_tp = {k: collectives.CollectiveRuntime(*v) for k, v in PLAN_TP.items()}
    ops.reset_launches()
    with collectives.use_runtime_plan(plan_tp), collectives.record_issued() as rows:
        loss_s = M.loss_and_metrics(cfg, model, b, mesh=model_mesh)[0]
        g_s = torch.autograd.grad(loss_s, params)
    torch.cuda.synchronize()
    out["placed_launches"] = dict(ops.LAUNCHES)
    loss_rel = abs(loss_s.item() - loss_u.item()) / abs(loss_u.item())
    err, at = max((((gs - gu).abs().max() / gu.abs().max().clamp_min(1e-30)).item(), n)
                   for n, gs, gu in zip(names, g_s, g_u))
    check(not placement_sites(rows), f"launch sited step: the placement issued "
                                     f"{placement_sites(rows)} on a model axis of 1")
    sited = issued_by_site([r for r in rows if r.site.startswith("tp.")])
    want_sited = expected_issued({s: nc for s, (_, nc) in PLAN_TP.items()}, 1)
    say(f"launch sited step ({cfg.name}, {LAUNCH_LAYERS} layers, B={SITED_STEP['B']}, "
        f"S={SITED_STEP['S']}, PLAN_TP on the 1-rank group) against the unsited: loss "
        f"{loss_s.item():.6f} / {loss_u.item():.6f} ({loss_rel:.2e} relative), gradients "
        f"{err:.3e} of max|g| at {at} (bound {SITED_GRAD_BOUND}); forward and backward "
        f"chunks by site {sited} ({card})")
    check(bool(torch.isfinite(loss_s)), "launch sited step: non-finite loss")
    check(loss_rel <= SITED_GRAD_BOUND and err <= SITED_GRAD_BOUND,
          f"launch sited step: loss {loss_rel}, gradients {err} of max|g| at {at}")
    check(sited == want_sited, f"launch sited step: issued {sited}, expected {want_sited}")
    out["sited"] = {"loss": loss_s.item(), "loss_unsited": loss_u.item(), "loss_rel": loss_rel,
                    "grad_err_of_max": err, "at": at, "issued": sited,
                    "bound": SITED_GRAD_BOUND}
    del model, g_u, g_s, loss_u, loss_s
    free()
    return out


# ---------------------------------------------------------------------------
# phase 10: the MoE family (olmoe-1b-7b at full size, plain and plan-bound on
# the 1-rank NCCL group; slice parity; one training step)
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
MOE_PARITY_LAYERS = {"olmoe-1b-7b": 2, "deepseek-moe-16b": 4}
MOE_PLAN_PARALLEL = "ep:8"
# plan (b): layer 0 and layer 1 chunk their dispatch differently
MOE_PLAN_B = {"serve.layer0.moe.a2a_disp": ("chunked", 2),
              "serve.layer1.moe.a2a_disp": ("chunked", 4)}
# the parity step's plan on the sited trunk: 1, 2 and 4 chunks
MOE_TRAIN_PLAN = {"ep.layer0.moe.a2a_disp": ("chunked", 2),
                  "ep.layer0.moe.a2a_comb": ("chunked", 4)}
# the MoE dispatch and combine by kernel name: the router's top-k (a sort),
# the positions (one-hot, cumsum, gather), the scatter into the capacity
# buffers (repeat, index_add) and the combine (index_select)
MOE_DISPATCH = {"moe_dispatch": ("index", "scatter", "gather", "sort", "scan", "repeat",
                                 "one_hot")}


def moe_kernels_phase(gen) -> dict:
    """The kernels at the MoE path's new shapes, each against its plain
    version: RMSNorm over qk_norm's rows of head_dim 128 (olmoe's prefill:
    8 x 512 tokens x 16 heads), forward and backward; flash attention at a
    GQA group of 1 (Hq = Hkv = 16, h = 128), forward at the prefill shape
    (timed) and backward at the parity step's (B = 1, S = 512) against
    autograd of the plain version in fp64."""
    rows, h = BATCH * PROMPT_LENS[1] * 16, 128
    x, dy = randn((rows, h), torch.float32, gen), randn((rows, h), torch.float32, gen)
    scale = torch.linspace(0.5, 1.5, h, device="cuda")
    y = ops.rmsnorm(x, scale, backend="cuda")
    err = (y - ref.rmsnorm_ref(x, scale)).abs().max().item()
    got = grads_of(lambda a, b: ops.rmsnorm(a, b, backend="cuda"), (x, scale), dy)
    want = grads_of(ref.rmsnorm_ref, (x.double(), scale.double()), dy.double())
    gerr = max((g.double() - w).abs().max().item() / w.abs().max().item()
               for g, w in zip(got, want))
    say(f"moe kernels: rmsnorm ({rows}, {h}) fp32 (qk_norm's rows): max abs err {err:.3e} "
        f"(bound {RMS_BOUND_F32}); backward {gerr:.3e} of max|g| (bound {RMS_GRAD_BOUND})")
    check(err <= RMS_BOUND_F32, f"moe kernels: rmsnorm at D=128 err {err}")
    check(gerr <= RMS_GRAD_BOUND, f"moe kernels: rmsnorm backward at D=128 err {gerr}")
    fwd = flash_timed(gen, BATCH, PROMPT_LENS[1], 16, 16, 128)
    q, do = randn((1, 512, 16, h), torch.float32, gen), randn((1, 512, 16, h), torch.float32, gen)
    k, v = randn((1, 512, 16, h), torch.float32, gen), randn((1, 512, 16, h), torch.float32, gen)
    got = grads_of(lambda *a: ops.flash_attention(*a, causal=True, backend="cuda"),
                   (q, k, v), do)
    want = grads_of(lambda *a: ref.flash_attention_ref(*a, causal=True),
                    (q.double(), k.double(), v.double()), do.double())
    gmax = max(w.abs().max().item() for w in want)
    ferr = max((g.double() - w).abs().max().item() for g, w in zip(got, want)) / gmax
    say(f"moe kernels: flash backward B=1 S=512 Hq=16 Hkv=16 h=128 causal fp32: "
        f"{ferr:.3e} of max|g| (bound {FLASH_GRAD_BOUND}) against autograd of the plain "
        f"version in fp64")
    check(ferr <= FLASH_GRAD_BOUND, f"moe kernels: flash backward at group 1 err {ferr}")
    del x, dy, y, got, want, q, k, v, do
    free()
    return {"rmsnorm_d128": {"max_abs_err": err, "grad_err_of_max_g": gerr},
            "flash_group1": {"forward": fwd, "grad_err_of_max_g": ferr}}


def moe_plan_phase(cfg, model, prompts, card: str, mesh) -> dict:
    """olmoe-1b-7b at full size on the 1-rank NCCL mesh under plan (a), tuned
    by the port for its ep:8 decode workload on h100-sxm, and plan (b)
    (``MOE_PLAN_B``), beside the unplanned engine, in turns: times, the
    teacher-forced logits' difference, and the ``serve.layer{i}.moe.a2a_*``
    rows, each at its plan's chunk count."""
    wl = extract_decode_workload(cfg, parse_parallel(MOE_PLAN_PARALLEL), global_batch=BATCH,
                                 seq=MAX_SEQ)
    t0 = time.perf_counter()
    tuned = tune(wl, "h100-sxm", method="lagom")
    tune_s = time.perf_counter() - t0
    plans = {"a": tuned,
             "b": {k: collectives.CollectiveRuntime(*v) for k, v in MOE_PLAN_B.items()}}
    engines = {"none": make_engine(cfg, model, batch_size=BATCH, max_seq=MAX_SEQ)}
    for name, plan in plans.items():
        engines[name] = make_engine(cfg, model, batch_size=BATCH, max_seq=MAX_SEQ,
                                    plan=plan, mesh=mesh)
    for e in engines.values():
        e.generate(prompts, max_new=2)          # warm-up
    times = {name: [] for name in engines}
    record = {}
    for name in ("none", "a", "b", "b", "a", "none"):
        collectives.reset_degraded_warnings()
        ops.reset_launches()
        with warnings.catch_warnings(record=True) as ws, \
                collectives.record_issued() as issued:
            warnings.simplefilter("always")
            outs = engines[name].generate(prompts, max_new=MAX_NEW)
        t = engines[name].last_timing
        times[name].append((t["prefill_s"] * 1e3, statistics.median(t["decode_s"]) * 1e3))
        if name not in record:
            record[name] = {"outs": outs, "launches": dict(ops.LAUNCHES), "rows": issued,
                            "degraded": sum(issubclass(w.category,
                                                       collectives.CollectiveDegradedWarning)
                                            for w in ws)}
    base = record["none"]["outs"]
    check_outputs(base, cfg.vocab_size, "moe plan serving, unplanned")
    forced = {name: e.teacher_forced_logits(prompts, base) for name, e in engines.items()}
    want_launches = expected_launches(cfg)
    out = {"parallel": MOE_PLAN_PARALLEL, "tune_s": tune_s, "plans": {}, "card": card}
    for name, plan in plans.items():
        r = record[name]
        with collectives.use_runtime_plan(plan.runtime_plan() if name == "a" else plan):
            knobs = {f"serve.layer{i}.moe.{k}": collectives.runtime_for(
                f"serve.layer{i}.moe.{k}", "a2a").num_chunks
                for i in range(cfg.num_layers) for k in ("a2a_disp", "a2a_comb")}
        by_site = issued_by_site(r["rows"])
        want_rows = {s: {"all_to_all": [nc] * (1 + MAX_NEW)} for s, nc in knobs.items()}
        err = (forced[name] - forced["none"]).abs().max().item()
        say(f"moe plan serving: plan ({name}): prefill {times[name][0][0]:.1f} / "
            f"{times[name][1][0]:.1f} ms, decode {times[name][0][1]:.2f} / "
            f"{times[name][1][1]:.2f} ms/token (unplanned {times['none'][0][0]:.1f} / "
            f"{times['none'][1][0]:.1f}, {times['none'][0][1]:.2f} / "
            f"{times['none'][1][1]:.2f}); teacher-forced logits max abs diff from unplanned "
            f"{err:.3e} (bound {PLAN_SERVE_BOUND}); tokens equal: {r['outs'] == base}; "
            f"CollectiveDegradedWarnings {r['degraded']}; launches {r['launches']}; "
            f"chunks by site of layers 0-1 "
            f"{ {s: v for s, v in knobs.items() if s.startswith(('serve.layer0.', 'serve.layer1.'))} } "
            f"({card})")
        check(err <= PLAN_SERVE_BOUND, f"moe plan ({name}): logits differ by {err}")
        check(r["launches"] == want_launches,
              f"moe plan ({name}): launches {r['launches']}, expected {want_launches}")
        check(by_site == want_rows, f"moe plan ({name}): issued {by_site}, expected "
                                    f"{want_rows}")
        out["plans"][name] = {"prefill_ms": [p for p, _ in times[name]],
                              "decode_ms": [d for _, d in times[name]],
                              "max_abs_logit_diff": err, "tokens_equal": r["outs"] == base,
                              "degraded_warnings": r["degraded"], "launches": r["launches"],
                              "chunks": knobs, "issued": issued_summary(r["rows"])}
    out["unplanned"] = {"prefill_ms": [p for p, _ in times["none"]],
                        "decode_ms": [d for _, d in times["none"]]}
    check(out["plans"]["b"]["chunks"]["serve.layer0.moe.a2a_disp"] == 2
          and out["plans"]["b"]["chunks"]["serve.layer1.moe.a2a_disp"] == 4,
          "moe plan (b) did not chunk layers 0 and 1 as it says")
    del engines, forced
    free()
    return out


def moe_slice_parity(cfg, prompts) -> dict:
    """A cut-depth MoE model at full width through the kernels and through
    ``backend="ref"``: teacher-forced logits within 1e-3, the plain run
    replaying the kernels' routing (``layers.record_routing``), as the
    tokens are forced; how many (token, slot) choices the plain run makes
    differently on its own is printed beside it."""
    from repro_torch.models import layers as L

    cfg2 = cfg.replace(num_layers=MOE_PARITY_LAYERS[cfg.name])
    model = M.init_params(cfg2, SEED + 1, device="cuda")
    kern = make_engine(cfg2, model, batch_size=BATCH, max_seq=MAX_SEQ)
    plain = make_engine(cfg2, model, batch_size=BATCH, max_seq=MAX_SEQ, backend="ref")
    outs = kern.generate(prompts, max_new=MAX_NEW)
    check_outputs(outs, cfg.vocab_size, "moe slice parity")
    with L.record_routing() as routing:
        lk = kern.teacher_forced_logits(prompts, outs)
    ops.reset_launches()
    with L.record_routing(replay=routing):
        lr = plain.teacher_forced_logits(prompts, outs)
    check(ops.LAUNCHES == NO_LAUNCHES, "moe slice parity: backend='ref' launched a kernel")
    with L.record_routing() as own:
        plain.teacher_forced_logits(prompts, outs)
    choices = sum(t.numel() for c in routing.calls.values() for t in c)
    differ = sum(int((a != b).sum()) for site, c in routing.calls.items()
                 for a, b in zip(c, own.calls[site]))
    err = (lk - lr).abs().max().item()
    say(f"moe slice parity {cfg.name} ({cfg2.num_layers} layers, full width): teacher-forced "
        f"logits max abs err {err:.3e} (bound {SLICE_LOGITS_BOUND}), the plain run on the "
        f"kernels' routing; on its own routing the plain run chose {differ} of {choices} "
        f"(token, slot) experts differently")
    check(bool(torch.isfinite(lk).all()), "moe slice parity: non-finite logits")
    check(err <= SLICE_LOGITS_BOUND, f"moe slice parity: logits err {err}")
    del kern, plain, model, lk, lr, routing, own
    free()
    return {"arch": cfg.name, "layers": cfg2.num_layers, "max_abs_err": err,
            "routing_choices": choices, "routing_differs_unforced": differ}


def moe_train_parity(card: str, mesh) -> dict:
    """One train step of olmoe-1b-7b at full width and 2 layers (B = 1,
    S = 512) through the kernels, then through ``backend="ref"`` and through
    the sited trunk on the 1-rank NCCL mesh under ``MOE_TRAIN_PLAN``, both
    replaying the kernels' routing; each held to the first with phase 8's
    parity bounds (aux with the loss's).  The kernels' launches must be the
    code's; the sited step's dispatch and combine rows its plan's."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as T

    P = PARITY_TRAIN
    cfg = get_config(MOE_ARCH).replace(num_layers=P["layers"])
    batch = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=P["S"],
                                       global_batch=P["B"], seed=SEED + 3)).batch(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    plan = {k: collectives.CollectiveRuntime(*v) for k, v in MOE_TRAIN_PLAN.items()}

    def one_step(routing, backend=None, sited=False):
        model = M.init_params(cfg, SEED + 2, device="cuda")
        state = adamw.init_state(dict(model.named_parameters()))
        step_fn = T.make_train_step(cfg, T.TrainConfig(
            opt=adamw.AdamWConfig(**PARITY_OPT), warmup=2, total_steps=100, backend=backend,
            sited_mesh=mesh if sited else None))
        ops.reset_launches()
        with collectives.use_runtime_plan(plan if sited else {}), \
                collectives.record_issued() as issued, L.record_routing(routing) as rec:
            model, state, m = step_fn(model, state, batch, 1)
        torch.cuda.synchronize()
        params = {n: p.detach() for n, p in model.named_parameters()}
        return (params, state["mu"], {k: float(m[k]) for k in ("loss", "aux", "grad_norm")},
                dict(ops.LAUNCHES), list(issued), rec)

    params, mu, met, launches, issued, routing = one_step(None)
    want = expected_train_launches(cfg, 1)
    check(all(np.isfinite(list(met.values()))), "moe train parity: non-finite loss")
    check(launches == want, f"moe train parity: launches {launches}, expected {want}")
    out = {"arch": cfg.name, "layers": P["layers"], "B": P["B"], "S": P["S"], **met,
           "launches": launches}
    for name, kw in (("ref", dict(backend="ref")), ("sited", dict(sited=True))):
        p2, mu2, met2, launches2, issued2, _ = one_step(routing, **kw)
        if name == "ref":
            check(launches2 == NO_LAUNCHES, "moe train parity: backend='ref' launched a kernel")
        else:
            check(launches2 == launches, f"moe train parity: the sited step launched "
                                         f"{launches2}, the unsited one {launches}")
            want_rows = {f"ep.layer{j}.moe.{k}": {
                "all_to_all": [MOE_TRAIN_PLAN.get(f"ep.layer{j}.moe.{k}", ("", 1))[1]] * 2,
                "all_to_all.bwd": [MOE_TRAIN_PLAN.get(f"ep.layer{j}.moe.{k}", ("", 1))[1]]}
                for j in range(cfg.num_layers) for k in ("a2a_disp", "a2a_comb")}
            check(issued_by_site(issued2) == want_rows,
                  f"moe train parity: sited rows {issued_by_site(issued2)}, expected {want_rows}")
        err = max((p - p2[n]).abs().max().item() for n, p in params.items())
        mu_err, mu_at = max(
            (((m - mu2[n]).abs().max() / m.abs().max().clamp_min(1e-30)).item(), n)
            for n, m in mu.items())
        rel = {k: abs(met2[k] - met[k]) / abs(met[k]) for k in met}
        say(f"moe train parity, kernels against {name} ({P['layers']} layers, full width, "
            f"B={P['B']}, S={P['S']}, routing replayed): updated parameters max abs diff "
            f"{err:.3e} (bound {P['bound']}); mu {mu_err:.3e} of its max, at {mu_at} (bound "
            f"{P['mu_bound']}); loss, aux, grad_norm {met} / {met2}, relative {rel} (bound "
            f"{P['rel_bound']})" + (f"; issued {issued_by_site(issued2)}" if issued2 else "")
            + f" ({card})")
        check(err <= P["bound"], f"moe train parity {name}: parameters differ by {err}")
        check(mu_err <= P["mu_bound"], f"moe train parity {name}: mu differs by {mu_err}")
        check(all(r <= P["rel_bound"] for r in rel.values()),
              f"moe train parity {name}: {rel}")
        out[name] = {"max_abs_param_diff": err, "mu_err_of_max": mu_err, **met2, "rel": rel}
        del p2, mu2
        free()
    del params, mu
    free()
    return out


def moe_phase(card: str, mesh) -> dict:
    """Phase 10: olmoe-1b-7b served at full width and all 16 layers with
    phase 4's prompts (launches, a profile with the dispatch and combine as
    a class of their own), then plan-bound on the 1-rank NCCL mesh; the
    kernels at the path's new shapes; slice parity of olmoe-1b-7b at 2
    layers and deepseek-moe-16b at 4; one training step at 2 layers."""
    kernels = moe_kernels_phase(torch.Generator(device="cuda").manual_seed(SEED + 7))
    cfg = get_config(MOE_ARCH)
    prompts = make_prompts(cfg)
    model, init_s = init_model(cfg)
    served = serving_phase(cfg, model, init_s, prompts, extra=MOE_DISPATCH)
    planned = moe_plan_phase(cfg, model, prompts, card, mesh)
    del model
    free()
    parity = [moe_slice_parity(get_config(arch), make_prompts(get_config(arch)))
              for arch in MOE_PARITY_LAYERS]
    return {"served": served, "plan_serving": planned, "kernels": kernels,
            "slice_parity": parity, "train_parity": moe_train_parity(card, mesh),
            "card": card}


# ---------------------------------------------------------------------------
# phase 11: the dense families of Lagom's Table 2 (phi2-2b, mpt-7b) and
# three configs that share their features (phi4-mini-3.8b, stablelm-3b,
# h2o-danube-1.8b)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("phi2-2b", "mpt-7b", "phi4-mini-3.8b", "stablelm-3b", "h2o-danube-1.8b")
SWA_ARCH = "h2o-danube-1.8b"
# h2o-danube's prompts fill its 4096-slot ring nearly full, so 32 new tokens
# wrap it; its ring (4096 slots of 24 layers x 8 rows x 8 KV heads x 80) is
# 4.03 GB in fp32
SWA_PROMPT_LENS, SWA_MAX_SEQ = (4064, 4080), 4160
FAMILY_PARITY_LAYERS = 2
# the parity run of h2o-danube also cuts its window to 256 with prompts of
# 200-256 tokens (a prefill must fit the ring), so its ring wraps there too
SWA_PARITY_WINDOW, SWA_PARITY_LENS = 256, (200, 256)
FAMILY_PLAN_ARCH = "phi2-2b"
# the flash kernel's instantiations this phase adds, each at a served model's
# prefill shape and with an entry of its own in the kernels line:
# (name, instance, B, S, Hq, Hkv, h, window, alibi)
FLASH_VARIANTS = (
    ("flash_attention (h = 80)", "h80", BATCH, PROMPT_LENS[1], 32, 32, 80, 0, False),
    ("flash_attention (ALiBi)", "alibi", BATCH, PROMPT_LENS[1], 32, 32, 128, 0, True),
)
# the h = 80 instantiation's run-time window, held to the plain version as
# checks of that entry: a window of 256 that masks at S 2048 on danube's
# heads, and danube's served prefill itself (its longest prompt, 4080
# tokens, under its window of 4096, which masks no key there), at B 2 so
# the plain version's scores fit (2 x 32 x 4080^2 fp32 is 4.3 GB); the
# per-row arithmetic does not depend on B
FLASH_WINDOW_CHECKS = (
    ("flash_attention (h = 80, window 256)", BATCH, 2048, 32, 8, 80, 256, False),
    ("flash_attention (h = 80, danube's prefill)", 2, SWA_PROMPT_LENS[1], 32, 8, 80,
     4096, False),
)


def flash_instance(cfg) -> str:
    """The flash kernel's instantiation a model's prefill launches: the
    ALiBi one, the h = 80 one, or the base ones (h 112 and 128 without
    ALiBi) of the earlier phases."""
    return "alibi" if cfg.pos_kind == "alibi" else "h80" if cfg.head_dim == 80 else "base"


masked_pairs = _work.masked_pairs


def sdpa_masked(q, k, v, bias):
    """SDPA on its memory-efficient backend with an additive fp32 bias (the
    causal mask, the window and ALiBi in one (1, 1 | Hq, Sq, Sk) tensor)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def sdpa_yardstick(S: int, window: int, slopes, causal: bool = True):
    """SDPA's efficient backend for a causal mask over S positions with a
    window (0 = none) and ALiBi ``slopes`` (or None): ``is_causal`` where the
    mask is causal only (the library then skips the masked tiles), else the
    equivalent additive mask; with ``causal`` false, no mask.  Returns the
    call on (B, H, S, h) views and how it masks."""
    if not causal:
        return (lambda *a: sdpa_efficient(*a, False)), "no mask"
    if slopes is None and not 0 < window < S:
        return (lambda *a: sdpa_efficient(*a, True)), "is_causal"
    pos = torch.arange(S, device="cuda")
    dist = (pos[None, :] - pos[:, None]).float()                       # kpos - qpos
    keep = dist <= 0
    if window:
        keep &= -dist < window
    bias = (slopes.view(1, -1, 1, 1) * dist if slopes is not None
            else torch.zeros_like(dist)[None, None])
    bias = bias.masked_fill(~keep, float("-inf")).contiguous()
    return (lambda *a: sdpa_masked(*a, bias)), "its additive mask"


def flash_variant_phase(gen, name, B, S, Hq, Hkv, h, window, alibi) -> dict:
    """The flash kernel at a served model's prefill shape, causal fp32, with
    a window (0 = none) and ALiBi as given: held against its plain version
    on the same inputs, timed beside it and beside SDPA's efficient backend
    (with ``is_causal`` where the mask is causal only, else with the
    equivalent additive mask; null where that backend refuses it), and
    bounded by the pairs inside the mask at the 3xTF32 rate."""
    from repro_torch.models.layers import alibi_slopes

    q = randn((B, S, Hq, h), torch.float32, gen)
    k = randn((B, S, Hkv, h), torch.float32, gen)
    v = randn((B, S, Hkv, h), torch.float32, gen)
    slopes = alibi_slopes(Hq).cuda() if alibi else None
    kw = dict(causal=True, window=window, alibi_slopes=slopes)
    o = ops.flash_attention(q, k, v, backend="cuda", **kw)
    torch.cuda.synchronize()
    o_ref = ref.flash_attention_ref(q, k, v, **kw)
    err = (o - o_ref).abs().max().item()
    check(o.shape == q.shape and bool(torch.isfinite(o).all()), f"{name}: bad output")
    check(err <= FLASH_BOUND, f"{name}: max abs err {err} > {FLASH_BOUND}")
    del o, o_ref
    free()
    ms = time_ms(lambda: ops.flash_attention(q, k, v, backend="cuda", **kw))
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), samples=5, per_sample=2)
    G = Hq // Hkv
    qt, kt, vt = (x.transpose(1, 2) for x in
                  (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    lib_fn, lib_how = sdpa_yardstick(S, window, slopes)
    lib_call = lambda: lib_fn(qt, kt, vt)   # noqa: E731
    lib, err_lib, lib_note = None, None, ""
    try:
        err_lib = (lib_call().transpose(1, 2) - ref.flash_attention_ref(q, k, v, **kw)
                   ).abs().max().item()
        lib = time_ms(lib_call)
    except RuntimeError as e:           # the backend refuses the mask: no library time
        lib_note = f" (refused: {str(e).splitlines()[0][:120]})"
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel()) + (4 * Hq if alibi else 0)
    flops = 4 * h * B * Hq * masked_pairs(S, S, window)
    b_ms, b_by = bound_ms(nbytes, flops, FP32_AS_3XTF32)
    say(f"{name}: B={B} S={S} Hq={Hq} Hkv={Hkv} h={h} causal window={window} alibi={alibi} "
        f"fp32: max abs err {err:.3e} (bound {FLASH_BOUND}); {ms:.4f} ms; plain "
        f"{plain:.4f} ms; sdpa[{SDPA_BACKEND}] with {lib_how} "
        + (f"{lib:.4f} ms (its err vs plain {err_lib:.1e})" if lib is not None else "null")
        + f"{lib_note}; bound {b_ms:.4f} ms ({b_by}, 3xTF32 tensor cores, pairs inside the "
        f"mask; {b_ms / ms:.1%} of it reached)")
    del q, k, v, qt, kt, vt, lib_fn, lib_call
    free()
    return {"name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash.cu",
            "replaces": "src/repro/kernels/flash.py:65", "shape": [B, S, Hq, Hkv, h],
            "window": window, "alibi": alibi, "dtype": "float32", "max_abs_err": err,
            "bound": FLASH_BOUND, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib, "library_backend": SDPA_BACKEND,
            "library_call": lib_how, "library_max_abs_err": err_lib}


def family_plan_phase(cfg, model, prompts, card: str, mesh) -> dict:
    """phi2-2b at full size on the 1-rank NCCL mesh under plan (b) (layer 0
    and layer 1 ring their up projection by 2 and 4) beside the unplanned
    engine, in turns: the GELU ``serve_mlp`` with its biases and the
    parallel block on the sited trunk; teacher-forced logits within 1e-4."""
    plan = {k: collectives.CollectiveRuntime(*v) for k, v in PLAN_B.items()}
    engines = {"none": make_engine(cfg, model, batch_size=BATCH, max_seq=MAX_SEQ),
               "b": make_engine(cfg, model, batch_size=BATCH, max_seq=MAX_SEQ, plan=plan,
                                mesh=mesh)}
    for e in engines.values():
        e.generate(prompts, max_new=2)          # warm-up
    times = {name: [] for name in engines}
    record = {}
    for name in ("none", "b", "b", "none"):
        collectives.reset_degraded_warnings()
        ops.reset_launches()
        with warnings.catch_warnings(record=True) as ws, \
                collectives.record_issued() as issued:
            warnings.simplefilter("always")
            outs = engines[name].generate(prompts, max_new=MAX_NEW)
        t = engines[name].last_timing
        times[name].append((t["prefill_s"] * 1e3, statistics.median(t["decode_s"]) * 1e3))
        if name not in record:
            record[name] = {"outs": outs, "launches": dict(ops.LAUNCHES), "rows": issued,
                            "degraded": sum(issubclass(w.category,
                                                       collectives.CollectiveDegradedWarning)
                                            for w in ws)}
    base = record["none"]["outs"]
    check_outputs(base, cfg.vocab_size, "family plan serving, unplanned")
    forced = {name: e.teacher_forced_logits(prompts, base) for name, e in engines.items()}
    r = record["b"]
    err = (forced["b"] - forced["none"]).abs().max().item()
    by_site = issued_by_site(r["rows"])
    chunks = {s: sorted(set(v.get("ring_ag_matmul", []))) for s, v in by_site.items()
              if s.startswith(("serve.layer0.", "serve.layer1.")) and s.endswith(".ag")}
    want = expected_launches(cfg)
    say(f"family plan serving {cfg.name}: plan (b): prefill {times['b'][0][0]:.1f} / "
        f"{times['b'][1][0]:.1f} ms, decode {times['b'][0][1]:.2f} / {times['b'][1][1]:.2f} "
        f"ms/token (unplanned {times['none'][0][0]:.1f} / {times['none'][1][0]:.1f}, "
        f"{times['none'][0][1]:.2f} / {times['none'][1][1]:.2f}); teacher-forced logits max "
        f"abs diff from unplanned {err:.3e} (bound {PLAN_SERVE_BOUND}); tokens equal: "
        f"{r['outs'] == base}; CollectiveDegradedWarnings {r['degraded']}; launches "
        f"{r['launches']}; ring chunks of layers 0-1 {chunks}; issued "
        f"{issued_summary(r['rows'])} ({card})")
    check(bool(torch.isfinite(forced["b"]).all()), "family plan (b): non-finite logits")
    check(err <= PLAN_SERVE_BOUND, f"family plan (b): logits differ by {err}")
    check(r["launches"] == want, f"family plan (b): launches {r['launches']}, expected {want}")
    check(chunks == {"serve.layer0.mlp.ag": [2], "serve.layer1.mlp.ag": [4]},
          f"family plan (b) did not chunk layers 0 and 1 as it says: {chunks}")
    check(all(f"serve.layer{i}.mlp.rs" in by_site for i in range(cfg.num_layers)),
          "family plan (b): a layer's down projection issued no reduce-scatter")
    out = {"arch": cfg.name, "max_abs_logit_diff": err, "tokens_equal": r["outs"] == base,
           "degraded_warnings": r["degraded"], "launches": r["launches"], "chunks": chunks,
           "issued": issued_summary(r["rows"]),
           "prefill_ms": {k: [p for p, _ in v] for k, v in times.items()},
           "decode_ms": {k: [d for _, d in v] for k, v in times.items()}, "card": card}
    del engines, forced
    free()
    return out


def families_phase(card: str, mesh) -> dict:
    """Phase 11: the flash kernel's new variants against their plain
    versions (h = 80 with its window checks, ALiBi); the five models served
    at full width and depth as phase 4 serves (h2o-danube-1.8b over
    prompts that fill its ring, so decode wraps it); phi2-2b under plan (b) on the
    1-rank NCCL mesh; slice parity of each at 2 layers against
    ``backend="ref"``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    kernels = {v[1]: flash_variant_phase(gen, v[0], *v[2:]) for v in FLASH_VARIANTS}
    kernels["h80"]["window_checks"] = [flash_variant_phase(gen, *c)
                                       for c in FLASH_WINDOW_CHECKS]
    served, planned = [], None
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        swa = arch == SWA_ARCH
        prompts = make_prompts(cfg, SWA_PROMPT_LENS if swa else PROMPT_LENS)
        model, init_s = init_model(cfg)
        served.append(serving_phase(cfg, model, init_s, prompts,
                                    max_seq=SWA_MAX_SEQ if swa else MAX_SEQ))
        served[-1]["flash_instance"] = flash_instance(cfg)
        if swa:
            ring = M.init_caches(cfg, BATCH, SWA_MAX_SEQ, device="meta")["trunk"]
            slots = ring["dense_layers"]["k"].shape[2]
            kv_bytes = sum(ring["dense_layers"][n].numel() * 4 for n in ("k", "v"))
            wrapped = max(len(p) for p in prompts) + MAX_NEW > slots
            say(f"serving {arch}: a ring of {slots} slots (window {cfg.sliding_window}), "
                f"{kv_bytes / 1e9:.2f} GB of K and V; decode wrapped it: {wrapped}")
            check(slots == cfg.sliding_window and wrapped, f"{arch}: the ring did not wrap")
            served[-1].update(ring_slots=slots, kv_bytes=kv_bytes)
        if arch == FAMILY_PLAN_ARCH:
            planned = family_plan_phase(cfg, model, prompts, card, mesh)
        del model
        free()
    parity = []
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        parity.append(slice_parity_phase(cfg, make_prompts(cfg), layers=FAMILY_PARITY_LAYERS))
    cfg = get_config(SWA_ARCH).replace(sliding_window=SWA_PARITY_WINDOW)
    parity.append(slice_parity_phase(cfg, make_prompts(cfg, SWA_PARITY_LENS),
                                     layers=FAMILY_PARITY_LAYERS))
    planned["flash_instance"] = flash_instance(get_config(FAMILY_PLAN_ARCH))
    for instance, k in kernels.items():   # each model's flash launches, by instantiation
        k["launches_by_model"] = {s["arch"]: s["launches"]["flash_attention"]
                                  for s in served if s["flash_instance"] == instance}
        if planned["flash_instance"] == instance:
            k["launches_by_model"][f"{FAMILY_PLAN_ARCH} plan (b)"] = \
                planned["launches"]["flash_attention"]
        k["launches"] = sum(k["launches_by_model"].values())
        check(k["launches"] > 0, f"{k['name']}: no launch on the main paths")
    kernels = list(kernels.values())
    return {"kernels": kernels, "served": served, "plan_serving": planned,
            "slice_parity": parity, "card": card}


# ---------------------------------------------------------------------------
# phase 12: the dense families' training (the flash backward at h = 80, with
# windows and with ALiBi; phi2-2b and h2o-danube-1.8b at full depth)
# ---------------------------------------------------------------------------

# the backward kernels' instantiations this phase adds, each at a family's
# training shape and with an entry of its own in the kernels line (phi2-2b's
# B 4, S 2048, 32/32 heads at h 80; mpt-7b's at h 128 with ALiBi):
# (name, instance, B, S, Hq, Hkv, h, window, alibi)
FLASH_BWD_VARIANTS = (
    ("flash_attention_bwd (h = 80)", "h80", 4, 2048, 32, 32, 80, 0, False),
    ("flash_attention_bwd (ALiBi)", "alibi", 4, 2048, 32, 32, 128, 0, True),
)
# the h = 80 instantiation's run-time window, as checks of that entry: 256
# over S 2048 on h2o-danube's 32/8 heads, and danube's own window of 4096 at
# its training shape (B 2, S 8192, so the window masks keys in both
# kernels), held on one KV head's group (fp64 scores of all 32 heads at
# S 8192 take 34 GB; the plain version's fp32 forward and backward do not
# fit either, so its time there is null)
FLASH_BWD_WINDOW_CHECKS = (
    ("flash_attention_bwd (h = 80, window 256)", 4, 2048, 32, 8, 80, 256, False),
    ("flash_attention_bwd (h = 80, danube's training shape)", 2, 8192, 32, 8, 80, 4096,
     False),
)
PLAIN_SCORES_MAX = 4.3e9      # the plain version is timed where its fp32 scores fit this
# (arch, layers or None for all, B, S): phi2-2b and h2o-danube-1.8b at full
# depth (fp32 AdamW keeps 16 B a parameter: 41.4 and 27.3 GiB), the others
# cut to 4 layers (mpt-7b's 32 would need 99.1 GiB, phi4-mini-3.8b's 57.2)
FAMILY_TRAIN = (("phi2-2b", None, 4, 2048), ("h2o-danube-1.8b", None, 2, 8192),
                ("mpt-7b", 4, 4, 2048), ("phi4-mini-3.8b", 4, 4, 2048),
                ("stablelm-3b", 4, 4, 2048))
FAMILY_TRAIN_PROFILE = SWA_ARCH


def tp_rank_flash_phase(gen) -> list:
    """Phase 3's entries at the shape a rank of llama3-8b's tensor-parallel
    1x4 placement runs (B 4, S 2048, its 8 of 32 query heads over 2 of 8
    KV heads, h 128, causal fp32): the forward and the backward against
    their plain versions, timed beside them, SDPA's efficient backend and
    their bounds."""
    cfg = get_config(PLAN_ARCH)
    shape = (TRAIN_B, TRAIN_S, cfg.num_heads // TP_RANKS, cfg.num_kv_heads // TP_RANKS,
             cfg.head_dim, 0, False)
    tag = f"({PLAN_ARCH} 1x{TP_RANKS} rank, {shape[2]}/{shape[3]} heads)"
    return [flash_variant_phase(gen, f"flash_attention {tag}", *shape),
            flash_bwd_variant_phase(gen, f"flash_attention_bwd {tag}", *shape)]


def flash_bwd_variant_phase(gen, name, B, S, Hq, Hkv, h, window, alibi, *,
                            causal: bool = True, Sk=None) -> dict:
    """The flash backward at a family's training shape, fp32, causal or full
    over ``Sk`` keys (S unless given), with a window (0 = none) and ALiBi as
    given: from the forward's o and lse, held
    against autograd of the plain version in fp64 (one KV head's group where
    S > 4096), then timed (the backward's call alone) beside the plain
    version's backward and SDPA's efficient backend's (forward and backward
    less forward; with ``is_causal`` where the mask is causal only, no mask
    where it is full, else
    with the equivalent additive mask; null where that backend refuses it
    or the plain version's scores do not fit), and bounded by five products
    over the pairs inside the mask at the 3xTF32 rate."""
    from repro_torch.kernels.flash import flash_attention_bwd_cuda, flash_attention_cuda
    from repro_torch.models.layers import alibi_slopes

    Sk = S if Sk is None else Sk
    q, do = randn((B, S, Hq, h), torch.float32, gen), randn((B, S, Hq, h), torch.float32, gen)
    k, v = randn((B, Sk, Hkv, h), torch.float32, gen), randn((B, Sk, Hkv, h), torch.float32, gen)
    slopes = alibi_slopes(Hq).cuda() if alibi else None
    kw = dict(causal=causal, window=window, alibi_slopes=slopes)
    o, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    held = flash_train_shape_errs(q, k, v, do, o, lse,
                                  flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw),
                                  window=window, slopes=slopes,
                                  group=0 if S > 4096 else None, what=name, causal=causal)
    free()
    ms = time_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw), samples=10,
                 per_sample=2)
    plain, plain_note = None, ""
    if B * Hq * S * Sk * 4 <= PLAIN_SCORES_MAX:
        plain = backward_ms(lambda *a: ref.flash_attention_ref(*a, **kw), (q, k, v), do,
                            samples=5, per_sample=1)
    else:
        plain_note = f" (not timed: its fp32 scores take {B * Hq * S * Sk * 4 / 1e9:.1f} GB)"
    free()
    G = Hq // Hkv
    qt, kt, vt, dot = (x.transpose(1, 2) for x in
                       (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2), do))
    lib_call, lib_how = sdpa_yardstick(S, window, slopes, causal)
    lib, lib_note = None, ""
    try:
        lib = backward_ms(lib_call, (qt, kt, vt), dot, samples=10, per_sample=2)
    except RuntimeError as e:           # the backend refuses the mask: no library time
        lib_note = f" (refused: {str(e).splitlines()[0][:120]})"
    pairs = masked_pairs(S, Sk, window, causal) * B * Hq
    nbytes = 4 * (4 * q.numel() + 4 * k.numel() + lse.numel()) + (4 * Hq if alibi else 0)
    b_ms, b_by = bound_ms(nbytes, 5 * 2 * h * pairs, FP32_AS_3XTF32)
    say(f"{name}: B={B} S={S} Sk={Sk} Hq={Hq} Hkv={Hkv} h={h} "
        f"{'causal' if causal else 'full'} window={window} alibi={alibi} "
        f"fp32: {ms:.4f} ms; plain (autograd) "
        + (f"{plain:.4f} ms" if plain is not None else "null") + plain_note
        + f"; sdpa[{SDPA_BACKEND}] backward with {lib_how} "
        + (f"{lib:.4f} ms" if lib is not None else "null") + lib_note
        + f"; bound {b_ms:.4f} ms ({b_by}, five products as 3xTF32 over the pairs inside "
        f"the mask; {b_ms / ms:.1%} of it reached)")
    del q, k, v, o, lse, do, qt, kt, vt, dot, lib_call
    free()
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "replaces": "src/repro/kernels/flash.py:65", "shape": [B, S, Hq, Hkv, h],
            "Sk": Sk, "causal": causal, "window": window, "alibi": alibi, "dtype": "float32",
            "max_abs_err": held["grad_err"], "err_of_max_g": held["grad_err_of_max_g"],
            "bound": FLASH_GRAD_BOUND, "bound_of": "max|g| over dq, dk, dv",
            "o_max_abs_err": held["o_err"], "lse_max_abs_err": held["lse_err"],
            "held_on": "all heads" if S <= 4096 else "KV head 0's group",
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "library_backend": SDPA_BACKEND, "library_call": lib_how,
            "library": f"sdpa[{SDPA_BACKEND}] forward+backward less forward"}


def family_train_phase(card: str, arch: str, layers, B: int, S: int, *,
                       profile: bool = False) -> dict:
    """One family at full width (and ``layers`` deep, or all), fp32, trained
    for three plain steps from the port's SyntheticCorpus (B x S, remat,
    warmup_cosine, phase 8's lr; an audio model's frames and a vlm model's
    patches from ``data.pipeline.stub_inputs``, the same every step): step
    time, tokens/s, MFU, peak memory, loss and grad_norm; gated on finite
    losses, every parameter moving and the kernels' launches equal to the
    code's (their shape classes returned beside them); with ``profile``, a
    profiler trace of a fourth step by kernel class."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, stub_inputs
    from repro_torch.optim import adamw
    from repro_torch.train import metrics as MET, trainer as T

    cfg = get_config(arch)
    cfg = cfg.replace(num_layers=layers) if layers else cfg
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                        seed=SEED))
    stubs = {k: torch.as_tensor(v, device="cuda")
             for k, v in stub_inputs(cfg, B, seed=SEED).items()}
    tokens = B * S
    t0 = time.perf_counter()
    model = M.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    state_gib = 16 * n_params / 2**30
    tag = f"train {arch}"
    say(f"{tag}: {cfg.num_layers} layers at full width, {n_params} params fp32 (AdamW "
        f"state {state_gib:.1f} GiB), init {time.perf_counter() - t0:.2f} s; batch {B} x "
        f"seq {S}, remat, warmup_cosine; flash instance {flash_instance(cfg)} ({card})")
    before = param_sums(model)
    step_fn = T.make_train_step(cfg, T.TrainConfig(opt=adamw.AdamWConfig(**TRAIN_OPT),
                                                   warmup=2, total_steps=100))
    state = adamw.init_state(dict(model.named_parameters()))
    times, losses, norms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for step in range(TRAIN_STEPS):
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in corpus.batch(step).items()}
        batch.update(stubs)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, state, m = step_fn(model, state, batch, step)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = dict(ops.LAUNCHES)
    by_shape = dict(ops.LAUNCHES_BY_SHAPE)
    peak = torch.cuda.max_memory_allocated()
    want = {k: TRAIN_STEPS * v for k, v in expected_train_launches(cfg, 1).items()}
    step_s = statistics.median(times[1:])
    mfu = MET.mfu(cfg, tokens, step_s, peak=MET.H100_FP32_PEAK)
    say(f"{tag}: step {step_s * 1e3:.1f} ms (median of steps 2-3; all "
        f"{[round(t * 1e3, 1) for t in times]} ms), {tokens / step_s:.0f} tok/s, MFU "
        f"{mfu:.4f} of the fp32 CUDA-core peak (67 TFLOP/s); peak memory "
        f"{peak / 2**30:.2f} GiB; loss {losses}, grad_norm {norms} ({card})")
    say(f"{tag}: launches {launches} (expected {want})")
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)), f"{tag}: non-finite")
    after = param_sums(model)
    still = [n for n in before if before[n] == after[n]]
    check(not still, f"{tag}: parameters that did not move: {still[:5]}")
    out = {"arch": arch, "layers": cfg.num_layers, "params": n_params, "batch": B, "seq": S,
           "adamw_state_gib": state_gib, "flash_instance": flash_instance(cfg),
           "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in times],
           "tokens_per_s": tokens / step_s, "mfu_fp32": mfu, "peak_bytes": peak,
           "loss": losses, "grad_norm": norms, "launches": launches,
           "launches_by_shape": by_shape}
    if profile:
        t = time.perf_counter()
        dev = train_ms_by_class(lambda: step_fn(model, state, batch, TRAIN_STEPS))
        wall = (time.perf_counter() - t) * 1e3
        busy = sum(dev.values())
        say(f"{tag} profile, one plain step: wall {wall:.1f} ms (profiled), device busy "
            f"{busy:.1f} ms; " + ", ".join(f"{k} {v:.1f} ms" for k, v in dev.items()) +
            f" ({card})")
        check(busy > 0, f"{tag} profile: the profiler saw no kernel")
        out.update(profile_ms=dev, profile_wall_ms=wall)
    del model, state, step_fn, batch
    free()
    return out


def family_train_parity(card: str, cfg, layers: int = PARITY_TRAIN["layers"], *,
                        grads_to_fp64: bool = False) -> dict:
    """One train step of ``cfg`` at full width and ``layers`` (an audio
    model's encoder too; B = 1, S = 512, with its frames or patches)
    through the kernels, then one through ``backend="ref"`` from the same
    weights on the same batch, replaying the kernels' MoE routing
    (``layers.record_routing``), held to each other with phase 8's parity
    bounds (PARITY_TRAIN); the kernels' launches must be the code's.  The
    first step's parameters and mu wait in host memory (a second model of
    qwen2-vl-72b's size does not fit on the card beside them).  With
    ``grads_to_fp64`` the step's mu and grad_norm are held instead to the
    plain versions' in fp64 (``fp64_grads_held``): where an fp32 rounding
    anywhere moves the first layers' gradients by more than PARITY_TRAIN's
    mu bound, two fp32 steps cannot agree within it."""
    from repro_torch.models import layers as L

    P = PARITY_TRAIN
    cut = dict(num_layers=layers)
    if cfg.family == "audio":
        cut["encoder_layers"] = layers
    cfg = cfg.replace(**cut)
    batch = parity_batch(cfg)
    with L.record_routing() as routed:
        first = parity_step(cfg, batch)
    first.update({k: {n: a.cpu() for n, a in first[k].items()} for k in ("params", "mu")})
    loss, gnorm, launches = first["loss"], first["grad_norm"], first["launches"]
    want = expected_train_launches(cfg, 1)
    window = f", window {cfg.sliding_window}" if cfg.sliding_window else ""
    stubs = "".join(f", {k}" for k in ("frames", "patches") if k in batch)
    tag = f"train parity {cfg.name} ({layers} layers, full width, B={P['B']}, " \
          f"S={P['S']}{window}{stubs}{', routing replayed' if cfg.is_moe else ''})"
    check(np.isfinite(loss) and np.isfinite(gnorm), f"{tag}: non-finite loss")
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    with L.record_routing(routed):
        other = parity_step(cfg, batch, backend="ref")
    check(other["launches"] == NO_LAUNCHES, f"{tag}: backend='ref' launched a kernel")
    held = parity_held(tag, "ref", first, other, card, mu_to_fp64=grads_to_fp64)
    del first, other
    free()
    out = {"arch": cfg.name, "layers": layers, "window": cfg.sliding_window,
           "loss": loss, "grad_norm": gnorm, "launches": launches, "ref": held}
    if grads_to_fp64:
        out["fp64"] = fp64_grads_held(tag, cfg, batch, card)
    return out


# the gradients and grad_norm of a parity step through the kernels against
# those of the plain versions with the model in fp64, of each gradient's
# max|g| and relative: fixed limits between the sound readings and a
# control's.  At zamba2-7b's 7 layers on an H100: the kernels 1.965e-4 and
# 2.40e-6, the fp32 plain versions 3.025e-4 and 1.02e-5; the control (the
# kernels' step with TF32 on for cuBLAS and cuDNN) must miss them.
PARITY_FP64 = dict(grads=1e-3, grad_norm=3e-5)


@contextlib.contextmanager
def tf32_on():
    """TF32 on for cuBLAS and cuDNN (``fp64_grads_held``'s control), off
    again after, as every phase runs."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def parity_grads(cfg, batch, *, backend=None, dtype=None) -> dict:
    """The loss's gradients of ``cfg`` from SEED + 2's weights (the model
    cast to ``dtype`` where given) on ``batch`` through ``backend``, remat
    on, as ``parity_step`` takes them before AdamW: ``grads``, ``loss``,
    ``grad_norm`` (in fp64) and the kernels' ``launches``."""
    model = M.init_params(cfg, SEED + 2, device="cuda")
    if dtype is not None:
        model = model.to(dtype)
    ops.reset_launches()
    loss, _ = M.loss_and_metrics(cfg, model, batch, remat=True, backend=backend)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, (g.detach() for g in torch.autograd.grad(loss, params))))
    torch.cuda.synchronize()
    gnorm = math.sqrt(sum(g.double().square().sum().item() for g in grads.values()))
    del model, params
    return {"grads": grads, "loss": loss.item(), "grad_norm": gnorm,
            "launches": dict(ops.LAUNCHES)}


def fp64_grads_held(tag: str, cfg, batch, card: str) -> dict:
    """The gradients and grad_norm of ``cfg``'s parity step through the
    kernels (``parity_grads``; one step's mu is 0.1 x the clipped gradient)
    held within PARITY_FP64 to the plain versions' with the model in fp64
    (they compute in fp64 for fp64 inputs); the fp32 plain versions' and a
    control's distance printed beside: the kernels' step with TF32 on,
    which must miss the limits, or they would not fail a step of lower
    precision."""
    want = expected_train_launches(cfg, 1)
    exact = parity_grads(cfg, batch, backend="ref", dtype=torch.float64)
    check(exact["launches"] == NO_LAUNCHES, f"{tag}: the fp64 plain step launched a kernel")
    runs = {}
    for name, kw, mode, launches in (
            ("kernels", {}, contextlib.nullcontext, want),
            ("plain fp32", dict(backend="ref"), contextlib.nullcontext, NO_LAUNCHES),
            ("control, kernels with TF32 on", {}, tf32_on, want)):
        with mode():
            got = parity_grads(cfg, batch, **kw)
        check(got["launches"] == launches, f"{tag} {name}: launches {got['launches']}, "
                                           f"expected {launches}")
        runs[name] = parity_errors(exact, got, "grads")
        del got
        free()
    del exact
    free()

    def within(e):
        return (e["grads_err_of_max"] <= PARITY_FP64["grads"]
                and e["grad_norm_rel"] <= PARITY_FP64["grad_norm"])

    say(f"{tag}, gradients against the plain versions' in fp64 (limits {PARITY_FP64['grads']} "
        f"of max|g|, grad_norm {PARITY_FP64['grad_norm']} relative): " + "; ".join(
            f"{name} {e['grads_err_of_max']:.3e} (at {e['grads_err_at']}), grad_norm "
            f"{e['grad_norm_rel']:.2e}, loss {e['loss_rel']:.2e}" for name, e in runs.items())
        + f" ({card})")
    kern, control = runs["kernels"], runs["control, kernels with TF32 on"]
    check(within(kern), f"{tag}: gradients {kern['grads_err_of_max']} of max|g|, grad_norm "
                        f"{kern['grad_norm_rel']} from fp64, beyond {PARITY_FP64}")
    check(kern["grads_zero_max"] <= kern["grads_zero_floor"],
          f"{tag}: gradients of {kern['grads_zero_but_for_rounding']} (zero but for "
          f"rounding) reach {kern['grads_zero_max']}")
    check(not within(control), f"{tag}: the control (TF32 on) is within {PARITY_FP64}: "
                               f"{control['grads_err_of_max']}, {control['grad_norm_rel']}")
    keep = ("grads_err_of_max", "grad_norm_rel", "loss_rel")
    return {"limits": PARITY_FP64,
            **{name: {k: e[k] for k in keep} for name, e in runs.items()}}


def families_train_phase(card: str) -> dict:
    """Phase 12: the flash backward's new variants (h = 80 with its window
    checks, ALiBi) against autograd of their plain versions in fp64, timed;
    the five families trained at full width (phi2-2b and h2o-danube-1.8b at
    full depth); one step of each at 2 layers against ``backend="ref"``
    (h2o-danube also with its window cut to 256, so the window masks at
    S 512).  The new backward entries carry each model's launches."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    kernels = {v[1]: flash_bwd_variant_phase(gen, v[0], *v[2:]) for v in FLASH_BWD_VARIANTS}
    kernels["h80"]["window_checks"] = [flash_bwd_variant_phase(gen, *c)
                                       for c in FLASH_BWD_WINDOW_CHECKS]
    trained = [family_train_phase(card, *t, profile=t[0] == FAMILY_TRAIN_PROFILE)
               for t in FAMILY_TRAIN]
    parity = [family_train_parity(card, get_config(arch)) for arch in FAMILY_ARCHS]
    parity.append(family_train_parity(
        card, get_config(SWA_ARCH).replace(sliding_window=SWA_PARITY_WINDOW)))
    for instance, k in kernels.items():   # each model's backward launches, by instantiation
        k["launches_by_model"] = {f"{t['arch']} train": t["launches"]["flash_attention_bwd"]
                                  for t in trained if t["flash_instance"] == instance}
        k["launches"] = sum(k["launches_by_model"].values())
        check(k["launches"] > 0, f"{k['name']}: no launch on the main paths")
    seconds = time.perf_counter() - t0
    say(f"phase 12 (the dense families' training) took {seconds:.1f} s")
    return {"kernels": list(kernels.values()), "trained": trained, "parity": parity,
            "seconds": seconds, "card": card}


# ---------------------------------------------------------------------------
# phase 13: the pipeline (yi-34b's stages on a stage mesh of one rank)
# ---------------------------------------------------------------------------

PIPE_ARCH = "yi-34b"
# full width (d 7168, 56/8 heads, d_ff 20480, vocab 64000) cut to 2 layers
# (8.1 GB of fp32 weights, 16 GB with their gradients); B x S from the
# port's SyntheticCorpus in M microbatches, remat on
PIPE = dict(layers=2, B=4, S=2048, M=4)
PIPE_LOSS_REL, PIPE_GRAD_BOUND = 1e-5, 1e-4    # against the unpipelined model
PIPE_SITE = "pp.tick.p2p"


def expected_pipeline_launches(cfg, microbatches: int) -> dict:
    """Each kernel's launches in one forward and backward of
    ``model.pipeline_loss`` with remat: each microbatch runs the stage's
    layers as a train pass does (forward, recompute, backward), the final
    norm runs once over the whole batch."""
    want = expected_train_launches(cfg, microbatches)
    return dict(want, rmsnorm=want["rmsnorm"] - (microbatches - 1),
                rmsnorm_bwd=want["rmsnorm_bwd"] - (microbatches - 1))


def rmsnorm_at_phase(gen, rows: int, D: int, tag: str) -> list:
    """The RMSNorm forward and backward kernels at (rows, D) fp32, each held
    against its plain version (the forward within 1e-5; the backward as
    ``rmsnorm_bwd_at`` holds it) and timed beside it, beside the library
    call (``F.rms_norm``) and beside its bound (the forward as
    ``rmsnorm_fwd_times`` times it): an entry of the kernels line each."""
    x = randn((rows, D), torch.float32, gen)
    scale = torch.linspace(0.5, 1.5, D, device="cuda")
    err = (ops.rmsnorm(x, scale, backend="cuda") - ref.rmsnorm_ref(x, scale)).abs().max().item()
    check(err <= RMS_BOUND_F32, f"rmsnorm ({rows}, {D}): max abs err {err} > {RMS_BOUND_F32}")
    del x
    free()
    fwd = rmsnorm_fwd_times(gen, rows, D)
    say_rmsnorm_fwd(f"rmsnorm ({rows}, {D}) fp32 {tag}", err, fwd)
    return [dict(route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                 replaces="src/repro/kernels/rmsnorm.py:25", shape=[rows, D], dtype="float32",
                 name=f"rmsnorm {tag}", max_abs_err=err, bound=RMS_BOUND_F32, **fwd),
            rmsnorm_bwd_at(gen, rows, D, tag)]


def rmsnorm_bwd_at(gen, rows: int, D: int, tag: str) -> dict:
    """The RMSNorm backward kernel at (rows, D) fp32 against autograd of its
    plain version in fp64 (within 1e-5 of max|g|), timed by its device time
    (the sum of its two kernels' mean launches, ``device_ms_split``; the
    call's time by CUDA events beside it, which at narrow rows is the
    host's) beside the plain version's
    backward, autograd of ``F.rms_norm`` (device time of its forward and
    backward less its forward, and by CUDA events) and its bound (bytes:
    x, dy and dx, the scale and dscale): an entry of the kernels line."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda

    x, dy = randn((rows, D), torch.float32, gen), randn((rows, D), torch.float32, gen)
    scale = torch.linspace(0.5, 1.5, D, device="cuda")
    got = rmsnorm_bwd_cuda(x, scale, dy)
    want = grads_of(ref.rmsnorm_ref, (x.double(), scale.double()), dy.double())
    errs = [(g.double() - w).abs().max().item() for g, w in zip(got, want)]
    rel = max(e / w.abs().max().item() for e, w in zip(errs, want))
    check(rel <= RMS_GRAD_BOUND, f"rmsnorm backward ({rows}, {D}): err {rel} of max|g| "
                                 f"> {RMS_GRAD_BOUND}")
    del got, want
    free()
    call = lambda: rmsnorm_bwd_cuda(x, scale, dy)  # noqa: E731
    split = device_ms_split(call, ("rmsnorm_bwd_kernel", "rmsnorm_dscale_kernel"), calls=50)
    check(all(math.isfinite(v) for v in split.values()),
          f"rmsnorm backward ({rows}, {D}): no profiler record of a kernel: {split}")
    leaves = [t.detach().clone().requires_grad_() for t in (x, scale)]
    lib_fwd = lambda: torch.nn.functional.rms_norm(leaves[0], (D,), leaves[1], 1e-5)  # noqa: E731
    bwd = dict(ms=sum(split.values()), device_ms_by_kernel=split, ms_a_call=time_ms(call),
               plain_ms=backward_ms(ref.rmsnorm_ref, (x, scale), dy),
               library_ms=(device_ms_a_call(lambda: torch.autograd.grad(lib_fwd(), leaves, dy))
                           - device_ms_a_call(lib_fwd)),
               library_ms_a_call=backward_ms(lambda a, b: torch.nn.functional.rms_norm(
                   a, (D,), b, 1e-5), (x, scale), dy))
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(4 * (3 * rows * D + 2 * D), 8 * rows * D,
                                                torch.float32)
    say(f"rmsnorm backward ({rows}, {D}) fp32 {tag}: max abs err {max(errs):.3e}, "
        f"{rel:.3e} of max|g| (bound {RMS_GRAD_BOUND}); {bwd['ms']:.4f} ms on the card "
        f"({bwd['ms_a_call']:.4f} ms a call); plain {bwd['plain_ms']:.4f} ms; F.rms_norm's "
        f"backward {bwd['library_ms']:.4f} ms on the card ({bwd['library_ms_a_call']:.4f} ms "
        f"a call); bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']}; "
        f"{bwd['bound_ms'] / bwd['ms']:.1%} of it reached)")
    del x, dy
    free()
    return dict(route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:25", shape=[rows, D], dtype="float32",
                name=f"rmsnorm_bwd {tag}", max_abs_err=max(errs), err_of_max_g=rel,
                bound=RMS_GRAD_BOUND, bound_of="max|g|", library="autograd of F.rms_norm",
                **bwd)


def pipeline_phase(card: str, mesh, rmsnorm_bwd_ptxas: dict) -> dict:
    """Phase 13: the kernels at yi-34b's shapes (RMSNorm forward and backward
    at (B·S, 7168), whose backward takes the 8-vector register path; flash
    forward and backward at its GQA group of 7), each against its plain
    version and timed; then yi-34b at full width and 2 layers through
    ``model.pipeline_loss`` on a stage mesh of the 1-rank NCCL group (no
    transfer is issued at one stage), held against the unpipelined
    ``loss_and_metrics`` of the same weights on the same batch: the loss
    within 1e-5 relative, every gradient within 1e-4 of its max|g|; the
    kernels' launches, forward and backward ms, peak memory and a profile
    by kernel class."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch.mesh import Mesh

    t0 = time.perf_counter()
    P = PIPE
    B, S, M_ = P["B"], P["S"], P["M"]
    full = get_config(PIPE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    tag = "(yi-34b, D = 7168)"
    kernels = rmsnorm_at_phase(gen, B * S, full.d_model, tag)
    attn = (B, S, full.num_heads, full.num_kv_heads, full.head_dim, 0, False)
    kernels.append(flash_variant_phase(gen, "flash_attention (yi-34b, GQA 7)", *attn))
    kernels.append(flash_bwd_variant_phase(gen, "flash_attention_bwd (yi-34b, GQA 7)", *attn))
    eight = rmsnorm_bwd_ptxas[8]
    kernels[1]["ptxas_8_vectors"] = eight
    say(f"ptxas rmsnorm backward <fp32, 8 vectors> (the path at D = {full.d_model}): "
        f"{eight['registers']} registers, {eight['spill_stores']} B spill stores, "
        f"{eight['spill_loads']} B spill loads")

    cfg = full.replace(num_layers=P["layers"])
    stage = Mesh(mesh.group, 1, 0, "stage")
    init_t = time.perf_counter()
    model = M.init_stage(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    names, params = zip(*model.named_parameters())
    n_params = sum(p.numel() for p in params)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                        seed=SEED))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in corpus.batch(0).items()}
    what = (f"pipeline {PIPE_ARCH} ({cfg.num_layers} layers at full width, {n_params} params "
            f"fp32, B {B} x S {S}, M {M_}, one stage)")
    say(f"{what}: init {time.perf_counter() - init_t:.2f} s ({card})")

    def unpiped():
        loss, _ = M.loss_and_metrics(cfg, model, batch)
        return loss, torch.autograd.grad(loss, params)

    def piped():
        loss, _ = M.pipeline_loss(cfg, model, batch, mesh=stage, microbatches=M_,
                                  site=PIPE_SITE)
        return loss, torch.autograd.grad(loss, params)

    loss0, want = unpiped()
    want = [g.cpu() for g in want]       # on the host: the peak below is the pipeline's
    free()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with collectives.record_issued() as issued, \
            collectives.record_site_resolutions() as resolved:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss1, got = piped()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expect = expected_pipeline_launches(cfg, M_)
    say(f"{what}: launches {launches} (expected {expect}); issued {len(issued)} transfers; "
        f"{PIPE_SITE} resolved to {[(r.matched_key, r.tier, r.num_chunks) for r in resolved]}")
    check(launches == expect, f"{what}: launches {launches}, expected {expect}")
    check(not issued, f"{what}: a stage mesh of one issued {issued}")
    loss0, loss1 = loss0.item(), loss1.detach().item()
    loss_rel = abs(loss1 - loss0) / abs(loss0)
    worst, at = 0.0, ""
    for n, g, w in zip(names, got, want):
        check(bool(torch.isfinite(g).all()), f"{what}: gradient of {n} not finite")
        w = w.to("cuda")
        rel = ((g - w).abs().max() / w.abs().max()).item()
        if rel > worst:
            worst, at = rel, n
    say(f"{what}: loss {loss1:.6f} against the unpipelined {loss0:.6f} (relative "
        f"{loss_rel:.2e}, bound {PIPE_LOSS_REL}); gradients within {worst:.2e} of max|g| "
        f"(at {at}; bound {PIPE_GRAD_BOUND}) ({card})")
    check(loss_rel <= PIPE_LOSS_REL, f"{what}: loss {loss1} against {loss0}")
    check(worst <= PIPE_GRAD_BOUND, f"{what}: gradient of {at} off by {worst} of max|g|")
    del got, want
    free()
    times = {"pipelined": [first_s], "unpipelined": []}
    for run, key in ((unpiped, "unpipelined"), (piped, "pipelined"), (unpiped, "unpipelined"),
                     (piped, "pipelined")):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times[key].append(time.perf_counter() - t)
        del out
        free()
    t = time.perf_counter()
    prof = train_ms_by_class(piped)
    wall = (time.perf_counter() - t) * 1e3
    ms = {k: statistics.median(v[-2:]) * 1e3 for k, v in times.items()}
    say(f"{what}: forward and backward {ms['pipelined']:.1f} ms pipelined (all "
        f"{[round(x * 1e3, 1) for x in times['pipelined']]}), {ms['unpipelined']:.1f} ms "
        f"unpipelined; peak memory {peak / 2**30:.2f} GiB; profiled {wall:.1f} ms wall: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in prof.items()) + f" ({card})")
    del model, params, batch
    free()
    names_by_kernel = {"rmsnorm": 0, "rmsnorm_bwd": 1, "flash_attention": 2,
                       "flash_attention_bwd": 3}
    for kernel, i in names_by_kernel.items():
        kernels[i]["launches_by_model"] = {f"{PIPE_ARCH} pipeline": launches[kernel]}
        kernels[i]["launches"] = launches[kernel]
        check(launches[kernel] > 0, f"{kernels[i]['name']}: no launch on the main path")
    seconds = time.perf_counter() - t0
    say(f"phase 13 (the pipeline) took {seconds:.1f} s")
    return {"kernels": kernels, "arch": PIPE_ARCH, "layers": cfg.num_layers, "params": n_params,
            "batch": B, "seq": S, "microbatches": M_, "loss": loss1, "unpipelined_loss": loss0,
            "loss_rel": loss_rel, "grad_err_of_max_g": worst, "grad_err_at": at,
            "launches": launches, "fwd_bwd_ms": ms, "fwd_bwd_ms_all": {
                k: [x * 1e3 for x in v] for k, v in times.items()},
            "peak_bytes": peak, "profile_ms": prof, "profile_wall_ms": wall,
            "rmsnorm_bwd_ptxas_8": eight, "seconds": seconds, "card": card}


# ---------------------------------------------------------------------------
# phase 14: the overlap verifier and the dry run
# ---------------------------------------------------------------------------

ANALYSIS_CHUNKS = (2, 4)
# llama3-8b's parameters, the reference's ``eval_shape`` count (the port's
# ``launch.specs`` count is held to it by tests/test_torch_dryrun.py)
LLAMA3_8B_PARAMS = 8_030_261_248
# the dry run's depth: 8 layers keep grad_accum > 1 (4 at train_4k) at a
# sixteenth of the full depth's trace time
DRYRUN_LAYERS = 8
DRYRUN_ARGS = ("--arch", PLAN_ARCH, "--shape", "train_4k", "--layers", str(DRYRUN_LAYERS))
_EXERCISE_OFF = """
import json, sys
from repro_torch.analysis.exercise import exercise_plan
from repro_torch.core.session import TunedPlan
print(json.dumps({p: [v.verdict for v in exercise_plan(TunedPlan.load(p), install=False).verdicts]
                  for p in sys.argv[1:]}))
"""


def _src_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")


def _param_count(cfg) -> int:
    from repro_torch.launch.specs import param_specs_shapes
    return sum(math.prod(s) for s in param_specs_shapes(cfg).values())


def dryrun_start(out_dir: str):
    """Starts phase 14's dry run (``dryrun``) in a process of its own: it
    traces fake tensors on one host core and needs no card, so ``main``
    starts it after the build and reads it in phase 14; its output goes to
    ``out_dir``/dryrun.log.  Returns (process, start)."""
    with open(os.path.join(out_dir, "dryrun.log"), "w") as log:
        return (subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                                  *DRYRUN_ARGS, "--out-dir", out_dir], cwd=ROOT,
                                 env=_src_env(), stdout=log, stderr=subprocess.STDOUT),
                time.perf_counter())


def dryrun(card: str, started, out_dir: str) -> dict:
    """``python -m repro_torch.launch.dryrun`` of llama3-8b's train_4k at
    ``DRYRUN_LAYERS`` layers on the 16 x 16 fake mesh (256 fake ranks, fake
    tensors, no card), as ``dryrun_start`` started it into ``out_dir``, its
    record checked: ``ok``, the parameters of its depth, ``grad_accum`` >
    1, and every collective kind the placed step issues.  The full depth's
    count (``launch.specs`` alone, no trace) is held to the reference's."""
    full = _param_count(get_config(PLAN_ARCH))
    check(full == LLAMA3_8B_PARAMS, f"param_specs_shapes of {PLAN_ARCH}: {full}")
    proc, t0 = started
    proc.wait(timeout=300)
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "dryrun.log")) as f:
        out = f.read()
    check(proc.returncode == 0, f"dry run: exit code {proc.returncode}: {out[-4000:]}")
    with open(os.path.join(out_dir, f"{PLAN_ARCH}_train_4k_pod1.json")) as f:
        rec = json.load(f)
    want = _param_count(get_config(PLAN_ARCH).replace(num_layers=DRYRUN_LAYERS))
    check(rec["status"] == "ok" and rec["params"] == want and rec["grad_accum"] > 1,
          f"dry run: {rec.get('status')}, params {rec.get('params')} (want {want}), "
          f"grad_accum {rec.get('grad_accum')}")
    coll = rec["collectives"]
    check(all(coll[k] > 0 for k in ("all-gather", "all-reduce", "reduce-scatter",
                                    "collective-permute")), f"dry run: collectives {coll}")
    say(f"analysis: dry run of {PLAN_ARCH} train_4k at {DRYRUN_LAYERS} layers on the 16x16 "
        f"fake mesh: {rec['trace_s']} s of run ({seconds:.1f} s from its start beside the "
        f"earlier phases), {rec['params']} "
        f"params ({full} at full depth), peak {rec['memory']['peak_bytes'] / 2**30:.2f} GiB "
        f"a rank, {rec['flops']:.4g} flops a rank, grad_accum {rec['grad_accum']}, "
        f"{coll['count']} collectives ({card})")
    return dict(rec, command_s=seconds, params_full_depth=full)


def verify_overlap_cli(card: str) -> dict:
    """Phase 6's two h100-sxm plans saved as JSON and judged by
    ``python -m repro_torch.analysis verify-overlap`` (exit 0, every site
    MATERIALIZED over the fake world of 8), and the ``install=False``
    control (every site ABSENT)."""
    cfg = get_config(PLAN_ARCH)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for name, spec in PLAN_WORKLOADS.items():
            wl = extract_workload(cfg, ParallelPlan(**spec), seq=PLAN_SEQ,
                                  global_batch=PLAN_BATCH)
            paths.append(os.path.join(d, f"{name.replace(':', '')}_h100-sxm.json"))
            tune(wl, "h100-sxm", method="lagom").save(paths[-1])
        t0 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "verify-overlap",
                              *paths], cwd=ROOT, env=_src_env(), capture_output=True,
                             text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        verdicts = re.findall(r"^\s+(MATERIALIZED|DEGRADED|ABSENT)\s", cli.stdout, re.M)
        check(cli.returncode == 0 and verdicts and set(verdicts) == {"MATERIALIZED"},
              f"verify-overlap: exit {cli.returncode}\n{cli.stdout[-3000:]}{cli.stderr[-2000:]}")
        off = subprocess.run([sys.executable, "-c", _EXERCISE_OFF, *paths], cwd=ROOT,
                             env=_src_env(), capture_output=True, text=True, timeout=300)
        check(off.returncode == 0, f"install=False control: {off.stderr[-2000:]}")
        absent = json.loads(off.stdout.strip().splitlines()[-1])
        check(all(v and set(v) == {"ABSENT"} for v in absent.values()),
              f"install=False control: {absent}")
    out = {"exit": cli.returncode, "sites": len(verdicts), "seconds": cli_s,
           "control_absent": sum(len(v) for v in absent.values())}
    say(f"analysis: verify-overlap of phase 6's fsdp:8 and tp:8 plans for h100-sxm: exit "
        f"{cli.returncode}, {len(verdicts)} sites MATERIALIZED in {cli_s:.1f} s; "
        f"install=False: all {out['control_absent']} ABSENT ({card})")
    return out


def profiled_helpers(card: str, mesh) -> list:
    """``trace_and_verify(..., profile=True)`` over phase 7's
    ``mm_reduce_scatter``, ``chunked_all_to_all`` and ``psum_tree_chunked``
    calls at 2 and 4 chunks on the 1-rank NCCL group: every site
    MATERIALIZED in the record, and the first two in the profile; then, from
    a profile of the same calls without the record (whose dispatch mode
    slows the host), each call's NCCL device ms with the ms of it under
    another kernel (``ir.nccl_overlap``).  At one rank NCCL runs a copy for
    the reduce-scatter and the all-to-all, and nothing for the psum's
    in-place all-reduce, so the profile holds no collective of the psum and
    its site is judged by the record alone; the ring issues no hop on one
    rank (nothing to judge its site by), so it is not among them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.ir import graph_from_profile, nccl_overlap
    from repro_torch.analysis.overlap import trace_and_verify

    C = collectives
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = get_config(PLAN_ARCH)
    D, F, T = cfg.d_model, cfg.d_ff, BATCH * PROMPT_LENS[1]
    h = randn((1, T, F), torch.float32, gen)
    wd = randn((F, D), torch.float32, gen) / F ** 0.5
    tree = {"gate": randn((D, F), torch.float32, gen), "down": wd}
    sites = {"tp.layer0.mlp.rs": "rs", "ep.layer0.moe.a2a_disp": "a2a",
             "acc.step0.rs_grads": "acc"}
    on_card = ("tp.layer0.mlp.rs", "ep.layer0.moe.a2a_disp")    # the profile's

    def program():
        C.mm_reduce_scatter(h, wd, mesh, site="tp.layer0.mlp.rs")
        C.chunked_all_to_all(h, mesh, split_axis=1, concat_axis=1,
                             site="ep.layer0.moe.a2a_disp")
        C.psum_tree_chunked(tree, mesh, site="acc.step0.rs_grads")

    rows = []
    with tempfile.TemporaryDirectory() as d:
        for nc in ANALYSIS_CHUNKS:
            plan = {s: C.CollectiveRuntime("chunked", nc) for s in sites}
            with C.use_runtime_plan(plan):
                program()               # warm: cuBLAS and NCCL set up outside the profile
            torch.cuda.synchronize()
            path = os.path.join(d, f"trace{nc}.json")
            rec, prof = trace_and_verify(plan, program, profile=path)
            got = {v.site: v.verdict for v in prof.verdicts}
            check(len(rec.materialized) == len(sites)
                  and all(got.get(s) == "MATERIALIZED" for s in on_card),
                  f"trace_and_verify x{nc}:\n{rec.format()}\n{prof.format()}\nthe "
                  f"profile's loops: {graph_from_profile(path).loops}")
            with C.use_runtime_plan(plan), profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                program()
                torch.cuda.synchronize()
            p.export_chrome_trace(path)
            for r in nccl_overlap(path):
                say(f"analysis: {r['op']} x{nc} at {r['site']} on the 1-rank NCCL group: "
                    f"{r['collectives']} collectives, {r['device_events']} NCCL device "
                    f"events, {r['nccl_ms']:.4f} ms, {r['under_compute_ms']:.4f} ms of it "
                    f"under another kernel ({card})")
                rows.append(dict(r, num_chunks=nc))
            say(f"analysis: x{nc}: record MATERIALIZED at {sorted(sites)}, profile "
                f"MATERIALIZED at {sorted(on_card)}; the psum's in-place all-reduce runs "
                "nothing on one rank (its profile verdict, "
                f"{got.get('acc.step0.rs_grads')}, is not judged), and the ring's site is "
                "not judged: it issues no hop on one rank")
    del h, wd, tree
    free()
    return rows


_PROFILED = """
import json, sys, tempfile
import torch.distributed as dist
import chip_smoke as C
with tempfile.TemporaryDirectory() as tmp:
    mesh = C.nccl_mesh(tmp)
    try:
        rows = C.profiled_helpers(sys.argv[1], mesh)
    finally:
        dist.destroy_process_group()
print(json.dumps(rows))
"""


def profiled_helpers_fresh(card: str) -> list:
    """``profiled_helpers`` in a process of its own, on a 1-rank NCCL group of
    its own: in this process, after phases 3 to 13's profiles, torch 2.11's
    profiler returned a trace with the kernels' launches and none of their
    device activity (``analysis.ir`` refuses such a trace)."""
    env = dict(_src_env(), PYTHONPATH=os.pathsep.join((os.path.join(ROOT, "src"), ROOT)))
    run = subprocess.run([sys.executable, "-c", _PROFILED, card], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    for line in run.stdout.strip().splitlines()[:-1]:
        print(line, flush=True)
    check(run.returncode == 0, f"profiled helpers: exit {run.returncode}\n"
          f"{run.stdout[-2000:]}{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def analysis_phase(card: str, dry_started, dry_dir: str) -> dict:
    """Phase 14: the overlap verifier (CLI, control, profiled helpers) and the
    dry run (started by ``dryrun_start``)."""
    return {"verify_overlap": verify_overlap_cli(card), "profiled": profiled_helpers_fresh(card),
            "dryrun": dryrun(card, dry_started, dry_dir)}


# ---------------------------------------------------------------------------
# phase 15: the other families (whisper-small, deepseek-v2-lite-16b's MLA,
# qwen2-vl-72b's M-RoPE) served on one card at full width
# ---------------------------------------------------------------------------

AUDIO_ARCH, MLA_ARCH, VLM_ARCH = "whisper-small", "deepseek-v2-lite-16b", "qwen2-vl-72b"
OTHER_ARCHS = (AUDIO_ARCH, MLA_ARCH, VLM_ARCH)
# qwen2-vl-72b takes 3.5 GB a layer and 10.0 GB of embeddings in fp32: 8 of its
# 80 layers (38.1 GB); deepseek-v2-lite-16b's 27 layers are 62.8 GB, whole
OTHER_LAYERS = {VLM_ARCH: 8}
OTHER_PARITY_LAYERS = 2
PATCH_TEXT = 256                    # the patch forward: 256 patches, then 256 tokens
# flash at the shapes the three give it: (name, B, Sq, Sk, Hq, Hkv, h, causal);
# whisper's frames are 1500 and its prompts at most PROMPT_LENS[1]
OTHER_FLASH = (
    ("flash_attention (whisper encoder, h = 64, full)", BATCH, 1500, 1500, 12, 12, 64, False),
    ("flash_attention (whisper decoder prefill, h = 64)", BATCH, PROMPT_LENS[1],
     PROMPT_LENS[1], 12, 12, 64, True),
    ("flash_attention (whisper cross-attention, h = 64, full)", BATCH, PROMPT_LENS[1], 1500,
     12, 12, 64, False),
    ("flash_attention (whisper decode cross-attention, h = 64, full)", BATCH, 1, 1500, 12,
     12, 64, False),
    ("flash_attention (qwen2-vl-72b prefill, GQA 8)", BATCH, PROMPT_LENS[1], PROMPT_LENS[1],
     64, 8, 128, True),
)
# RMSNorm at (rows, D): a prefill's rows, checked at a decode step's too
OTHER_RMSNORM = ((BATCH * PROMPT_LENS[1], 512, "deepseek-v2-lite-16b kv_a_norm, D = 512"),
                 (BATCH * PROMPT_LENS[1], 8192, "qwen2-vl-72b, D = 8192"))
MLA_RANGES = ("mla.kv_b", "mla.scores")     # models.layers' ranges around MLA's attention


def other_flash_phase(gen, name, B, Sq, Sk, Hq, Hkv, h, causal) -> dict:
    """The flash kernel at one of the other families' shapes, fp32, held
    against its plain version on the same inputs, timed beside it (a
    decode step's single query by its device time from the profiler, the
    call's host time beside it), beside SDPA's efficient backend and its
    bound (the pairs inside the mask at the 3xTF32 rate, or the bytes)."""
    q = randn((B, Sq, Hq, h), torch.float32, gen)
    k = randn((B, Sk, Hkv, h), torch.float32, gen)
    v = randn((B, Sk, Hkv, h), torch.float32, gen)
    o = ops.flash_attention(q, k, v, causal=causal, backend="cuda")
    torch.cuda.synchronize()
    o_ref = ref.flash_attention_ref(q, k, v, causal=causal)
    err = (o - o_ref).abs().max().item()
    check(o.shape == q.shape and bool(torch.isfinite(o).all()), f"{name}: bad output")
    check(err <= FLASH_BOUND, f"{name}: max abs err {err} > {FLASH_BOUND}")
    call = lambda: ops.flash_attention(q, k, v, causal=causal, backend="cuda")  # noqa: E731
    a_call = time_ms(call)
    ms = kernel_ms(call, "flash_fwd_kernel") if Sq == 1 else a_call
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal), samples=5,
                    per_sample=2)
    G = Hq // Hkv
    qt, kt, vt = (x.transpose(1, 2) for x in
                  (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    err_lib = (sdpa_efficient(qt, kt, vt, causal).transpose(1, 2) - o_ref).abs().max().item()
    lib = time_ms(lambda: sdpa_efficient(qt, kt, vt, causal))
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    flops = _work.flash_flops(B, Sq, Sk, Hq, h, causal=causal)
    b_ms, b_by = bound_ms(nbytes, flops, FP32_AS_3XTF32)
    say(f"{name}: B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} h={h} causal={causal} fp32: max abs "
        f"err {err:.3e} (bound {FLASH_BOUND}); {ms:.4f} ms"
        + (f" on the card ({a_call:.4f} ms a call)" if Sq == 1 else "")
        + f"; plain {plain:.4f} ms; sdpa[{SDPA_BACKEND}] {lib:.4f} ms (its err vs plain "
        f"{err_lib:.1e}); bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} of it reached)")
    del q, k, v, o, o_ref, qt, kt, vt
    free()
    return {"name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash.cu",
            "replaces": "src/repro/kernels/flash.py:65", "shape": [B, Sq, Sk, Hq, Hkv, h],
            "causal": causal, "dtype": "float32", "max_abs_err": err, "bound": FLASH_BOUND,
            "ms": ms, "ms_a_call": a_call, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib, "library_backend": SDPA_BACKEND,
            "library_max_abs_err": err_lib}


def rmsnorm_fwd_at(gen, rows: int, D: int, tag: str) -> dict:
    """The RMSNorm kernel at (rows, D) fp32 and at a decode step's (BATCH,
    D), each within 1e-5 of its plain version, timed at (rows, D) beside
    the plain version, ``F.rms_norm`` and its bound (``rmsnorm_fwd_times``)."""
    scale = torch.linspace(0.5, 1.5, D, device="cuda")
    cases = []
    for r in (rows, BATCH):
        x = randn((r, D), torch.float32, gen)
        err = (ops.rmsnorm(x, scale, backend="cuda") - ref.rmsnorm_ref(x, scale)
               ).abs().max().item()
        check(err <= RMS_BOUND_F32, f"rmsnorm ({r}, {D}): max abs err {err} > {RMS_BOUND_F32}")
        cases.append({"shape": [r, D], "max_abs_err": err, "bound": RMS_BOUND_F32})
    del x
    t = rmsnorm_fwd_times(gen, rows, D)
    err = max(c["max_abs_err"] for c in cases)
    say_rmsnorm_fwd(f"rmsnorm ({rows}, {D}) fp32 ({tag}; with ({BATCH}, {D}))", err, t)
    return {"name": f"rmsnorm ({tag})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:25", "shape": [rows, D],
            "dtype": "float32", "max_abs_err": err, "bound": RMS_BOUND_F32, **t,
            "cases": cases}


def other_config(arch: str):
    cfg = get_config(arch)
    return cfg.replace(num_layers=OTHER_LAYERS[arch]) if arch in OTHER_LAYERS else cfg


def other_frames(cfg):
    """whisper's stub frames from the seed, as the reference's launcher draws
    them (N(0, 0.02²)); None for the other families."""
    if cfg.family != "audio":
        return None
    rs = np.random.default_rng(SEED)
    return (rs.standard_normal((BATCH, cfg.encoder_seq, cfg.d_model)) * 0.02
            ).astype(np.float32)


def patches_forward(cfg, model) -> dict:
    """One forward of the vlm model with 256 image patches at the head of
    512 positions (the reference's M-RoPE grid) through the kernels and
    through ``backend="ref"`` on the same weights: finite hidden states
    within 1e-3, the kernels' launches equal to the code's."""
    rs = np.random.default_rng(SEED + 15)
    S = M.N_PATCHES + PATCH_TEXT
    batch = {"tokens": torch.as_tensor(rs.integers(0, cfg.vocab_size, (1, S)), device="cuda"),
             "patches": torch.as_tensor((rs.standard_normal((1, M.N_PATCHES, cfg.d_model))
                                         * 0.02).astype(np.float32), device="cuda")}
    with torch.inference_mode():
        ops.reset_launches()
        t0 = time.perf_counter()
        x = M.forward_hidden(cfg, model, batch)[0]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.LAUNCHES)
        by_shape = dict(ops.LAUNCHES_BY_SHAPE)
        xr = M.forward_hidden(cfg, model, batch, backend="ref")[0]
    err = (x - xr).abs().max().item()
    L = cfg.num_layers
    want = dict(NO_LAUNCHES, rmsnorm=2 * L + 1, flash_attention=L)
    say(f"{cfg.name} with {M.N_PATCHES} patches + {PATCH_TEXT} tokens ({L} layers, full "
        f"width): forward {ms:.1f} ms; hidden states max abs err vs backend='ref' {err:.3e} "
        f"(bound {SLICE_LOGITS_BOUND}); launches {launches}")
    check(x.shape == (1, S, cfg.d_model) and bool(torch.isfinite(x).all()),
          "patch forward: bad output")
    check(err <= SLICE_LOGITS_BOUND, f"patch forward: err {err} > {SLICE_LOGITS_BOUND}")
    check(launches == want, f"patch forward: launches {launches}, expected {want}")
    del x, xr
    free()
    return {"seq": S, "patches": M.N_PATCHES, "layers": L, "ms": ms, "max_abs_err": err,
            "launches": launches, "launches_by_shape": by_shape}


def other_slice_parity(cfg, prompts, frames) -> dict:
    """A 2-layer model (whisper: 2 encoder layers too) at full width through
    the kernels and through ``backend="ref"``: the plain run replays the
    kernels' MoE routing (``layers.record_routing``), its greedy tokens
    must equal the kernels', and the teacher-forced logits agree within
    1e-3."""
    from repro_torch.models import layers as L

    cut = dict(num_layers=OTHER_PARITY_LAYERS)
    if cfg.family == "audio":
        cut["encoder_layers"] = OTHER_PARITY_LAYERS
    cfg2 = cfg.replace(**cut)
    model = M.init_params(cfg2, SEED + 1, device="cuda")
    kern = make_engine(cfg2, model, batch_size=BATCH, max_seq=MAX_SEQ)
    plain = make_engine(cfg2, model, batch_size=BATCH, max_seq=MAX_SEQ, backend="ref")
    with L.record_routing() as routed:
        outs_k = kern.generate(prompts, max_new=MAX_NEW, frames=frames)
    ops.reset_launches()
    with L.record_routing(replay=routed):
        outs_r = plain.generate(prompts, max_new=MAX_NEW, frames=frames)
    check(ops.LAUNCHES == NO_LAUNCHES, "other slice parity: backend='ref' launched a kernel")
    check_outputs(outs_k, cfg.vocab_size, "other slice parity")
    with L.record_routing() as routed:
        lk = kern.teacher_forced_logits(prompts, outs_k, frames=frames)
    with L.record_routing(replay=routed):
        lr = plain.teacher_forced_logits(prompts, outs_k, frames=frames)
    err = (lk - lr).abs().max().item()
    same = outs_k == outs_r
    say(f"slice parity {cfg.name} ({OTHER_PARITY_LAYERS} layers, full width): teacher-forced "
        f"logits max abs err {err:.3e} (bound {SLICE_LOGITS_BOUND}); greedy tokens equal: "
        f"{same}")
    check(bool(torch.isfinite(lk).all()), "other slice parity: non-finite logits")
    check(err <= SLICE_LOGITS_BOUND, f"other slice parity {cfg.name}: logits err {err}")
    check(same, f"other slice parity {cfg.name}: greedy tokens differ from backend='ref'")
    del kern, plain, model, lk, lr, routed
    free()
    return {"arch": cfg.name, "layers": OTHER_PARITY_LAYERS, "max_abs_err": err,
            "tokens_equal": same}


def launch_class(name, B, Sq, Sk, Hq, Hkv, h, causal, kernel="flash_attention") -> str:
    """The shape class (``ops.shape_class``) of a flash entry of phase 15
    (or, with ``kernel`` the backward's, of phase 16)."""
    q, k = (torch.empty((B, n, H, h), device="meta") for n, H in ((Sq, Hq), (Sk, Hkv)))
    return ops.shape_class(kernel, q, k, causal)


def other_families_phase(card: str) -> dict:
    """Phase 15 (module docstring).  Returns the kernels' entries, the
    served records, the patch forward and slice parity.  Each entry's
    launches are those of its shape class (``ops.LAUNCHES_BY_SHAPE``) in
    each served run; the served models' RMSNorm launches at a D that no
    entry here names (deepseek-v2-lite-16b's ln1, ln2 and ln_f at 2048)
    count in the base RMSNorm entry (``base_rmsnorm``).  A launch of a
    flash class that no entry names fails the phase."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    flash = [other_flash_phase(gen, *v) for v in OTHER_FLASH]
    norms = [rmsnorm_fwd_at(gen, *r) for r in OTHER_RMSNORM]
    entry_of = {launch_class(*v): e for v, e in zip(OTHER_FLASH, flash)}
    entry_of.update({f"rmsnorm D={D}": e for (_, D, _), e in zip(OTHER_RMSNORM, norms)})
    for key, e in entry_of.items():      # phase 16 adds its training launches by class
        e["shape_class"] = key
    runs, served, patched = [], [], None
    for arch in OTHER_ARCHS:
        cfg = other_config(arch)
        prompts, frames = make_prompts(cfg), other_frames(cfg)
        model, init_s = init_model(cfg)
        served.append(serving_phase(cfg, model, init_s, prompts, frames=frames,
                                    ranges=MLA_RANGES if cfg.attn_kind == "mla" else ()))
        served[-1]["layers"] = cfg.num_layers
        runs.append((arch, served[-1]))
        if cfg.family == "vlm":
            patched = patches_forward(cfg, model)
            runs.append((f"{arch} with patches", patched))
        del model
        free()
    parity = [other_slice_parity(get_config(arch), make_prompts(get_config(arch)),
                                 other_frames(get_config(arch))) for arch in OTHER_ARCHS]
    base_rmsnorm = {}
    for label, run in runs:
        for kernel, n in run["launches"].items():
            check(sum(c for key, c in run["launches_by_shape"].items()
                      if key.split(" ")[0] == kernel) == n,
                  f"{label}: {kernel}'s launches by shape do not sum to its count {n}")
        for key, n in run["launches_by_shape"].items():
            if key in entry_of:
                entry_of[key].setdefault("launches_by_model", {})[label] = n
            else:
                check(key.startswith("rmsnorm "), f"{label}: {n} launches of {key}, which no "
                      "phase 15 entry names")
                base_rmsnorm[f"{label} ({key})"] = n
    kernels = flash + norms
    for k in kernels:
        k.setdefault("launches_by_model", {})
        k["launches"] = sum(k["launches_by_model"].values())
        check(k["launches"] > 0, f"{k['name']}: no launch on the main paths")
    return {"kernels": kernels, "base_rmsnorm": base_rmsnorm, "served": served,
            "patches": patched, "slice_parity": parity, "card": card}


# ---------------------------------------------------------------------------
# phase 16: the other families trained on one card at full width
# ---------------------------------------------------------------------------

# (arch, layers or None for all, B, S).  whisper-small whole (12 + 12 layers,
# 264.6 M params: 3.9 GiB of fp32 AdamW state) over its published text
# context of 448 and 1500 stub frames; deepseek-v2-lite-16b at 4 of its 27
# layers (1 dense + 3 MoE: 33.6 GiB of state; 6 layers would be 51.0 GiB,
# and olmoe-1b-7b's MoE transients ran 11 GiB past their prediction);
# qwen2-vl-72b at 2 of its 80 layers (63.3 GiB of state, 39.9 of it the
# embedding and the head), with 256 patches at the head of each row
OTHER_TRAIN = ((AUDIO_ARCH, None, 8, 448), (MLA_ARCH, 4, 4, 2048), (VLM_ARCH, 2, 2, 1024))
OTHER_TRAIN_PROFILE = (AUDIO_ARCH, VLM_ARCH)
# the flash backward at the shapes those runs give it:
# (name, B, Sq, Sk, Hq, Hkv, h, causal)
OTHER_FLASH_BWD = (
    ("flash_attention_bwd (whisper-small encoder, h = 64, full)", 8, 1500, 1500, 12, 12, 64,
     False),
    ("flash_attention_bwd (whisper-small decoder, h = 64, causal)", 8, 448, 448, 12, 12, 64,
     True),
    ("flash_attention_bwd (whisper-small cross, h = 64, 448 x 1500)", 8, 448, 1500, 12, 12,
     64, False),
    ("flash_attention_bwd (qwen2-vl-72b, 64/8 heads)", 2, 1024, 1024, 64, 8, 128, True),
)
# the RMSNorm backward at (rows, D): deepseek's latent and its ln1, ln2, ln_f
# at B 4 x S 2048, qwen2-vl's at B 2 x S 1024
OTHER_RMSNORM_BWD = ((8192, 512, "(deepseek-v2-lite-16b kv_a_norm, D = 512)"),
                     (8192, 2048, "(deepseek-v2-lite-16b, D = 2048)"),
                     (2048, 8192, "(qwen2-vl-72b, D = 8192)"))


# flash forward and backward at the heads a rank of a 1x4 placement runs
# (tools/four_rank_check.py's families section): whisper-small's 12/12 heads
# are 3/3 a rank, qwen2-vl-72b's 64/8 are 16/2 (a dK/dV grid of B·Hkv·S/128 =
# 32 blocks on 132 SMs); (tag, B, Sq, Sk, Hq, Hkv, h, causal)
OTHER_RANK_FLASH = (
    ("whisper-small encoder, 1x4 rank, 3/3 heads, h = 64, full", 8, 1500, 1500, 3, 3, 64,
     False),
    ("whisper-small decoder, 1x4 rank, 3/3 heads, h = 64, causal", 8, 448, 448, 3, 3, 64, True),
    ("whisper-small cross, 1x4 rank, 3/3 heads, h = 64, 448 x 1500", 8, 448, 1500, 3, 3, 64,
     False),
    ("qwen2-vl-72b, 1x4 rank, 16/2 heads, h = 128, causal", 2, 1024, 1024, 16, 2, 128, True),
)
# whisper and deepseek placed on the 1-rank group (every leaf whole) against
# their unplaced steps: (arch, layers; whisper's encoder too).  qwen2-vl-72b's
# 1-layer step (its 152064 x 8192 embedding and head, near 60 GiB twice)
# would check no code that these two do not
OTHER_PLACED = ((AUDIO_ARCH, 2), (MLA_ARCH, 2))


def other_rank_flash_phase(gen) -> list:
    """Phase 16's entries at a 1x4 rank's heads (OTHER_RANK_FLASH), the
    forward (``other_flash_phase``) and the backward
    (``flash_bwd_variant_phase``), each held to its plain version and timed
    beside it, SDPA and its bound; each carries its shape class."""
    out = []
    for tag, B, Sq, Sk, Hq, Hkv, h, causal in OTHER_RANK_FLASH:
        fwd = other_flash_phase(gen, f"flash_attention ({tag})", B, Sq, Sk, Hq, Hkv, h, causal)
        fwd["shape_class"] = launch_class(tag, B, Sq, Sk, Hq, Hkv, h, causal)
        bwd = flash_bwd_variant_phase(gen, f"flash_attention_bwd ({tag})", B, Sq, Hq, Hkv, h,
                                      0, False, causal=causal, Sk=Sk)
        bwd["shape_class"] = launch_class(tag, B, Sq, Sk, Hq, Hkv, h, causal,
                                          kernel="flash_attention_bwd")
        out += [fwd, bwd]
    return out


def other_placed_phase(card: str) -> dict:
    """Each of OTHER_PLACED (B 1 x S 512, whisper with its frames) placed by
    ``models.model.init_placed`` on the 1-rank NCCL group's (data, model)
    mesh, one train step against its unplaced step from the same weights
    on the same batch (the MoE routing replayed), within phase 8's parity
    bounds, with the same launches; the placement issues no collective of
    its own (no attention, vocabulary or shared-expert row)."""
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    meshes = make_mesh((1, 1), ("data", "model"))
    P = PARITY_TRAIN
    runs = []
    for arch, layers in OTHER_PLACED:
        t1 = time.perf_counter()
        cut = dict(num_layers=layers)
        if arch == AUDIO_ARCH:
            cut["encoder_layers"] = layers
        cfg = get_config(arch).replace(**cut)
        batch = parity_batch(cfg)
        with L.record_routing() as routed:
            first = parity_step(cfg, batch)
        first.update({k: {n: a.cpu() for n, a in first[k].items()} for k in ("params", "mu")})
        free()
        with L.record_routing(routed):
            placed = parity_step(cfg, batch, placed=meshes)
        sites = placement_sites(placed["issued"])
        tag = f"placed {cfg.name} ({layers} layers, 1-rank group, B={P['B']}, S={P['S']})"
        check(not sites, f"{tag}: the placement issued {sites} on a model axis of 1")
        check(placed["launches"] == first["launches"],
              f"{tag}: launches {placed['launches']}, unplaced {first['launches']}")
        held = parity_held(tag, "placed", first, placed, card,
                           f"; issued {issued_summary(placed['issued'])}")
        runs.append({"arch": cfg.name, "layers": layers, "loss": placed["loss"],
                     "grad_norm": placed["grad_norm"], "launches": placed["launches"],
                     "unplaced": held, "issued": issued_summary(placed["issued"]),
                     "seconds": time.perf_counter() - t1})
        del first, placed
        free()
        say(f"{tag}: {runs[-1]['seconds']:.1f} s")
    seconds = time.perf_counter() - t0
    say(f"phase 16's placed steps took {seconds:.1f} s")
    return {"runs": runs, "seconds": seconds, "card": card}


def other_families_train_phase(card: str, other: dict) -> dict:
    """Phase 16 (module docstring).  Returns the backward kernels' entries,
    the trained records and the parity steps.  Each new entry's launches
    are those of its shape class (``ops.LAUNCHES_BY_SHAPE``) in the trained
    runs; their forward launches go to phase 15's entries of their class
    in ``other`` (RMSNorm at a D that none names, deepseek's 2048, to its
    ``base_rmsnorm``).  A launch of a class that no entry names fails the
    phase."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    flash = [flash_bwd_variant_phase(gen, name, B, Sq, Hq, Hkv, h, 0, False, causal=causal,
                                     Sk=Sk)
             for name, B, Sq, Sk, Hq, Hkv, h, causal in OTHER_FLASH_BWD]
    norms = [rmsnorm_bwd_at(gen, *r) for r in OTHER_RMSNORM_BWD]
    entry_of = {launch_class(*v, kernel="flash_attention_bwd"): e
                for v, e in zip(OTHER_FLASH_BWD, flash)}
    entry_of.update({f"rmsnorm_bwd D={D}": e for (_, D, _), e in zip(OTHER_RMSNORM_BWD, norms)})
    entry_of.update({e["shape_class"]: e for e in other["kernels"]})
    trained = [family_train_phase(card, *t, profile=t[0] in OTHER_TRAIN_PROFILE)
               for t in OTHER_TRAIN]
    for t in trained:
        label = f"{t['arch']} train"
        for key, n in t["launches_by_shape"].items():
            if key in entry_of:
                e = entry_of[key]
                e.setdefault("launches_by_model", {})[label] = n
                e["launches"] = sum(e["launches_by_model"].values())
            else:
                check(key.startswith("rmsnorm "), f"{label}: {n} launches of {key}, which no "
                      "phase 15 or 16 entry names")
                other["base_rmsnorm"][f"{label} ({key})"] = n
    parity = [family_train_parity(card, get_config(arch)) for arch in OTHER_ARCHS]
    kernels = flash + norms
    for k in kernels:
        check(k.get("launches", 0) > 0, f"{k['name']}: no launch on the main paths")
    rank_kernels = other_rank_flash_phase(gen)
    for k in rank_kernels:
        k["launches_by_model"] = {
            f"{t['arch']} train (whole heads, the same instantiation)":
            t["launches_by_shape"][k["shape_class"]] for t in trained
            if t["launches_by_shape"].get(k["shape_class"], 0)}
        k["launches"] = sum(k["launches_by_model"].values())
        check(k["launches"] > 0, f"{k['name']}: no launch on the main paths")
    seconds = time.perf_counter() - t0
    say(f"phase 16 (the other families' training) took {seconds:.1f} s")
    return {"kernels": kernels, "rank_kernels": rank_kernels, "trained": trained,
            "parity": parity, "seconds": seconds, "card": card}


# ---------------------------------------------------------------------------
# phase 17: the recurrent-training slice (zamba2-7b trained on one card)
# ---------------------------------------------------------------------------

RECURRENT_ARCH = "zamba2-7b"
# full width (d 3584, 112 SSD heads, P = N = 64, the shared block's 32 heads
# of h = 112, d_ff 14336) cut to 13 layers: two groups of six, each with a
# shared-block application, and one tail layer (1.49 B parameters, 22.3 GiB
# of fp32 AdamW state); B 4 x S 2048 as phase 8
RECURRENT_TRAIN = (RECURRENT_ARCH, 13, TRAIN_B, TRAIN_S)
RECURRENT_PARITY_LAYERS = 7     # one group of six, the shared block, one tail layer
# the SSD backward against fp64, of each gradient's max|g|: its products are
# fp32 on the CUDA cores, its exponents and dcum's cancelling sums fp64 (the
# plain backward in fp32 errs by 3e-8 to 4e-7 at 112 heads)
SSD_GRAD_BOUND = 1e-5
SSD_BWD_CASES = ((1, 500, False), (2, 300, True))   # B, S, with states, through SSDFn
SSD_GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dstate0")


def ssd_bwd_build_report(entries=None) -> dict:
    """What ptxas reports for ``ssd_bwd.cu``: the backward kernel at its two
    (P, N), zamba2-7b's (64, 64) and its smoke config's (128, 16), and the
    group sum, beside the blocks per SM that shared memory and registers
    allow; fails on a spill."""
    lib = _build.library()
    report = {}
    for entry in entries if entries is not None else ptxas_report("ssd_bwd.cu"):
        name = entry["kernel"]
        m = re.search(r"ssd_bwd_kernelILi(\d+)ELi(\d+)EE", name)
        if m:
            key = f"<fp32, {m.group(1)}, {m.group(2)}>"
            smem = lib.rt_ssd_bwd_smem_bytes(int(m.group(1)), int(m.group(2)))
            check(smem > 0, f"ssd backward: no shared memory size for {key}")
        elif "ssd_bwd_group_sum" in name:
            key, smem = "group_sum", 0
        else:
            continue
        regs = -(-entry["registers"] // 8) * 8     # allocated in units of 8 a thread
        blocks = min(SM_SMEM // (smem + SM_SMEM_PER_BLOCK), SM_REGS // (regs * 256),
                     SM_THREADS // 256)
        report[key] = dict({k: v for k, v in entry.items() if k != "kernel"},
                           smem_dynamic=smem, blocks_per_sm=blocks)
        say(f"ptxas ssd backward {key}: {entry['registers']} registers, "
            f"{entry['spill_stores']} B spill stores, {entry['spill_loads']} B spill loads, "
            f"{entry['stack']} B stack; {smem} B of shared memory and 256 threads a block, "
            f"so {blocks} block(s) per SM")
        check(entry["spill_stores"] == 0 and entry["spill_loads"] == 0,
              f"ssd backward {key} spills")
    check(sorted(report) == ["<fp32, 128, 16>", "<fp32, 64, 64>", "group_sum"],
          f"ptxas reported the ssd backward kernels {sorted(report)}")
    return report


def ssd_views(buf):
    """x (B,S,H,P), B and C (B,S,1,N) as views of one conv buffer
    (B, S, H·P + 2·N) at zamba2-7b's heads, as the Mamba2 block holds them."""
    _, H, P, N = SSD_SHAPE
    x, Bm, Cm = torch.split(buf, [H * P, N, N], dim=-1)
    return x.unflatten(-1, (H, P)), Bm.unflatten(-1, (1, N)), Cm.unflatten(-1, (1, N))


def ssd_bwd_inputs(gen, B: int, S: int, with_states: bool):
    """zamba2-7b's scan inputs for one layer at B x S: the conv buffer of
    ``ssd_views``, dt after softplus, zamba2-7b's initial A = −linspace(1,
    16, H) (``mamba2.Block.init_weights``: cum reaches about −700 in a
    chunk), D = 1 + 0.5·randn, and the output gradient dy; with
    ``with_states`` also an initial state and the final state's gradient
    (else None)."""
    _, H, P, N = SSD_SHAPE
    buf = randn((B, S, H * P + 2 * N), torch.float32, gen)
    dt = torch.nn.functional.softplus(randn((B, S, H), torch.float32, gen))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    D = 1.0 + 0.5 * randn((H,), torch.float32, gen)
    dy = randn((B, S, H, P), torch.float32, gen)
    if not with_states:
        return buf, (dt, A, D), None, dy, None
    return (buf, (dt, A, D), randn((B, H, P, N), torch.float32, gen), dy,
            randn((B, H, P, N), torch.float32, gen))


def ssd_fp64_oracles(args, s0, dy, dse) -> tuple:
    """The SSD's gradients (dx, ddt, dA, dB, dC, dD, dstate0) in fp64 two
    ways: autograd of the step oracle ``ref.ssd_ref``, one batch element at
    a time (its saved states at B = 4, S = 2048 would take 30 GB at once;
    dA and dD are summed over the elements), with a zero initial state
    where none is given; and the plain backward ``ref.ssd_chunked_bwd_ref``."""
    B, _, H, P = dy.shape
    parts = []
    for b in range(B):
        leaves = [a.detach().double().requires_grad_() if a.dim() == 1
                  else a[b:b + 1].detach().double().requires_grad_() for a in args]
        s = (torch.zeros((1, H, P, args[3].shape[-1]), dtype=torch.float64, device=dy.device)
             if s0 is None else s0[b:b + 1].double()).requires_grad_()
        y, st = ops.ssd(*leaves, s, backend="ref")
        loss = (y * dy[b:b + 1].double()).sum()
        if dse is not None:
            loss = loss + (st * dse[b:b + 1].double()).sum()
        parts.append(torch.autograd.grad(loss, leaves + [s]))
        del leaves, s, y, st, loss
    auto = tuple(sum(p[i] for p in parts) if i in (2, 5) else torch.cat([p[i] for p in parts])
                 for i in range(7))
    del parts
    plain = ref.ssd_chunked_bwd_ref(*(a.double() for a in args),
                                    None if s0 is None else s0.double(), dy.double(),
                                    None if dse is None else dse.double())
    return auto, plain


def ssd_grads_held(what: str, got, args, s0, dy, dse) -> dict:
    """``got`` (the kernel's gradients; without dstate0 where there is no
    initial state) held within SSD_GRAD_BOUND of each gradient's max|g| to
    both fp64 oracles (``ssd_fp64_oracles``); printed, failing the run
    past the bound."""
    auto, plain = ssd_fp64_oracles(args, s0, dy, dse)
    errs = {}
    for name, g, w1, w2 in zip(SSD_GRAD_NAMES, got, auto, plain):
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
        rel = []
        for w in (w1, w2):
            err, top = (g.double() - w).abs().max().item(), w.abs().max().item()
            check(err <= SSD_GRAD_BOUND * top, f"{what}: {name} err {err} > {SSD_GRAD_BOUND} "
                                               f"x max|g| {top}")
            rel.append(err / top if top else 0.0)
        errs[name] = {"max_abs_err": (g.double() - w1).abs().max().item(),
                      "err_of_max_g_autograd": rel[0], "err_of_max_g_plain": rel[1]}
    say(f"{what} fp32, against fp64 autograd of the step oracle / the plain backward in "
        f"fp64, of each max|g| (bound {SSD_GRAD_BOUND}): "
        + ", ".join(f"{n} {e['err_of_max_g_autograd']:.2e} / {e['err_of_max_g_plain']:.2e}"
                    for n, e in errs.items()))
    del auto, plain
    free()
    return errs


def ssd_bwd_phase(gen, ptxas: dict) -> dict:
    """The SSD backward kernel at zamba2-7b's training shape for one layer:
    the call it times held to both fp64 oracles, then timed (device time
    by kernel from the profiler; a call by CUDA events) beside the plain
    version's backward (autograd of the chunked scan, fp32) and its bound;
    at S 500 and with both state gradients through ``ops.ssd`` under grad
    (``SSDFn``: one forward and one backward launch each), held to both."""
    from repro_torch.kernels.ssd import ssd_bwd_cuda, ssd_cuda

    B, S = TRAIN_B, TRAIN_S
    _, H, P, N = SSD_SHAPE
    buf, (dt, A, D), _, dy, _ = ssd_bwd_inputs(gen, B, S, False)
    x, Bm, Cm = ssd_views(buf)
    args = [x, dt, A, Bm, Cm, D]
    _, _, states = ssd_cuda(*args, save_states=True)
    got = ssd_bwd_cuda(*args, states, dy)
    torch.cuda.synchronize()
    what = f"ssd backward B={B} S={S} H={H} P={P} N={N} G=1 (the timed call)"
    cases = [{"shape": [B, S, H, P, N], "groups": 1, "states": False, "timed": True,
              "errors": ssd_grads_held(what, got, args, None, dy, None)}]
    del got
    free()

    def call():
        return ssd_bwd_cuda(*args, states, dy)

    ms_a_call = time_ms(call, samples=10, per_sample=2)
    split = device_ms_split(call, ("ssd_bwd_kernel", "ssd_bwd_group_sum"), calls=5)
    ms = sum(split.values())
    plain = backward_ms(lambda *a: ops.ssd(*a, backend="chunked")[0], args, dy, samples=3,
                        per_sample=1)
    nbytes, flops = _work.ssd_bwd_bytes(B, S, H, P, N, 1), _work.ssd_bwd_flops(B, S, H, P, N)
    b_ms, b_by = bound_ms(nbytes, flops, FP32_AS_3XTF32)
    b_cores, by_cores = bound_ms(nbytes, flops, torch.float32)
    say(f"ssd backward B={B} S={S} H={H} P={P} N={N} G=1 fp32: {ms:.4f} ms on the card ("
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
        + f"; {ms_a_call:.4f} ms a call back to back); plain (autograd of the chunked scan) "
        f"{plain:.4f} ms; no single library call; bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP at fp32 as 3xTF32's "
        f"{PEAK_FLOPS[FP32_AS_3XTF32] / 1e12:.0f} TFLOP/s; {b_ms / ms:.1%} of it reached); on "
        f"the fp32 CUDA cores it runs on, {b_cores:.4f} ms ({by_cores}, "
        f"{b_cores / ms:.1%} of it reached)")
    del args, buf, x, Bm, Cm, states, dy
    free()

    for Bc, Sc, with_states in SSD_BWD_CASES:
        buf, (dt, A, D), s0, dy, dse = ssd_bwd_inputs(gen, Bc, Sc, with_states)
        buf, dt, A, D = (t.requires_grad_() for t in (buf, dt, A, D))
        x, Bm, Cm = ssd_views(buf)                   # the views SSDFn takes, as in training
        s_leaf = None if s0 is None else s0.clone().requires_grad_()
        inputs = [x, dt, A, Bm, Cm, D]
        ops.reset_launches()
        y, st = ops.ssd(*inputs, s_leaf)
        loss = (y * dy).sum() + (0.0 if dse is None else (st * dse).sum())
        got = torch.autograd.grad(loss, inputs + ([s_leaf] if s_leaf is not None else []))
        torch.cuda.synchronize()
        check(ops.LAUNCHES == dict(NO_LAUNCHES, ssd=1, ssd_bwd=1),
              f"ssd backward S={Sc}: launches {ops.LAUNCHES}")
        what = f"ssd backward B={Bc} S={Sc} H={H} G=1 through SSDFn" + (
            ", with an initial state and the final state's gradient" if with_states else "")
        cases.append({"shape": [Bc, Sc, H, P, N], "groups": 1, "states": with_states,
                      "errors": ssd_grads_held(what, got, [a.detach() for a in inputs], s0,
                                               dy, dse)})
        del buf, dt, A, D, x, Bm, Cm, inputs, got, y, st, loss
        free()
    worst = max(e["err_of_max_g_autograd"] for c in cases for e in c["errors"].values())
    return {"name": "ssd_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
            "replaces": "src/repro/kernels/ssd.py:61", "shape": [B, S, H, P, N],
            "groups": 1, "dtype": "float32",
            "max_abs_err": max(e["max_abs_err"] for c in cases for e in c["errors"].values()),
            "err_of_max_g": worst, "bound": SSD_GRAD_BOUND, "bound_of": "each gradient's max|g|",
            "ms": ms, "ms_a_call": ms_a_call, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "bound_ms_cuda_cores": b_cores, "library_ms": None,
            "device_ms_by_kernel": split,
            "ptxas": ptxas, "cases": cases}


def recurrent_train_phase(card: str, ssd_bwd_ptxas: dict) -> dict:
    """Phase 17: the SSD backward kernel and the flash backward at
    zamba2-7b's training shapes; zamba2-7b trained at full width and 13
    layers (a profile of a fourth step by kernel class); one 7-layer step
    against ``backend="ref"``.  The two backward entries carry the trained
    run's launches."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    kernels = [ssd_bwd_phase(gen, ssd_bwd_ptxas),
               flash_bwd_variant_phase(gen, f"flash_attention_bwd ({RECURRENT_ARCH}, h = 112)",
                                       TRAIN_B, TRAIN_S, 32, 32, 112, 0, False)]
    trained = family_train_phase(card, *RECURRENT_TRAIN, profile=True)
    parity = family_train_parity(card, get_config(RECURRENT_ARCH), RECURRENT_PARITY_LAYERS,
                                 grads_to_fp64=True)
    for k, kernel in zip(kernels, ("ssd_bwd", "flash_attention_bwd")):
        k["launches_by_model"] = {f"{RECURRENT_ARCH} train": trained["launches"][kernel]}
        k["launches"] = trained["launches"][kernel]
        check(k["launches"] > 0, f"{k['name']}: no launch on the main path")
    seconds = time.perf_counter() - t0
    say(f"phase 17 (the recurrent-training slice) took {seconds:.1f} s")
    return {"kernels": kernels, "trained": trained, "parity": parity, "seconds": seconds,
            "card": card}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, tf32 off")

    # what ptxas says of each source, its nvccs all started at once beside the
    # build's
    t0 = time.perf_counter()
    jobs = ptxas_start("flash.cu", "flash_bwd.cu", "rmsnorm.cu", "ssd.cu", "ssd_bwd.cu",
                       "wkv6.cu", "wkv6_step.cu")
    try:
        _build.library()
    finally:
        found = ptxas_collect(jobs)
    say(f"build: kernels compiled with nvcc for sm_90a in {_build.BUILD_SECONDS:.1f} s "
        f"({_build.BUILD_DIR}), beside the ptxas reports of seven sources, all done in "
        f"{time.perf_counter() - t0:.1f} s")
    # phase 14's dry run needs no card: it runs beside the phases from here on
    dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dry = dryrun_start(dry_dir)
    try:
        return run_phases(card, t_start, found, dry, dry_dir)
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].wait()
        shutil.rmtree(dry_dir, ignore_errors=True)


def run_phases(card: str, t_start: float, found: dict, dry, dry_dir: str) -> int:
    """Phases 3 to 16 and the result lines, after the build (``main``)."""
    flash_ptxas = flash_build_report(found["flash.cu"])
    flash_bwd_ptxas = flash_bwd_build_report(found["flash_bwd.cu"])
    rmsnorm_fwd_ptxas = rmsnorm_fwd_build_report(found["rmsnorm.cu"])
    rmsnorm_bwd_ptxas = rmsnorm_bwd_build_report(found["rmsnorm.cu"])
    ssd_ptxas = ssd_build_report(found["ssd.cu"])
    ssd_bwd_ptxas = ssd_bwd_build_report(found["ssd_bwd.cu"])
    wkv6_ptxas = wkv6_build_report(found["wkv6.cu"] + found["wkv6_step.cu"])

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [rmsnorm_phase(gen), flash_phase(gen), ssd_phase(gen), wkv6_phase(gen),
               rmsnorm_bwd_phase(gen), flash_bwd_phase(gen)]
    kernels[0]["ptxas"] = rmsnorm_fwd_ptxas
    kernels[1]["ptxas"] = flash_ptxas
    kernels[2]["ptxas"] = ssd_ptxas
    kernels[3]["ptxas"] = wkv6_ptxas
    kernels[4]["ptxas"] = rmsnorm_bwd_ptxas
    kernels[5]["ptxas"] = flash_bwd_ptxas
    # the heads a rank of llama3-8b's tensor-parallel 1x4 placement runs
    tp_kernels = tp_rank_flash_phase(gen)
    widths = rmsnorm_widths_phase(gen)
    say(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    # phase 15 before the others: its profiles in a process the profiler has
    # not run long in (late in one, torch 2.11's returned no device events)
    other = other_families_phase(card)
    say(f"phase 15 done at {time.perf_counter() - t_start:.1f} s")
    other_train = other_families_train_phase(card, other)
    say(f"phase 16 done at {time.perf_counter() - t_start:.1f} s")
    recurrent = recurrent_train_phase(card, ssd_bwd_ptxas)
    say(f"phase 17 done at {time.perf_counter() - t_start:.1f} s")

    import torch.distributed as dist

    served, plan_served = [], None
    with tempfile.TemporaryDirectory() as tmp:
        mesh = nccl_mesh(tmp)      # phases 7 and 8: a 1-rank NCCL group
        try:
            for arch in ARCHS:
                cfg = get_config(arch)
                prompts = make_prompts(cfg)
                model, init_s = init_model(cfg)
                served.append(serving_phase(cfg, model, init_s, prompts))
                if arch == PLAN_ARCH:      # phase 7 on phase 4's weights, before they go
                    plan_served = plan_serving_phase(cfg, model, prompts, card, mesh)
                del model
                free()
                slice_parity_phase(cfg, prompts)
            say(f"phases 4, 5 and 7 done at {time.perf_counter() - t_start:.1f} s")
            trained = train_phase(card, mesh)
            launched = launch_phase(card)
            say(f"phases 8 and 9 done at {time.perf_counter() - t_start:.1f} s")
            moe = moe_phase(card, mesh)
            say(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")
            families = families_phase(card, mesh)
            say(f"phase 11 done at {time.perf_counter() - t_start:.1f} s")
            families_train = families_train_phase(card)
            say(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")
            pipelined = pipeline_phase(card, mesh, rmsnorm_bwd_ptxas)
            say(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")
            other_train["placed"] = other_placed_phase(card)
            say(f"phase 16's placed steps done at {time.perf_counter() - t_start:.1f} s")
        finally:
            dist.destroy_process_group()
    analysis = analysis_phase(card, dry, dry_dir)
    say(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")

    say(json.dumps({"plan": plan_phase(card)}))
    say(json.dumps({"plan_serving": plan_served}))
    say(json.dumps({"train": trained}))
    say(json.dumps({"launch": launched}))
    say(json.dumps({"moe": moe}))
    say(json.dumps({"families": {k: v for k, v in families.items() if k != "kernels"}}))
    say(json.dumps({"families_train": {k: v for k, v in families_train.items()
                                       if k != "kernels"}}))
    say(json.dumps({"pipeline": {k: v for k, v in pipelined.items() if k != "kernels"}}))
    say(json.dumps({"analysis": analysis}))
    say(json.dumps({"other_families": {k: v for k, v in other.items() if k != "kernels"}}))
    say(json.dumps({"other_families_train": {k: v for k, v in other_train.items()
                                             if k not in ("kernels", "rank_kernels")}}))
    say(json.dumps({"recurrent_train": {k: v for k, v in recurrent.items() if k != "kernels"}}))

    for k in kernels:       # launches on the main paths, by path and in all
        k["launches_by_model"] = {s["arch"]: s["launches"][k["name"]] for s in served}
        k["launches_by_model"].update({f"{PLAN_ARCH} plan ({name})": run["launches"][k["name"]]
                                       for name, run in plan_served["plans"].items()})
        k["launches_by_model"].update({f"{PLAN_ARCH} train ({name})": run["launches"][k["name"]]
                                       for name, run in trained["modes"].items()})
        k["launches_by_model"][f"{PLAN_ARCH} launch.train (1x1)"] = \
            launched["launches"][k["name"]]
        k["launches_by_model"][MOE_ARCH] = moe["served"]["launches"][k["name"]]
        k["launches_by_model"].update(
            {f"{MOE_ARCH} plan ({name})": run["launches"][k["name"]]
             for name, run in moe["plan_serving"]["plans"].items()})
        # the flash entry counts its base instantiations; phase 11's own
        # instantiations count theirs in their entries
        k["launches_by_model"].update({s["arch"]: s["launches"][k["name"]]
                                       for s in families["served"]
                                       if k["name"] != "flash_attention"
                                       or s["flash_instance"] == "base"})
        fp = families["plan_serving"]
        if k["name"] != "flash_attention" or fp["flash_instance"] == "base":
            k["launches_by_model"][f"{FAMILY_PLAN_ARCH} plan (b)"] = \
                fp["launches"][k["name"]]
        # phase 12's training: the flash entries count the base instantiations
        k["launches_by_model"].update({f"{t['arch']} train": t["launches"][k["name"]]
                                       for t in families_train["trained"]
                                       if not k["name"].startswith("flash_attention")
                                       or t["flash_instance"] == "base"})
        # phase 15's and 16's RMSNorm launches at a D that none of their
        # entries names (deepseek-v2-lite-16b's ln1, ln2 and ln_f at 2048)
        if k["name"] == "rmsnorm":
            k["launches_by_model"].update(other["base_rmsnorm"])
        # phase 17's zamba2-7b training (its flash backward at h = 112 has an
        # entry of its own, below)
        if k["name"] in ("rmsnorm", "flash_attention", "ssd", "rmsnorm_bwd"):
            k["launches_by_model"][f"{RECURRENT_ARCH} train"] = \
                recurrent["trained"]["launches"][k["name"]]
        k["launches"] = sum(k["launches_by_model"].values())
        check(k["launches"] > 0, f"{k['name']}: no launch on the main paths")
    for k in families["kernels"]:      # phase 11's forward instantiations, trained in phase 12
        instance = "alibi" if k["alibi"] else "h80"
        k["launches_by_model"].update({f"{t['arch']} train": t["launches"]["flash_attention"]
                                       for t in families_train["trained"]
                                       if t["flash_instance"] == instance})
        k["launches"] = sum(k["launches_by_model"].values())
    # flash's new instantiations, forward (phase 11) and backward (phase 12),
    # with their launches by model
    kernels += families["kernels"] + families_train["kernels"]
    # phase 13's kernels at yi-34b's shapes, with the pipelined run's launches
    kernels += pipelined["kernels"]
    # a 1x4 rank's heads, with the launches of phase 9's placed step: the same
    # instantiations at the 1-rank group's 32/8 heads (8/2 heads run only on a
    # model axis of 4, in tools/four_rank_check.py)
    for k in tp_kernels:
        kernel = "flash_attention_bwd" if k["name"].startswith("flash_attention_bwd") \
            else "flash_attention"
        k["launches_by_model"] = {f"{PLAN_ARCH} placed step (phase 9, 1-rank group, "
                                  f"32/8 heads, the same instantiation)":
                                  launched["placed_launches"][kernel]}
        k["launches"] = launched["placed_launches"][kernel]
        check(k["launches"] > 0, f"{k['name']}: no launch on the main path")
    kernels += tp_kernels
    # the RMSNorm forward's other widths, with the launches of their shape
    # class in the served runs of phases 4, 10 and 11 (the base entry counts
    # these launches too)
    for k, (_, D, _) in zip(widths, RMSNORM_WIDTHS):
        k["launches_by_model"] = {
            s["arch"]: s["launches_by_shape"][f"rmsnorm D={D}"]
            for s in served + [moe["served"]] + families["served"]
            if s["launches_by_shape"].get(f"rmsnorm D={D}")}
        k["launches"] = sum(k["launches_by_model"].values())
        check(k["launches"] > 0, f"{k['name']}: no launch on the main paths")
    kernels += widths
    kernels += other["kernels"]          # phase 15's shapes, with their models' launches
    kernels += other_train["kernels"]    # phase 16's backward shapes, likewise
    kernels += other_train["rank_kernels"]   # a 1x4 rank's heads
    kernels += recurrent["kernels"]      # the SSD backward, flash's at h = 112
    say(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s ({card})")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
