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
    steps, beside the unsited trunk: the logits' max abs difference;
  * trains llama3-8b at full width cut to 4 layers (seed 0, fp32, remat,
    B = 4 x S = 2048 from the port's ``SyntheticCorpus``) with the model
    sharded in place over ``model`` (attention by heads, the MLP, the
    vocabulary of the embedding and the head): 3 steps each of plain and
    ``grad_accum=2`` at ``--mesh 1x4`` under ``TRAIN_PLAN`` (layers 0 and 1
    chunk both sites differently), and 3 plain steps at 2x2 (data x
    model).  The first step of each is held to the one-card unsited step
    of that mode from the same weights (each rank runs it on its own card
    first): the loss and every parameter this rank holds within 1e-5
    relative (AdamW with eps = 1e-3, as phase 8's parity step).  Each
    site's forward and backward ``Issued`` rows (the MLP's chunked ones and
    the placement's all-reduces) and the kernels' launches must equal the
    code's; each rank must hold 1/m of ``attn.q.weight``, ``embed.weight``
    and ``head.weight``, their sha256 differing between the model ranks;
    after the steps each parameter must be bit-equal (sha256 of its bytes)
    on the ranks that hold the same slice of it, a whole one (the norms) on
    every rank.  It prints step ms, tokens/s, peak memory and, of one more
    step under the profiler, device ms by class (NCCL, GEMM, other) beside
    its wall ms;
  * trains the same 4-layer model with FSDP placements
    (``models.model.shard_`` on a (data, model) mesh, every F dim split
    over ``data``): 3 plain steps at 4x1 (B = 4), 3 ``grad_accum=2`` steps
    at 4x1 (B = 8, so that each rank's two rows make its two microbatches)
    and 3 plain steps at 2x2 under ``TRAIN_PLAN``, under
    ``constraints.use_axes``.  Step 1 is held to the one-card step as
    above; each rank must hold exactly its slices, the leaves ranks hold
    alike must be bit-equal (sha256) after the steps, and the ``fsdp.*`` and
    ``tp.*`` ``Issued`` rows must be the code's.  The 4x1 plain model's
    parameters are then gathered leaf by leaf, written by rank 0 in the
    reference's checkpoint layout and restored into every rank's slices,
    exactly;
  * trains llama3-8b at its full 32 layers under 4x1 (B = 4 x S = 2048,
    fp32, remat, lr 3e-5, 3 steps): step 1's loss within 1e-5 relative of
    a one-card ``no_grad`` forward of the same weights on the same global
    batch (each rank on its card, before it keeps its slices), every
    parameter moved, peak memory under 80 GB; it prints step ms (median
    of steps 2-3), tokens/s, MFU on the fp32 peak, peak GiB and device ms
    by class of one more step under the profiler;
  * trains llama3-8b at all 32 layers placed tensor-parallel (``TP32``:
    1x4, and 2x2 with the F dims over ``data`` too; B = 4 x S = 2048, fp32,
    remat, lr 3e-5, 3 steps): step 1's loss within 1e-5 relative of a
    one-card ``no_grad`` forward of the same weights, every parameter
    moved, the split, the leaves held alike, the launches and the
    ``Issued`` rows the code's, peak memory under 80 GB; it prints the
    losses, step ms, tokens/s, MFU on the fp32 peak, peak GiB, the
    ``Issued`` rows a step by site and device ms by class of one more step;
  * trains olmoe-1b-7b at full width (fp32, remat, B = 4 x S = 2048, 3
    steps) with its experts, attention heads and vocabulary split over
    ``model`` (expert parallelism: the
    dispatch and combine all-to-alls at ``ep.layer{j}.moe.a2a_disp|comb``)
    under ``MOE_PLAN``, which chunks layer 0's dispatch by 2 and layer 1's
    by 4: at 4 layers under 1x4 and 2x2 (eps = 1e-3), step 1's parameters
    within 1e-5 relative of the one-card step (each rank on its card
    first); at all 16 layers under 1x4 and 2x2 (lr 3e-5), step 1's loss
    within 1e-5 relative of a one-card ``no_grad`` forward of the same
    weights, every parameter moved, peak memory under 80 GB.  Each step 1
    replays the one-card run's routing (``layers.record_routing``; a data
    rank its rows of it): a routing choice whose two experts' router
    probabilities differ by less than the runs' rounding would otherwise
    flip.  Then qwen2-moe-a2.7b (``QWEN``: attention biases, a gated shared
    expert over ``model``) at 4 layers under 1x4, B = 3, its step 1 held to
    the one-card step as olmoe's.  The dispatch and combine ``Issued`` rows
    and the placement's, the kernels' launches, the split and the leaves
    held alike (sha256) must be the code's; it prints step ms, tokens/s,
    peak GiB and device ms by class of one more step.
  * runs yi-34b through a pipeline of four stages, one a rank
    (``make_mesh((4,), ("stage",))``, ``models.model.pipeline_loss`` over
    ``parallel.pipeline.pipeline_apply``; random weights from seed 0 by
    ``model.init_stage``, each rank allocating its stage's layers with the
    embedding, final norm and head; fp32, remat, M = 4 microbatches of
    ``SyntheticCorpus`` batches at S = 2048): at full width and 4 layers, B
    = 4, a forward and backward unplanned, under a plan chunking ``p2p``
    by 4, and under the port's tune of yi-34b as ``pp:4:4`` on h100-sxm
    (lowered and installed; its resolution at ``pp.tick.p2p``, matched key,
    tier and chunks, and whether d_model 7168 degrades the count), each
    held against rank 0's unpipelined model of the same weights (the loss
    within 1e-5 relative; every gradient within 1e-4 of its max|g|, each
    stage's gathered to rank 0), the embedding's, final norm's and head's
    gradients bit-equal (sha256) on every rank, the transfers' ``Issued``
    rows the code's; at all 60 layers (15 a stage, B = 8) a forward, its
    ms, peak memory and ``Issued`` rows by tick; and at all 60 layers
    again (B = 4) forward and backward twice, its ms, peak memory and
    device ms by class of a third under the profiler.
  * runs the overlap verifier (``repro_torch.analysis``) over the four
    ranks: ``exercise_plan`` of a plan the port tunes for tp:4 on h100-sxm,
    its record and its profile judged; then ``trace_and_verify(TRAIN_PLAN,
    ..., profile=True)`` of one tensor-parallel 1x4 step of llama3-8b at
    full width and 4 layers (B 4 x S 2048, as ``train``), every tuned
    ``tp.layer{0,1}.mlp.ag|rs`` site MATERIALIZED in the record and in
    the profile; and, from a profile of one more step taken without the
    record (whose dispatch mode slows the host), for each helper call the
    NCCL kernels' device ms and the ms of them during which another kernel
    ran (``ir.nccl_overlap``, summed by op and site): measurements, which
    no verdict reads; the step's ms unprofiled, profiled, and recorded
    and profiled.
  * trains the other families placed (``FAMILIES``; ``models.model.
    init_placed``: each rank draws its slices a module at a time), fp32,
    remat, three plain steps each: whisper-small whole (12 + 12 layers, B
    8 x S 448 over its 1500 stub frames) at 1x4 and 2x2 (attention of the
    encoder, self- and cross-attention by heads, the GELU MLPs over
    ``model``, ``dec_pos`` over ``data``); deepseek-v2-lite-16b (B 4 x S
    2048: MLA's heads, the experts) and qwen2-vl-72b (B 2 x S 1024, 256
    patches a row) at 1x4, each first at its probes' depths (deepseek 4
    and 8 layers, qwen2-vl 1 and 2), then at the deepest of its depths
    whose peak a rank, fitted linearly through the probes' largest peaks,
    stays under FAMILY_PEAK_GIB.  Whisper's runs and each first probe
    hold step 1 to this card's unplaced step of the same weights and batch
    (loss and grad_norm within ``chip_smoke.PARITY_TRAIN``'s relative
    bound; a MoE model's routing replayed).  The ``Issued`` rows at
    ``tp.*`` and ``ep.*`` (``family_rows``), the kernels' launches
    (``chip_smoke.expected_train_launches``), the split by heads and the
    leaves held alike must be the code's; it prints step ms, tokens/s,
    MFU, every rank's peak GiB and, of the deepest runs and whisper's, the
    device ms by class of one more step.
``--sections`` runs a subset of helpers, train, fsdp, deep, tp32, moe, pp, overlap,
families and launcher.
``--json PATH`` writes the result line to a file as well.  Then it runs
the launcher under ``torch.distributed.run``
(torchrun): ``repro_torch.launch.train --config`` (the same model, batch
and sequence, 3 steps) ``--mesh 1x4 --tuned-plan`` a plan the port tunes
for tp:4 on h100-sxm; and the same without a plan for each of
FAMILY_LAUNCHES (whisper-small whole, B 8 x S 448; qwen2-vl-72b at the
families section's 16 layers, B 2 x S 1024), which the launcher places by
``models.model.init_placed``.  Rank 0 prints one JSON line with every
rank's results and the launches' last lines; the exit code is 1 if a
check failed on any rank or a launch failed.
"""
from __future__ import annotations

import argparse
import contextlib
import faulthandler
import hashlib
import json
import math
import os
import re
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
sys.path.insert(1, ROOT)          # chip_smoke's launch counts and parity bounds

N = 4
BOUNDS = {"ring_ag_matmul": 1e-4, "mm_reduce_scatter": 1e-3, "chunked_all_to_all": 1e-6,
          "psum_tree_chunked": 1e-6}
TRUNK_BOUND = 1e-4
WAIT_S = 1500                     # the workers' time, after which they are stopped
LAUNCH_WAIT_S = 300               # the launcher's
PLAN = {"tp.layer0.mlp.ag": ("ring", 2), "tp.layer1.mlp.ag": ("ring", 4),
        "serve.layer0.mlp.ag": ("ring", 2), "serve.layer1.mlp.ag": ("ring", 4)}
TRAIN_PLAN = {"tp.layer0.mlp.ag": ("ring", 2), "tp.layer0.mlp.rs": ("chunked", 4),
              "tp.layer1.mlp.ag": ("ring", 4), "tp.layer1.mlp.rs": ("chunked", 2)}
TRAIN = dict(layers=4, B=4, S=2048, steps=3)          # --smoke: 2 layers, S = 64
SECTIONS = ("helpers", "train", "fsdp", "deep", "tp32", "moe", "pp", "overlap", "families",
            "launcher")
GATE_OPT = dict(lr=3e-4, eps=1e-3)
GATE_REL = 1e-5
# FSDP placements at 4 layers: (mesh, shape, mode, global batch); grad_accum=2 at
# 4x1 takes 8 rows, so that each rank's two rows split into its two microbatches
FSDP_RUNS = (("4x1", (4, 1), "plain", 4), ("4x1", (4, 1), "grad_accum=2", 8),
             ("2x2", (2, 2), "plain", 4))
DEEP = dict(layers=32, B=4, S=2048, steps=3, lr=3e-5)   # --smoke: smoke widths, 4 layers
# llama3-8b at all 32 layers placed tensor-parallel (attention, MLP and the
# vocabulary over ``model``, the F dims over ``data``) at 1x4 and 2x2
TP32 = dict(layers=32, B=4, S=2048, steps=3, lr=3e-5, meshes=(("1x4", (1, 4)),
                                                                ("2x2", (2, 2))))
CARD_BYTES = 80e9
# olmoe-1b-7b with its experts split over ``model``: 4 layers against the
# one-card step, 16 (all) against the one-card forward; --smoke: 2 and 4
MOE = dict(arch="olmoe-1b-7b", layers=(4, 16), B=4, S=2048, steps=3, lr=3e-5)
# the launcher's runs of the other families at 1x4 (--smoke: their smoke
# configs at S = 64)
FAMILY_LAUNCHES = ({"arch": "whisper-small", "batch": 8, "seq": 448},
                   {"arch": "qwen2-vl-72b", "overrides": {"num_layers": 16}, "batch": 2,
                    "seq": 1024})
# qwen2-moe-a2.7b (attention biases, a gated shared expert over ``model``) at
# 4 layers under 1x4 against the one-card step; B 3 x S 2048 makes its
# capacity int(6144 * 4 * 1.25 / 60) = 512 split over 4 ranks, and lets the
# one-card step (2.9 B parameters, 46 GB with AdamW's state) fit
QWEN = dict(arch="qwen2-moe-a2.7b", layers=4, B=3, S=2048)
MOE_PLAN = {"ep.layer0.moe.a2a_disp": ("chunked", 2), "ep.layer1.moe.a2a_disp": ("chunked", 4)}
# the pipeline: yi-34b, one stage a rank, at (parity, forward-only, forward
# and backward) depths; B x S in M microbatches (the forward-only run at
# full depth takes PP_FULL_B rows)
PP = dict(arch="yi-34b", layers=(4, 60, 60), B=4, S=2048, M=4, steps=2)
PP_FULL_B = 8
PP_PLAN = {"p2p": ("chunked", 4)}
PP_SITE = "pp.tick.p2p"
PP_LOSS_REL, PP_GRAD_BOUND = 1e-5, 1e-4       # against one rank's unpipelined model
# the other families placed (item 8.1 of ROADMAP.md's queue 1), at full width
# over B x S (whisper's 1500 stub frames, qwen2-vl's 256 patches at the head of
# each row): whisper-small whole at 1x4 and 2x2; deepseek-v2-lite-16b (MLA's
# heads and its experts over ``model``) and qwen2-vl-72b at 1x4, each at the
# deepest of ``depths`` whose peak a rank, fitted linearly through the peaks
# the ``probes`` measured, stays under FAMILY_PEAK_GIB.  Step 1 is held to
# one card's unplaced step (each rank on its card) at ``parity`` layers, a
# depth one card holds (whisper whole), which is the first probe.
FAMILIES = (dict(arch="whisper-small", B=8, S=448, meshes=("1x4", "2x2")),
            dict(arch="deepseek-v2-lite-16b", B=4, S=2048, meshes=("1x4",), probes=(4, 8),
                 depths=(8, 16, 27)),
            dict(arch="qwen2-vl-72b", B=2, S=1024, meshes=("1x4",), probes=(1, 2),
                 depths=(4, 8, 12, 16, 20, 24)))
FAMILY_PEAK_GIB = 72.0
FAMILY_STEPS = 3
# --smoke: the smoke configs (2 + 2 layers of whisper over 64 frames), S 64
# (qwen2-vl's 288: its 256 patches and 32 tokens), the probes and depths cut
FAMILY_SMOKE = {"whisper-small": (64, None, None), "deepseek-v2-lite-16b": (64, (2, 3), (4,)),
                "qwen2-vl-72b": (288, (1, 2), (3,))}
# Issued rows a layer's sites log in one forward and backward pass with remat:
# gate and up ring twice (forward, recompute) and once backward each; down
# reduce-scatter twice and once backward
ROWS_A_PASS = {"ag": {"ring_ag_matmul": 4, "ring_ag_matmul.bwd": 2},
               "rs": {"mm_reduce_scatter": 2, "mm_reduce_scatter.bwd": 1}}


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


def device_ms_by_class(run, dev) -> dict:
    """Device ms of one call of ``run`` by kernel class (NCCL, GEMM, other)
    from a torch.profiler trace, beside its wall ms under the profiler
    (all 0 on the CPU)."""
    out = {"nccl": 0.0, "gemm": 0.0, "other": 0.0, "wall": 0.0}
    if dev.type != "cuda":
        run()
        return out
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out["wall"] = (time.perf_counter() - t) * 1e3
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        kind = "nccl" if "nccl" in name else "gemm" if ("gemm" in name or "gemv" in name) \
            else "other"
        out[kind] += ev.self_device_time_total / 1e3
    return out


def expected_rows(cfg, passes: int, steps: int, plan=TRAIN_PLAN) -> dict:
    """``{site: {op: [chunks, ...]}}`` that ``steps`` steps of ``passes``
    passes log: ``plan``'s chunk counts, 1 at the layers it leaves out."""
    out = {}
    for i in range(cfg.num_layers):
        for k, ops in ROWS_A_PASS.items():
            site = f"tp.layer{i}.mlp.{k}"
            nc = plan.get(site, ("", 1))[1]
            out[site] = {op: [nc] * n * passes * steps for op, n in ops.items()}
    return out


def placement_rows(cfg, place, passes: int, steps: int, S: int) -> dict:
    """``{site: {op: [chunks, ...]}}`` of the placement's all-reduces in
    ``steps`` steps of ``passes`` passes with remat, read from what the
    placed model's ``place`` (``model.placement``) splits over ``model``:
    where q is split, a layer's attention rows twice (forward, recompute)
    and its input's gradient once, and where k is not, the k and v weights'
    (and biases') gradients once each (MLA: its whole ``kv_a`` and latent
    norm, and ``q_a`` and its norm with a q LoRA); qk_norm's two scales' gradients once
    each; where the embedding is split, the embedding once, the loss's two
    sums (``vocab_ce``) twice a chunk of 256 and its input's gradient once;
    a MoE layer's shared experts as attention (their sum once forward where
    no gate reads it).  None on one model rank."""
    n, out = passes * steps, {}

    def split(suffix):
        name = next(k for k in place.specs if k.endswith(suffix))
        return "model" in place.axes(name)

    def add(site, op, k):
        out[site] = {op: [1] * k * n}

    if "model" not in place.meshes or place.meshes["model"].size == 1:
        return out
    for i in range(cfg.num_layers if split("attn.q.weight") else 0):
        add(f"tp.layer{i}.attn.ar", "all_reduce", 2)
        add(f"tp.layer{i}.attn.ar.bwd", "all_reduce.bwd", 1)
        if cfg.attn_kind == "mla":        # the whole kv_a and its latent's norm
            add(f"tp.layer{i}.attn.kv.ar.bwd", "all_reduce.bwd",
                4 if cfg.q_lora_rank else 2)
        elif not split("attn.k.weight"):
            add(f"tp.layer{i}.attn.kv.ar.bwd", "all_reduce.bwd", 4 if cfg.attn_bias else 2)
        if cfg.qk_norm:
            add(f"tp.layer{i}.attn.qk_norm.ar.bwd", "all_reduce.bwd", 2)
    if split("embed.weight"):
        add("tp.embed.ar", "all_reduce", 1)
        add("tp.ce.ar", "vocab_ce", 2 * -(-S // 256))
        add("tp.ce.ar.bwd", "all_reduce.bwd", 1)
    first = cfg.first_dense_layers if cfg.is_moe else cfg.num_layers
    for j in range(cfg.num_layers - first if cfg.num_shared_experts else 0):
        # gated, the sum is saved for the gate's product, so remat's recompute
        # reaches it; ungated, the recompute stops before it
        add(f"ep.layer{j}.moe.shared.ar", "all_reduce", 2 if cfg.shared_expert_gate else 1)
        add(f"ep.layer{j}.moe.shared.ar.bwd", "all_reduce.bwd", 1)
    return out


def rows_by_site(issued, prefixes=("tp.", "ep.")) -> dict:
    """``{site: {op: [chunks, ...]}}`` of the ``Issued`` rows at ``prefixes``."""
    out = {}
    for r in issued:
        if r.site.startswith(prefixes):
            out.setdefault(r.site, {}).setdefault(r.op, []).append(r.num_chunks)
    return out


def tp_split(cfg, model, mm) -> dict:
    """Each rank's shapes of ``attn.q.weight``, ``embed.weight`` and
    ``head.weight`` (layer 0's attention) and whether they are 1/m of the
    whole, their sha256 differing between the model ranks of a data index
    (every rank calls it)."""
    import torch.distributed as dist

    layer = "trunk.moe_layers.0." if cfg.is_moe and not cfg.first_dense_layers \
        else "trunk.dense_layers.0."
    names = [layer + "attn.q.weight", "embed.weight"] + ([] if cfg.tie_embeddings
                                                          else ["head.weight"])
    params = dict(model.named_parameters())
    shapes = {n: list(params[n].shape) for n in names}
    rows = {n: (cfg.q_dim if "attn" in n else cfg.vocab_size) // mm.size for n in names}
    ok = all(shapes[n][0] == rows[n] for n in names)
    marks = {n: digest(params[n]) for n in names}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (dist.get_rank() // mm.size, marks))     # data index
    for n in names:
        for d in {e[0] for e in every}:
            ok &= len({e[1][n] for e in every if e[0] == d}) == mm.size
    return {"shapes": shapes, "ok": ok}


def train_section(rank: int, dev, smoke: bool, res: dict) -> None:
    """Tensor-parallel training at 1x4 and 2x2 against the one-card
    unsited steps (module docstring)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as C
    from repro_torch.train import trainer as T

    cfg = (get_smoke_config if smoke else get_config)("llama3-8b").replace(
        num_layers=2 if smoke else TRAIN["layers"])
    B, S = TRAIN["B"], 64 if smoke else TRAIN["S"]
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in corpus.batch(k).items()}
               for k in range(TRAIN["steps"] + 1)]
    plan = {k: C.CollectiveRuntime(*v) for k, v in TRAIN_PLAN.items()}
    modes = {"plain": {}, "grad_accum=2": dict(grad_accum=2)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def release():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    one_card = {}                    # the unsited step 1 of each mode, on this card
    for mode, kw in modes.items():
        model = M.init_params(cfg, 0, device=dev)
        state = adamw.init_state(dict(model.named_parameters()))
        step = T.make_train_step(cfg, T.TrainConfig(opt=adamw.AdamWConfig(**GATE_OPT),
                                                    warmup=2, total_steps=100, **kw))
        model, state, m = step(model, state, batches[0], 1)
        one_card[mode] = ({n: p.detach().cpu() for n, p in model.named_parameters()},
                          float(m["loss"]))      # on the host: the card's peak is the run's
        del model, state, step, m
        release()
    runs = []
    meshes = {}
    for name, shape, mode, steps in (("1x4", (1, 4), "plain", TRAIN["steps"]),
                                     ("1x4", (1, 4), "grad_accum=2", TRAIN["steps"]),
                                     ("2x2", (2, 2), "plain", TRAIN["steps"])):
        if name not in meshes:
            meshes[name] = make_mesh(shape, ("data", "model"))
        mm, dm = meshes[name]["model"], meshes[name]["data"]
        k = B // dm.size
        rows = slice(dm.rank * k, (dm.rank + 1) * k)
        model = M.init_placed(cfg, 0, mm, device=dev)
        state = adamw.init_state(dict(model.named_parameters()))
        step_fn = T.make_train_step(cfg, T.TrainConfig(
            opt=adamw.AdamWConfig(**GATE_OPT), warmup=2, total_steps=100, sited_mesh=mm,
            data_axis=dm if dm.size > 1 else None, **modes[mode]))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        times, losses, gate = [], [], None
        with C.use_runtime_plan(plan), C.record_issued() as issued:
            for i in range(steps):
                b = {n: a[rows] for n, a in batches[i].items()}
                sync()
                t = time.perf_counter()
                model, state, m = step_fn(model, state, b, i + 1)
                losses.append(float(m["loss"]))
                sync()
                times.append(time.perf_counter() - t)
                if i == 0:
                    want, want_loss = one_card[mode]
                    worst, at = 0.0, ""
                    for n, p in model.named_parameters():
                        w = model.placement.local(n, want[n].to(dev))
                        rel = ((p.detach() - w).abs().max() / w.abs().max()).item()
                        if rel > worst:
                            worst, at = rel, n
                    gate = {"param_rel": worst, "at": at,
                            "loss_rel": abs(losses[0] - want_loss) / abs(want_loss)}
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        launches, launches_ok = launches_as_code(cfg, modes[mode].get("grad_accum", 1),
                                                 steps, dev)
        by_site = rows_by_site(issued)
        passes = modes[mode].get("grad_accum", 1)
        rows_ok = by_site == {**expected_rows(cfg, passes, steps),
                              **placement_rows(cfg, model.placement, passes, steps, S)}
        split = tp_split(cfg, model, mm)
        b = {n: a[rows] for n, a in batches[steps].items()}
        with C.use_runtime_plan(plan):
            prof_ms = device_ms_by_class(lambda: step_fn(model, state, b, steps + 1), dev)
        replicated_equal = held_alike(model)
        step_s = statistics.median(times[1:] or times)
        row = {"mesh": name, "mode": mode, "steps": steps, "step_ms": step_s * 1e3,
               "step_ms_all": [t * 1e3 for t in times], "tokens_per_s": B * S / step_s,
               "peak_bytes": peak, "peak_gib": peak / 2**30, "profiled_step_ms": prof_ms,
               "losses": losses, "gate": gate, "issued_as_code": rows_ok,
               "replicated_equal": replicated_equal, "split": split, "launches": launches}
        runs.append(row)
        tag = f"train {name} {mode}"
        if not (gate["param_rel"] <= GATE_REL and gate["loss_rel"] <= GATE_REL):
            res["failed"].append(f"{tag}: step 1 against one card {gate}")
        if not rows_ok:
            res["failed"].append(f"{tag}: issued {by_site}")
        if not split["ok"]:
            res["failed"].append(f"{tag}: attention and the vocabulary not split {split}")
        if not launches_ok:
            res["failed"].append(f"{tag}: kernel launches {launches}")
        if not replicated_equal:
            res["failed"].append(f"{tag}: replicated parameters differ between ranks")
        if not all(map(math.isfinite, losses)):
            res["failed"].append(f"{tag}: losses {losses}")
        del model, state, step_fn
        release()
    res["train"] = {"layers": cfg.num_layers, "batch": B, "seq": S, "runs": runs}


def _one_card_step(cfg, mode_kw: dict, batch, dev):
    """The unsited step 1 of a mode from seed 0 on this card: (parameters on
    the host, loss)."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as T

    model = M.init_params(cfg, 0, device=dev)
    state = adamw.init_state(dict(model.named_parameters()))
    step = T.make_train_step(cfg, T.TrainConfig(opt=adamw.AdamWConfig(**GATE_OPT), warmup=2,
                                                total_steps=100, **mode_kw))
    model, state, m = step(model, state, batch, 1)
    out = ({n: p.detach().cpu() for n, p in model.named_parameters()}, float(m["loss"]))
    del model, state, step, m
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def digest(t: torch.Tensor) -> str:
    """sha256 of ``t``'s bytes, read on the host."""
    return hashlib.sha256(t.detach().contiguous().reshape(-1).view(torch.uint8)
                          .cpu().numpy()).hexdigest()


def held_alike(model) -> bool:
    """Whether every leaf is bit-equal (its ``digest``) on the ranks that
    hold the same slice of it (the same rank on each axis that splits it):
    a replicated leaf on every rank."""
    return not differ_alike(model)


def differ_alike(model) -> list:
    """The leaves that ``held_alike`` finds differing between ranks that
    hold the same slice of them."""
    import torch.distributed as dist

    place = model.placement
    marks = {n: ([place.meshes[a].rank for a in place.axes(n)], digest(p))
             for n, p in model.named_parameters()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, marks)
    out = []
    for n in marks:
        seen = {}
        for e in every:
            key, mark = tuple(e[n][0]), e[n][1]
            if seen.setdefault(key, mark) != mark:
                out.append(n)
                break
    return out


def fsdp_rows(rows, cfg, passes: int, steps: int, per_layer: int) -> bool:
    """Whether the ``fsdp.*`` ``Issued`` rows are the code's: a pass gathers
    each layer's ``per_layer`` split weights twice (forward, remat's
    recompute) and reduce-scatters them once, the embedding and the head
    once each way."""
    got = {}
    for r in rows:
        if r.site.startswith("fsdp."):
            got.setdefault(r.site, {}).setdefault(r.op, 0)
            got[r.site][r.op] += 1
    n = passes * steps
    want = {f"fsdp.layer{i}.ag_params": {"all_gather": 2 * per_layer * n,
                                         "all_gather.bwd": per_layer * n}
            for i in range(cfg.num_layers)}
    want.update({f"fsdp.{k}.ag_params": {"all_gather": n, "all_gather.bwd": n}
                 for k in ("embed", "head")})
    return got == want


def fsdp_section(rank: int, dev, smoke: bool, res: dict, shared: str) -> None:
    """FSDP placements at 4 layers (``FSDP_RUNS``) against the one-card
    steps, and a checkpoint round trip at 4x1 (module docstring)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as C, constraints as CT
    from repro_torch.train import trainer as T

    cfg = (get_smoke_config if smoke else get_config)("llama3-8b").replace(
        num_layers=2 if smoke else TRAIN["layers"])
    S = 64 if smoke else TRAIN["S"]
    batches = {}
    for B in sorted({b for *_, b in FSDP_RUNS}):
        corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                            global_batch=B))
        batches[B] = [{k: torch.as_tensor(v, device=dev) for k, v in corpus.batch(k).items()}
                      for k in range(TRAIN["steps"] + 1)]
    modes = {"plain": {}, "grad_accum=2": dict(grad_accum=2)}
    one_card = {(mode, B): _one_card_step(cfg, modes[mode], batches[B][0], dev)
                for _, _, mode, B in FSDP_RUNS}
    runs, meshes, steps = [], {}, TRAIN["steps"]
    for name, shape, mode, B in FSDP_RUNS:
        if name not in meshes:
            meshes[name] = make_mesh(shape, ("data", "model"))
        mesh = meshes[name]
        dm, mm = mesh["data"], mesh["model"]
        k = B // dm.size
        rows = slice(dm.rank * k, (dm.rank + 1) * k)
        knobs = TRAIN_PLAN if mm.size > 1 else {}          # the plan on a model axis
        plan = {site: C.CollectiveRuntime(*v) for site, v in knobs.items()}
        model = M.init_placed(cfg, 0, mesh, device=dev)
        place = model.placement
        state = adamw.init_state(dict(model.named_parameters()))
        step_fn = T.make_train_step(cfg, T.TrainConfig(
            opt=adamw.AdamWConfig(**GATE_OPT), warmup=2, total_steps=100, sited_mesh=mm,
            data_axis=dm if dm.size > 1 else None, **modes[mode]))
        want, want_loss = one_card[(mode, B)]
        shapes_ok = all(list(p.shape) == list(place.local(n, want[n]).shape)
                        and (not place.axes(n) or p.shape != want[n].shape)
                        for n, p in model.named_parameters())
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        sizes = {"data": dm.size, "model": mm.size}
        times, losses, gate = [], [], None
        with C.use_runtime_plan(plan), CT.use_axes(("data",), "model", sizes=sizes, batch=B), \
                C.record_issued() as issued:
            for i in range(steps):
                b = {n: a[rows] for n, a in batches[B][i].items()}
                _sync(dev)
                t = time.perf_counter()
                model, state, m = step_fn(model, state, b, i + 1)
                losses.append(float(m["loss"]))
                _sync(dev)
                times.append(time.perf_counter() - t)
                if i == 0:
                    worst, at = 0.0, ""
                    for n, p in model.named_parameters():
                        w = place.local(n, want[n].to(dev))
                        rel = ((p.detach() - w).abs().max() / w.abs().max()).item()
                        if rel > worst:
                            worst, at = rel, n
                    gate = {"param_rel": worst, "at": at,
                            "loss_rel": abs(losses[0] - want_loss) / abs(want_loss)}
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        launches, launches_ok = launches_as_code(cfg, modes[mode].get("grad_accum", 1),
                                                 steps, dev)
        by_site = rows_by_site(issued, ("tp.",))
        passes = modes[mode].get("grad_accum", 1)
        per_layer = sum(1 for n in place.specs
                        if n.startswith("trunk.dense_layers.0.") and "data" in place.axes(n))
        rows_ok = (by_site == {**expected_rows(cfg, passes, steps, knobs),
                               **placement_rows(cfg, place, passes, steps, S)}
                   and fsdp_rows(issued, cfg, passes, steps, per_layer))
        b = {n: a[rows] for n, a in batches[B][steps].items()}
        with C.use_runtime_plan(plan), CT.use_axes(("data",), "model", sizes=sizes, batch=B):
            prof_ms = device_ms_by_class(lambda: step_fn(model, state, b, steps + 1), dev)
        alike = held_alike(model)
        step_s = statistics.median(times[1:] or times)
        row = {"mesh": name, "mode": mode, "batch": B, "steps": steps, "step_ms": step_s * 1e3,
               "step_ms_all": [t * 1e3 for t in times], "tokens_per_s": B * S / step_s,
               "peak_bytes": peak, "profiled_step_ms": prof_ms, "losses": losses,
               "gate": gate, "issued_as_code": rows_ok, "held_alike_equal": alike,
               "shapes_are_slices": shapes_ok, "launches": launches}
        runs.append(row)
        tag = f"fsdp {name} {mode}"
        if not (gate["param_rel"] <= GATE_REL and gate["loss_rel"] <= GATE_REL):
            res["failed"].append(f"{tag}: step 1 against one card {gate}")
        if not rows_ok:
            res["failed"].append(f"{tag}: issued rows differ from the code's")
        if not launches_ok:
            res["failed"].append(f"{tag}: kernel launches {launches}")
        if not alike:
            res["failed"].append(f"{tag}: leaves held alike differ between ranks")
        if not shapes_ok:
            res["failed"].append(f"{tag}: a rank does not hold exactly its slices")
        if not all(map(math.isfinite, losses)):
            res["failed"].append(f"{tag}: losses {losses}")
        if name == "4x1" and mode == "plain":
            res["ckpt"] = ckpt_round_trip(cfg, model, mesh, shared, res)
        del model, state, step_fn
        _release(dev)
    res["fsdp"] = {"layers": cfg.num_layers, "seq": S, "runs": runs}


def ckpt_round_trip(cfg, model, mesh, shared: str, res: dict) -> dict:
    """The placed model's parameters gathered leaf by leaf and written by
    rank 0 in the reference's checkpoint layout, then restored on every
    rank into its slices: equal, exactly."""
    import torch.distributed as dist

    from repro_torch.convert import params_from_jax, params_to_jax
    from repro_torch.train import checkpoint

    path = os.path.join(shared, "ckpt")
    t = time.perf_counter()
    tree = params_to_jax(cfg, model)
    if dist.get_rank() == 0:
        checkpoint.save(path, tree, step=TRAIN["steps"])
    dist.barrier()
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    back, step = checkpoint.restore(path, tree)
    del tree
    mine = params_from_jax(cfg, back, mesh)
    del back
    read_s = time.perf_counter() - t
    sd = model.state_dict()
    equal = step == TRAIN["steps"] and all(torch.equal(mine[k], v.cpu()) for k, v in sd.items())
    del mine
    dist.barrier()
    if not equal:
        res["failed"].append("checkpoint: restored slices differ from the trained ones")
    return {"write_s": write_s, "read_s": read_s, "restored_equal": equal}


def deep_section(rank: int, dev, smoke: bool, res: dict) -> None:
    """llama3-8b at its full 32 layers under 4x1 (module docstring)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as C, constraints as CT
    from repro_torch.train import metrics as MET, trainer as T

    cfg = (get_smoke_config if smoke else get_config)("llama3-8b").replace(
        num_layers=4 if smoke else DEEP["layers"])
    B, S, steps = DEEP["B"], 64 if smoke else DEEP["S"], DEEP["steps"]
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in corpus.batch(k).items()}
               for k in range(steps + 1)]
    model = M.init_params(cfg, 0, device=dev)
    t = time.perf_counter()
    with torch.no_grad():                 # the one-card forward of the same weights
        want = float(M.loss_and_metrics(cfg, model, batches[0], remat=False)[0])
    forward_s = time.perf_counter() - t
    mesh = make_mesh((N, 1), ("data", "model"))
    dm, mm = mesh["data"], mesh["model"]
    M.shard_(cfg, model, mesh)
    _release(dev)
    before = {n: p.detach().double().sum().item() for n, p in model.named_parameters()}
    state = adamw.init_state(dict(model.named_parameters()))
    step_fn = T.make_train_step(cfg, T.TrainConfig(
        opt=adamw.AdamWConfig(lr=DEEP["lr"]), warmup=2, total_steps=100, sited_mesh=mm,
        data_axis=dm))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    k = B // dm.size
    rows = slice(dm.rank * k, (dm.rank + 1) * k)
    times, losses = [], []
    axes = CT.use_axes(("data",), "model", sizes={"data": dm.size, "model": mm.size}, batch=B)
    with axes:
        for i in range(steps):
            b = {n: a[rows] for n, a in batches[i].items()}
            _sync(dev)
            t = time.perf_counter()
            model, state, m = step_fn(model, state, b, i + 1)
            losses.append(float(m["loss"]))
            _sync(dev)
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        launches, launches_ok = launches_as_code(cfg, 1, steps, dev)
        b = {n: a[rows] for n, a in batches[steps].items()}
        with C.record_issued() as issued:
            prof_ms = device_ms_by_class(lambda: step_fn(model, state, b, steps + 1), dev)
    still = [n for n, p in model.named_parameters()
             if p.detach().double().sum().item() == before[n]]
    step_s = statistics.median(times[1:] or times)
    tokens = B * S
    loss_rel = abs(losses[0] - want) / abs(want)
    gathers = sum(r.collectives for r in issued if r.op == "all_gather")
    res["deep"] = {"layers": cfg.num_layers, "batch": B, "seq": S, "lr": DEEP["lr"],
                   "params": cfg.param_count(), "losses": losses, "one_card_loss": want,
                   "one_card_forward_s": forward_s, "loss_rel": loss_rel,
                   "step_ms": step_s * 1e3, "step_ms_all": [x * 1e3 for x in times],
                   "tokens_per_s": tokens / step_s,
                   "mfu_fp32": MET.mfu(cfg, tokens, step_s, chips=N, peak=MET.H100_FP32_PEAK),
                   "peak_bytes": peak, "peak_gib": peak / 2**30, "profiled_step_ms": prof_ms,
                   "gathers_a_step": gathers, "not_moved": still, "launches": launches}
    if not loss_rel <= GATE_REL:
        res["failed"].append(f"deep: step 1 loss {losses[0]} against the one-card {want}")
    if still:
        res["failed"].append(f"deep: parameters that did not move: {still[:5]}")
    if not launches_ok:
        res["failed"].append(f"deep: kernel launches {launches}")
    if not peak < CARD_BYTES:
        res["failed"].append(f"deep: peak memory {peak} bytes")
    if not all(map(math.isfinite, losses)):
        res["failed"].append(f"deep: losses {losses}")
    del model, state, step_fn
    _release(dev)


def tp32_section(rank: int, dev, smoke: bool, res: dict) -> None:
    """llama3-8b at all 32 layers placed tensor-parallel at 1x4 and 2x2
    (module docstring)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as C, constraints as CT
    from repro_torch.train import metrics as MET, trainer as T

    cfg = (get_smoke_config if smoke else get_config)("llama3-8b").replace(
        num_layers=4 if smoke else TP32["layers"])
    B, S, steps = TP32["B"], 64 if smoke else TP32["S"], TP32["steps"]
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in corpus.batch(k).items()}
               for k in range(steps + 1)]
    runs = []
    for name, shape in TP32["meshes"]:
        model = M.init_params(cfg, 0, device=dev)
        t = time.perf_counter()
        with torch.no_grad():             # the one-card forward of the same weights
            want = float(M.loss_and_metrics(cfg, model, batches[0], remat=False)[0])
        forward_s = time.perf_counter() - t
        mesh = make_mesh(shape, ("data", "model"))
        dm, mm = mesh["data"], mesh["model"]
        M.shard_(cfg, model, mesh)
        _release(dev)
        before = {n: p.detach().double().sum().item() for n, p in model.named_parameters()}
        state = adamw.init_state(dict(model.named_parameters()))
        step_fn = T.make_train_step(cfg, T.TrainConfig(
            opt=adamw.AdamWConfig(lr=TP32["lr"]), warmup=2, total_steps=100, sited_mesh=mm,
            data_axis=dm if dm.size > 1 else None))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        k = B // dm.size
        rows = slice(dm.rank * k, (dm.rank + 1) * k)
        times, losses = [], []
        with CT.use_axes(("data",), "model", sizes={"data": dm.size, "model": mm.size},
                         batch=B), C.record_issued() as issued:
            for i in range(steps):
                b = {n: a[rows] for n, a in batches[i].items()}
                _sync(dev)
                t = time.perf_counter()
                model, state, m = step_fn(model, state, b, i + 1)
                losses.append(float(m["loss"]))
                _sync(dev)
                times.append(time.perf_counter() - t)
            peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
            launches, launches_ok = launches_as_code(cfg, 1, steps, dev)
            by_site = rows_by_site(issued, ("tp.",))
            b = {n: a[rows] for n, a in batches[steps].items()}
            prof_ms = device_ms_by_class(lambda: step_fn(model, state, b, steps + 1), dev)
        want_rows = {**expected_rows(cfg, 1, steps, {}),
                     **placement_rows(cfg, model.placement, 1, steps, S)}
        counts = {site: {op: len(c) for op, c in ops_.items()} for site, ops_ in by_site.items()}
        summary = {}                      # Issued rows a step by site kind, all layers
        for site, ops_ in counts.items():
            kind = site.split(".", 2)[-1] if site.startswith("tp.layer") else site
            for op, c in ops_.items():
                summary[f"{kind} {op}"] = summary.get(f"{kind} {op}", 0) + c // steps
        split = tp_split(cfg, model, mm)
        alike = held_alike(model)
        still = [n for n, p in model.named_parameters()
                 if p.detach().double().sum().item() == before[n]]
        step_s = statistics.median(times[1:] or times)
        tokens = B * S
        loss_rel = abs(losses[0] - want) / abs(want)
        row = {"mesh": name, "layers": cfg.num_layers, "batch": B, "seq": S, "lr": TP32["lr"],
               "losses": losses, "one_card_loss": want, "one_card_forward_s": forward_s,
               "loss_rel": loss_rel, "step_ms": step_s * 1e3,
               "step_ms_all": [x * 1e3 for x in times], "tokens_per_s": tokens / step_s,
               "mfu_fp32": MET.mfu(cfg, tokens, step_s, chips=N, peak=MET.H100_FP32_PEAK),
               "peak_bytes": peak, "peak_gib": peak / 2**30, "profiled_step_ms": prof_ms,
               "issued_a_step": summary, "issued_as_code": by_site == want_rows,
               "split": split, "held_alike_equal": alike, "not_moved": still,
               "launches": launches}
        runs.append(row)
        tag = f"tp32 {name}"
        if not loss_rel <= GATE_REL:
            res["failed"].append(f"{tag}: step 1 loss {losses[0]} against the one-card {want}")
        if by_site != want_rows:
            res["failed"].append(f"{tag}: issued {counts}")
        for what, ok in (("attention and the vocabulary not split", split["ok"]),
                         ("leaves held alike differ between ranks", alike),
                         (f"kernel launches {launches}", launches_ok),
                         (f"parameters that did not move: {still[:5]}", not still),
                         (f"peak memory {peak} bytes", peak < CARD_BYTES),
                         (f"losses {losses}", all(map(math.isfinite, losses)))):
            if not ok:
                res["failed"].append(f"{tag}: {what}")
        del model, state, step_fn
        _release(dev)
    res["tp32"] = {"arch": cfg.name, "params": cfg.param_count(), "runs": runs}


def launches_as_code(cfg, passes: int, steps: int, dev) -> tuple:
    """(the kernels' launches since the last reset, whether they are the
    code's for ``steps`` steps of ``passes`` passes with remat: a layer's
    ln1, ln2 (and qk_norm's two) and flash forward twice (forward,
    recompute), ln_f once, each backward once).  The CPU takes the plain
    versions: nothing launches."""
    from repro_torch.kernels import ops

    got = {k: v for k, v in ops.LAUNCHES.items() if v}
    L, n, norms = cfg.num_layers, passes * steps, 4 if cfg.qk_norm else 2
    want = {} if dev.type != "cuda" else {
        "rmsnorm": n * (2 * norms * L + 1), "rmsnorm_bwd": n * (norms * L + 1),
        "flash_attention": n * 2 * L, "flash_attention_bwd": n * L}
    return got, got == want


def _twice(routing):
    """A one-pass routing record for a step with remat: each site's choices
    for its forward and again for its recompute."""
    from repro_torch.models import layers as L

    out = L.Routing()
    out.calls = {site: [c[0], c[0]] for site, c in routing.calls.items()}
    return out


def moe_section(rank: int, dev, smoke: bool, res: dict) -> None:
    """olmoe-1b-7b with expert parallelism at 1x4 and 2x2 (module docstring)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L, model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as C, constraints as CT
    from repro_torch.train import metrics as MET, trainer as T

    get = get_smoke_config if smoke else get_config
    base = get(MOE["arch"])
    short, deep = (2, 4) if smoke else MOE["layers"]
    S, steps = 64 if smoke else MOE["S"], MOE["steps"]
    plan = {k: C.CollectiveRuntime(*v) for k, v in MOE_PLAN.items()}
    meshes = {"1x4": make_mesh((1, N), ("data", "model")),
              "2x2": make_mesh((2, 2), ("data", "model"))}
    runs = []
    # (config, batch, meshes, whether step 1 is held to the one-card step; else
    # its loss to the one-card forward)
    cases = [(base.replace(num_layers=short), MOE["B"], ("1x4", "2x2"), True),
             (base.replace(num_layers=deep), MOE["B"], ("1x4", "2x2"), False),
             (get(QWEN["arch"]).replace(num_layers=2 if smoke else QWEN["layers"]), QWEN["B"],
              ("1x4",), True)]
    for cfg, B, mesh_names, gated_step in cases:
        layers = cfg.num_layers
        corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                            global_batch=B))
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in corpus.batch(k).items()}
                   for k in range(steps + 1)]
        opt = adamw.AdamWConfig(**GATE_OPT) if gated_step else adamw.AdamWConfig(lr=MOE["lr"])
        model = M.init_params(cfg, 0, device=dev)
        t = time.perf_counter()
        if gated_step:            # the one-card step of the same weights, on this card
            state = adamw.init_state(dict(model.named_parameters()))
            with L.record_routing() as routing:
                model, state, m = T.make_train_step(cfg, T.TrainConfig(
                    opt=opt, warmup=2, total_steps=100))(model, state, batches[0], 1)
            want = {n: p.detach().cpu() for n, p in model.named_parameters()}
            want_loss = float(m["loss"])
            del state, m
        else:                     # the one-card forward of the same weights
            with torch.no_grad(), L.record_routing() as once:
                want_loss = float(M.loss_and_metrics(cfg, model, batches[0], remat=False)[0])
            routing, want = _twice(once), None
        one_card_s = time.perf_counter() - t
        del model
        _release(dev)
        for name in mesh_names:
            mesh = meshes[name]
            dm, mm = mesh["data"], mesh["model"]
            k = B // dm.size
            rows = slice(dm.rank * k, (dm.rank + 1) * k)
            model = M.init_placed(cfg, 0, mesh, device=dev)
            place = model.placement
            _release(dev)
            before = {n: p.detach().double().sum().item() for n, p in model.named_parameters()}
            state = adamw.init_state(dict(model.named_parameters()))
            step_fn = T.make_train_step(cfg, T.TrainConfig(
                opt=opt, warmup=2, total_steps=100, sited_mesh=mm,
                data_axis=dm if dm.size > 1 else None))
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            sizes = {"data": dm.size, "model": mm.size}
            times, losses, auxes, gate = [], [], [], None
            tok_rows = slice(dm.rank * k * S, (dm.rank + 1) * k * S)
            with C.use_runtime_plan(plan), CT.use_axes(("data",), "model", sizes=sizes,
                                                       batch=B), \
                    C.record_issued() as issued:
                for i in range(steps):
                    b = {n: a[rows] for n, a in batches[i].items()}
                    replay = L.record_routing(routing, rows=tok_rows) if i == 0 else \
                        contextlib.nullcontext()
                    _sync(dev)
                    t = time.perf_counter()
                    with replay:
                        model, state, m = step_fn(model, state, b, i + 1)
                    losses.append(float(m["loss"]))
                    auxes.append(float(m["aux"]))
                    _sync(dev)
                    times.append(time.perf_counter() - t)
                    if i == 0:
                        gate = {"loss_rel": abs(losses[0] - want_loss) / abs(want_loss)}
                        if want is not None:
                            worst, at = 0.0, ""
                            for n, p in model.named_parameters():
                                w = place.local(n, want[n].to(dev))
                                rel = ((p.detach() - w).abs().max() / w.abs().max()).item()
                                if rel > worst:
                                    worst, at = rel, n
                            gate.update(param_rel=worst, at=at)
                peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
                launches, launches_ok = launches_as_code(cfg, 1, steps, dev)
                b = {n: a[rows] for n, a in batches[steps].items()}
                prof_ms = device_ms_by_class(lambda: step_fn(model, state, b, steps + 1), dev)
            by_site = rows_by_site(issued)
            want_rows = placement_rows(cfg, place, 1, steps + 1, S)
            for j in range(layers):
                for kind in ("a2a_disp", "a2a_comb"):
                    site = f"ep.layer{j}.moe.{kind}"
                    nc = MOE_PLAN.get(site, ("", 1))[1]
                    want_rows[site] = {"all_to_all": [nc] * 2 * (steps + 1),
                                       "all_to_all.bwd": [nc] * (steps + 1)}
            rows_ok = by_site == want_rows
            split = tp_split(cfg, model, mm)
            still = [n for n, p in model.named_parameters()
                     if p.detach().double().sum().item() == before[n]]
            alike = held_alike(model)
            step_s = statistics.median(times[1:] or times)
            tokens = B * S
            row = {"arch": cfg.name, "mesh": name, "layers": layers, "batch": B, "seq": S,
                   "lr": opt.lr, "split": split,
                   "eps": opt.eps, "one_card_s": one_card_s, "step_ms": step_s * 1e3,
                   "step_ms_all": [x * 1e3 for x in times], "tokens_per_s": tokens / step_s,
                   "mfu_fp32": MET.mfu(cfg, tokens, step_s, chips=N, peak=MET.H100_FP32_PEAK),
                   "peak_bytes": peak, "peak_gib": peak / 2**30, "profiled_step_ms": prof_ms,
                   "losses": losses, "aux": auxes, "one_card_loss": want_loss, "gate": gate,
                   "issued_as_code": rows_ok, "held_alike_equal": alike, "not_moved": still,
                   "launches": launches}
            runs.append(row)
            tag = f"moe {cfg.name} {name} {layers} layers"
            if not (gate["loss_rel"] <= GATE_REL and gate.get("param_rel", 0.0) <= GATE_REL):
                res["failed"].append(f"{tag}: step 1 against one card {gate}")
            if not split["ok"]:
                res["failed"].append(f"{tag}: attention and the vocabulary not split {split}")
            if not rows_ok:
                res["failed"].append(f"{tag}: issued {by_site}")
            if not launches_ok:
                res["failed"].append(f"{tag}: kernel launches {launches}")
            if not alike:
                res["failed"].append(f"{tag}: leaves held alike differ between ranks")
            if still:
                res["failed"].append(f"{tag}: parameters that did not move: {still[:5]}")
            if not peak < CARD_BYTES:
                res["failed"].append(f"{tag}: peak memory {peak} bytes")
            if not all(map(math.isfinite, losses)):
                res["failed"].append(f"{tag}: losses {losses}")
            del model, state, step_fn, place
            _release(dev)
            dist.barrier()
        del want, routing
        _release(dev)
    res["moe"] = {"archs": [base.name, QWEN["arch"]], "plan": MOE_PLAN, "runs": runs}


def pp_section(rank: int, dev, smoke: bool, res: dict) -> None:
    """yi-34b through four pipeline stages, one a rank (module docstring)."""
    import dataclasses
    import warnings

    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import TunedPlan, extract_workload, parse_parallel, tune
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.pipeline import transfer_ticks

    t_section = time.perf_counter()
    base = get_config(PP["arch"])
    if smoke:              # the smoke widths, with yi-34b's GQA group of 7 kept
        base = dataclasses.replace(get_smoke_config(PP["arch"]), num_heads=7, num_kv_heads=1,
                                   head_dim=32, d_model=224)
    short, full, deep = PP["layers"]
    B, S, mb = PP["B"], 64 if smoke else PP["S"], PP["M"]
    mesh = make_mesh((N,), ("stage",))["stage"]
    dist.barrier()         # every rank in the group before its first p2p
    ticks = transfer_ticks(N, mb, rank)

    def batch_of(rows):
        corpus = SyntheticCorpus(DataConfig(vocab_size=base.vocab_size, seq_len=S,
                                            global_batch=rows))
        return {k: torch.as_tensor(v, device=dev) for k, v in corpus.batch(0).items()}

    def rows_as_code(rows, nc, passes=("ppermute", "ppermute.bwd")) -> bool:
        want = [(PP_SITE, op, nc, 0, nc) for op in passes for _ in ticks]
        return [(r.site, r.op, r.num_chunks, r.matmuls, r.collectives) for r in rows] == want

    def agree(value) -> list:
        every = [None] * N
        dist.all_gather_object(every, value)
        return every

    out = {"arch": base.name, "stages": N, "microbatches": mb, "transfer_ticks": ticks}

    # 1 and 4: `short` layers, one a stage, against one rank's unpipelined model
    cfg = base.replace(num_layers=short)
    batch = batch_of(B)
    want, want_loss = {}, None
    if rank == 0:
        whole = M.init_stage(cfg, 0, device=dev)
        loss = M.loss_and_metrics(cfg, whole, batch)[0]    # no metrics kept: they hold
        names, ps = zip(*whole.named_parameters())          # the graph, and the model
        want = {n: g.cpu() for n, g in zip(names, torch.autograd.grad(loss, ps))}
        want_loss = float(loss)
        del whole, loss, ps
        _release(dev)
    model = M.init_stage(cfg, 0, rank, N, device=dev)
    names, params = zip(*model.named_parameters())
    per = short // N

    def held(tag: str, plan: dict, nc: int) -> dict:
        """One forward and backward of the pipelined loss under ``plan``: the
        loss and the gradients against the unpipelined model's (each stage's
        gathered to rank 0), the replicated leaves' gradients bit-equal on
        every rank, the transfers' ``Issued`` rows as the code's."""
        with C.use_runtime_plan(plan), C.record_issued() as rows, \
                C.record_site_resolutions() as resolved, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _sync(dev)
            t = time.perf_counter()
            loss, _ = M.pipeline_loss(cfg, model, batch, mesh=mesh, microbatches=mb,
                                      site=PP_SITE)
            grads = torch.autograd.grad(loss, params)
            _sync(dev)
            ms = (time.perf_counter() - t) * 1e3
        losses = agree(float(loss))
        worst, at = 0.0, ""
        for n, g in zip(names, grads):
            if n.startswith("trunk.dense_layers."):      # each stage's, gathered to rank 0
                _, _, j, rest = n.split(".", 3)
                parts = [torch.empty_like(g) for _ in range(N)] if rank == 0 else None
                dist.gather(g.contiguous(), parts, dst=0)
                pairs = [(f"trunk.dense_layers.{r * per + int(j)}.{rest}", q)
                         for r, q in enumerate(parts or [])]
            else:
                pairs = [(n, g)] if rank == 0 else []
            for key, q in pairs:
                w = want[key].to(dev)
                err = ((q - w).abs().max() / w.abs().max()).item()
                if err > worst:
                    worst, at = err, key
        marks = agree({n: digest(g) for n, g in zip(names, grads)
                       if not n.startswith("trunk.")})
        row = {"plan": tag, "plan_entries": len(plan), "ms": ms, "losses": losses, "rows": len(rows),
               "rows_as_code": rows_as_code(rows, nc),
               "resolved": sorted({(r.matched_key, r.tier, r.num_chunks) for r in resolved}),
               "degraded_warnings": [str(c.message) for c in caught
                                     if issubclass(c.category, C.CollectiveDegradedWarning)],
               "replicated_bit_equal": all(m == marks[0] for m in marks)}
        if rank == 0:
            row.update(loss_rel=max(abs(x - want_loss) / abs(want_loss) for x in losses),
                       grad_err_of_max_g=worst, grad_err_at=at)
            if not (row["loss_rel"] <= PP_LOSS_REL and worst <= PP_GRAD_BOUND):
                res["failed"].append(f"pp {tag}: loss {losses} against {want_loss}, "
                                     f"gradient of {at} off by {worst} of max|g|")
        if not row["rows_as_code"]:
            res["failed"].append(f"pp {tag}: issued {[tuple(r.__dict__.values()) for r in rows]}")
        if not row["replicated_bit_equal"]:
            res["failed"].append(f"pp {tag}: embedding, norm or head gradients differ")
        if len(set(losses)) != 1:
            res["failed"].append(f"pp {tag}: the ranks' losses differ {losses}")
        del grads, loss
        return row

    out["parity"] = {"layers": short, "batch": B, "seq": S,
                     # the first call sets up each pair's p2p communicator
                     "unplanned, first call": held("unplanned, first call", {}, 1),
                     "unplanned": held("unplanned", {}, 1),
                     "p2p x4": held("p2p x4", {k: C.CollectiveRuntime(*v)
                                               for k, v in PP_PLAN.items()}, 4)}
    # 4: the port's tune of yi-34b as pp:4:4, lowered and installed
    text = None
    if rank == 0:
        t = time.perf_counter()
        tuned = tune(extract_workload(base, parse_parallel(f"pp:{N}:{mb}"), seq=S,
                                      global_batch=B), "h100-sxm")
        text = [tuned.to_json(), (time.perf_counter() - t) * 1e3]
    text, tune_ms = agree(text)[0]
    tuned = TunedPlan.from_json(text)
    lowered = tuned.runtime_plan()
    with C.use_runtime_plan(lowered):
        knobs, key, tier = C.resolve_runtime(PP_SITE, "p2p")
    used = knobs.num_chunks if base.d_model % knobs.num_chunks == 0 else 1
    out["tuned"] = {"parallel": f"pp:{N}:{mb}", "hardware": "h100-sxm", "tune_ms": tune_ms,
                    "site": PP_SITE, "matched_key": key, "tier": tier,
                    "num_chunks": knobs.num_chunks, "strategy": knobs.strategy,
                    "d_model": base.d_model, "degraded": used != knobs.num_chunks,
                    "step": held("tuned", lowered, used)}
    del model, params, want
    _release(dev)

    # 2: all `full` layers, forward only, PP_FULL_B rows
    cfg = base.replace(num_layers=full)
    batch = batch_of(PP_FULL_B)
    model = M.init_stage(cfg, 0, rank, N, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(2):
        with torch.no_grad(), C.record_issued() as rows:
            _sync(dev)
            t = time.perf_counter()
            losses.append(float(M.pipeline_loss(cfg, model, batch, mesh=mesh,
                                                microbatches=mb, site=PP_SITE)[0]))
            _sync(dev)
            times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    every = agree(losses[-1])
    out["forward"] = {"layers": full, "layers_a_stage": full // N, "batch": PP_FULL_B,
                      "seq": S, "ms": times[-1], "ms_all": times, "losses": every,
                      "peak_bytes": peak, "peak_gib": peak / 2**30,
                      "rows_by_tick": [[t, r.op, r.num_chunks, r.collectives]
                                       for t, r in zip(ticks, rows)]}
    if not rows_as_code(rows, 1, passes=("ppermute",)):
        res["failed"].append(f"pp forward: issued {len(rows)} rows at ticks {ticks}")
    if not (all(map(math.isfinite, every)) and len(set(every)) == 1 and peak < CARD_BYTES):
        res["failed"].append(f"pp forward: losses {every}, peak {peak}")
    del model
    _release(dev)

    # 3: `deep` layers, forward and backward
    cfg = base.replace(num_layers=deep)
    batch = batch_of(B)
    model = M.init_stage(cfg, 0, rank, N, device=dev)

    def step():
        loss, _ = M.pipeline_loss(cfg, model, batch, mesh=mesh, microbatches=mb,
                                  site=PP_SITE)
        loss.backward()
        for q in model.parameters():
            q.grad = None
        return float(loss)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(PP["steps"]):
        _sync(dev)
        t = time.perf_counter()
        losses.append(step())
        _sync(dev)
        times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    prof = device_ms_by_class(step, dev)
    every = agree(losses[-1])
    out["forward_backward"] = {"layers": deep, "layers_a_stage": deep // N, "batch": B,
                               "seq": S, "ms": times[-1], "ms_all": times, "losses": every,
                               "peak_bytes": peak, "peak_gib": peak / 2**30,
                               "profiled_ms": prof}
    if not (all(map(math.isfinite, every)) and len(set(every)) == 1 and peak < CARD_BYTES):
        res["failed"].append(f"pp forward and backward: losses {every}, peak {peak}")
    del model
    _release(dev)
    out["seconds"] = time.perf_counter() - t_section
    res["pp"] = out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _release(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def helpers_section(rank: int, dev, smoke: bool, res: dict) -> None:
    """The collective helpers against their oracles, timed beside their
    parts, and the sited trunk against the unsited (module docstring)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel import collectives as C

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
    del model, tp, tp_plain, sv, sv_plain
    if not smoke:
        torch.cuda.empty_cache()


def _verdicts(rep) -> dict:
    return {v.site: v.verdict for v in rep.verdicts}


def _overlap_by_call(rows) -> dict:
    """``ir.nccl_overlap``'s rows summed by helper op and site, and in all."""
    out = {}
    for r in rows:
        for key in (f"{r['op']}@{r['site']}", "all"):
            e = out.setdefault(key, {"calls": 0, "collectives": 0, "nccl_ms": 0.0,
                                     "under_compute_ms": 0.0})
            e["calls"] += 1
            e["collectives"] += r["collectives"]
            e["nccl_ms"] += r["nccl_ms"]
            e["under_compute_ms"] += r["under_compute_ms"]
    return out


def overlap_section(rank: int, dev, smoke: bool, res: dict) -> None:
    """The overlap verifier over the four ranks (module docstring)."""
    from repro_torch.analysis.exercise import exercise_plan
    from repro_torch.analysis.ir import nccl_overlap
    from repro_torch.analysis.overlap import trace_and_verify
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import ParallelPlan, extract_workload, tune
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import constraints as CT
    from repro_torch.train import trainer as T
    from torch.profiler import ProfilerActivity, profile

    cfg = (get_smoke_config if smoke else get_config)("llama3-8b").replace(
        num_layers=2 if smoke else TRAIN["layers"])
    B, S = TRAIN["B"], 64 if smoke else TRAIN["S"]
    out = res["overlap"] = {"layers": cfg.num_layers, "batch": B, "seq": S}
    card = dev.type == "cuda"

    # the exerciser over the real group, on a tp:4 plan the port tunes
    plan = tune(extract_workload(cfg, ParallelPlan(kind="tp", tp=N), seq=S, global_batch=B),
                "h100-sxm")
    rec, prof = exercise_plan(plan, mesh=make_mesh(), profile=True)
    out["exercise"] = {"record": _verdicts(rec), "profile": _verdicts(prof)}
    if not (rec.verdicts and rec.ok()):
        res["failed"].append(f"overlap: exercise_plan record\n{rec.format()}")
    if card and not (prof.verdicts and prof.ok()):
        res["failed"].append(f"overlap: exercise_plan profile\n{prof.format()}")

    # one tp 1x4 step under TRAIN_PLAN, judged and profiled
    meshes = make_mesh((1, N), ("data", "model"))
    mm = meshes["model"]
    model = M.init_placed(cfg, 0, mm, device=dev)
    state = adamw.init_state(dict(model.named_parameters()))
    step_fn = T.make_train_step(cfg, T.TrainConfig(
        opt=adamw.AdamWConfig(**GATE_OPT), warmup=2, total_steps=100, sited_mesh=mm))
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in corpus.batch(0).items()}
    runtime = {k: C.CollectiveRuntime(*v) for k, v in TRAIN_PLAN.items()}

    def run():
        step_fn(model, state, batch, 1)
        _sync(dev)

    with CT.use_axes(("data",), "model", sizes={"data": 1, "model": N}, batch=B):
        with C.use_runtime_plan(runtime):
            run()                      # warm: cuBLAS and NCCL set up outside the profile
            t = time.perf_counter()
            run()
            out["step_ms"] = (time.perf_counter() - t) * 1e3
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            t = time.perf_counter()
            rec, prof = trace_and_verify(runtime, run, profile=path)
            out["step_ms_recorded_profiled"] = (time.perf_counter() - t) * 1e3
            # the shares come from a profile of its own: the record's
            # dispatch mode slows every op on the host, and with it how far
            # the host keeps the card fed while NCCL runs
            with C.use_runtime_plan(runtime):
                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
                t = time.perf_counter()
                with profile(activities=acts) as p:
                    run()
                out["step_ms_profiled"] = (time.perf_counter() - t) * 1e3
                p.export_chrome_trace(path)
            rows = nccl_overlap(path)
    out["step"] = {"record": _verdicts(rec), "profile": _verdicts(prof),
                   "untuned": rec.untuned, "nccl": _overlap_by_call(rows)}
    for site in TRAIN_PLAN:
        got = (rec.verdict_for(site), prof.verdict_for(site))
        if got[0] != "MATERIALIZED" or (card and got[1] != "MATERIALIZED"):
            res["failed"].append(f"overlap: {site} record/profile {got}\n{rec.format()}\n"
                                 f"{prof.format()}")
    del model, state, step_fn
    _release(dev)


def family_rows(cfg, place, steps: int, S: int) -> dict:
    """``{site: {op: [chunks, ...]}}`` that ``steps`` plain steps of an
    other family's placed model log at ``tp.*`` and ``ep.*`` with remat,
    each site at one chunk (no plan).  whisper: each encoder layer's
    attention at ``tp.enc{i}.attn`` and each decoder layer's self- and
    cross-attention at ``tp.layer{i}.attn|cross_attn`` (twice forward,
    their inputs' gradients once, the memory's at ``.mem.ar.bwd`` once),
    each GELU MLP's ring once a projection twice and once backward and its
    reduce-scatter likewise where the sequence splits (else column-then-row
    at ``{site}.ar``: the recompute stops before the sum, once each way),
    the vocabulary where it splits (``placement_rows``); the dense trunk's
    (MLA, M-RoPE): ``placement_rows``, the dense layers' MLPs as
    ``expected_rows``, each MoE layer's dispatch and combine twice and once
    backward."""
    m = place.meshes["model"].size
    if cfg.family != "audio":
        out = placement_rows(cfg, place, 1, steps, S)
        first = cfg.first_dense_layers if cfg.is_moe else cfg.num_layers
        out.update({k: v for k, v in expected_rows(cfg, 1, steps, {}).items()
                    if int(k.split(".")[1][len("layer"):]) < first})
        for j in range(cfg.num_layers - first):
            for kind in ("a2a_disp", "a2a_comb"):
                out[f"ep.layer{j}.moe.{kind}"] = {"all_to_all": [1] * 2 * steps,
                                                   "all_to_all.bwd": [1] * steps}
        return out
    out = {}

    def add(site, op, k):
        out[site] = {op: [1] * k * steps}

    def attn(site, memory=False):
        add(f"{site}.ar", "all_reduce", 2)
        add(f"{site}.ar.bwd", "all_reduce.bwd", 1)
        if memory:
            add(f"{site}.mem.ar.bwd", "all_reduce.bwd", 1)

    def mlp(site, seq):
        if seq % m:
            add(f"{site}.ar", "all_reduce", 1)
            add(f"{site}.ar.bwd", "all_reduce.bwd", 1)
            return
        for k, ops_ in (("ag", ("ring_ag_matmul", "ring_ag_matmul.bwd")),
                        ("rs", ("mm_reduce_scatter", "mm_reduce_scatter.bwd"))):
            out[f"{site}.{k}"] = {ops_[0]: [1] * 2 * steps, ops_[1]: [1] * steps}

    if m == 1:
        return out
    for i in range(cfg.encoder_layers):
        attn(f"tp.enc{i}.attn")
        mlp(f"tp.enc{i}.mlp", cfg.encoder_seq)
    for i in range(cfg.num_layers):
        attn(f"tp.layer{i}.attn")
        attn(f"tp.layer{i}.cross_attn", memory=True)
        mlp(f"tp.layer{i}.mlp", S)
    out.update({k: v for k, v in placement_rows(cfg, place, 1, steps, S).items()
                if not k.startswith("tp.layer")})
    return out


def _max_over_ranks(x: float, dev) -> float:
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def family_run(cfg, mesh_name: str, B: int, S: int, dev, res: dict, *, parity: bool,
               profile: bool) -> dict:
    """``FAMILY_STEPS`` plain steps of ``cfg`` placed on the mesh
    ``mesh_name`` (``models.model.init_placed``), remat, fp32, from the
    port's SyntheticCorpus and the family's stubs (the same every step);
    with ``parity`` step 1 (GATE_OPT) held to this card's unplaced step 1 of
    the same weights and batch, loss and grad_norm within
    ``chip_smoke.PARITY_TRAIN``'s relative bound (a MoE model's routing
    replayed from it); else at lr 3e-5.  Step ms (median of steps 2-3),
    tokens/s, MFU (the reference's 6·N_active·tokens on the fp32 peak of
    four cards), every rank's peak GiB, the ``Issued`` rows a step by site
    against the code's (``family_rows``), the kernels' launches against
    ``chip_smoke.expected_train_launches``, the split and the leaves held
    alike; with ``profile``, device ms by class of one more step."""
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, stub_inputs
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L, model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as C, constraints as CT
    from repro_torch.train import metrics as MET, trainer as T

    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
    stubs = {k: torch.as_tensor(v, device=dev) for k, v in stub_inputs(cfg, B).items()}
    batches = [dict({k: torch.as_tensor(v, device=dev) for k, v in corpus.batch(k).items()},
                    **stubs) for k in range(FAMILY_STEPS + 1)]
    opt = adamw.AdamWConfig(**GATE_OPT) if parity else adamw.AdamWConfig(lr=3e-5)
    want, routing, one_card_s = None, None, None
    if parity:                # this card's unplaced step 1 of the same weights
        t = time.perf_counter()
        model = M.init_params(cfg, 0, device=dev)
        state = adamw.init_state(dict(model.named_parameters()))
        with L.record_routing() as routing:
            model, state, m = T.make_train_step(cfg, T.TrainConfig(
                opt=opt, warmup=2, total_steps=100))(model, state, batches[0], 1)
        want = {k: float(m[k]) for k in ("loss", "grad_norm")}
        one_card_s = time.perf_counter() - t
        del model, state, m
        _release(dev)
    shape = tuple(int(x) for x in mesh_name.split("x"))
    mesh = make_mesh(shape, ("data", "model"))
    dm, mm = mesh["data"], mesh["model"]
    t = time.perf_counter()
    model = M.init_placed(cfg, 0, mesh, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t
    place = model.placement
    before = {n: p.detach().double().sum().item() for n, p in model.named_parameters()}
    state = adamw.init_state(dict(model.named_parameters()))
    step_fn = T.make_train_step(cfg, T.TrainConfig(opt=opt, warmup=2, total_steps=100,
                                                   sited_mesh=mm,
                                                   data_axis=dm if dm.size > 1 else None))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    k = B // dm.size
    rows = slice(dm.rank * k, (dm.rank + 1) * k)
    tok_rows = slice(dm.rank * k * S, (dm.rank + 1) * k * S)
    times, losses, norms, gate = [], [], [], None
    with CT.use_axes(("data",), "model", sizes={"data": dm.size, "model": mm.size},
                     batch=B), C.record_issued() as issued:
        for i in range(FAMILY_STEPS):
            b = {n: a[rows] for n, a in batches[i].items()}
            replay = L.record_routing(routing, rows=tok_rows) if i == 0 and parity \
                and cfg.is_moe else contextlib.nullcontext()
            _sync(dev)
            t = time.perf_counter()
            with replay:
                model, state, m = step_fn(model, state, b, i + 1)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            _sync(dev)
            times.append(time.perf_counter() - t)
            if i == 0 and parity:
                gate = {k: abs(v - want[k]) / abs(want[k])
                        for k, v in (("loss", losses[0]), ("grad_norm", norms[0]))}
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        by_site = rows_by_site(issued)
        b = {n: a[rows] for n, a in batches[FAMILY_STEPS].items()}
        prof_ms = device_ms_by_class(lambda: step_fn(model, state, b, FAMILY_STEPS + 1), dev) \
            if profile else None
    want_launches = {} if dev.type != "cuda" else {
        k: v for k, v in chip_smoke.expected_train_launches(cfg, FAMILY_STEPS).items() if v}
    want_rows = family_rows(cfg, place, FAMILY_STEPS, S)
    counts = {site: {op: len(c) for op, c in ops_.items()} for site, ops_ in by_site.items()}
    summary = {}                          # Issued rows a step by site kind, all layers
    for site, ops_ in counts.items():
        kind = re.sub(r"\.(layer|enc)\d+\.", r".\1{i}.", site)
        for op, c in ops_.items():
            summary[f"{kind} {op}"] = summary.get(f"{kind} {op}", 0) + c // FAMILY_STEPS
    differ = differ_alike(model)
    alike = not differ
    still = [n for n, p in model.named_parameters()
             if p.detach().double().sum().item() == before[n]]
    heads = [n for n in place.specs if re.search(r"attn\.(q|kv_b)\.weight$", n)]
    split = all("model" in place.axes(n) for n in heads) if mm.size > 1 else True
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak / 2**30)
    step_s = statistics.median(times[1:] or times)
    tokens = B * S
    row = {"arch": cfg.name, "mesh": mesh_name, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers, "batch": B, "seq": S, "lr": opt.lr,
           "eps": opt.eps, "init_s": init_s, "one_card_s": one_card_s, "losses": losses,
           "grad_norms": norms, "one_card": want, "gate": gate, "step_ms": step_s * 1e3,
           "step_ms_all": [x * 1e3 for x in times], "tokens_per_s": tokens / step_s,
           "mfu_fp32": MET.mfu(cfg, tokens, step_s, chips=N, peak=MET.H100_FP32_PEAK),
           "peak_gib": peak / 2**30, "peak_gib_by_rank": peaks,
           "profiled_step_ms": prof_ms, "issued_a_step": summary,
           "issued_as_code": by_site == want_rows, "heads_split": split,
           "held_alike_equal": alike, "not_moved": still, "launches": launches,
           "launches_as_code": launches == want_launches}
    tag = f"families {cfg.name} {mesh_name} {cfg.num_layers} layers"
    if gate is not None and not max(gate.values()) <= chip_smoke.PARITY_TRAIN["rel_bound"]:
        res["failed"].append(f"{tag}: step 1 against one card {gate}")
    if by_site != want_rows:
        diff = sorted(set(by_site) ^ set(want_rows)) + sorted(
            s for s in set(by_site) & set(want_rows) if by_site[s] != want_rows[s])
        res["failed"].append(f"{tag}: issued rows differ from the code's at {diff}: "
                             f"{ {s: counts.get(s) for s in diff} }")
    for what, ok in (("attention not split by heads", split),
                     (f"leaves held alike differ between ranks: {differ[:8]}", alike),
                     (f"kernel launches {launches}, expected {want_launches}",
                      launches == want_launches),
                     (f"parameters that did not move: {still[:5]}", not still),
                     (f"peak memory {peak} bytes", peak < CARD_BYTES),
                     (f"losses {losses}", all(map(math.isfinite, losses + norms)))):
        if not ok:
            res["failed"].append(f"{tag}: {what}")
    del model, state, step_fn, place, batches
    _release(dev)
    dist.barrier()
    return row


def families_section(rank: int, dev, smoke: bool, res: dict) -> None:
    """The other families placed (``FAMILIES``, module docstring): whisper
    whole at 1x4 and 2x2; deepseek-v2-lite-16b and qwen2-vl-72b at 1x4,
    their probes (the first with parity), the fitted peaks and the depth
    the rule picks, and three steps there."""
    from repro_torch.configs import get_config, get_smoke_config

    if rank == 0:
        print("families: start", flush=True)
    runs, picks = [], {}
    for fam in FAMILIES:
        base = (get_smoke_config if smoke else get_config)(fam["arch"])
        S = FAMILY_SMOKE[fam["arch"]][0] if smoke else fam["S"]
        if "probes" not in fam:          # whole: its parity run is its run
            for name in fam["meshes"]:
                runs.append(family_run(base, name, fam["B"], S, dev, res, parity=True,
                                       profile=True))
            continue
        probes, depths = FAMILY_SMOKE[fam["arch"]][1:] if smoke else (fam["probes"],
                                                                       fam["depths"])
        peak = {}
        for j, L_ in enumerate(probes):
            row = family_run(base.replace(num_layers=L_), fam["meshes"][0], fam["B"], S, dev,
                             res, parity=j == 0, profile=False)
            runs.append(row)
            peak[L_] = max(row["peak_gib_by_rank"])
        (a, pa), (b, pb) = sorted(peak.items())
        fit = {d: pa + (pb - pa) / (b - a) * (d - a) for d in depths}
        pick = max([d for d in depths if fit[d] < FAMILY_PEAK_GIB] or [depths[0]])
        if dev.type == "cuda" and not pb > pa:        # a deeper probe must hold more
            res["failed"].append(f"families {fam['arch']}: probe peaks {peak} GiB do not "
                                 "grow with depth")
            pick = depths[0]
        picks[fam["arch"]] = {"probe_peaks_gib": peak, "fitted_gib": fit, "depth": pick,
                              "limit_gib": FAMILY_PEAK_GIB}
        if rank == 0:
            print(f"families: {fam['arch']} probes {peak} GiB, fit {fit}, depth {pick}",
                  flush=True)
        runs.append(family_run(base.replace(num_layers=pick), fam["meshes"][0], fam["B"], S,
                               dev, res, parity=False, profile=True))
    res["families"] = {"runs": runs, "depths": picks, "steps": FAMILY_STEPS}


def worker(rank: int, port: int, smoke: bool, out: str, sections=SECTIONS) -> int:
    import torch.distributed as dist

    faulthandler.dump_traceback_later(WAIT_S - 60, exit=True)   # a hang shows its stack
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu") if smoke else torch.device("cuda", rank)
    if smoke:       # four processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or N) // N))
    kw = {}
    if not smoke:
        # NCCL's batch_isend_irecv (the ring) and the port's kernels use the
        # current device: it must be this rank's card
        torch.cuda.set_device(dev)
        kw = dict(device_id=dev)
    dist.init_process_group("gloo" if smoke else "nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=N, timeout=timedelta(seconds=600), **kw)
    res = {"rank": rank, "helpers": [], "failed": []}
    try:
        if "helpers" in sections:
            helpers_section(rank, dev, smoke, res)
        if "train" in sections:
            train_section(rank, dev, smoke, res)
        if "fsdp" in sections:
            fsdp_section(rank, dev, smoke, res, os.path.dirname(out))
        if "deep" in sections:
            deep_section(rank, dev, smoke, res)
        if "tp32" in sections:
            tp32_section(rank, dev, smoke, res)
        if "moe" in sections:
            moe_section(rank, dev, smoke, res)
        if "pp" in sections:
            pp_section(rank, dev, smoke, res)
        if "overlap" in sections:
            overlap_section(rank, dev, smoke, res)
        if "families" in sections:
            families_section(rank, dev, smoke, res)
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def run_launcher(smoke: bool, tmp: str) -> dict:
    """``torch.distributed.run --standalone --nproc-per-node 4 -m
    repro_torch.launch.train --config ... --mesh 1x4 --tuned-plan ...``:
    its exit code, seconds and last lines."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import ParallelPlan, extract_workload, tune
    from repro_torch.parallel import collectives as C

    run = {"arch": "llama3-8b", "batch": TRAIN["B"], "seq": 64 if smoke else TRAIN["S"],
           "steps": TRAIN["steps"], "lr": 3e-5}       # chip_smoke.py phase 8's lr
    if smoke:
        run["smoke"] = True
        cfg = get_smoke_config("llama3-8b")
    else:
        run["overrides"] = {"num_layers": TRAIN["layers"]}
        cfg = get_config("llama3-8b").replace(num_layers=TRAIN["layers"])
    plan = tune(extract_workload(cfg, ParallelPlan(kind="tp", tp=N), seq=run["seq"],
                                 global_batch=run["batch"]), "h100-sxm")
    path = os.path.join(tmp, "plan.json")
    plan.save(path)
    with plan.applied():         # what the sited trunk's sites resolve to
        knobs = {f"tp.layer{i}.mlp.{k}": C.runtime_for(f"tp.layer{i}.mlp.{k}", k).num_chunks
                 for i in range(cfg.num_layers) for k in ("ag", "rs")}
    return dict(torchrun(run, smoke, tmp, ["--tuned-plan", path]), plan_knobs=knobs)


def family_launches(smoke: bool, tmp: str) -> list:
    """``torchrun`` of each of FAMILY_LAUNCHES: 3 steps at 1x4 with no
    plan."""
    out = []
    for run in FAMILY_LAUNCHES:
        run = dict(run, steps=TRAIN["steps"], lr=3e-5)
        if smoke:
            run.update(smoke=True, seq=64)
            run.pop("overrides", None)
        out.append(dict(torchrun(run, smoke, tmp, []), arch=run["arch"]))
    return out


def torchrun(run: dict, smoke: bool, tmp: str, extra: list) -> dict:
    """``repro_torch.launch.train --config`` (``run``) ``--mesh 1x4`` under
    ``torch.distributed.run``, one process a card: the command, its exit
    code, seconds and last lines."""
    import signal

    path = os.path.join(tmp, f"run_{run['arch']}.json")
    with open(path, "w") as f:
        json.dump(run, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(N), "-m", "repro_torch.launch.train", "--config", path, "--mesh", f"1x{N}",
           "--log-every", "1"] + extra
    cmd += ["--device", "cpu"] if smoke else []
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t = time.perf_counter()
    p = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        text = p.communicate(timeout=LAUNCH_WAIT_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)          # torchrun and its workers
        text = p.communicate()[0]
    return {"cmd": " ".join(cmd[1:]), "rc": p.returncode,
            "seconds": time.perf_counter() - t,
            "last_lines": text.strip().splitlines()[-8:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="on the CPU over gloo, at the smoke config's widths")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help=f"comma-separated, of {SECTIONS} (default: all)")
    ap.add_argument("--json", default="",
                    help="also write the result line to this file (it outgrows a "
                         "terminal's tail)")
    args = ap.parse_args()
    sections = tuple(args.sections.split(","))
    if not set(sections) <= set(SECTIONS):
        ap.error(f"--sections: unknown {sorted(set(sections) - set(SECTIONS))}")
    if args.rank is not None:
        return worker(args.rank, args.port, args.smoke, args.out, sections)
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
                                   "--port", str(port), "--out", outs[r],
                                   "--sections", args.sections]
                                  + (["--smoke"] if args.smoke else []),
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(N)]
        deadline = time.monotonic() + WAIT_S
        try:
            # a rank that fails (out of memory, say) leaves the others blocked
            # in NCCL until its timeout: stop them all as soon as one fails
            while True:
                codes = [p.poll() for p in procs]
                if None not in codes or any(codes) or time.monotonic() > deadline:
                    break
                time.sleep(1.0)
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if None in codes or any(codes):
            for r, f in enumerate(logs):
                f.seek(0)
                print(f"--- rank {r}:\n{f.read()[-3000:]}", file=sys.stderr)
            print(f"four_rank_check: worker exit codes {codes} (None: stopped, after "
                  f"another rank failed or {WAIT_S} s)", file=sys.stderr)
            return 1
        for f in logs:
            f.close()
        ranks = []
        for o in outs:
            with open(o) as f:
                ranks.append(json.load(f))
        launches = []
        if "launcher" in sections:
            launches = [dict(run_launcher(args.smoke, tmp), arch="llama3-8b")]
            launches += family_launches(args.smoke, tmp)
    line = json.dumps({"cards": card, "ranks": ranks, "launcher": launches or None})
    print(line)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    failed = [f for r in ranks for f in r["failed"]]
    failed += [f"launcher, {run['arch']}: exit code {run['rc']}" for run in launches
               if run["rc"] != 0 or not any(
                   line.startswith(f"step {TRAIN['steps'] - 1:4d} loss")
                   for line in run["last_lines"])]
    if failed:
        print(f"four_rank_check: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
