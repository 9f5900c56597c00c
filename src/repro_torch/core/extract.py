"""The port's own copy of ``repro.core.extract``.

Lower (ModelConfig × ParallelPlan × InputShape) into the Workload IR.

Overlap structure per parallelism (paper Fig. 2):
  * FSDP: layer-i compute ‖ AllGather(layer i+1 params); backward:
    layer-i grads ‖ [AllGather(params i−1), ReduceScatter(grads i)]
    (the two-comm window of the paper's Pattern 2).
  * TP (Domino-style batch pipelining): attention compute of microbatch b
    ‖ AllReduce of microbatch b−1, same for the MLP half.
  * EP (dual-batch): expert FFN of one half-batch ‖ AlltoAll
    dispatch/combine of the other half.

Compute operators carry FLOPs / bytes / threadblock counts so the
contention model (Eqs. 4–6) can price them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.workload import CommOp, CompOp, OverlapGroup, Workload, matmul_comp


@dataclass(frozen=True)
class ParallelPlan:
    kind: str          # "fsdp" | "tp" | "ep" | "pp"
    dp: int = 1        # data-parallel degree (FSDP shard count for "fsdp")
    tp: int = 1
    ep: int = 1
    pp: int = 1        # pipeline stages
    microbatches: int = 2      # Domino / dual-batch pipelining depth
    dsize: int = 2             # bytes per element (bf16)
    # hierarchical-fabric axes (core.topology): ``pods`` replicas of the
    # plan's island joined by a slow inter-pod fabric.  ``accum_steps`` > 1
    # turns on ACCO-style gradient accumulation — per-layer groups shrink
    # to one microbatch and ``acc.step{k}`` groups hide microbatch k's grad
    # reduce under microbatch k+1's compute.  ``outer_frags`` > 0 (with
    # pods > 1) adds Streaming-DiLoCo ``outer.round{r}.sync.frag{f}``
    # groups: fragment-streamed cross-pod parameter sync hidden under the
    # next inner iteration's compute.
    pods: int = 1
    accum_steps: int = 1
    outer_frags: int = 0
    outer_rounds: int = 1

    @property
    def world(self) -> int:
        return max(self.dp, 1) * max(self.tp, 1) * max(self.ep, 1) \
            * max(self.pods, 1)


# ---------------------------------------------------------------------------
# per-layer compute ops
# ---------------------------------------------------------------------------

def _attn_ops(cfg, m: int, seq: int, batch_local: int, tp: int, dsize: int,
              tag: str) -> List[CompOp]:
    hd = cfg.head_dim
    hq = max(1, cfg.num_heads // tp)
    hkv = max(1, cfg.num_kv_heads // tp)
    ops = [
        matmul_comp(f"{tag}.qkv", m, cfg.d_model, (hq + 2 * hkv) * hd, dsize),
    ]
    ctx = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    sdpa_flops = 2 * 2 * batch_local * hq * seq * ctx * hd / 2  # causal half
    sdpa_bytes = dsize * batch_local * seq * (hq + 2 * hkv + hq) * hd
    mu = max(1, batch_local * hq * math.ceil(seq / 128) * math.ceil(min(ctx, seq) / 512))
    ops.append(CompOp(f"{tag}.sdpa", sdpa_flops, sdpa_bytes, mu))
    ops.append(matmul_comp(f"{tag}.o", m, hq * hd, cfg.d_model, dsize))
    return ops


def _mlp_ops(cfg, m: int, tp: int, dsize: int, tag: str) -> List[CompOp]:
    f = max(1, cfg.d_ff // tp)
    n_in = 2 if cfg.mlp_kind == "swiglu" else 1
    ops = [matmul_comp(f"{tag}.up{i}", m, cfg.d_model, f, dsize) for i in range(n_in)]
    ops.append(matmul_comp(f"{tag}.down", m, f, cfg.d_model, dsize))
    return ops


def _expert_ops(cfg, tokens_local: int, ep: int, dsize: int, tag: str) -> List[CompOp]:
    # balanced routing: each device computes tokens_local·top_k expert-token
    # pairs across its num_experts/ep local experts
    m = max(1, tokens_local * cfg.top_k)
    f = cfg.moe_d_ff
    ops = [matmul_comp(f"{tag}.e_up{i}", m, cfg.d_model, f, dsize) for i in range(2)]
    ops.append(matmul_comp(f"{tag}.e_down", m, f, cfg.d_model, dsize))
    if cfg.num_shared_experts:
        sf = cfg.shared_d_ff or cfg.moe_d_ff * cfg.num_shared_experts
        ops += [matmul_comp(f"{tag}.s_up{i}", tokens_local, cfg.d_model, sf, dsize)
                for i in range(2)]
        ops.append(matmul_comp(f"{tag}.s_down", tokens_local, sf, cfg.d_model, dsize))
    return ops


def _layer_param_bytes(cfg, dsize: int) -> float:
    per_layer = cfg.param_count() - cfg.vocab_size * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    return per_layer / max(1, cfg.num_layers) * dsize


def _scale(ops: List[CompOp], s: float, suffix: str) -> List[CompOp]:
    return [CompOp(o.name + suffix, o.flops * s, o.bytes_rw * s,
                   max(1, int(o.threadblocks * s)), o.tb_per_slot)
            for o in ops]


# ---------------------------------------------------------------------------
# workload builders
# ---------------------------------------------------------------------------

def extract_workload(cfg, plan: ParallelPlan, *, seq: int, global_batch: int,
                     decode: bool = False, layers: Optional[int] = None) -> Workload:
    L = layers or cfg.num_layers
    dsize = plan.dsize
    if decode:
        seq_q = 1
    else:
        seq_q = seq
    # under gradient accumulation the per-layer groups describe ONE
    # microbatch (1/accum_steps of the local batch); the other microbatches
    # live in the aggregated ``acc.step{k}`` groups appended below
    accum = max(1, plan.accum_steps) if not decode else 1
    batch_local = max(1, global_batch // max(1, plan.dp) // accum)
    m = batch_local * seq_q
    groups: List[OverlapGroup] = []

    if plan.kind == "fsdp":
        n = plan.dp
        pbytes = _layer_param_bytes(cfg, dsize)
        comp = (_attn_ops(cfg, m, seq, batch_local, 1, dsize, "attn")
                + _mlp_ops(cfg, m, 1, dsize, "mlp"))
        for i in range(L):
            groups.append(OverlapGroup(
                f"fwd.L{i}", comps=list(comp),
                comms=[CommOp(f"ag.L{i + 1}", "allgather", pbytes, n,
                              site=f"fsdp.layer{i + 1}.ag_params")]))
        if not decode:
            bcomp = _scale(comp, 2.0, ".bwd")
            for i in range(L):
                comms = [CommOp(f"ag.L{i - 1}", "allgather", pbytes, n,
                                site=f"fsdp.layer{i - 1}.ag_params.bwd")]
                if accum == 1:
                    # with accumulation, grads stay local per layer and the
                    # whole-model reduce moves to the acc.step{k} groups
                    comms.append(CommOp(f"rs.L{i}", "reducescatter", pbytes,
                                        n, site=f"fsdp.layer{i}.rs_grads"))
                groups.append(OverlapGroup(
                    f"bwd.L{i}", comps=list(bcomp), comms=comms))

    elif plan.kind == "tp":
        n = plan.tp
        mb = max(1, plan.microbatches)
        m_mb = max(1, m // mb)
        b_mb = max(1, batch_local // mb)
        ar_bytes = m_mb * cfg.d_model * dsize
        attn = _attn_ops(cfg, m_mb, seq, b_mb, n, dsize, "attn")
        mlp = _mlp_ops(cfg, m_mb, n, dsize, "mlp")
        passes = [("fwd", 1.0)] if decode else [("fwd", 1.0), ("bwd", 2.0)]
        for pname, s in passes:
            for i in range(L):
                groups.append(OverlapGroup(
                    f"{pname}.L{i}.attn",
                    comps=_scale(attn, s * mb, f".{pname}"),
                    comms=[CommOp(f"ar.attn.{pname}.L{i}.mb{b}", "allreduce",
                                  ar_bytes * s, n,
                                  site=f"tp.layer{i}.attn.ar.{pname}.mb{b}")
                           for b in range(mb)]))
                groups.append(OverlapGroup(
                    f"{pname}.L{i}.mlp",
                    comps=_scale(mlp, s * mb, f".{pname}"),
                    comms=[CommOp(f"ar.mlp.{pname}.L{i}.mb{b}", "allreduce",
                                  ar_bytes * s, n,
                                  site=f"tp.layer{i}.mlp.ar.{pname}.mb{b}")
                           for b in range(mb)]))

    elif plan.kind == "pp":
        # GPipe fill+drain: per tick, each stage's compute overlaps the
        # ppermute of the previous tick's activations to the next stage.
        n = max(2, plan.pp)
        layers_per_stage = max(1, L // n)
        mb = max(1, plan.microbatches)
        m_mb = max(1, m // mb)
        b_mb = max(1, batch_local // mb)
        stage_comp = (_attn_ops(cfg, m_mb, seq, b_mb, 1, dsize, "attn")
                      + _mlp_ops(cfg, m_mb, 1, dsize, "mlp"))
        stage_comp = _scale(stage_comp, float(layers_per_stage), ".stage")
        act_bytes = m_mb * cfg.d_model * dsize
        passes = [("fwd", 1.0)] if decode else [("fwd", 1.0), ("bwd", 2.0)]
        for pname, s in passes:
            for t in range(n + mb - 1):
                groups.append(OverlapGroup(
                    f"{pname}.tick{t}",
                    comps=_scale(stage_comp, s, f".{pname}"),
                    comms=[CommOp(f"p2p.{pname}.t{t}", "permute",
                                  act_bytes * s, n,
                                  site=f"pp.tick{t}.p2p.{pname}")]))

    elif plan.kind == "ep":
        n = plan.ep
        tokens_local = m
        halves = 2
        t_half = max(1, tokens_local // halves)
        a2a_bytes = t_half * cfg.top_k * cfg.d_model * dsize / n
        attn = _attn_ops(cfg, m, seq, batch_local, 1, dsize, "attn")
        experts = _expert_ops(cfg, t_half, n, dsize, "moe")
        moe_layers = max(1, L - cfg.first_dense_layers)
        passes = [("fwd", 1.0)] if decode else [("fwd", 1.0), ("bwd", 2.0)]
        for pname, s in passes:
            for i in range(moe_layers):
                groups.append(OverlapGroup(
                    f"{pname}.L{i}.attn", comps=_scale(attn, s, f".{pname}"), comms=[]))
                groups.append(OverlapGroup(
                    f"{pname}.L{i}.moe",
                    comps=_scale(experts, s * halves, f".{pname}"),
                    comms=[CommOp(f"a2a.{d}.{pname}.L{i}.h{h}", "alltoall",
                                  a2a_bytes * s, n,
                                  site=f"ep.layer{i}.moe.a2a_{d}.{pname}.h{h}")
                           for h in range(halves) for d in ("disp", "comb")]))
    else:
        raise ValueError(plan.kind)

    meta = {"seq": seq, "global_batch": global_batch}

    # -- ACCO gradient-accumulation overlap (acc.step{k} site class) -------
    # One microbatch's aggregate compute (the per-layer groups above are
    # exactly one microbatch when accum > 1), measured before acc/outer
    # groups are appended.
    mb_flops = sum(c.flops for g in groups for c in g.comps)
    mb_bytes = sum(c.bytes_rw for g in groups for c in g.comps)
    mb_tbs = sum(c.threadblocks for g in groups for c in g.comps)
    # a ``layers=`` trim scales the per-layer compute groups above, so the
    # whole-model reduce payloads scale with it too — otherwise a trimmed
    # workload's acc/outer groups price a 32-layer reduce against 4 layers
    # of compute
    param_bytes = cfg.param_count() * dsize * L / max(1, cfg.num_layers)
    shards = {"fsdp": plan.dp, "tp": plan.tp, "ep": plan.ep,
              "pp": plan.pp}[plan.kind]
    owned_bytes = param_bytes / max(1, shards)   # per-chip parameter shard

    if accum > 1:
        for k in range(accum):
            comms = []
            if plan.kind == "fsdp" and plan.dp > 1:
                # microbatch k's whole-model grad reduce across the pod-local
                # dp axis (replaces the per-layer rs_grads dropped above)
                comms.append(CommOp(
                    f"rs.grads.s{k}", "reducescatter", param_bytes, plan.dp,
                    site=f"acc.step{k}.rs_grads"))
            if plan.pods > 1:
                # the owned shard then reduces across pods on the slow tier
                comms.append(CommOp(
                    f"ar.grads.s{k}", "allreduce", owned_bytes, plan.pods,
                    site=f"acc.step{k}.ar_grads", tier="inter"))
            # hidden under microbatch k+1's compute; the last step has no
            # next microbatch — its reduce is the exposed tail
            comps = [] if k == accum - 1 else [
                CompOp(f"acc.mb{k + 1}.compute", mb_flops, mb_bytes,
                       max(1, mb_tbs))]
            groups.append(OverlapGroup(f"acc.step{k}", comps=comps,
                                       comms=comms))
        meta["accum_steps"] = float(accum)

    # -- Streaming-DiLoCo outer-loop sync (outer.round{r} site class) ------
    if plan.outer_frags > 0 and plan.pods > 1 and not decode:
        frags = plan.outer_frags
        frag_bytes = owned_bytes / frags
        iter_flops = mb_flops * accum            # one full inner iteration
        iter_bytes = mb_bytes * accum
        iter_tbs = mb_tbs * accum
        for r in range(max(1, plan.outer_rounds)):
            groups.append(OverlapGroup(
                f"outer.round{r}",
                comps=[CompOp(f"outer.r{r}.inner_iter", iter_flops,
                              iter_bytes, max(1, iter_tbs))],
                comms=[CommOp(f"outer.sync.r{r}.f{f}", "allreduce",
                              frag_bytes, plan.pods,
                              site=f"outer.round{r}.sync.frag{f}",
                              tier="inter")
                       for f in range(frags)]))
        meta["outer_frags"] = float(frags)
    if plan.pods > 1:
        meta["pods"] = float(plan.pods)

    total_flops = sum(g.total_flops for g in groups)
    meta["flops"] = total_flops
    return Workload(name=f"{cfg.name}:{plan.kind}", groups=groups, meta=meta)


def extract_decode_workload(cfg, plan: ParallelPlan, *, global_batch: int,
                            seq: int) -> Workload:
    """One *serving decode step* under ``plan``, with ``serve.*`` SiteIds.

    Unlike the per-kind training extractions above, serving deploys one
    combined topology: every layer contributes an attention group (TP
    AllReduce at ``serve.layer{i}.attn.ar``) plus either a dense MLP group
    (``serve.layer{i}.mlp.ag`` / ``.rs`` — the ``dense.tp_mlp`` pair) or a
    MoE group (``serve.layer{i}.moe.a2a_disp`` / ``.a2a_comb``), with
    ``i`` the *global* layer index — exactly the sites the sited decode
    path (``model.decode_step(mesh=...)``) resolves at trace time.  Comms
    appear only for degrees > 1, so a ``tp:1``/``ep:1`` plan yields a
    collective-free (but still fingerprintable) workload.

    ``global_batch`` is the number of sequences in flight (= tokens per
    decode step); ``seq`` the KV-cache context length.  Both land in
    ``meta`` as the banded shape coordinates tolerance-band repository
    resolution interpolates over.
    """
    dsize = plan.dsize
    tp = max(1, plan.tp)
    ep = max(1, plan.ep)
    m = max(1, global_batch)           # one token per in-flight sequence
    groups: List[OverlapGroup] = []
    attn = _attn_ops(cfg, m, seq, m, tp, dsize, "attn")
    mlp = _mlp_ops(cfg, m, tp, dsize, "mlp")
    act_bytes = m * cfg.d_model * dsize
    for i in range(cfg.num_layers):
        attn_comms = []
        if tp > 1:
            attn_comms.append(CommOp(f"ar.L{i}", "allreduce", act_bytes, tp,
                                     site=f"serve.layer{i}.attn.ar"))
        groups.append(OverlapGroup(f"decode.L{i}.attn", comps=list(attn),
                                   comms=attn_comms))
        if cfg.is_moe and i >= cfg.first_dense_layers:
            experts = _expert_ops(cfg, max(1, m // ep), ep, dsize, "moe")
            moe_comms = []
            if ep > 1:
                a2a_bytes = m * cfg.top_k * cfg.d_model * dsize / ep
                moe_comms = [CommOp(f"a2a.{d}.L{i}", "alltoall", a2a_bytes,
                                    ep, site=f"serve.layer{i}.moe.a2a_{d}")
                             for d in ("disp", "comb")]
            groups.append(OverlapGroup(f"decode.L{i}.moe", comps=experts,
                                       comms=moe_comms))
        else:
            mlp_comms = []
            if tp > 1:
                mlp_comms = [CommOp(f"ag.L{i}", "allgather", act_bytes, tp,
                                    site=f"serve.layer{i}.mlp.ag"),
                             CommOp(f"rs.L{i}", "reducescatter", act_bytes,
                                    tp, site=f"serve.layer{i}.mlp.rs")]
            groups.append(OverlapGroup(f"decode.L{i}.mlp", comps=list(mlp),
                                       comms=mlp_comms))
    total_flops = sum(g.total_flops for g in groups)
    return Workload(name=f"{cfg.name}:serve", groups=groups,
                    meta={"flops": total_flops, "seq": seq,
                          "global_batch": global_batch, "decode": 1.0})


def parse_parallel(spec: str) -> ParallelPlan:
    """``kind[:degree[:microbatches]]`` -> ``ParallelPlan`` — e.g.
    ``fsdp:8``, ``tp:4``, ``ep:16``, ``pp:4:8``.  The degree lands on the
    kind's own axis (dp for fsdp)."""
    parts = spec.split(":")
    kind = parts[0]
    deg = int(parts[1]) if len(parts) > 1 else 8
    mb = int(parts[2]) if len(parts) > 2 else 2
    axes = {"fsdp": "dp", "tp": "tp", "ep": "ep", "pp": "pp"}
    if kind not in axes:
        raise ValueError(f"unknown parallel kind {kind!r} in {spec!r} "
                         f"(expected one of {sorted(axes)})")
    return ParallelPlan(kind=kind, microbatches=mb, **{axes[kind]: deg})
