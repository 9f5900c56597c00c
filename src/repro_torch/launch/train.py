"""Training launcher of the port (the counterpart of ``repro.launch.train``),
on the card unless ``--device cpu`` is asked for.

    python -m repro_torch.launch.train --arch llama3-8b --smoke --steps 50
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --config run.json \\
        --mesh 1x4 --tuned-plan plan.json --ckpt ckpt/
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --mesh 1x4 --seq 2048 --batch 4 --lr 3e-5

``--arch`` takes the dense family (llama3-8b), the dense families of
Lagom's Table 2 and their kin (phi2-2b, mpt-7b, phi4-mini-3.8b,
stablelm-3b, h2o-danube-1.8b: parallel block, GELU, ALiBi, LayerNorm,
a sliding window), the MoE models (olmoe-1b-7b, deepseek-moe-16b,
qwen2-moe-a2.7b) and the other families (whisper-small,
deepseek-v2-lite-16b's MLA, qwen2-vl-72b's M-RoPE), on one process or
under ``--mesh``, and the hybrid zamba2-7b on one process (its placement
and rwkv6-1.6b's training raise ``NotImplementedError`` naming their
ROADMAP items); the loss adds
``router_aux_coef`` times the routers' load-balancing loss, printed as
``aux``.  An audio model's every batch carries the stub frames that the
reference's ``data.pipeline.make_batch`` draws (``data.pipeline.
stub_inputs``: the same for every step); a vlm model trains on its tokens
alone, as the reference's launcher feeds it.  (The reference's launcher
gives whisper no frames, and fails with ``KeyError: 'frames'``.)

The flags are the reference's, with ``--plan-hardware`` defaulting to
``h100-sxm``, plus ``--device``.  Without ``--mesh`` one process trains
(``train.trainer.train_loop``).  With ``--mesh DxM`` the launcher runs
under ``torchrun``, one process a card: the world size must be D·M, each
rank takes the card ``LOCAL_RANK``, and the process group is NCCL on the
card and gloo for ``--device cpu`` (a group the caller already initialised
is used as it is).  Pure FSDP over D ranks is ``--mesh Dx1``; ``--mesh D``
raises ``ValueError`` naming it (the reference's launcher fails there with
``KeyError: 'model'``).

Every rank draws the weights from seed 0 a module at a time and keeps its
slice of each before the next is drawn (``models.model.init_placed``:
``shard_`` of ``init_params``' weights, the reference's
``parallel/sharding.py`` rules, as its launcher places the parameters with
``device_put``), so no card holds the whole model:

  * the ``data`` axis splits every F dim that it divides (FSDP): each
    layer gathers its weights over ``data`` inside its checkpoint, the
    head once for the loss and the embedding once for the lookup, and
    the gradients come back reduce-scattered.  Each data rank takes its
    rows of the global batch (``sharding.batch_specs``), and the gradients
    of the leaves that stay whole, the loss and its metrics are averaged
    over the axis, so the printed loss is the global batch's, as the
    reference's.
  * the ``model`` axis splits the T dims and always runs the sited
    trunk: attention by whole heads (GQA, whisper's bidirectional and
    cross-attention, MLA), summed at ``tp.layer{i}.attn.ar``; every dense
    layer's MLP over the explicit chunked collectives at
    ``tp.layer{i}.mlp.ag|rs``, every MoE layer's experts over the chunked
    all-to-alls at ``ep.layer{j}.moe.a2a_disp|comb`` (expert parallelism),
    resolved against the plan ``--tuned-plan`` or ``--plan-repo``
    installs; with no plan each site takes its default structure,
    numerically the reference's GSPMD scan.  The embedding and the head
    split their vocabulary where the axis divides it.  Whisper's encoder
    layers take the sites ``tp.enc{i}.*``.
  * ``constraints.use_axes(("data",), "model")`` is installed, as the
    reference's launcher does; its helpers check that each activation
    holds this rank's share of the batch.
  * ``--accumulate`` only sets ``--grad-accum``, as in the reference: the
    launcher does not run ACCO.

``--ckpt`` writes the final parameters as the reference's tree in its
checkpoint layout (``train.checkpoint``), which
``repro.train.checkpoint.restore`` reads: every rank gathers each leaf
whole, one at a time, to the host, and global rank 0 writes them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_to_jax
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, stub_inputs
from repro_torch.launch.config import load_run_config, merge_cli, resolve_model
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.plan import apply_tuned_plan, resolve_plan_repo
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import constraints as CT, sharding
from repro_torch.train import checkpoint
from repro_torch.train.trainer import TrainConfig, make_train_step, train_loop


def _init_distributed(device) -> torch.device:
    """This rank's device (``cuda:LOCAL_RANK`` on the card, set current
    before any NCCL call), with the default process group initialised from
    ``torchrun``'s environment unless it already is."""
    dev = M.resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError("--mesh runs one process a rank: start it with torchrun "
                               "(or initialise the process group first)")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                **({"device_id": dev} if dev.type == "cuda" else {}))
    return dev


def mesh_shape(spec: str):
    """``--mesh DxM`` -> (D, M); one number raises, naming ``Dx1``."""
    shape = tuple(int(x) for x in spec.split("x"))
    if len(shape) != 2:
        raise ValueError(f"--mesh {spec}: the mesh is data x model; pure FSDP over "
                         f"{shape[0]} ranks is --mesh {shape[0]}x1")
    return shape


def _rows(batch, specs, data_m):
    """This data rank's rows of each leaf of the global ``batch``, by its
    ``sharding.batch_specs`` spec (the whole leaf where the batch is not
    split)."""
    out = {}
    for n, a in batch.items():
        if specs[n][0] is None:
            out[n] = a
        else:
            k = a.shape[0] // data_m.size
            out[n] = a[data_m.rank * k:(data_m.rank + 1) * k]
    return out


def _train_on_mesh(cfg, tcfg, data, args):
    """``args.steps`` steps on the (data, model) mesh; returns (model,
    losses, step seconds)."""
    shape = mesh_shape(args.mesh)
    M.check_placement(cfg)          # before any process group is started
    dev = _init_distributed(args.device)
    meshes = make_mesh(shape, ("data", "model"))
    data_m, model_m = meshes["data"], meshes["model"]
    sizes = {"data": data_m.size, "model": model_m.size}
    tcfg = dataclasses.replace(tcfg, sited_mesh=model_m,
                               data_axis=data_m if data_m.size > 1 else None)
    model = M.init_placed(cfg, 0, meshes, device=dev)
    opt_state = adamw.init_state(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, tcfg)
    losses, times = [], []
    with CT.use_axes(("data",), "model", sizes=sizes, batch=args.batch):
        for step in range(args.steps):
            batch = next(data)
            specs = sharding.batch_specs(cfg, {n: a.shape for n, a in batch.items()}, sizes)
            batch = {n: torch.as_tensor(a, device=dev)
                     for n, a in _rows(batch, specs, data_m).items()}
            t = time.perf_counter()
            model, opt_state, metrics = step_fn(model, opt_state, batch, step)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t)
            if dist.get_rank() == 0 and step % args.log_every == 0:
                print(f"step {step:4d} loss {losses[-1]:.4f}  aux "
                      f"{float(metrics['aux']):.4f}  {times[-1] * 1e3:.1f} ms")
    return model, losses, times


def main(argv=None):
    """Parse ``argv``, train, and write the checkpoint.  Returns {"model",
    "losses", "step_s", "ckpt_s"}: the trained model (this rank's shards
    under ``--mesh``), each step's loss and host seconds, and the seconds
    the checkpoint took to gather and write (None without ``--ckpt``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="JSON run config (CLI flags override file values)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (2 layers, d_model<=256)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--mesh", default=None,
                    help="DxM, e.g. 2x4 -> (data=2, model=4), 4x1 pure FSDP; the "
                         "world size must be D*M")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--tuned-plan", default=None,
                    help="saved TunedPlan JSON: lowered to per-site collective "
                         "runtime knobs and installed for this run (the sited "
                         "trunk's tp.layer*.mlp sites on the --mesh path)")
    ap.add_argument("--plan-repo", default=None,
                    help="PlanRepository directory: resolve a stored plan matching "
                         "this launch's (workload fingerprint, hardware) with zero "
                         "tuning work; untuned with a warning on a miss "
                         "(--tuned-plan, if also given, wins)")
    ap.add_argument("--plan-parallel", default="fsdp:8",
                    help="parallel spec the repo lookup fingerprints the workload "
                         "under: kind[:degree[:microbatches]], e.g. fsdp:8, tp:4")
    ap.add_argument("--plan-hardware", default="h100-sxm",
                    help="hardware profile name for the repo lookup key")
    ap.add_argument("--pods", type=int, default=1,
                    help="pod count of the hierarchical topology this run spans; >1 "
                         "makes the plan lookup key the topology name")
    ap.add_argument("--inter-pod", default="dcn",
                    help="inter-pod fabric joining the pods (core.topology built-ins: "
                         "dcn, wan, pcie-switch)")
    ap.add_argument("--accumulate", type=int, default=0,
                    help="ACCO gradient-accumulation steps: sets grad_accum and "
                         "registers acc.step*.{rs,ar}_grads sites in the plan lookup")
    ap.add_argument("--outer-sync", type=int, default=0,
                    help="streamed outer-loop sync fragments (Streaming DiLoCo): "
                         "registers outer.round*.sync.* sites in the plan lookup "
                         "(needs --pods > 1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for ('cpu')")
    args = ap.parse_args(argv)

    if args.config:
        run = merge_cli(load_run_config(args.config), args, defaults=dict(
            steps=100, seq=256, batch=8, lr=3e-4, grad_accum=1,
            mesh=None, ckpt=None, log_every=10))
        if args.arch:
            run["arch"] = args.arch
        for k, v in run.items():
            if hasattr(args, k) and k != "overrides":
                setattr(args, k, v)
        cfg = resolve_model(run)
    else:
        if not args.arch:
            ap.error("--arch or --config required")
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.accumulate > 1:
        args.grad_accum = args.accumulate
    if args.tuned_plan:
        apply_tuned_plan(args.tuned_plan, expect_arch=cfg.name)
    elif args.plan_repo:
        plan_hw = args.plan_hardware
        if args.pods > 1:
            from repro_torch.core import topology
            plan_hw = topology.hierarchical(args.plan_hardware, args.pods,
                                            args.inter_pod).name
        resolve_plan_repo(args.plan_repo, cfg, parallel=args.plan_parallel,
                          hardware=plan_hw, seq=args.seq, global_batch=args.batch,
                          pods=args.pods, accum_steps=max(1, args.accumulate),
                          outer_frags=args.outer_sync)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                        global_batch=args.batch))
    # an audio model's batches carry its stub frames; a vlm model trains on
    # tokens alone, as the reference's launcher does
    frames = stub_inputs(cfg, args.batch) if cfg.family == "audio" else {}
    data = (dict(b, **frames) for b in corpus)
    tcfg = TrainConfig(opt=adamw.AdamWConfig(lr=args.lr), warmup=max(5, args.steps // 10),
                       total_steps=args.steps, grad_accum=args.grad_accum)

    owned = args.mesh and not dist.is_initialized()
    ckpt_s = None
    try:
        if args.mesh:
            model, losses, times = _train_on_mesh(cfg, tcfg, data, args)
        else:
            model, history = train_loop(cfg, tcfg, data, steps=args.steps,
                                        log_every=args.log_every, device=args.device)
            losses, times = history["loss"], history["step_time"]
        if args.ckpt:
            t = time.perf_counter()
            tree = params_to_jax(cfg, model)       # every rank: gathers each leaf
            if not dist.is_initialized() or dist.get_rank() == 0:
                checkpoint.save(args.ckpt, tree, step=args.steps)
                print(f"checkpoint written to {args.ckpt}")
            if dist.is_initialized():
                dist.barrier()
            ckpt_s = time.perf_counter() - t
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    if not args.mesh and losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return {"model": model, "losses": losses, "step_s": times, "ckpt_s": ckpt_s}


if __name__ == "__main__":
    main()
