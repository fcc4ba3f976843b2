"""The training launcher: mesh + step + data + fault tolerance, for any
assigned LM architecture (`--arch`) or a 2-layer EnGN stack (`--gnn`),
under the fault-tolerant runner and atomic checkpoints.

    # LM mode, smoke-scale on the CPU (reduced config, 1x1 mesh):
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        --smoke --steps 20 --device cpu

    # LM mode on the card (the default device), the full config:
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        --batch 1 --seq 512 --steps 4

    # GNN mode on the card
    PYTHONPATH=src python -m repro_torch.launch.train --gnn gcn \\
        --gnn-backend blocked --dataset pubmed --steps 100

    # on the CPU, through the kernels' plain versions, replaying a
    # seeded fault schedule
    PYTHONPATH=src python -m repro_torch.launch.train --gnn gcn \\
        --gnn-backend blocked --device cpu --steps 20 --chaos-seed 3

    # the sharded ring: 4 shards, co-located on the one card
    PYTHONPATH=src python -m repro_torch.launch.train --gnn gcn \\
        --gnn-backend ring --gnn-shards 4 --steps 30

LM mode trains the `configs/` architecture (fp32 master weights, the
config's compute dtype, AdamW on the config's cosine / WSD schedule,
`--micro-steps` gradient accumulation), its state updated in place as
the reference donates it to its jitted step.  GNN mode trains on
`segment`, `blocked` (dense or packed tiles, as the format autotuner
picks), `fused`, the sharded `ring` and the streamed `tiled`, `tiled`
directly or by a budget spill (`--device-budget`: a plan over it
streams the graph from the host, its backward re-streaming the
transposed tiles or running B5^T over the device queue; on the ring the
budget is per shard); `--gnn rgcn` (a 3-type edge colouring, `rel =
(src + dst) % 3`) and `--gnn gated_gcn` train on `segment`, `blocked`,
`ring` and `tiled`, and refuse `fused` as the reference does.  Shard
loss and straggler strikes re-mesh the ring (`ElasticGNNTrainer`);
`--chaos-seed` replays the reference's seeded fault schedule (shard
loss, a transient, a straggler, a torn save) on a virtual clock.
Both modes run on `cuda` unless the caller passes `--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed.fault import FaultConfig, FaultTolerantRunner


def build(arch: str, *, smoke: bool, batch: int, seq: int, steps: int,
          micro_steps: int = 1, peak_lr: float = 3e-4,
          q_chunk: int = 512, loss_chunk: int = 256, device=None,
          cfg=None):
    """Assemble (mesh, step, init_state, data, cfg), as the reference's
    `build`: the config (`SMOKE` with `smoke`; `cfg` overrides both),
    the mesh for the visible devices (1x1 for one), the train step
    (gradient accumulation over `micro_steps`) whose activations pass
    the mesh's constrainer, parameters drawn from seed 0 and AdamW
    state on `device` (`cuda` unless the caller passes "cpu"), and the
    token stream (seed 0).  The step updates the state in place."""
    from repro_torch.data.pipeline import SyntheticTokenStream
    from repro_torch.device import resolve_device, visible_devices
    from repro_torch.distributed.sharding import Constrainer, make_rules
    from repro_torch.launch.mesh import make_elastic_mesh, single_device_mesh
    from repro_torch.nn import transformer as T
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_lib import (make_grad_accum_train_step,
                                                make_train_step)

    dev = resolve_device(device)
    if cfg is None:
        cfg = get_smoke(arch) if smoke else get_config(arch)
    n_dev = visible_devices(dev)
    mesh = (single_device_mesh(dev) if n_dev == 1
            else make_elastic_mesh(n_dev, device=dev))
    rules = make_rules(mesh)
    sc = Constrainer(mesh, rules)

    q_chunk = min(q_chunk, seq)
    loss_chunk = min(loss_chunk, seq)
    if micro_steps > 1:
        step = make_grad_accum_train_step(
            cfg, sc=sc, micro_steps=micro_steps, peak_lr=peak_lr,
            total_steps=steps, q_chunk=q_chunk, loss_chunk=loss_chunk,
            donate=True)
    else:
        step = make_train_step(cfg, sc=sc, peak_lr=peak_lr,
                               total_steps=steps, q_chunk=q_chunk,
                               loss_chunk=loss_chunk, donate=True)
    params = T.init_params(cfg, seed=0, device=dev)
    opt = init_opt_state(params)
    data = SyntheticTokenStream(cfg.vocab_size, batch=batch, seq=seq,
                                seed=0)
    return mesh, step, {"params": params, "opt": opt}, data, cfg


def batch_to_device(cfg, batch, device):
    """A token batch (numpy) as tensors on `device`.  The vlm / encdec
    stub frontends get bf16 embeddings (image patches, speech frames)
    drawn by numpy from the batch's first tokens, so a replayed batch
    gets the same ones on any device."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    b, s = batch["tokens"].shape
    if cfg.family in ("vlm", "encdec"):
        rng = np.random.default_rng(batch["tokens"][:, 0].astype(np.int64))
        key, shape = (("image_embeds", (b, cfg.n_patches, cfg.d_model))
                      if cfg.family == "vlm" else
                      ("frames", (b, s, cfg.d_model)))
        emb = rng.standard_normal(shape, dtype=np.float32)
        out["extras"] = {key: torch.from_numpy(emb).to(device).to(
            torch.bfloat16)}
    return out


def build_gnn(*, model: str, dataset: str, backend: str, steps: int,
              hidden: int = 32, batch: int = 256,
              ring_shards=None, device_budget_bytes=None,
              max_vertices: int = 4000, max_edges: int = 30_000,
              peak_lr: float = 5e-3, seed: int = 0, device=None,
              reference_params=None, strike_limit: int = 3):
    """Assemble (train_step, init_state, data, plan, aux) for a 2-layer
    EnGN stack, as the reference's `build_gnn`: the dataset's R-MAT
    stand-in (F capped at 128), GCN-normalised; labels from a hidden
    GCN teacher [F, 16, classes] on the `segment` backend; the student
    [F, hidden, classes] on `backend` with `cfg.training=True`, so the
    budget gate prices the backward's buffers.  `backend="ring"` trains
    on `ring_shards` shards (default: the visible devices), gradients
    flowing back through the rotation; the trainer (`aux["trainer"]`)
    re-meshes it on shard loss or `strike_limit` straggler strikes.

    `rgcn` colours the (untyped) dataset's edges with 3 types, `rel =
    (src + dst) % 3`, as the reference does, so the typed contract runs
    end to end.

    The weights are drawn from the port's seeded generators (student
    `seed`, teacher 42) unless `reference_params` gives them as the
    reference's per-layer dicts, `{"student": [...], "teacher": [...]}`
    (numpy, through `interop.load_reference_params`).  The plan and the
    tensors live on `device` (`cuda` unless the caller passes "cpu")."""
    from repro_torch.core.engn import prepare_graph
    from repro_torch.core.models import (apply_stack, make_gnn_stack,
                                         stack_params)
    from repro_torch.data.pipeline import GraphNodeStream
    from repro_torch.device import resolve_device
    from repro_torch.graphs.generate import make_dataset, random_features
    from repro_torch.interop import load_reference_params
    from repro_torch.launch.elastic_gnn import ElasticGNNTrainer
    from repro_torch.training.optimizer import init_opt_state

    dev = resolve_device(device)
    refs = reference_params or {}
    g, f, classes = make_dataset(dataset, max_vertices=max_vertices,
                                 max_edges=max_edges)
    f = min(f, 128)
    x = torch.from_numpy(random_features(g.num_vertices, f,
                                         seed=seed)).to(dev)
    gn = g.gcn_normalized()

    # synthetic ground truth from a hidden teacher (segment reference)
    teacher = make_gnn_stack("gcn", [f, 16, classes], device=dev, seed=42)
    if "teacher" in refs:
        load_reference_params(teacher, refs["teacher"])
    with torch.no_grad():
        y_true = torch.argmax(apply_stack(
            teacher, prepare_graph(gn, teacher[0].cfg, device=dev), x), -1)

    num_rel = 1
    if model == "rgcn":
        num_rel = 3
        rel = ((gn.src.astype(np.int64) + gn.dst) % num_rel).astype(np.int32)
        gn = dataclasses.replace(gn, rel=rel, num_relations=num_rel)
    layers = make_gnn_stack(model, [f, hidden, classes], backend=backend,
                            num_relations=num_rel, device=dev, seed=seed)
    for layer in layers:
        layer.cfg.ring_shards = ring_shards
        layer.cfg.device_budget_bytes = device_budget_bytes
        # price the budget gate for forward AND backward buffers
        layer.cfg.training = True
    if "student" in refs:
        load_reference_params(layers, refs["student"])
    params = stack_params(layers)

    trainer = ElasticGNNTrainer(layers=layers, graph=gn, x=x,
                                y_true=y_true, hidden=hidden,
                                peak_lr=peak_lr, steps=steps,
                                strike_limit=strike_limit)
    data = GraphNodeStream(g.num_vertices, classes, batch=batch, seed=1)
    state = {"params": params, "opt": init_opt_state(params)}
    aux = {"layers": layers, "graph": trainer.plan, "x": x,
           "y_true": y_true, "num_classes": classes, "trainer": trainer}
    return trainer.step, state, data, trainer.plan, aux


def run_gnn(args):
    """--gnn entry point: fault-tolerant GNN training on the chosen
    aggregation backend, resuming from the newest checkpoint in
    `--ckpt-dir`; `--chaos-seed` replays `FaultPlan.sample(seed, steps)`
    against the run (the step and the checkpoint manager wrapped, a
    virtual clock in the runner).  Returns {"start", "steps", "losses",
    "saves", "runner" (the runner's stats), "trainer" (the trainer's
    stats), "injector" (the `ChaosInjector`, or None)}."""
    step, state, data, gd, aux = build_gnn(
        model=args.gnn, dataset=args.dataset, backend=args.gnn_backend,
        steps=args.steps, hidden=args.gnn_hidden, batch=args.batch,
        ring_shards=args.gnn_shards,
        device_budget_bytes=args.device_budget or None,
        device=args.device,
        strike_limit=getattr(args, "straggler_strikes", 3))
    trainer = aux["trainer"]
    shown = {k: v for k, v in gd.meta.items() if k not in ("mesh", "stats")}
    print(f"gnn={args.gnn} backend={gd.backend} device={gd.device} "
          f"format={gd.tile_format} footprint={gd.footprint_bytes} "
          f"meta={shown}", flush=True)

    losses = []

    def logged(ps, opt, batch):
        ps, opt, m = step(ps, opt, batch)
        losses.append(float(m["loss"]))
        if len(losses) % 20 == 0:
            print(f"step {len(losses):4d}  loss {losses[-1]:.4f}",
                  flush=True)
        return ps, opt, m

    ckdir = args.ckpt_dir or tempfile.mkdtemp(prefix="engn_gnn_ckpt_")
    mgr = CheckpointManager(ckdir, keep=2, async_save=True)
    step_fn, ckpt, clock_kw, injector = logged, mgr, {}, None
    if args.chaos_seed is not None:
        # deterministic fault schedule on a virtual clock (C13): shard
        # loss, a transient blip, a straggler episode, a torn save
        from repro_torch.distributed.chaos import (ChaosInjector, FaultPlan,
                                                   VirtualClock)
        clock = VirtualClock()
        plan = FaultPlan.sample(args.chaos_seed, args.steps)
        injector = ChaosInjector(plan, clock=clock)
        step_fn = injector.wrap_step(logged)
        ckpt = injector.wrap_checkpoint(mgr)
        clock_kw = {"clock": clock, "sleep": clock.sleep}
        print(f"chaos: {injector.describe()}", flush=True)
    runner = FaultTolerantRunner(step_fn, ckpt,
                                 FaultConfig(ckpt_every=args.ckpt_every),
                                 on_failure=trainer.on_failure,
                                 on_straggler=trainer.on_straggler,
                                 **clock_kw)
    start = 0
    if mgr.latest_step() is not None:
        state, meta_d, start = mgr.restore(state)
        data.seek(meta_d.get("cursor", start))
        print(f"restored from step {start}")
    state, last = runner.run(state, data, num_steps=args.steps,
                             start_step=start)
    mgr.wait()
    traj = (f"loss {losses[0]:.3f} -> {losses[-1]:.3f}" if losses
            else "no steps run (checkpoint already at --steps)")
    recov = (f", remesh={trainer.stats['remesh_count']} "
             f"lost_steps={runner.stats['lost_steps']:.0f} "
             f"mttr={runner.stats['mttr_s']:.2f}s"
             if runner.stats["failures"] else "")
    print(f"done: {last} steps, {traj}, saves={runner.stats['saves']}"
          f"{recov}")
    if injector is not None:
        print(f"chaos fired: {injector.stats}", flush=True)
    return {"start": start, "steps": last, "losses": losses,
            "saves": runner.stats["saves"], "runner": dict(runner.stats),
            "trainer": dict(trainer.stats), "injector": injector}


def run_lm(args):
    """--arch entry point: fault-tolerant LM training of the assigned
    architecture, resuming from the newest checkpoint in `--ckpt-dir`.
    Returns {"start", "steps", "losses", "step_s" (host seconds of each
    step, to the read of its loss), "saves", "params"}."""
    from repro_torch.device import resolve_device
    from repro_torch.nn import transformer as T
    dev = resolve_device(args.device)
    mesh, step, state, data, cfg = build(
        args.arch, smoke=args.smoke, batch=args.batch, seq=args.seq,
        steps=args.steps, micro_steps=args.micro_steps, peak_lr=args.lr,
        q_chunk=min(512, args.seq), loss_chunk=min(256, args.seq),
        device=dev)
    print(f"arch={cfg.name} params={T.param_count(cfg)/1e6:.1f}M "
          f"mesh={mesh.shape} device={dev}", flush=True)

    losses, step_s = [], []
    t_last = [time.monotonic()]

    def logged(params, opt, batch):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt,
                              batch_to_device(cfg, batch, dev))
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        now = time.monotonic()
        if len(losses) % 10 == 0:
            print(f"step {len(losses):5d}  loss {losses[-1]:.4f}  "
                  f"{(now - t_last[0]) / 10:.2f}s/step", flush=True)
            t_last[0] = now
        return params, opt, m

    ckdir = args.ckpt_dir or tempfile.mkdtemp(prefix="engn_ckpt_")
    mgr = CheckpointManager(ckdir, keep=3, async_save=True)
    runner = FaultTolerantRunner(
        logged, mgr, FaultConfig(ckpt_every=args.ckpt_every),
        on_straggler=lambda s, dt: print(f"[straggler] step {s}: {dt:.2f}s",
                                         flush=True))
    start = 0
    if mgr.latest_step() is not None:       # elastic / crash restart
        state, meta, start = mgr.restore(state)
        data.seek(meta.get("cursor", start))
        print(f"restored from step {start}")
    state, last = runner.run(state, data, num_steps=args.steps,
                             start_step=start)
    mgr.wait()
    traj = (f"loss {losses[0]:.3f} -> {losses[-1]:.3f}" if losses
            else "no steps run (checkpoint already at --steps)")
    print(f"done: {last} steps, {traj}, "
          f"saves={runner.stats['saves']} "
          f"stragglers={runner.stats['stragglers']}")
    return {"start": start, "steps": last, "losses": losses,
            "step_s": step_s, "saves": runner.stats["saves"],
            "params": T.param_count(cfg)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS,
                    help="transformer architecture (LM mode)")
    ap.add_argument("--gnn", choices=["gcn", "gs_pool", "rgcn",
                                      "gated_gcn", "grn"],
                    help="GNN mode: train an EnGN stack instead of an LM")
    ap.add_argument("--gnn-backend", default="segment",
                    choices=["segment", "blocked", "fused", "ring",
                             "tiled"])
    ap.add_argument("--gnn-shards", type=int, default=None,
                    help="ring backend: shards in the ring (default: the "
                         "visible devices; co-located on one card)")
    ap.add_argument("--gnn-hidden", type=int, default=32)
    ap.add_argument("--dataset", default="pubmed")
    ap.add_argument("--device-budget", type=int, default=0,
                    help="device budget in bytes, per shard on the ring "
                         "(0 = off)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 4 (LM mode) / 256 (GNN mode)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro-steps", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="replay a seeded fault schedule (GNN mode): "
                         "shard loss, transient, straggler, torn save")
    ap.add_argument("--straggler-strikes", type=int, default=3,
                    help="straggler episodes before the ring sheds the "
                         "slow shard (GNN mode)")
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args(argv)
    if args.gnn:
        args.batch = args.batch if args.batch is not None else 256
        return run_gnn(args)
    if not args.arch:
        ap.error("one of --arch or --gnn is required")
    args.batch = args.batch if args.batch is not None else 4
    return run_lm(args)


if __name__ == "__main__":
    main()
