"""The training launcher, GNN mode: a 2-layer EnGN stack trained with
AdamW on any ported aggregation backend, under the fault-tolerant
runner and atomic checkpoints.

    # on the card (the default device)
    PYTHONPATH=src python -m repro_torch.launch.train --gnn gcn \\
        --gnn-backend blocked --dataset pubmed --steps 100

    # on the CPU, through the kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.train --gnn gcn \\
        --gnn-backend blocked --device cpu --steps 20

    # the sharded ring: 4 shards, co-located on the one card
    PYTHONPATH=src python -m repro_torch.launch.train --gnn gcn \\
        --gnn-backend ring --gnn-shards 4 --steps 30

Backends `segment`, `blocked` (dense or packed tiles, as the format
autotuner picks), `fused`, the sharded `ring` and the streamed `tiled`
train, `tiled` directly or by a budget spill (`--device-budget`: a plan
over it streams the graph from the host, its backward re-streaming the
transposed tiles or running B5^T over the device queue; on the ring the
budget is per shard); `--gnn rgcn` (a 3-type edge colouring, `rel =
(src + dst) % 3`) and `--gnn gated_gcn` train on `segment`, `blocked`,
`ring` and `tiled`, and refuse `fused` as the reference does.  Shard
loss and straggler strikes re-mesh the ring (`ElasticGNNTrainer`).  Not
ported yet, each raising `NotImplementedError` with its ROADMAP item:
the chaos schedule (`--chaos-seed`, A11) and the LM mode (`--arch`,
A12).
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.fault import FaultConfig, FaultTolerantRunner

_NOT_YET = {
    "chaos": "the seeded chaos schedule is not ported yet (ROADMAP A11)",
    "lm": "the LM training mode is not ported yet (ROADMAP A12)",
}


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
    `--ckpt-dir`.  Returns {"start", "steps", "losses", "saves"}."""
    if args.chaos_seed is not None:
        raise NotImplementedError(_NOT_YET["chaos"])
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
    runner = FaultTolerantRunner(logged, mgr,
                                 FaultConfig(ckpt_every=args.ckpt_every),
                                 on_failure=trainer.on_failure,
                                 on_straggler=trainer.on_straggler)
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
    return {"start": start, "steps": last, "losses": losses,
            "saves": runner.stats["saves"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="transformer architecture (LM mode, "
                                   "not ported yet: ROADMAP A12)")
    ap.add_argument("--gnn", choices=["gcn", "gs_pool", "rgcn",
                                      "gated_gcn", "grn"],
                    help="GNN mode: train an EnGN stack")
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
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="seeded fault schedule (ROADMAP A11)")
    ap.add_argument("--straggler-strikes", type=int, default=3,
                    help="straggler episodes before the ring sheds the "
                         "slow shard")
    args = ap.parse_args(argv)
    if args.gnn:
        return run_gnn(args)
    if args.arch:
        raise NotImplementedError(_NOT_YET["lm"])
    ap.error("--gnn is required (the LM mode, --arch, is ROADMAP A12)")


if __name__ == "__main__":
    main()
