"""Dry run: build and count every (arch x shape x mesh) cell on `meta`
tensors, no device needed.

For each cell it builds the parameters, the AdamW state, the batch or
the decode state as `meta` stand-ins (shapes and dtypes, no storage)
under a co-located production mesh (`launch/mesh.py`: (16, 16) single
pod, (2, 16, 16) multi-pod, every shard on the CPU) and its
`Constrainer`, runs the train step, `prefill` or `decode_step` once
under the cost counter (`launch/op_cost.py`, with its loop scaling),
and writes the reference's record: status (ok / skipped / error), the
roofline terms on one H100 (`launch/analysis.py`), the model FLOPs and
their ratio to the counted ones, and the counted FLOPs and bytes
(`op_flops_global` / `op_bytes_global`, the reference's
`jaxpr_flops_global` / `jaxpr_bytes_global`).  Where the reference asks
its compiler for memory and collectives, the port computes
`memory.argument_bytes` per device from the arguments' PartitionSpecs
and the mesh's axis sizes and records the rest as None (no compiler to
ask; ROADMAP §C divergence 17).  On a mesh whose model axis is above 1
the MoE layers take the all-to-all dispatch (`nn/moe_a2a.py`), whose
expert products the counter counts.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out build/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import (Constrainer, batch_pspec,
                                             make_rules, mesh_shape_dict,
                                             param_pspecs)
from repro_torch.launch import specs as SP
from repro_torch.launch.analysis import model_flops_estimate, roofline_from_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import traced_cost
from repro_torch.nn import transformer as T
from repro_torch.nn.param import PartitionSpec as P
from repro_torch.nn.param import tree_leaves
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_lib import make_train_step

DEFAULT_OUT = "build/dryrun_torch"


@dataclasses.dataclass
class Cell:
    """One cell's program and its `meta` arguments, with their specs."""
    fn: Callable
    args: tuple
    pspecs: tuple


def _is_pspec(x) -> bool:
    return isinstance(x, P)


def argument_bytes(args, pspecs, mesh) -> int:
    """Bytes of the arguments one device holds: each leaf's bytes over
    the product of the mesh-axis sizes its PartitionSpec shards it on."""
    shape = mesh_shape_dict(mesh)
    total = 0
    for arg, spec in zip(args, pspecs):
        leaves = tree_leaves(arg)
        specs = tree_leaves(spec, is_leaf=_is_pspec)
        assert len(leaves) == len(specs), (len(leaves), len(specs))
        for t, s in zip(leaves, specs):
            parts = 1
            for ax in s:
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    parts *= shape.get(a, 1) if a is not None else 1
            total += t.numel() * t.element_size() // parts
    return int(total)


def lower_cell(arch: str, shape: str, mesh, *, q_chunk=512, loss_chunk=256,
               seq_override=None, batch_override=None, rules=None):
    """Build one cell on `meta`.  Returns (cell, meta), or (None,
    {"skipped": why}) for a shape the arch does not take."""
    cfg = get_config(arch)
    info = SP.SHAPES[shape]
    kind = info["kind"]
    seq = seq_override or info["seq"]
    batch = batch_override or info["batch"]
    ok, why = SP.shape_applicable(cfg, shape)
    if not ok:
        return None, {"skipped": why}

    rules = rules or make_rules(mesh)
    sc = Constrainer(mesh, rules)
    pparams = param_pspecs(cfg, mesh, rules)
    aparams = T.abstract_params(cfg)

    if kind == "train":
        batch_sds = SP.train_batch_specs(cfg, seq, batch)
        batch_ps = SP.train_batch_pspecs(cfg, mesh, rules)
        aopt = init_opt_state(aparams)
        popt = {"m": pparams, "v": pparams, "count": P()}
        # the reference donates params and state to its jitted step
        step = make_train_step(cfg, sc=sc, q_chunk=q_chunk,
                               loss_chunk=loss_chunk, donate=True)
        cell = Cell(step, (aparams, aopt, batch_sds),
                    (pparams, popt, batch_ps))
    elif kind == "prefill":
        batch_sds = SP.train_batch_specs(cfg, seq, batch)
        extras_sds = batch_sds.get("extras")
        tok_ps = batch_pspec(mesh, 2, seq_axis=1, rules=rules,
                             shape=(batch, seq))
        ex_ps = SP.train_batch_pspecs(cfg, mesh, rules).get("extras")

        def fn(params, tokens, extras):
            with torch.no_grad():
                return T.prefill(cfg, params, tokens, extras, sc, q_chunk)

        cell = Cell(fn, (aparams, batch_sds["tokens"], extras_sds or {}),
                    (pparams, tok_ps, ex_ps or {}))
    elif kind == "decode":
        state_sds = SP.decode_state_specs(cfg, batch, seq)
        state_ps = SP.decode_state_pspecs(cfg, state_sds, mesh, rules)
        tok_ps = batch_pspec(mesh, 2, rules=rules, shape=(batch, 1))
        tok_sds = SP.sds((batch, 1), torch.int32)

        def fn(params, state, tokens):
            with torch.no_grad():
                return T.decode_step(cfg, params, state, tokens, sc)

        cell = Cell(fn, (aparams, state_sds, tok_sds),
                    (pparams, state_ps, tok_ps))
    else:
        raise ValueError(kind)
    meta = {"arch": arch, "shape": shape, "kind": kind, "seq": seq,
            "batch": batch}
    return cell, meta


def _write(rec: dict, out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    fn = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    fn.write_text(json.dumps(rec, indent=2, default=str))


def run_cell(arch: str, shape: str, mesh_name: str,
             out_dir: Optional[Path] = None, **kw) -> dict:
    """Build, count and record one cell (written to `out_dir`, default
    `build/dryrun_torch`)."""
    out_dir = Path(out_dir or DEFAULT_OUT)
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"),
                                device="cpu")
    chips = int(mesh.size)
    rec: dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "chips": chips}
    try:
        cell, meta = lower_cell(arch, shape, mesh, **kw)
        rec.update(meta)
        if cell is None:
            rec["status"] = "skipped"
            return rec
        t1 = time.time()
        cost = traced_cost(cell.fn, *cell.args)
        t2 = time.time()
        roof = roofline_from_cost(cost, chips)
        mf = model_flops_estimate(get_config(arch), meta["kind"],
                                  meta["seq"], meta["batch"])
        rec.update({
            "status": "ok",
            "lower_s": round(t1 - t0, 1),
            "trace_s": round(t2 - t1, 1),
            "memory": {
                "argument_bytes": argument_bytes(cell.args, cell.pspecs,
                                                 mesh),
                "output_bytes": None,
                "temp_bytes": None,
                "generated_code_bytes": None,
                "note": "argument bytes per device from the PartitionSpecs; "
                        "no compiler to report the rest",
            },
            "roofline": roof.as_dict(),
            "model_flops_global": mf,
            "model_flops_ratio": mf / max(roof.flops * chips, 1e-30),
            "op_flops_global": cost.flops,
            "op_bytes_global": cost.bytes,
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        rec["total_s"] = round(time.time() - t0, 1)
        _write(rec, out_dir)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SP.SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out_dir = Path(args.out)

    results = []
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                rec = run_cell(arch, shape, mesh_name, out_dir)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f"dom={r['dominant']} "
                             f"frac={r['roofline_fraction']:.2f} "
                             f"trace={rec['trace_s']}s")
                elif status == "error":
                    extra = rec["error"][:120]
                print(f"[{status:7s}] {arch:28s} {shape:12s} {mesh_name:6s} "
                      f"{extra}", flush=True)
                results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
