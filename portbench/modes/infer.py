"""Closed-loop full-graph inference: back-to-back forwards of the whole
stack through `repro_torch.core.models.apply_stack` over one prepared
plan, each ended by a synchronise, under `torch.inference_mode()`.

The check compares the logits of the window's last forward, every row,
with the plain reference's, computed in float64: `logit_gap`, the
largest absolute difference over the largest reference logit.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from portbench.lib import program, rmat
from portbench.lib.spec import Cell


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Mode:
    train = False
    faults = ("altered",)      # what `reference(fault=...)` can plant

    def __init__(self, cell: Cell, device: torch.device):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.ref = cell.reference()
        self.dev = device
        self.graph = None
        self.ref_graph = None
        self.times: Dict[str, float] = {}

    # -- inputs ------------------------------------------------------------
    def make_graph(self) -> None:
        """The configuration's graph, made on the device and handed to the
        port as host arrays."""
        src, dst, rel = rmat.config_edges(self.cfg, self.dev)
        self.graph = program.host_graph(src, dst, rel, self.cfg)

    def draw(self, seed: int) -> Dict:
        """Features and weights from the seed, on the device."""
        gen = torch.Generator(device=self.dev).manual_seed(int(seed))
        n, f = self.cfg["graph"]["vertices"], self.cfg["dims"][0]
        x = torch.randn((n, f), generator=gen, device=self.dev)
        return {"x": x, "params": self.ref.init_params(self.cfg, gen,
                                                        self.dev)}

    # -- the program ---------------------------------------------------------
    def prepare(self, inputs: Dict) -> None:
        """The port's set-up: relabel, normalise, layers, plan."""
        from repro_torch.core.engn import prepare_graph
        g, perm = program.relabel_and_normalise(self.graph, self.cfg,
                                                self.times)
        t = time.perf_counter()
        self.perm = torch.from_numpy(perm).to(self.dev).long()
        self.layers = program.make_layers(self.cfg, self.dev, training=False)
        self.plan = prepare_graph(g, self.layers[0].cfg, device=self.dev)
        self.times["plan_s"] = time.perf_counter() - t

    def bind(self, inputs: Dict) -> None:
        """The seed's inputs into the program, then the warm-up forwards."""
        self.x = inputs["x"][self.perm]
        program.load_params(self.layers, inputs["params"])
        for _ in range(int(self.traffic["warmup_iters"])):
            self.iterate()

    def iterate(self) -> bool:
        from repro_torch.core import models
        with torch.inference_mode():
            self.y = models.apply_stack(self.layers, self.plan, self.x)
        sync(self.dev)
        return True

    def outputs(self) -> Dict:
        return {"y": self.y}

    def window_metrics(self, n: int, seconds: float) -> Dict[str, float]:
        return {"forward_ms": 1e3 * seconds / n}

    def plan_bytes(self) -> int:
        """The plan's own count of its device bytes (every tensor it
        holds, the kernels' tables included)."""
        return int(self.plan.held_bytes())

    def release(self) -> None:
        """Drop the program's state (the outputs to check stay)."""
        for name in ("layers", "plan", "x"):
            setattr(self, name, None)

    # -- the reference ---------------------------------------------------------
    def reference_graph(self):
        if self.ref_graph is None:
            src, dst, rel = rmat.config_edges(self.cfg, self.dev)
            self.ref_graph = self.ref.Graph(src, dst, rel, self.cfg)
            from portbench.lib.plain import degree_order
            self.order = degree_order(src, dst, self.ref_graph.n)
        return self.ref_graph

    def reference_inputs(self, inputs: Dict, precision: str):
        """(graph, inputs, product precision) for a precision: "fp64", the
        yardstick, is the reference run on float64 copies of the inputs;
        "fp32" and "tf32" run it on the inputs as drawn."""
        g = self.reference_graph()
        if precision != "fp64":
            return g, inputs, precision
        wide = {k: (v.double() if k == "x" else v) for k, v in inputs.items()}
        wide["params"] = [{k: v.double() for k, v in p.items()}
                          for p in inputs["params"]]
        return g.astype(torch.float64), wide, "fp32"

    def reference(self, inputs: Dict, precision: str = "fp64",
                  fault: Optional[str] = None) -> Dict:
        """The reference's logits, in the order the program returns its
        rows (the degree order, worked out again from the raw edges)."""
        g, inputs, precision = self.reference_inputs(inputs, precision)
        with torch.no_grad():
            y = self.ref.forward(g, inputs["x"], inputs["params"],
                                 precision)[self.order]
        if fault == "altered":
            y[0, 0] += 1.0
        elif fault is not None:
            raise ValueError(fault)
        return {"y": y}

    def compare(self, inputs: Dict, ref: Dict,
                cand: Dict) -> Dict[str, float]:
        y, yr = cand["y"], ref["y"]
        scale = float(yr.abs().max())
        gap = float((y - yr).abs().max()) / max(scale, 1e-30)
        if not torch.isfinite(y).all():
            gap = float("inf")
        return {"logit_gap": gap}

    def detail(self, inputs: Dict, ref: Dict, cand: Dict) -> Dict:
        return {}

    def work(self) -> Dict:
        return self.reference_graph().work

    def release_reference(self) -> None:
        self.ref_graph = None
