"""Full-graph training: steps of `ElasticGNNTrainer.step` (AdamW through
`training/train_lib.py`, as `launch/train.py --gnn` runs it), each over
the whole graph with the loss at one labelled set of vertices, each
ended by the read of its loss.

Set-up builds one trainer and drives it from the seed through its first
`checked_steps` steps, each on another labelled set, through the same
call the window makes; the window goes on from there with the same
object.  The check follows those first steps in the plain reference,
computed in float64, and compares:

- `first_loss_gap`: the first step's loss, |program - reference| /
  |reference| (every checked step's loss has to be finite);
- `grad_gap`: the first step's clipped gradient of the output layer's
  weights as the optimizer got it (its first moment over 1 - b1): for
  each leaf the median over its elements of |program - reference| over
  the leaf's root mean square, the worst leaf;
- `leaf_grad_gap`: the same median gap over every leaf of every layer,
  the worst leaf: the first layer's weight gradient is the only reading
  of the aggregate's backward at the first layer's width (B2 transposed
  at GCN's hidden width, the typed gathers' backward into R-GCN's
  payload), which the change cannot see, since AdamW's steps hardly
  move when a gradient is scaled;
- `change_gap`: the norm of each leaf's change over the checked steps,
  |program - reference| over the reference's norm of that leaf or of the
  median leaf, whichever is larger, the worst leaf.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's (nought to rounding: they move by round-off alone) are left out
of the last three.  Why these, and not the loss of every step or the
norm of every leaf's gradient: float32 itself puts a few ReLU
pre-activations on the other side of zero on some seeds; at a hub of the
graph one such unit moves the later steps' losses and the change by up
to what the TF32 control reads, and the first layer's whole gradient by
a fraction of it, in the program and in a float32 reference alike.  The
first loss is continuous in such a flip, and the output layer's
gradient takes it in one column, which its median element does not
see; `leaf_grad_gap`'s limit sits above what such a flip reads
(`PERF.md`).
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List, Optional

import torch

from portbench.lib import plain, program
from portbench.lib.traffic import labelled_sets
from portbench.modes.infer import Mode as InferMode

QUIET_LEAF = 1e-3     # a leaf whose gradient is under this x the median's


def _norms(tree) -> Dict:
    return {(i, k): float(torch.linalg.vector_norm(v.double()))
            for i, p in enumerate(tree) for k, v in p.items()}


def _change(tree, inputs) -> Dict:
    """Norms of each leaf's change from the parameters both sides
    started from."""
    p0 = inputs["params"]
    return _norms([{k: v.double() - p0[i][k].double() for k, v in p.items()}
                   for i, p in enumerate(tree)])


def _median_gap(cand: torch.Tensor, ref: torch.Tensor) -> float:
    """Median over the elements of |cand - ref|, over the rms of ref."""
    ref = ref.double()
    rms = float(torch.sqrt(torch.mean(ref * ref)))
    med = float(torch.median(torch.abs(cand.double() - ref)))
    return med / max(rms, 1e-300)


def worst_leaf_gap(cand: Dict, ref: Dict, keys) -> float:
    """max over `keys` of |cand - ref| / max(ref, median of ref)."""
    keys = list(keys)
    if not keys:
        return 0.0
    med = statistics.median(ref[k] for k in keys)
    gaps = [abs(cand[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


class Mode(InferMode):
    train = True
    # planted in the reference put in the program's place: half of each
    # labelled set left out; the state left unchanged; the first layer's
    # aggregate backward returning 2 A^T G, or A G in place of A^T G
    faults = ("half_batch", "unchanged", "scaled", "transposed")

    def draw(self, seed: int) -> Dict:
        """Features, weights, labels and the labelled sets from the seed."""
        gen = torch.Generator(device=self.dev).manual_seed(int(seed))
        g = self.cfg["graph"]
        n, f = g["vertices"], self.cfg["dims"][0]
        x = torch.randn((n, f), generator=gen, device=self.dev)
        params = self.ref.init_params(self.cfg, gen, self.dev)
        labels = torch.randint(0, self.cfg["dims"][-1], (n,), generator=gen,
                               device=self.dev)
        sets = labelled_sets(n, self.cfg["labelled"],
                             int(self.traffic["labelled_sets"]), gen,
                             self.dev)
        return {"x": x, "params": params, "labels": labels, "sets": sets}

    def prepare(self, inputs: Dict) -> None:
        """The port's set-up: relabel, normalise, layers, and the trainer,
        which prepares its plan."""
        from repro_torch.launch.elastic_gnn import ElasticGNNTrainer
        g, perm = program.relabel_and_normalise(self.graph, self.cfg,
                                                self.times)
        t = time.perf_counter()
        self.perm = torch.from_numpy(perm).to(self.dev).long()
        self.inv = torch.empty_like(self.perm)
        self.inv[self.perm] = torch.arange(self.perm.numel(),
                                           device=self.dev)
        self.layers = program.make_layers(self.cfg, self.dev, training=True)
        self.trainer = ElasticGNNTrainer(
            layers=self.layers, graph=g, x=inputs["x"][self.perm],
            y_true=inputs["labels"][self.perm], hidden=self.cfg["dims"][1],
            peak_lr=self.traffic["peak_lr"],
            steps=int(self.traffic["total_steps"]))
        self.plan = self.trainer.plan
        self.times["plan_s"] = time.perf_counter() - t

    def bind(self, inputs: Dict) -> None:
        """The seed's inputs into the trainer, then its first steps."""
        from repro_torch.training.optimizer import init_opt_state
        self.trainer.x = inputs["x"][self.perm]
        self.trainer.y_true = inputs["labels"][self.perm]
        self.sets = [self.inv[s] for s in inputs["sets"]]
        self.params = [{k: v.clone() for k, v in p.items()}
                       for p in inputs["params"]]
        self.opt = init_opt_state(self.params)
        self.k = 0
        b1 = self.traffic["optimizer"]["b1"]
        losses, grads = [], None
        for _ in range(int(self.traffic["checked_steps"])):
            losses.append(self._step())
            if grads is None:
                grads = [{k: m / (1 - b1) for k, m in p.items()}
                         for p in self.opt["m"]]
        self.checked = {"losses": losses, "grads": grads,
                        "params": self.params}

    def _step(self) -> float:
        nodes = self.sets[self.k % len(self.sets)]
        self.k += 1
        self.params, self.opt, m = self.trainer.step(
            self.params, self.opt, {"nodes": nodes})
        return float(m["loss"])

    def iterate(self) -> bool:
        return math.isfinite(self._step())

    def outputs(self) -> Dict:
        return self.checked

    def window_metrics(self, n: int, seconds: float) -> Dict[str, float]:
        return {"step_ms": 1e3 * seconds / n}

    def release(self) -> None:
        for name in ("layers", "plan", "trainer", "params", "opt", "sets"):
            setattr(self, name, None)

    # -- the reference ---------------------------------------------------------
    def reference(self, inputs: Dict, precision: str = "fp64",
                  fault: Optional[str] = None) -> Dict:
        """The checked steps in the plain reference (original vertex
        order: the loss and the weights do not depend on it)."""
        g, inputs, precision = self.reference_inputs(inputs, precision)
        steps = int(self.traffic["checked_steps"])
        sets: List[torch.Tensor] = inputs["sets"][:steps]
        if fault == "half_batch":
            sets = [s[: s.numel() // 2] for s in sets]
        elif fault not in (None,) + self.faults:
            raise ValueError(fault)
        planted = fault if fault in ("scaled", "transposed") else None
        losses, grads, params = plain.train_steps(
            lambda ps: self.ref.forward(g, inputs["x"], ps, precision,
                                        planted),
            inputs["params"], inputs["labels"], sets, self.traffic)
        if fault == "unchanged":
            params = inputs["params"]
        return {"losses": losses, "grads": grads, "params": params}

    def compare(self, inputs: Dict, ref: Dict,
                cand: Dict) -> Dict[str, float]:
        c0, r0 = cand["losses"][0], ref["losses"][0]
        first_loss_gap = abs(c0 - r0) / max(abs(r0), 1e-30)
        if not all(math.isfinite(c) for c in cand["losses"]):
            first_loss_gap = math.inf
        gr = _norms(ref["grads"])
        med = statistics.median(gr.values())
        moving = [k for k in gr if gr[k] >= QUIET_LEAF * med]
        out = len(ref["grads"]) - 1          # the output layer
        med = {(i, k): _median_gap(cand["grads"][i][k], ref["grads"][i][k])
               for i, k in moving}
        grad_gap = max((v for (i, _), v in med.items() if i == out),
                       default=0.0)
        change_gap = worst_leaf_gap(_change(cand["params"], inputs),
                                    _change(ref["params"], inputs), moving)
        return {"first_loss_gap": first_loss_gap, "grad_gap": grad_gap,
                "leaf_grad_gap": max(med.values(), default=0.0),
                "change_gap": change_gap}

    def detail(self, inputs: Dict, ref: Dict, cand: Dict) -> Dict:
        """Each step's loss gap and each leaf's gradient and change gap,
        for the calibration's look at a seed that reads high."""
        gr, gc = _norms(ref["grads"]), _norms(cand["grads"])
        cr = _change(ref["params"], inputs)
        cc = _change(cand["params"], inputs)
        return {"losses": [abs(c - r) / abs(r) for c, r in
                           zip(cand["losses"], ref["losses"])],
                "grad": {f"{i}.{k}": [gr[i, k], gc[i, k]] for i, k in gr},
                "grad_median": {f"{i}.{k}": _median_gap(cand["grads"][i][k],
                                                        ref["grads"][i][k])
                                for i, k in gr},
                "change": {f"{i}.{k}": [cr[i, k], cc[i, k]] for i, k in cr}}

