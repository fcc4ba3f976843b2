"""`correct` comes out false where it must: for the control (the
reference in the next precision down, TF32 products, put in the
program's place), for each fault the calibration plants in the
reference, and for a run whose timed path is broken underneath.
At the cells' own widths on a few hundred vertices, on the CPU, where
TF32 is emulated by rounding the products' inputs."""
import pytest
import torch

from portbench.lib import cellrun, spec
from portbench.lib.spec import Cell

CPU = torch.device("cpu")
TRAIN = spec.cell_names("train")
INFER = spec.cell_names("infer")


@pytest.mark.parametrize("cell", spec.cell_names())
@pytest.mark.parametrize("seed", [3, 2 ** 32 + 5, 77])
def test_the_control_fails_a_limit(tiny_root, cell, seed):
    c = Cell(cell, tiny_root)
    mode = c.mode().Mode(c, CPU)
    inputs = mode.draw(seed)
    ref = mode.reference(inputs)
    readings = mode.compare(inputs, ref, mode.reference(inputs, "tf32"))
    limits = c.limits()
    assert any(readings[k] > limits[k] for k in limits), readings
    # and the reference against itself reads within every limit
    same = mode.compare(inputs, ref, mode.reference(inputs))
    assert all(same[k] <= limits[k] for k in limits), same


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["half_batch", "unchanged", "scaled",
                                   "transposed"])
def test_each_planted_fault_fails_a_limit(tiny_root, cell, fault):
    c = Cell(cell, tiny_root)
    mode = c.mode().Mode(c, CPU)
    assert fault in mode.faults
    inputs = mode.draw(2 ** 31 + 9)
    readings = mode.compare(inputs, mode.reference(inputs),
                            mode.reference(inputs, fault=fault))
    limits = c.limits()
    assert any(readings[k] > limits[k] for k in limits), readings
    if fault in ("scaled", "transposed"):
        # the first layer's gradient is what they break, and only its
        # per-leaf reading sees it
        assert readings["leaf_grad_gap"] > 10 * limits["leaf_grad_gap"]


def _run(root, cell):
    line, checks = cellrun.run(cell, seed=11, seconds=0.1, traced=False,
                               device=CPU, t0=0.0, root=root)
    return line["correct"], {k: v for k, v, _ in checks}


def test_a_step_that_returns_its_state_unchanged(tiny_root, monkeypatch):
    from repro_torch.training import train_lib

    def frozen_step(loss_fn, **kw):
        def step(params, opt, batch):
            with torch.no_grad():
                loss = loss_fn(params, batch)
            return params, opt, {"loss": loss}
        return step
    monkeypatch.setattr(train_lib, "make_gnn_train_step", frozen_step)
    for cell in TRAIN:
        correct, got = _run(tiny_root, cell)
        assert not correct and got["change_gap"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(tiny_root, monkeypatch):
    from repro_torch.launch.elastic_gnn import ElasticGNNTrainer
    loss = ElasticGNNTrainer.loss

    def half(self, params, batch, plan=None):
        nodes = batch["nodes"]
        return loss(self, params, {"nodes": nodes[: nodes.numel() // 2]},
                    plan)
    monkeypatch.setattr(ElasticGNNTrainer, "loss", half)
    for cell in TRAIN:
        correct, got = _run(tiny_root, cell)
        assert not correct, got


def test_an_answer_altered_where_it_is_produced(tiny_root, monkeypatch):
    from repro_torch.core import models
    apply_stack = models.apply_stack

    def altered(layers, graph, x, params=None):
        y = apply_stack(layers, graph, x, params).clone()
        y[7, 3] += 0.5
        return y
    monkeypatch.setattr(models, "apply_stack", altered)
    for cell in INFER:
        correct, got = _run(tiny_root, cell)
        assert not correct and got["logit_gap"] > 1e-2, (cell, got)


class _Transposed(torch.autograd.Function):
    """The flat aggregate y = A x whose backward returns A g in place of
    A^T g."""

    @staticmethod
    def forward(ctx, x, flat, gsrc, gdst, gval, kw):
        ctx.args = (flat, gsrc, gdst, gval, kw)
        return flat(gsrc, gdst, gval, x, **kw)

    @staticmethod
    def backward(ctx, g):
        flat, gsrc, gdst, gval, kw = ctx.args
        return flat(gsrc, gdst, gval, g, **kw), None, None, None, None, None


@pytest.mark.parametrize("fault", ["scaled", "transposed"])
def test_first_layer_aggregate_backward_broken(tiny_root, monkeypatch,
                                               fault):
    """B2 transposed at the first layer's width (GCN's hidden 128)
    returning 2 A^T G, or A G: only the first layer's weight gradient
    sees it."""
    from portbench.lib.plain import GradScale
    from repro_torch.kernels import rer_gather
    flat = rer_gather.packed_flat_plain
    width = Cell("gcn-reddit.train", tiny_root).config["dims"][1]

    def broken(gsrc, gdst, gval, x, **kw):
        if x.shape[1] != width or not x.requires_grad:
            return flat(gsrc, gdst, gval, x, **kw)
        if fault == "scaled":
            return flat(gsrc, gdst, gval, GradScale.apply(x, 2.0), **kw)
        return _Transposed.apply(x, flat, gsrc, gdst, gval, kw)
    monkeypatch.setattr(rer_gather, "packed_flat_plain", broken)
    correct, got = _run(tiny_root, "gcn-reddit.train")
    assert not correct and got["leaf_grad_gap"] > 1e-1, got


def test_typed_first_layer_gradient_scaled(tiny_root, monkeypatch):
    """R-GCN's first-layer gathers (width 10) returning their payload
    gradient doubled."""
    from portbench.lib.plain import GradScale
    from repro_torch.core import engn
    seg = engn.segment_aggregate
    width = Cell("rgcn-am.train", tiny_root).config["dims"][1]

    def broken(ev, dst, n, op):
        if ev.shape[1] == width and ev.requires_grad:
            ev = GradScale.apply(ev, 2.0)
        return seg(ev, dst, n, op)
    monkeypatch.setattr(engn, "segment_aggregate", broken)
    correct, got = _run(tiny_root, "rgcn-am.train")
    assert not correct and got["leaf_grad_gap"] > 1e-1, got
