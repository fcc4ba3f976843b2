"""A configuration whose model is neither GCN nor R-GCN, added as new
files and new `BENCHMARK.json` entries alone: an unweighted graph
(`"normalize": "none"`), a plain reference written beside the others,
and the model's own least work, which the readers take in place of the
DASR count.  The model is the port's GRN (EnGN Table 1: W h_u, sum,
GRU(h_v, agg)); the configuration and its cell are throwaway."""
import json

import numpy as np
import pytest
import torch

from portbench.conftest import TINY_DEFAULT, shrink_configs
from portbench.lib import cellrun, counts, program, readers, spec, trace

CELL = "grn-reddit.infer"
SIBLING = "gcn-reddit.infer"      # the new cell reports what this one does

REFERENCE = '''
"""GRN, a plain reference: h'_v = GRU(h_v, sum_{u -> v} W h_u), no edge
weights, multi-edges counted."""
import torch

from portbench.lib import plain

KEYS = ("w", "w_z", "u_z", "w_r", "u_r", "w_n", "u_n")


def init_params(cfg, gen, device):
    return [{k: torch.randn((d, d), generator=gen, device=device) * d ** -0.5
             for k in KEYS} for d in cfg["dims"][:-1]]


class Graph:
    def __init__(self, src, dst, rel, cfg):
        n = cfg["graph"]["vertices"]
        ones = torch.ones(src.numel(), device=src.device)
        self.a, self.at, entries = plain.sparse_pair(dst.long(), src.long(),
                                                     ones, n)
        self.n = n
        self.work = {"n": n, "entries": entries, "src_rows": n,
                     "dst_rows": n, "self_term": 0}

    def astype(self, dtype):
        g = object.__new__(Graph)
        g.__dict__.update(self.__dict__, a=self.a.to(dtype),
                          at=self.at.to(dtype))
        return g


def forward(graph, x, params, precision="fp32", fault=None):
    h = x
    for p in params:
        mm = lambda a, k: plain.mm(a, p[k], precision)
        agg = plain.SparseAggregate.apply(mm(h, "w"), graph.a, graph.at)
        z = torch.sigmoid(mm(agg, "w_z") + mm(h, "u_z"))
        r = torch.sigmoid(mm(agg, "w_r") + mm(h, "u_r"))
        nh = torch.tanh(mm(agg, "w_n") + mm(r * h, "u_n"))
        h = (1.0 - z) * nh + z * h
    return h


def model_flops(dims, work, train):
    """The message's cheaper order and the GRU's six products a layer; a
    step at least doubles each (its weight gradients)."""
    total = 0.0
    for d in dims[:-1]:
        message = 2.0 * work["entries"] * d + 2.0 * min(
            work["src_rows"], work["dst_rows"]) * d * d
        total += message + 12.0 * work["n"] * d * d
    return total * (2 if train else 1)


def aggregate_bytes(dims, work, train):
    total = sum(12.0 * work["entries"] + 8.0 * work["n"] * d
                for d in dims[:-1])
    return total * (2 if train else 1)
'''


def _add_grn_cell(root):
    """The new files and entries, at a published-looking size, in a copy
    of the benchmark; then every configuration cut to its CPU size."""
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "gcn-reddit.json").read_text())
    cfg.update(name="grn-reddit", model="grn", dims=[32, 32, 32],
               normalize="none")
    cfg["graph"].update(vertices=232965, edges=114600000)
    del cfg["labelled"]
    (pb / "configs" / "grn-reddit.json").write_text(json.dumps(cfg))
    (pb / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"trace_iters": 3, "limits": {"logit_gap": 3e-5}}))
    (pb / "reference" / "grn.py").write_text(REFERENCE)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "grn-reddit", "source": "x",
                             "file": "portbench/configs/grn-reddit.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": CELL, "config": "grn-reddit",
                               "traffic": "infer", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if SIBLING in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shrink_configs(root)


def test_a_new_model_runs_correct_through_the_unedited_harness(
        tiny_root, monkeypatch):
    _add_grn_cell(tiny_root)
    cell = spec.Cell(CELL, tiny_root)
    assert (cell.config["graph"]["vertices"],
            cell.config["graph"]["edges"]) == TINY_DEFAULT
    assert CELL in spec.cell_names("infer", tiny_root)
    h100 = counts.load_peaks("NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(counts, "load_peaks", lambda kind, path=None: h100)
    window = []
    host_window = trace.host_window

    def recorded(run, seconds):
        window.append(host_window(run, seconds))
        return window[-1]
    monkeypatch.setattr(trace, "host_window", recorded)
    line, checks = cellrun.run(CELL, seed=2 ** 33 + 3, seconds=0.2,
                               traced=True, device=torch.device("cpu"),
                               t0=0.0, root=tiny_root)
    assert line["correct"] and line["failed"] == 0, checks
    assert [name for name, _, _ in checks] == ["logit_gap"]
    # the count is the reference's, not the DASR default's
    dims, work = cell.config["dims"], line["work"]
    ref = cell.reference()
    flops = ref.model_flops(dims, work, False)
    assert flops > counts.model_flops(dims, work, False)
    (n, elapsed), = window
    assert line["metrics"]["mfu.infer"]["value"] == pytest.approx(
        100.0 * flops / (elapsed / n * h100["fp32_flops_per_s"]))


def test_the_readers_take_the_models_arithmetic(tiny_root):
    _add_grn_cell(tiny_root)
    cell = spec.Cell(CELL, tiny_root)
    ref = cell.reference()
    flops, agg_bytes = counts.least_work(ref)
    assert (flops, agg_bytes) == (ref.model_flops, ref.aggregate_bytes)
    work = {"n": 10, "entries": 40, "src_rows": 10, "dst_rows": 10,
            "self_term": 0}
    kernel = ("void (anonymous namespace)::rer_gather_kernel<false, 4>"
              "(long long const*)")
    summary = trace.TraceSummary(2, 1e-3, 1e-4, [(kernel, 0.0, 1e-4)], [])
    peaks = counts.load_peaks("NVIDIA H100 80GB HBM3")
    ctx = readers.Context(
        train=False, dims=[8, 8], work=work, iter_s=0.01, trace=summary,
        peaks=peaks, families=spec.kernel_families(tiny_root), prepare_s=1.0,
        plan_bytes=0, build_s=0.0, model_flops=flops,
        aggregate_bytes=agg_bytes)
    assert readers.mfu(ctx, False) == pytest.approx(
        100.0 * ref.model_flops([8, 8], work, False)
        / (0.01 * peaks["fp32_flops_per_s"]))
    assert readers.aggregate_roofline(ctx, False) == pytest.approx(
        100.0 * 2 * ref.aggregate_bytes([8, 8], work, False)
        / peaks["hbm_bytes_per_s"] / 1e-4)


@pytest.mark.parametrize("normalize", ["none", "sym"])
def test_normalise_takes_none_and_refuses_what_it_does_not_know(normalize):
    from repro_torch.graphs.format import COOGraph
    g = COOGraph(4, np.array([0, 1, 2, 2], np.int32),
                 np.array([1, 2, 3, 3], np.int32))
    if normalize == "sym":
        with pytest.raises(ValueError):
            program.relabel_and_normalise(g, {"normalize": normalize}, {})
        return
    out, perm = program.relabel_and_normalise(g, {"normalize": normalize},
                                              {})
    assert out.val is None and out.num_edges == 4
    assert sorted(perm.tolist()) == [0, 1, 2, 3]
