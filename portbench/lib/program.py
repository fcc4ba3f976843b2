"""The calls the harness makes into the port (`repro_torch`), in one place:
the kernel build, the hand-over of the graph, the degree relabel, the
normalisation, the layers and their weights.  The port is imported here
and in the modes only, inside functions, so that the harness's tests
import this module without it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def build_kernels(device: torch.device) -> None:
    """Build (or find built) the port's CUDA kernels, into the fixed
    `build/repro_torch/<hash>` of the checkout."""
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()


def host_graph(src: torch.Tensor, dst: torch.Tensor,
               rel: Optional[torch.Tensor], cfg: Dict):
    """The port's input: a `COOGraph` of plain host arrays."""
    from repro_torch.graphs.format import COOGraph
    g = cfg["graph"]
    return COOGraph(g["vertices"], src.cpu().numpy(), dst.cpu().numpy(),
                    None, None if rel is None else rel.cpu().numpy(),
                    g.get("relations", 1))


def relabel_and_normalise(graph, cfg: Dict, times: Dict[str, float]
                          ) -> Tuple[object, np.ndarray]:
    """The port's degree relabel (`graphs/degree.py`), then the
    normalisation the configuration states: "gcn", GCN's self-loops and
    D^-1/2 weights; "relation", none here (R-GCN's relation norm is
    folded by `prepare_graph`); "none", the drawn graph unweighted (no
    edge values), as a model that weights no edge takes it.  Returns
    (graph, perm), perm[new] = old; the host seconds of each go into
    `times`."""
    from repro_torch.graphs.degree import (apply_vertex_permutation,
                                           degree_sort_permutation)
    t = time.perf_counter()
    perm = degree_sort_permutation(graph)
    graph = apply_vertex_permutation(graph, perm)
    times["relabel_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if cfg["normalize"] == "gcn":
        graph = graph.gcn_normalized()
    elif cfg["normalize"] not in ("relation", "none"):
        raise ValueError(f"normalize {cfg['normalize']!r}")
    times["normalise_s"] = time.perf_counter() - t
    return graph, perm


def make_layers(cfg: Dict, device: torch.device, training: bool) -> List:
    """The stack through `make_gnn_stack`, configured as the file states."""
    from repro_torch.core.models import make_gnn_stack
    layers = make_gnn_stack(cfg["model"], cfg["dims"], backend=cfg["backend"],
                            num_relations=cfg["graph"].get("relations", 1),
                            tile=cfg["tile"], device=device)
    for layer in layers:
        layer.cfg.tile_format = cfg["tile_format"]
        layer.cfg.stage_order = cfg["stage_order"]
        layer.cfg.training = training
    return layers


def load_params(layers, params) -> None:
    """Write the harness's weights into the layers' own parameters."""
    with torch.no_grad():
        for layer, p in zip(layers, params):
            for k, v in p.items():
                getattr(layer, k).copy_(v)
