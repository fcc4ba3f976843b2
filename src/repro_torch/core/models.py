"""GNN models of the paper's Table 1 on the EnGN processing model.

| model     | feature_extraction          | aggregate | update                 |
|-----------|-----------------------------|-----------|------------------------|
| GCN       | XW (norm folded in weights) | sum       | ReLU                   |
| GS-Pool   | ReLU(W_pool x_u + b)        | max       | ReLU(W concat(agg, h)) |
| GRN       | W h_u                       | sum       | GRU(h_v, agg)          |

R-GCN and Gated-GCN ride the typed/gated stage contracts and come with
the next slice of the port (ROADMAP A3); `make_gnn` names that item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.engn import EnGNConfig, EnGNLayer
from repro_torch.device import DeviceLike


def _glorot(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    scale = np.sqrt(2.0 / (shape[0] + shape[-1]))
    return torch.randn(shape, generator=gen, dtype=dtype) * scale


class GCNLayer(EnGNLayer):
    """Kipf & Welling GCN (Eq. 1): D~^-1/2 A~ D~^-1/2 is folded into the
    edge weights host-side (`COOGraph.gcn_normalized`), so extraction is
    the plain XW condense — the layer where DASR applies."""


class GSPoolLayer(EnGNLayer):
    """GraphSAGE-Pool (Eq. 2): max aggregator + concat self in update."""

    def __init__(self, cfg: EnGNConfig, name: str = "gs_pool", **kw):
        # copy-on-configure: never mutate the caller's (possibly shared) cfg
        cfg = dataclasses.replace(
            cfg, aggregate_op="max",
            stage_order="fau")    # max is non-linear: no reordering (S6.3)
        super().__init__(cfg, name, **kw)

    def init_params(self, gen):
        cfg = self.cfg
        return {
            "w_pool": _glorot(gen, (cfg.in_dim, cfg.out_dim), cfg.dtype),
            "b_pool": torch.zeros((cfg.out_dim,), dtype=cfg.dtype),
            "w": _glorot(gen, (cfg.out_dim + cfg.in_dim, cfg.out_dim),
                         cfg.dtype),
        }

    def feature_extraction(self, x_src):
        return torch.relu(x_src @ self.w_pool + self.b_pool)

    def update(self, x_self, agg):
        return torch.relu(torch.cat([agg, x_self], dim=-1) @ self.w)


class GRNLayer(EnGNLayer):
    """Graph recurrent network (Eq. 5): h' = GRU(h_v, sum_u W h_u)."""

    def init_params(self, gen):
        cfg = self.cfg
        if cfg.in_dim != cfg.out_dim:
            raise ValueError("GRU state keeps the dimension: in_dim must "
                             f"equal out_dim, got {cfg.in_dim}, "
                             f"{cfg.out_dim}")
        d = cfg.in_dim
        return {k: _glorot(gen, (d, d), cfg.dtype)
                for k in ("w", "w_z", "u_z", "w_r", "u_r", "w_n", "u_n")}

    def feature_extraction(self, x_src):
        return x_src @ self.w

    def update(self, x_self, agg):
        z = torch.sigmoid(agg @ self.w_z + x_self @ self.u_z)
        r = torch.sigmoid(agg @ self.w_r + x_self @ self.u_r)
        nh = torch.tanh(agg @ self.w_n + (r * x_self) @ self.u_n)
        return (1.0 - z) * nh + z * x_self


MODEL_REGISTRY = {
    "gcn": GCNLayer,
    "gs_pool": GSPoolLayer,
    "grn": GRNLayer,
}
_NEXT_SLICE = ("rgcn", "gated_gcn")


def make_gnn(model: str, in_dim: int, out_dim: int, backend: str = "segment",
             tile: int = 256, stage_order: str = "auto",
             device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> EnGNLayer:
    if model in _NEXT_SLICE:
        raise NotImplementedError(
            f"{model!r} needs the typed/gated stage contracts, which are "
            f"not ported yet (ROADMAP A3)")
    cfg = EnGNConfig(in_dim=in_dim, out_dim=out_dim, backend=backend,
                     tile=tile, stage_order=stage_order)
    return MODEL_REGISTRY[model](cfg, device=device, generator=generator)


def make_gnn_stack(model: str, dims, backend: str = "segment",
                   tile: int = 256, device: DeviceLike = None,
                   seed: int = 0):
    """A multi-layer GNN: dims = [F_in, H_1, ..., H_out], its weights
    drawn in layer order from one generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    return [make_gnn(model, dims[i], dims[i + 1], backend=backend,
                     tile=tile, device=device, generator=gen)
            for i in range(len(dims) - 1)]


def init_stack(layers, generator: Union[int, torch.Generator]) -> None:
    """Redraw every layer's weights, in layer order, from one generator
    (or a seed for one)."""
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    for layer in layers:
        layer.reset_parameters(generator)


def apply_stack(layers, graph, x, params=None) -> torch.Tensor:
    """The stack's forward.  `params`, a list of per-layer dicts of
    tensors keyed like each layer's parameters (what `stack_params`
    returns, or the reference's `init_stack`), runs the layers on those
    tensors instead of their own (`torch.func.functional_call`): the
    functional form the train step differentiates."""
    for i, layer in enumerate(layers):
        x = (layer(graph, x) if params is None
             else torch.func.functional_call(layer, params[i], (graph, x)))
    return x


def stack_params(layers):
    """The layers' parameters as a list of per-layer dicts of detached
    tensors, the reference's parameter layout."""
    return [{k: v.detach() for k, v in layer.named_parameters()}
            for layer in layers]
