"""GNN models of the paper's Table 1 on the EnGN processing model.

| model     | feature_extraction               | aggregate | update                  |
|-----------|----------------------------------|-----------|-------------------------|
| GCN       | XW (norm folded in weights)      | sum       | ReLU                    |
| GS-Pool   | ReLU(W_pool x_u + b)             | max       | ReLU(W concat(agg, h))  |
| R-GCN     | W_r h_u per relation (typed)     | sum       | ReLU(sum_r V_r + W_0 h) |
| Gated-GCN | sigmoid(W_H h_v + W_C h_u) h_u   | sum       | ReLU(W V_temp)          |
| GRN       | W h_u                            | sum       | GRU(h_v, agg)           |

R-GCN and Gated-GCN ride the typed and gated stage contracts
(`stage_spec()` with `src_payload` and `pair_payload` / `gate_dst` /
`gate_src`) on "segment", "blocked", "ring" and "tiled"; "fused" serves
the default contract only and refuses them, as the reference does.  Their
parameters are the reference's by name and shape (`w0`, `wr` of shape
(R, F, H); `w_h`, `w_c`, `w`), so `interop.load_reference_params`
carries them across unchanged.
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


class RGCNLayer(EnGNLayer):
    """Relational GCN (Eq. 3): one aggregation per relation type, summed
    through per-relation weights, plus a self-loop W_0 h."""

    def __init__(self, cfg: EnGNConfig, num_relations: int,
                 name: str = "rgcn", **kw):
        # copy-on-configure: the typed stage contract is part of this
        # layer's identity, not the caller's shared cfg
        cfg = dataclasses.replace(
            cfg, stage_contract="typed", num_relations=num_relations,
            rel_normalize=True)
        super().__init__(cfg, name, **kw)
        self.num_relations = num_relations

    def init_params(self, gen):
        cfg = self.cfg
        return {
            "w0": _glorot(gen, (cfg.in_dim, cfg.out_dim), cfg.dtype),
            "wr": _glorot(gen, (cfg.num_relations, cfg.in_dim, cfg.out_dim),
                          cfg.dtype),
        }

    def stage_spec(self):
        return {"kind": "typed", "num_relations": self.num_relations,
                "channels": self.cfg.out_dim, "normalize": True}

    def src_payload(self, x):
        """The (N, R*H) stack of every relation's projection; each typed
        carrier (tile, flat entry) selects its own H slice."""
        r, h = self.num_relations, self.cfg.out_dim
        return torch.einsum("nf,rfh->nrh", x, self.wr).reshape(
            x.shape[0], r * h)

    def pair_payload(self, x, pairs):
        """(P, H): the projection of each (src, relation) pair of a typed
        plan's `typed_pairs`, x[src] @ W_rel, the rows of `src_payload`
        that its flat entries read."""
        from repro_torch.kernels.typed_pairs import typed_pair_project
        return typed_pair_project(x, self.wr, pairs)

    def extract(self, x_src, x_dst, edge_val, rel):
        """The reference per-edge message: W_rel x_src scaled by the
        (already rel-normalised) edge value."""
        r, h = self.num_relations, self.cfg.out_dim
        pay = self.src_payload(x_src).reshape(-1, r, h)
        sel = torch.gather(pay, 1, rel.long()[:, None, None].expand(-1, 1, h))
        return edge_val[:, None] * sel[:, 0, :]

    def update(self, x_self, agg):
        return torch.relu(x_self @ self.w0 + agg)


class GatedGCNLayer(EnGNLayer):
    """Gated-GCN (Eq. 4): edge gate eta_uv = sigmoid(W_H h_v + W_C h_u),
    message = eta . h_u, sum-aggregate, ReLU(W .) update."""

    def __init__(self, cfg: EnGNConfig, name: str = "gated_gcn", **kw):
        # copy-on-configure: never mutate the caller's (possibly shared) cfg
        cfg = dataclasses.replace(
            cfg, stage_contract="gated",
            stage_order="fau")  # gate depends on both endpoints: no reorder
        super().__init__(cfg, name, **kw)

    def init_params(self, gen):
        cfg = self.cfg
        return {
            "w_h": _glorot(gen, (cfg.in_dim, cfg.in_dim), cfg.dtype),
            "w_c": _glorot(gen, (cfg.in_dim, cfg.in_dim), cfg.dtype),
            "w": _glorot(gen, (cfg.in_dim, cfg.out_dim), cfg.dtype),
        }

    def stage_spec(self):
        return {"kind": "gated"}

    def gate_dst(self, x):
        return x @ self.w_h

    def gate_src(self, x):
        return x @ self.w_c

    def extract(self, x_src, x_dst, edge_val, rel):
        """The reference per-edge message: eta_uv . h_u, weighted by the
        edge value."""
        eta = torch.sigmoid(self.gate_dst(x_dst) + self.gate_src(x_src))
        return edge_val[:, None] * eta * x_src

    def update(self, x_self, agg):
        return torch.relu(agg @ self.w)


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
    "rgcn": RGCNLayer,
    "gated_gcn": GatedGCNLayer,
    "grn": GRNLayer,
}


def make_gnn(model: str, in_dim: int, out_dim: int, backend: str = "segment",
             num_relations: int = 1, tile: int = 256,
             stage_order: str = "auto", device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> EnGNLayer:
    cfg = EnGNConfig(in_dim=in_dim, out_dim=out_dim, backend=backend,
                     tile=tile, stage_order=stage_order)
    if model == "rgcn":
        return RGCNLayer(cfg, num_relations, device=device,
                         generator=generator)
    return MODEL_REGISTRY[model](cfg, device=device, generator=generator)


def make_gnn_stack(model: str, dims, backend: str = "segment",
                   num_relations: int = 1, tile: int = 256,
                   device: DeviceLike = None, seed: int = 0):
    """A multi-layer GNN: dims = [F_in, H_1, ..., H_out], its weights
    drawn in layer order from one generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    return [make_gnn(model, dims[i], dims[i + 1], backend=backend,
                     num_relations=num_relations, tile=tile, device=device,
                     generator=gen)
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
