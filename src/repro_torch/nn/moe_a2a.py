"""Expert-parallel MoE dispatch via all-to-all (GShard-style), on a mesh
whose shards are co-located.

Why this exists (the reference's measurement on moonshot_v1_16b_a3b /
train_4k): scattering data-sharded tokens into a model-sharded expert
buffer under automatic partitioning lowers to full-buffer all-reduces.
The production dataflow routes tokens explicitly:

  1. each shard routes its local tokens (top-k, capacity-bounded) into
     a per-expert send buffer (E, cap_loc, D);
  2. one all-to-all over the model axis moves each expert's slice to
     the shard that owns it (experts are model-sharded);
  3. the owner runs the expert FFNs on (E_loc, M*cap_loc, D);
  4. the reverse all-to-all returns expert outputs to the token owners,
     which combine them with the router gates.

The reference runs this under `shard_map`, one program a device.  A
port mesh co-locates its shards on one device (ROADMAP §C divergence
10), so here `shard_map` is an explicit loop over the local blocks of
`x`, with the reference's divisibility fallback, and each all-to-all is
a permutation of the co-located shards' buffers: the M send buffers
(M, E_loc, cap, D) of one model group become the owners' (E_loc,
M*cap, D) and back.  Autograd runs through the copies; no
`torch.distributed` is involved.

Edge-centric note: this is the EnGN aggregate stage on the
token->expert bipartite graph, executed with the paper's tiling
discipline: tokens (edges) are grouped by destination (expert
interval), moved once, and reduced densely at the owner.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import mlp, no_sc
from repro_torch.nn.moe import route


def _axes_tuple(ax):
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, tuple) else (ax,)


def _mesh_size(mesh, axes) -> int:
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    return int(np.prod([shape.get(a, 1) for a in axes]))


def model_axis_size(mesh, rules) -> int:
    """Shards along the mesh axes the "experts" rule names."""
    return _mesh_size(mesh, _axes_tuple(rules.get("experts")))


def _local_dispatch(cfg: ModelConfig, router, xf, cap: int, dtype):
    """Route each block's local tokens xf (blocks, t, D) at capacity
    `cap`: returns (buf (blocks, E, cap, D), combine info)."""
    nblk, _, d = xf.shape
    e = cfg.n_experts
    r = route(cfg, router, xf, cap=cap)
    slot, gt, gp, keep = r["slot"], r["gt"], r["gp"], r["keep"]
    blk = torch.arange(nblk, device=xf.device)[:, None].expand_as(slot)
    buf = torch.zeros((nblk, e * cap + 1, d), dtype=dtype,
                      device=xf.device).index_put(
        (blk, slot), xf[blk, gt].to(dtype))
    return buf[:, :-1].reshape(nblk, e, cap, d), (blk, slot, gt, gp, keep)


def _local_combine(out_buf, info, t: int, d: int, dtype):
    """Scatter each block's expert outputs (blocks, E, cap, D) back to
    its local tokens with gate weights: (blocks, t, D)."""
    blk, slot, gt, gp, keep = info
    nblk = out_buf.shape[0]
    e_cap = out_buf.shape[1] * out_buf.shape[2]
    flat = out_buf.reshape(nblk, e_cap, d)
    contrib = flat[blk, torch.clamp_max(slot, e_cap - 1)]
    contrib = contrib * (gp * keep).to(dtype)[..., None]
    out = torch.zeros((nblk * t, d), dtype=dtype, device=flat.device)
    out = out.index_add(0, (blk * t + gt).reshape(-1),
                        contrib.reshape(-1, d))
    return out.reshape(nblk, t, d)


def _experts(h_in, wg, wu, wd):
    """The expert FFNs on (..., E, rows, D)."""
    dt = h_in.dtype
    act = (F.silu(torch.einsum("...ecd,edf->...ecf", h_in, wg.to(dt)))
           * torch.einsum("...ecd,edf->...ecf", h_in, wu.to(dt)))
    return torch.einsum("...ecf,efd->...ecd", act, wd.to(dt))


def _model_groups(cfg: ModelConfig, p, blocks, m: int, cap: int):
    """G model groups of M ranks each: blocks (G, M, t, D), rank order
    within a group -> their outputs (G, M, t, D), through each rank's
    dispatch, the all-to-all, the owners' experts, the reverse
    all-to-all and each rank's combine."""
    g, _, t, d = blocks.shape
    e = cfg.n_experts
    e_loc = e // m
    dtype = blocks.dtype
    buf, info = _local_dispatch(cfg, p["router"], blocks.reshape(g * m, t, d),
                                cap, dtype)
    # rank r's send buffer (M, E_loc, cap, D): slice o goes to owner o,
    # which receives (M, E_loc, cap, D) indexed by source rank and
    # computes on (E_loc, M*cap, D); over the owners that is (E, M*cap, D)
    send = buf.reshape(g, m, m, e_loc, cap, d)         # (g, src, dst, ...)
    h_in = send.permute(0, 2, 3, 1, 4, 5).reshape(g, e, m * cap, d)
    h_out = _experts(h_in, p["w_gate"], p["w_up"], p["w_down"])
    # reverse: each owner's rows (E_loc, M, cap, D) back to their source
    back = h_out.reshape(g, m, e_loc, m, cap, d).permute(0, 3, 1, 2, 4, 5)
    out = _local_combine(back.reshape(g * m, e, cap, d), info, t, d, dtype)
    return out.reshape(g, m, t, d)


def moe_ffn_a2a(cfg: ModelConfig, p, x: torch.Tensor, mesh, rules,
                capacity_factor: float = 1.25) -> torch.Tensor:
    """x: (B, S, D) global -> (B, S, D), the reference's
    `moe_ffn_a2a` on a co-located mesh."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    ex_ax = _axes_tuple(rules.get("experts"))[0]   # one model axis
    m = model_axis_size(mesh, rules)
    assert e % m == 0, (e, m)

    # the Constrainer's divisibility fallback: only shard dims that
    # divide their mesh-axis size
    bt_axes = _axes_tuple(rules.get("batch"))
    if b % max(_mesh_size(mesh, bt_axes), 1) != 0:
        bt_axes = ()
    seq_axes = _axes_tuple(rules.get("seq"))
    if s % max(_mesh_size(mesh, seq_axes), 1) != 0:
        seq_axes = ()
    seq_axes = seq_axes[:1]                  # x_spec shards seq on one axis
    b_loc = b // max(_mesh_size(mesh, bt_axes), 1)
    s_loc = s // max(_mesh_size(mesh, seq_axes), 1)
    t_loc = b_loc * s_loc
    cap = max(1, int(np.ceil(t_loc * k / e * capacity_factor)))

    shape = dict(zip(mesh.axis_names, mesh.devices.shape))

    def flat(coords, axes):
        i = 0
        for a in axes:
            i = i * shape[a] + coords.get(a, 0)
        return i

    # the shards that hold distinct blocks: every coordinate of the axes
    # x is sharded over, and the model axis (the all-to-all's); shards
    # that differ only along other axes hold replicas of the same work.
    # With seq unsharded (decode) every model rank of a group holds the
    # same tokens, and each computes its block, as the reference's do.
    group_axes = [a for a in mesh.axis_names
                  if a != ex_ax and (a in bt_axes or a in seq_axes)]
    where = []
    for g in itertools.product(*(range(shape[a]) for a in group_axes)):
        coords = dict(zip(group_axes, g))
        for r in range(m):
            coords[ex_ax] = r
            where.append((flat(coords, bt_axes), flat(coords, seq_axes)))
    nb, ns = b // b_loc, s // s_loc
    grid = x.reshape(nb, b_loc, ns, s_loc, d).permute(0, 2, 1, 3, 4)
    bi = torch.tensor([w[0] for w in where], device=x.device)
    si = torch.tensor([w[1] for w in where], device=x.device)
    blocks = grid[bi, si].reshape(-1, m, t_loc, d)
    outs = _model_groups(cfg, p, blocks, m, cap).reshape(-1, b_loc, s_loc, d)
    # each (batch, seq) block's output is its first rank's, as the
    # replicated out_spec reads it
    first = {}
    for j, at in enumerate(where):
        first.setdefault(at, j)
    pick = torch.tensor([first[(i, j)] for i in range(nb) for j in range(ns)],
                        device=x.device)
    out = outs[pick].reshape(nb, ns, b_loc, s_loc, d).permute(
        0, 2, 1, 3, 4).reshape(b, s, d)

    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], x.reshape(b * s, d), no_sc
                        ).reshape(b, s, d)
    return out
