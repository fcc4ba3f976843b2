#!/usr/bin/env python3
"""Time the `fused_engn` kernel of whichever `repro_torch` is on the path,
one layer at a time, without checking its output.

    PYTHONPATH=<tree>/src python3 benchmarks/torch/time_fused_layers.py <label>

Layers (CUDA events, 20 calls after a warm call, random features and
weights): cora degree-sorted on dense T=256 tiles at the quickstart's
widths (1433 -> 64, 64 -> 7) and uncut pubmed as `build_gnn` makes it
at the training widths (128 -> 64, 64 -> 3), each through the plan's
column table.  It checks nothing, so it also times a tree whose kernel
was cut short on purpose (one that stops after computing P = X W, say);
`time_rer_kernels.py` holds the same rows to their plain version.  Put
two trees on the path in turns within one call to compare them.
Prints one JSON line.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys

CALLS = 20


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: time_fused_layers.py <label> (needs a CUDA card)",
              file=sys.stderr)
        return 2
    import repro_torch as rt
    from repro_torch.graphs.degree import (apply_vertex_permutation,
                                           degree_sort_permutation)
    from repro_torch.graphs.generate import make_dataset
    from repro_torch.kernels.fused_engn import ops as fused_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def feats(rows, width):
        return torch.randn((rows, width), generator=gen, device=dev) * 0.1

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / CALLS

    g_cora, f_cora, c_cora = make_dataset("cora", seed=0)
    g_cora = apply_vertex_permutation(
        g_cora, degree_sort_permutation(g_cora)).gcn_normalized()
    g_tr, _, _ = make_dataset("pubmed")
    cases = [("cora", g_cora, [(f_cora, 64), (64, c_cora)]),
             ("train", g_tr.gcn_normalized(), [(128, 64), (64, 3)])]
    out = {}
    with torch.inference_mode():
        for tag, g, widths in cases:
            plan = rt.prepare_graph(g, rt.EnGNConfig(
                widths[0][0], widths[0][1], backend="fused", tile=256))
            c = plan.carrier
            q, npad = c["blocks_meta"]["q"], c["blocks_meta"]["padded"]
            for f, h in widths:
                x, w = feats(npad, f), feats(f, h)
                out[f"{tag} {f}->{h}"] = timed(
                    lambda x=x, w=w: fused_ops.fused_engn_layer(
                        c["blocks"], c["block_row"], c["block_col"], x, w,
                        q=q, columns=c["fused_columns"]))
            del plan, c
    print(json.dumps({"label": sys.argv[1], "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
