"""The port's kernels: the aggregates, their backward kernels, the
fused linear + activation, R-GCN's typed pair projection and
Gated-GCN's gated aggregate.  Each
`<name>/ops.py` holds the wrapper (the hand-written CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors), the plain version
itself, and the wrapper's launch counter; the CUDA sources are
`csrc/<name>.cu`."""
from __future__ import annotations

from typing import Dict


def _modules():
    from repro_torch.kernels.chunk_queue import ops as queue_ops
    from repro_torch.kernels.feature_update import ops as update_ops
    from repro_torch.kernels.fused_engn import ops as fused_ops
    from repro_torch.kernels.rer_gather import ops as gather_ops
    from repro_torch.kernels.rer_gather_bwd import ops as gather_bwd_ops
    from repro_torch.kernels.rer_gather_gated import ops as gated_ops
    from repro_torch.kernels.rer_spmm import ops as spmm_ops
    from repro_torch.kernels.rer_spmm_bwd import ops as spmm_bwd_ops
    from repro_torch.kernels.typed_pairs import ops as pairs_ops
    return {"rer_spmm": spmm_ops, "rer_gather": gather_ops,
            "fused_engn": fused_ops, "chunk_queue": queue_ops,
            "rer_spmm_bwd": spmm_bwd_ops, "rer_gather_bwd": gather_bwd_ops,
            "feature_update": update_ops, "typed_pairs": pairs_ops,
            "rer_gather_gated": gated_ops}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, keyed "<kernel>_<op>"."""
    return {f"{name}_{op}": n for name, mod in _modules().items()
            for op, n in mod.LAUNCHES.items()}


def reset_launch_counts() -> None:
    for mod in _modules().values():
        for op in mod.LAUNCHES:
            mod.LAUNCHES[op] = 0
