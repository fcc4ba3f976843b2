"""EnGN on PyTorch and CUDA: the port of the `repro` package to an
NVIDIA Hopper card.

Module for module it mirrors `repro` (`graphs/`, `core/`, `kernels/`),
imports `torch` and numpy only, and runs its entry points on `cuda`
unless the caller asks for `device="cpu"`.  The three aggregation
kernels (`kernels/rer_spmm`, `kernels/rer_gather`, `kernels/fused_engn`)
are CUDA C++ under `csrc/`, built with `nvcc` at first use.
"""
from repro_torch.core.engn import (EnGNConfig, EnGNLayer, prepare_graph,
                                   segment_aggregate, update_plan)
from repro_torch.core.models import (MODEL_REGISTRY, apply_stack, init_stack,
                                     make_gnn, make_gnn_stack)
from repro_torch.core.plan import PreparedPlan
from repro_torch.device import resolve_device

__all__ = ["EnGNConfig", "EnGNLayer", "prepare_graph", "segment_aggregate",
           "update_plan",
           "MODEL_REGISTRY", "apply_stack", "init_stack", "make_gnn",
           "make_gnn_stack", "PreparedPlan", "resolve_device"]
