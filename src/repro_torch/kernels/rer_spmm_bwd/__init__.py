from repro_torch.kernels.rer_spmm_bwd.ops import (blocked_spmm_max_bwd,
                                                 blocked_spmm_max_bwd_plain)

__all__ = ["blocked_spmm_max_bwd", "blocked_spmm_max_bwd_plain"]
