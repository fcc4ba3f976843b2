from repro_torch.kernels.rer_spmm.ops import (blocked_spmm, blocked_spmm_plain,
                                             prepare_blocks)

__all__ = ["blocked_spmm", "blocked_spmm_plain", "prepare_blocks"]
