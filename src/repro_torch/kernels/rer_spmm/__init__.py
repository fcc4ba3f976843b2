from repro_torch.kernels.rer_spmm.ops import (TransposedBlocks, blocked_spmm,
                                             blocked_spmm_plain,
                                             blocked_spmm_t, prepare_blocks,
                                             transpose_blocks_on)

__all__ = ["TransposedBlocks", "blocked_spmm", "blocked_spmm_plain",
           "blocked_spmm_t", "prepare_blocks", "transpose_blocks_on"]
