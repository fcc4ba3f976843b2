from repro_torch.kernels.rer_spmm_bwd.ops import (RowCounts,
                                                 blocked_spmm_max_bwd,
                                                 blocked_spmm_max_bwd_plain,
                                                 row_counts, slab_max,
                                                 slab_rows, upload_row_counts)

__all__ = ["RowCounts", "blocked_spmm_max_bwd", "blocked_spmm_max_bwd_plain",
           "row_counts", "slab_max", "slab_rows", "upload_row_counts"]
