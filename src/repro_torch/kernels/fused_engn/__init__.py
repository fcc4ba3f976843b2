from repro_torch.kernels.fused_engn.ops import (ColumnTable, column_order,
                                               column_table, fused_engn_bwd,
                                               fused_engn_bwd_plain,
                                               fused_engn_layer,
                                               fused_engn_plain)

__all__ = ["ColumnTable", "column_order", "column_table", "fused_engn_bwd",
           "fused_engn_bwd_plain", "fused_engn_layer", "fused_engn_plain"]
