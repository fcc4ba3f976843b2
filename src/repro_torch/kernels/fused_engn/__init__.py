from repro_torch.kernels.fused_engn.ops import (fused_engn_bwd,
                                               fused_engn_bwd_plain,
                                               fused_engn_layer,
                                               fused_engn_plain)

__all__ = ["fused_engn_bwd", "fused_engn_bwd_plain", "fused_engn_layer",
           "fused_engn_plain"]
