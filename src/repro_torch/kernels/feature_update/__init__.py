from repro_torch.kernels.feature_update.ops import (fused_linear_act,
                                                   fused_linear_act_plain)

__all__ = ["fused_linear_act", "fused_linear_act_plain"]
