from repro_torch.kernels.rer_gather_gated.ops import (gated_backward,
                                                      gated_backward_plain,
                                                      gated_flat_plain,
                                                      gated_forward,
                                                      gated_groups_aggregate)

__all__ = ["gated_backward", "gated_backward_plain", "gated_flat_plain",
           "gated_forward", "gated_groups_aggregate"]
