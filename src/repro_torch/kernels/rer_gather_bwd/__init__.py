from repro_torch.kernels.rer_gather_bwd.ops import (packed_max_count,
                                                   packed_max_count_plain,
                                                   packed_max_grad,
                                                   packed_max_grad_plain)

__all__ = ["packed_max_count", "packed_max_count_plain", "packed_max_grad",
           "packed_max_grad_plain"]
