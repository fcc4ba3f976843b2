from repro_torch.kernels.rer_gather_bwd.ops import (packed_groups_t,
                                                   packed_groups_t_plain,
                                                   packed_max_count,
                                                   packed_max_count_plain,
                                                   packed_max_scatter,
                                                   packed_max_scatter_plain)

__all__ = ["packed_groups_t", "packed_groups_t_plain", "packed_max_count",
           "packed_max_count_plain", "packed_max_scatter",
           "packed_max_scatter_plain"]
