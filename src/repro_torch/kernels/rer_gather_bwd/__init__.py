from repro_torch.kernels.rer_gather_bwd.ops import (
    packed_groups_t, packed_groups_t_plain, packed_max_backward,
    packed_max_backward_plain, packed_max_count, packed_max_count_plain,
    packed_max_resolve, packed_max_resolve_plain, packed_max_scatter,
    packed_max_scatter_plain, packed_max_words, packed_max_words_plain,
    unit_weights)

__all__ = ["packed_groups_t", "packed_groups_t_plain", "packed_max_backward",
           "packed_max_backward_plain", "packed_max_count",
           "packed_max_count_plain", "packed_max_resolve",
           "packed_max_resolve_plain", "packed_max_scatter",
           "packed_max_scatter_plain", "packed_max_words",
           "packed_max_words_plain", "unit_weights"]
