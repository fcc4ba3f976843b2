from repro_torch.kernels.rer_gather.ops import (PackedGroup, PlanGroups,
                                               flat_entries,
                                               packed_flat_plain,
                                               packed_groups_plain,
                                               packed_groups_spmm,
                                               packed_spmm, packed_spmm_plain,
                                               packed_tile_part,
                                               packed_tile_part_plain,
                                               prepare_packed_groups)

__all__ = ["PackedGroup", "PlanGroups", "flat_entries", "packed_flat_plain",
           "packed_groups_plain", "packed_groups_spmm", "packed_spmm",
           "packed_spmm_plain", "packed_tile_part", "packed_tile_part_plain",
           "prepare_packed_groups"]
