from repro_torch.kernels.rer_gather.ops import (PackedGroup, flat_entries,
                                               packed_flat_plain, packed_spmm,
                                               packed_spmm_plain,
                                               packed_tile_part,
                                               packed_tile_part_plain,
                                               prepare_packed_groups)

__all__ = ["PackedGroup", "flat_entries", "packed_flat_plain", "packed_spmm",
           "packed_spmm_plain", "packed_tile_part", "packed_tile_part_plain",
           "prepare_packed_groups"]
