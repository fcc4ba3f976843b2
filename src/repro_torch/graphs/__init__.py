"""Graph substrate of the port: host-side numpy carriers, copied from
the reference so the same seed builds the same graph bit for bit."""
from repro_torch.graphs.degree import (apply_vertex_permutation,
                                       degree_sort_permutation,
                                       hub_edge_coverage, permute_features,
                                       unpermute_features)
from repro_torch.graphs.format import BlockedAdjacency, COOGraph, coo_to_blocked
from repro_torch.graphs.generate import (DATASET_STATS, dataset_stats,
                                         make_dataset, random_features,
                                         rmat_graph)
from repro_torch.graphs.partition import grid_partition, tile_schedule_order

__all__ = [
    "COOGraph", "BlockedAdjacency", "coo_to_blocked",
    "DATASET_STATS", "rmat_graph", "dataset_stats", "make_dataset",
    "random_features", "degree_sort_permutation",
    "apply_vertex_permutation", "hub_edge_coverage", "permute_features",
    "unpermute_features", "grid_partition", "tile_schedule_order",
]
