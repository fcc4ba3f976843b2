"""Graph substrate of the port: host-side numpy carriers, copied from
the reference so the same seed builds the same graph bit for bit."""
from repro_torch.graphs.degree import (apply_vertex_permutation,
                                       degree_sort_permutation,
                                       permute_features, unpermute_features)
from repro_torch.graphs.format import BlockedAdjacency, COOGraph, coo_to_blocked
from repro_torch.graphs.generate import (DATASET_STATS, make_dataset,
                                         random_features, rmat_graph)
from repro_torch.graphs.partition import tile_schedule_order

__all__ = [
    "COOGraph", "BlockedAdjacency", "coo_to_blocked",
    "DATASET_STATS", "rmat_graph", "make_dataset", "random_features",
    "degree_sort_permutation", "apply_vertex_permutation",
    "permute_features", "unpermute_features", "tile_schedule_order",
]
