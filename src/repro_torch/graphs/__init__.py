"""Graph substrate of the port: host-side numpy carriers, copied from
the reference so the same seed builds the same graph bit for bit, and
the dynamic-graph update log."""
from repro_torch.graphs.degree import (apply_vertex_permutation,
                                       degree_sort_permutation,
                                       hub_edge_coverage, permute_features,
                                       unpermute_features)
from repro_torch.graphs.format import (BlockedAdjacency, COOGraph, CSRGraph,
                                       coo_to_blocked, coo_to_csr)
from repro_torch.graphs.generate import (DATASET_STATS, dataset_stats,
                                         make_dataset, random_features,
                                         rmat_graph, zipf_traffic)
from repro_torch.graphs.partition import grid_partition, tile_schedule_order
from repro_torch.graphs.subgraph import (Subgraph, SubgraphExtractor,
                                         extract_khop)
from repro_torch.graphs.updates import EpochSnapshot, UpdateBatch, UpdateLog

__all__ = [
    "COOGraph", "CSRGraph", "BlockedAdjacency", "coo_to_csr",
    "coo_to_blocked", "DATASET_STATS", "rmat_graph", "dataset_stats",
    "make_dataset", "random_features", "zipf_traffic",
    "degree_sort_permutation", "apply_vertex_permutation",
    "hub_edge_coverage", "permute_features", "unpermute_features",
    "grid_partition", "tile_schedule_order",
    "Subgraph", "SubgraphExtractor", "extract_khop",
    "UpdateLog", "EpochSnapshot", "UpdateBatch",
]
