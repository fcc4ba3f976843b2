from repro_torch.kernels.chunk_queue.ops import (ChunkQueue, TileQueue,
                                                 build_chunk_queue,
                                                 build_tile_queue,
                                                 chunk_queue_aggregate,
                                                 make_queue_max_diff,
                                                 queue_bytes,
                                                 queue_sweep_plain,
                                                 tile_queue_aggregate,
                                                 tile_queue_bytes,
                                                 tile_queue_plain,
                                                 tile_queue_t,
                                                 tile_queue_t_plain)

__all__ = ["ChunkQueue", "TileQueue", "build_chunk_queue", "build_tile_queue",
           "chunk_queue_aggregate", "make_queue_max_diff", "queue_bytes",
           "queue_sweep_plain", "tile_queue_aggregate", "tile_queue_bytes",
           "tile_queue_plain", "tile_queue_t", "tile_queue_t_plain"]
