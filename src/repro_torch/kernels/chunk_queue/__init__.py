from repro_torch.kernels.chunk_queue.ops import (ChunkQueue, TileQueue,
                                                 build_chunk_queue,
                                                 build_tile_queue,
                                                 chunk_queue_aggregate,
                                                 queue_bytes,
                                                 queue_sweep_plain,
                                                 tile_queue_aggregate,
                                                 tile_queue_plain)

__all__ = ["ChunkQueue", "TileQueue", "build_chunk_queue", "build_tile_queue",
           "chunk_queue_aggregate", "queue_bytes", "queue_sweep_plain",
           "tile_queue_aggregate", "tile_queue_plain"]
