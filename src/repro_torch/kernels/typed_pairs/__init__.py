from repro_torch.kernels.typed_pairs.ops import (TypedPairs, pair_blocks,
                                                 pair_table,
                                                 typed_pair_grad_w_plain,
                                                 typed_pair_grad_x_plain,
                                                 typed_pair_project,
                                                 typed_pair_project_plain)

__all__ = ["TypedPairs", "pair_blocks", "pair_table",
           "typed_pair_grad_w_plain", "typed_pair_grad_x_plain",
           "typed_pair_project", "typed_pair_project_plain"]
