from repro_torch.utils.tree import (  # noqa: F401
    tree_add,
    tree_cast,
    tree_global_norm,
    tree_num_params,
    tree_scale,
    tree_size_bytes,
    tree_weighted_sum,
    tree_zeros_like,
)
