from turdb_tpu_torch.ops.distance import (
    Metric,
    chain_norms,
    gathered_distances,
    normalize_rows,
    pairwise_distances,
    prep_norms,
    self_distances,
)
from turdb_tpu_torch.ops.topk import (
    mask_duplicates,
    member_mask,
    merge_topk,
    topk_smallest,
    topk_smallest_wide,
)

__all__ = [
    "Metric", "chain_norms", "gathered_distances", "normalize_rows", "pairwise_distances",
    "prep_norms", "self_distances", "mask_duplicates", "member_mask",
    "merge_topk", "topk_smallest", "topk_smallest_wide",
]
