from tpu_rag_torch.retrieval.hybrid import (
    filter_meta_hits,
    highlight,
    is_meta_hit,
    mix_with_recency,
    vector_hits,
)

__all__ = [
    "filter_meta_hits",
    "highlight",
    "is_meta_hit",
    "mix_with_recency",
    "vector_hits",
]
