from tpu_rag_torch.ingest.schema import content_hash, normalize_text, normalize_value, slug
from tpu_rag_torch.ingest.chunker import to_chunks
from tpu_rag_torch.ingest.indexer import DocIndexer

__all__ = [
    "content_hash",
    "normalize_text",
    "normalize_value",
    "slug",
    "to_chunks",
    "DocIndexer",
]
