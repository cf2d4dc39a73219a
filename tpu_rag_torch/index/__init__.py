from tpu_rag_torch.index.filter import TagVocab
from tpu_rag_torch.index.flat import FlatIndex, SearchResult
from tpu_rag_torch.index.ivf import IVFIndex
from tpu_rag_torch.index.store import load_index, save_index

__all__ = [
    "TagVocab",
    "FlatIndex",
    "IVFIndex",
    "SearchResult",
    "load_index",
    "save_index",
]
