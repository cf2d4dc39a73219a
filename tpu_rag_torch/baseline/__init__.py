"""CPU baselines the GPU engine is measured against (BASELINE.md config #1)."""

from tpu_rag_torch.baseline.hnsw_cpu import CpuHnswIndex

__all__ = ["CpuHnswIndex"]
