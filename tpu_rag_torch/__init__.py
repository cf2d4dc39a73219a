"""tpu_rag_torch: the PyTorch / CUDA port of tpu_rag.

The same retrieval system as `tpu_rag` (ingest, embed, flat index, hybrid
search, HTTP serving), written against PyTorch for an NVIDIA Hopper GPU.
Module names follow `tpu_rag` so each counterpart is easy to find.  Plain
tensor code is PyTorch; every Pallas kernel of `tpu_rag` on the ported path
is a hand-written CUDA kernel under `csrc/`, built with nvcc on first use
(`_build.py`).

The package imports nothing of JAX or of `tpu_rag`.  Entry points run on
`cuda` unless the caller asks for `cpu` (the tests do); asking for `cuda`
without a card raises (`device.resolve`).
"""

__version__ = "0.1.0"
