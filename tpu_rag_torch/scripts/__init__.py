"""Command-line tools of the port: `python -m tpu_rag_torch.scripts.<tool>`."""
