"""The benchmark of tpu_rag_torch: `python3 perfbench/run.py --workload <cell> ...`."""
