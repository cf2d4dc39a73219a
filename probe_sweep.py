#!/usr/bin/env python3
"""Batch-shared IVF probe (#7) on one GPU: its device time by query count
and by the share of masked (PAD) slots, beside the read floor of the same
lists.

    python3 probe_sweep.py

On the ivf phase's geometry of chip_smoke.py (2048 int8 lists of cap 3968,
d 384, nprobe 64, m 2; seeded random lists), for 8, 32 and 64 queries:
#7 with every slot live, with each list's tail PAD (a fill drawn from
[cap/3, 2 cap/3), as chip_smoke.py's lists), and with every slot PAD (the
kernel then only loads its lists and writes -inf winners); and #4's read
floor over the union's lists gathered into one matrix.  Device time: 10
calls back to back between CUDA events, median of 5.  Prints one JSON line
per shape, the card's name and power limit, then all results as one JSON
object.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops import topk as tk
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    d, nlist, cap = 384, cs.IVF_NLIST, cs.IVF_CAP
    vec = torch.randint(-127, 128, (nlist, cap, d), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand((nlist, cap), generator=g, device=dev) * 1e-3 + 1e-3
    tags = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
    fill = torch.randint(cap // 3, (2 * cap) // 3, (nlist, 1), generator=g, device=dev)
    tail_pad = torch.where(torch.arange(cap, device=dev)[None, :] < fill, tags,
                           tk.PAD_TAG).contiguous()
    all_pad = torch.full_like(tags, tk.PAD_TAG)
    centroids = torch.randn((nlist, d), generator=g, device=dev)
    out = {}
    for nq in (8, 32, 64):
        q8, _ = quantize_int8_rows(torch.randn((nq, d), generator=g, device=dev))
        lists = ip._top_lists(q8.float(), centroids, cs.IVF_NPROBE)
        uniq, n_uniq, _ = ip._dedup(lists, nlist)
        nu = int(n_uniq)
        for name, ns in (("live", tags), ("tail_pad", tail_pad), ("all_pad", all_pad)):
            args = (q8, uniq, n_uniq, vec, scale, ns, ns, -1, -1, 2)
            ms = cs.cuda_ms(lambda: ip._probe_batched_cuda(*args), iters=5, batch=10)
            out[f"q{nq}_{name}"] = {"device_ms": ms, "union": nu,
                                    "tb_s": nu * cap * (d + 12) / ms / 1e9}
            print(json.dumps({f"q{nq}_{name}": out[f"q{nq}_{name}"]}), flush=True)
        flat = vec[uniq[:nu].long()].reshape(-1, d)
        out[f"q{nq}_read_floor_ms"] = cs.cuda_ms(lambda: tk._read_sum_cuda(flat), iters=5,
                                                 batch=10)
        print(json.dumps({f"q{nq}_read_floor_ms": out[f"q{nq}_read_floor_ms"]}), flush=True)
        del flat
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
