#!/usr/bin/env python3
"""The IVF probes on one GPU: the batch-shared probe (#7) by query count
and by the share of masked (PAD) slots, beside the read floor of the same
lists; and the per-list probe (#6) under its launch plan and the plans
around it.

    python3 probe_sweep.py                # both
    python3 probe_sweep.py --list         # #6 only
    python3 probe_sweep.py --list --f32   # #6 on f32 lists only

On the ivf phase's geometry of chip_smoke.py (2048 int8 lists of cap 3968,
d 384, nprobe 64, m 2; seeded random lists), for 8, 32 and 64 queries:
#7 with every slot live, with each list's tail PAD (a fill drawn from
[cap/3, 2 cap/3), as chip_smoke.py's lists), and with every slot PAD (the
kernel then only loads its lists and writes -inf winners); and #4's read
floor over the union's lists gathered into one matrix.  #6 on the same
lists (every slot live, k 40) at 1 and 3 queries, int8 and bf16: the plan
_list_plan picks and others (split 1-4; 128- or 64-row stages, as many as
fit one, two or three resident blocks), beside the read floor of the
probed lists.  Device time: 10 calls back to back between CUDA events,
median of 5; for #6 the kernel's own time (torch.profiler, chip_smoke's
kernel_ms), since its wrapper's host time exceeds it.  #6 on f32 lists
(--f32; chip_smoke.py's f32 geometry: 256 lists of cap 1024, ~90% live,
nprobe 16, k 40, d 384 and 768) at 1 and 3 queries: the plan _list_plan
picks and split 1, 2, 4 and 8 with as many one-box stages as one, two or
three resident blocks leave.  Prints one JSON line
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
    if "--list" in sys.argv[1:] and "--f32" in sys.argv[1:]:
        del vec, scale, tags, tail_pad, all_pad
        return _f32_list_sweep(cs, ip, g)
    if "--list" in sys.argv[1:]:
        return _list_sweep(cs, ip, tk, quantize_int8_rows, vec, scale, tags, centroids, g)
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


def _list_sweep(cs, ip, tk, quantize_int8_rows, vec, scale, tags, centroids, g) -> int:
    import torch

    from tpu_rag_torch.native.binding import layout

    dev, d, cap = vec.device, vec.shape[2], vec.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k = cs.IVF_KSCAN
    list_plan = ip._list_plan
    lay = layout()
    out = {}
    lists_bf = vec.to(torch.bfloat16).mul_(1e-3)
    ones = torch.ones_like(scale)
    for dtype, lv, sv in ((torch.int8, vec, scale), (torch.bfloat16, lists_bf, ones)):
        code = tk._DTYPE_CODE[dtype]
        for nq in (1, 3):
            qf = torch.randn((nq, d), generator=g, device=dev)
            lists = ip._top_lists(qf, centroids, cs.IVF_NPROBE)
            q_in = (quantize_int8_rows(qf)[0] if dtype == torch.int8
                    else (qf / qf.norm(dim=1, keepdim=True)).to(torch.bfloat16))
            args = (q_in, lists, lv, sv, tags, tags, -1, -1, k)
            default = list_plan(nq, cs.IVF_NPROBE, cap, d, dtype, k, sms)
            plans = {default}
            for split in (1, 2, 4):
                for per_sm in (1, 2, 3):
                    for rows in (64, 128):
                        stages = lay.tr_list_fit(code, d, k, rows, per_sm)
                        if stages >= 2:
                            plans.add(ip.ListPlan(split, rows, stages, nq * 64 * split, per_sm,
                                                  lay.tr_list_smem(code, d, k, stages, rows)))
            name = f"per_list[{str(dtype)[6:]},q={nq}]"
            res = []
            for plan in sorted(plans):
                ip._list_plan = lambda *_, plan=plan: plan     # the wrapper launches `plan`
                try:
                    ms = cs.kernel_ms(lambda: ip._probe_list_cuda(*args), "probe_split_kernel")
                finally:
                    ip._list_plan = list_plan
                res.append({"plan": plan._asdict(), "device_ms": ms, "default": plan == default})
                print(json.dumps({name: res[-1]}), flush=True)
            flat = lv[lists.reshape(-1)].reshape(-1, d)
            floor = cs.cuda_ms(lambda: tk._read_sum_cuda(flat), iters=5, batch=10)
            del flat
            out[name] = {"plans": res, "read_floor_ms": floor}
            print(json.dumps({name + "_read_floor_ms": floor}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps(out), flush=True)
    return 0


def _f32_list_sweep(cs, ip, g) -> int:
    import torch

    from tpu_rag_torch.native.binding import layout
    from tpu_rag_torch.ops.topk import PAD_TAG

    dev = g.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nlist, cap, nprobe, k = 256, 1024, 16, 40
    list_plan = ip._list_plan
    lay = layout()
    out = {}
    for d in (384, 768):
        vec = torch.randn((nlist, cap, d), generator=g, device=dev)
        vec /= vec.norm(dim=2, keepdim=True)
        ones = torch.ones((nlist, cap), device=dev)
        ns = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
        ns[:, -100:] = PAD_TAG
        centroids = torch.randn((nlist, d), generator=g, device=dev)
        for nq in (1, 3):
            q = torch.randn((nq, d), generator=g, device=dev)
            q /= q.norm(dim=1, keepdim=True)
            args = (q, ip._top_lists(q, centroids, nprobe), vec, ones, ns, ns, -1, -1, k)
            default = list_plan(nq, nprobe, cap, d, torch.float32, k, sms)
            plans = {default}
            for split in (1, 2, 4, 8):
                for per_sm in (1, 2, 3):
                    stages = lay.tr_list_fit(0, d, k, 128, per_sm)
                    if stages >= 2:
                        plans.add(ip.ListPlan(split, 128, stages, nq * nprobe * split, per_sm,
                                              lay.tr_list_smem(0, d, k, stages, 128)))
            name = f"per_list[f32,q={nq},d={d}]"
            res = []
            for plan in sorted(plans):
                ip._list_plan = lambda *_, plan=plan: plan     # the wrapper launches `plan`
                try:
                    ms = cs.kernel_ms(lambda: ip._probe_list_cuda(*args), "probe_f32_kernel")
                finally:
                    ip._list_plan = list_plan
                res.append({"plan": plan._asdict(), "device_ms": ms, "default": plan == default})
                print(json.dumps({name: res[-1]}), flush=True)
            out[name] = {"plans": res}
        del vec, ones, ns
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
