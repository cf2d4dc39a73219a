#!/usr/bin/env python3
"""A/B timing of the port's scan (#1 #2 #3), attention (#5) and IVF probe
(#6 #7) kernels between checkouts of this repository, on one GPU.

    python3 kernel_ab.py [--profile] PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout: its tpu_rag_torch/ is imported in
a subprocess of its own and builds its kernels into its own build/.  The
runs go in the order given, so "parent, change, change, parent" puts both
sides in one call on one card.  Each run prints one JSON line: per shape,
the median ms of one wrapper call at a time (CUDA events around the call,
as chip_smoke.py times its kernels line) and the device's ms (10 calls back
to back); the last line holds each shape's values in run order.  #6 and
#7 come once from the checkout's own chip_smoke.py (its kernels line's
`ms`) and once with both times on lists seeded the same for every
checkout: #6 at one and three queries on int8 lists and at one on bf16
lists (k 40), #7 at 8 and 64 queries (m 2).  The data is the same in
every run (seeded on the card), as in chip_smoke.py.
With --profile each shape also gets its device time per kernel and its
wall time, per call (torch.profiler over 5 calls): where a wrapper's time
goes between its kernels, the library calls around them and the host.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

SEED = 0
SCANS = (("exact", "bf16", 1, 20), ("exact", "bf16", 8, 20), ("exact", "bf16", 64, 20),
         ("exact", "int8", 64, 40), ("exact", "int8", 8, 1024),
         ("packed", "bf16", 8, 64), ("packed", "int8", 64, 80))
ATTENTION_T = (128, 256, 512)


def _ms(fn, iters: int, batch: int) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def _profile(fn, reps: int = 5, warmup: bool = True) -> dict:
    """torch.profiler over `reps` calls of fn after one warm-up call (none
    with warmup=False, for a training step whose call must not repeat): the
    wall time, each kernel's device time and each record_function range's
    device span, per call (ms).  chip_smoke.py's kernel times and its serve
    window's and training steps' breakdowns come from here too."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    by_kernel, spans = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                      # host ops; their kernels are listed
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us > 0:
            # a record_function range (e.g. Optimizer.step) shows on the
            # device as the span of its kernels, gaps included: kept apart,
            # or device_ms would count its kernels twice
            out = spans if getattr(e, "is_user_annotation", False) else by_kernel
            out[e.key] = us / reps / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": sum(by_kernel.values()),
            "by_kernel_ms": by_kernel, "spans_ms": spans}


def _both(fn, profile: bool) -> dict:
    out = {"ms": _ms(fn, 20, 1), "device_ms": _ms(fn, 5, 10)}
    if profile:
        prof = _profile(fn)
        top = sorted(prof["by_kernel_ms"].items(), key=lambda kv: -kv[1])[:6]
        out["profile"] = {**prof, "by_kernel_ms": {key[:60]: ms for key, ms in top}}
    return out


def worker(root: Path, profile: bool) -> dict:
    import torch

    sys.path.insert(0, str(root))
    from tpu_rag_torch.ops import attention as att
    from tpu_rag_torch.ops import topk as tk
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    if not Path(tk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {tk.__file__}, not the checkout at {root}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    n, d = 1_000_000, 384
    x = torch.randn((n, d), generator=g, device=dev)
    x /= x.norm(dim=1, keepdim=True)
    ns = torch.randint(0, 4, (n,), generator=g, device=dev, dtype=torch.int32)
    canon = torch.zeros_like(ns)
    ns[-1000:] = tk.PAD_TAG
    xb = x.to(torch.bfloat16)
    x8, s8 = quantize_int8_rows(x)
    del x
    out = {}
    kernels = {"exact": tk._exact_scan_cuda, "packed": tk._packed_scan_cuda}
    for mode, dtype, nq, k in SCANS:
        qf = torch.randn((nq, d), generator=g, device=dev)
        if dtype == "bf16":
            args = (qf.to(torch.bfloat16), xb, None, ns, canon, None, -1, -1, k)
        else:
            q8, qs = quantize_int8_rows(qf)
            args = (q8, x8, s8, ns, canon, qs, -1, -1, k)
        out[f"{mode}_scan[{dtype},q={nq},k={k}]"] = _both(lambda: kernels[mode](*args), profile)
    del xb
    x8 = torch.cat([x8, x8])                          # 2M rows int8, as the scale cell
    s8, ns, canon = torch.cat([s8, s8]), torch.cat([ns, ns]), torch.cat([canon, canon])
    q8, _ = quantize_int8_rows(torch.randn((64, d), generator=g, device=dev))
    out["bucketed_scan[int8,n=2M,q=64]"] = _both(
        lambda: tk._bucketed_scan_cuda(q8, x8, s8, ns, canon, -1, -1), profile)
    del x8, s8, ns, canon
    for t in ATTENTION_T:
        q, k_, v = (torch.randn((64, t, 12, 32), generator=g, device=dev).to(torch.bfloat16)
                    for _ in range(3))
        lens = torch.randint(1, t + 1, (64,), generator=g, device=dev)
        mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        out[f"fused_mha[bf16,B=64,T={t},H=12,D=32]"] = _both(
            lambda: att._fused_mha_cuda(q, k_, v, mask), profile)
    del q, k_, v
    # #6 and #7: their kernels line's `ms` through the checkout's own
    # chip_smoke.py, then both times
    import chip_smoke
    from tpu_rag_torch.ops import ivf_probe as ip

    for row in chip_smoke._probe_kernel_rows(g):
        out[row["name"]] = {"ms": row["ms"]}
    # the lists below are the same in every checkout: the rows above draw
    # a checkout's own amount of random numbers
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    nlist, cap = chip_smoke.IVF_NLIST, chip_smoke.IVF_CAP
    vec = torch.randint(-127, 128, (nlist, cap, d), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand((nlist, cap), generator=g, device=dev) * 1e-3 + 1e-3
    tags = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
    centroids = torch.randn((nlist, d), generator=g, device=dev)
    ones = torch.ones_like(scale)
    for nq, dtype in ((1, "int8"), (3, "int8"), (1, "bf16")):    # #6
        qf = torch.randn((nq, d), generator=g, device=dev)
        lists = ip._top_lists(qf, centroids, chip_smoke.IVF_NPROBE)
        if dtype == "int8":
            args = (quantize_int8_rows(qf)[0], lists, vec, scale, tags, tags, -1, -1,
                    chip_smoke.IVF_KSCAN)
        else:
            q_in = (qf / qf.norm(dim=1, keepdim=True)).to(torch.bfloat16)
            args = (q_in, lists, vec.to(torch.bfloat16).mul_(1e-3), ones, tags, tags, -1, -1,
                    chip_smoke.IVF_KSCAN)
        out[f"ivf_probe_per_list[{dtype},q={nq}]"] = _both(lambda: ip._probe_list_cuda(*args),
                                                            profile)
        del args
    for nq in (8, 64):                                            # #7
        q8, _ = quantize_int8_rows(torch.randn((nq, d), generator=g, device=dev))
        lists = ip._top_lists(q8.float(), centroids, chip_smoke.IVF_NPROBE)
        uniq, n_uniq, _ = ip._dedup(lists, nlist)
        args = (q8, uniq, n_uniq, vec, scale, tags, tags, -1, -1, 2)
        out[f"ivf_probe_batched[int8,q={nq}]"] = _both(
            lambda: ip._probe_batched_cuda(*args), profile)
    return out


def main() -> int:
    args = sys.argv[1:]
    profile = "--profile" in args
    args = [a for a in args if a != "--profile"]
    if len(args) == 2 and args[0] == "--worker":
        print(json.dumps(worker(Path(args[1]).resolve(), profile)), flush=True)
        return 0
    roots = [Path(a).resolve() for a in args]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                               str(root)] + (["--profile"] if profile else []),
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(rows)
        print(json.dumps({"run": i, "root": str(root), "rows": rows}), flush=True)
    # a checkout's own chip_smoke.py rows may be named differently (a union
    # size in the name): a shape missing from a run reads None there
    names = list(dict.fromkeys(name for r in runs for name in r))
    summary = {name: {key: [r.get(name, {}).get(key) for r in runs] for key in ("ms", "device_ms")}
               for name in names}
    print(json.dumps({"runs": [str(r) for r in roots], "by_shape": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
