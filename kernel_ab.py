#!/usr/bin/env python3
"""A/B timing of the port's scan (#1 #2 #3), attention (#5) and IVF probe
(#6 #7) kernels between checkouts of this repository, on one GPU.

    python3 kernel_ab.py [--profile] [--f32 | --bucket | --list | --wide | --masks FILE] \
        PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout: its tpu_rag_torch/ is imported in
a subprocess of its own and builds its kernels into its own build/.  The
runs go in the order given, so "parent, change, change, parent" puts both
sides in one call on one card.  Each run prints one JSON line: per shape,
the median ms of one wrapper call at a time (CUDA events around the call,
as chip_smoke.py times its kernels line) and the device's ms (10 calls back
to back); the last line holds each shape's values in run order and the
card's name and power limit (nvidia-smi).  #6 and
#7 come once from the checkout's own chip_smoke.py (its kernels line's
`ms`) and once with both times on lists seeded the same for every
checkout: #6 at one and three queries on int8 lists and at one on bf16
lists (k 40), #7 at 8 and 64 queries (m 2).  The data is the same in
every run (seeded on the card), as in chip_smoke.py.
With --profile each shape also gets its device time per kernel and its
wall time, per call (torch.profiler over 5 calls): where a wrapper's time
goes between its kernels, the library calls around them and the host;
`kernel_ms` is the port's own kernels' share (a library row: 0).
With --f32 only the f32 kernels run: the f32 scans (#1 exact at 1M x 384,
q 1, 8 and 64, k 20, and at 1M x 768, q 8; #2 packed, q 8, k 64; #3
bucketed at 2M x 384, q 64), #5 in f32 (B 64, H 12, D 32 and 64, T 160,
256 and 512), #6 on f32 lists (cap 1024, nprobe 16, k 40; q 1 and 3 at d
384 and 768) and #7 on f32 lists (cap 1024, nprobe 16, m 2; q 8 and 80 at
d 384 and 768).  With --bucket only #7 runs: on int8 and bf16 lists seeded
as above (q 8 and 64) and on --f32's f32 lists.  With --list only #6 runs:
on int8 and bf16 lists seeded as above (q 1 and 3) and on --f32's f32
lists.  With --wide only #1 #2 and #5 run, each shape beside one library
call on the same inputs (its `library:` row, the same in every checkout:
the yardstick of that run): the scans at d 384 (the default rows) and at
bge-base's d 768 over 1M rows (bf16 exact at q 1, 8 and 64, k 20; exact and
packed at q 8, k 512; int8 exact at q 64, k 40), beside matmul + topk;
#5 in bf16 at D 32 (B 64, H 12, T 128, 256 and 512; the reranker's B 32,
T 256 and its eval's B 256, T 160), at D 64 (B 64, H 12, T 128, 256 and
512) and on one tensor-parallel rank's heads (B 64, T 256, D 64 at H 6 and
3; B 32, T 256, D 32 at H 6), on ragged rows (lengths uniform in 1..T),
and at B 64, T 256, D 32, at B 256, T 160 and at B 64, T 512, D 64 with
every key real (`dense`), beside SDPA; and #3 bucketed on bf16 rows at d
384, q 32 (eval_recall's).  With --masks FILE only #5 in bf16 runs, on the
masks that `chip_smoke.py --save-masks FILE` kept of each phase's launches:
each (B, T, H, D) shape on its kept masks in turn (`masks:` rows) and with
every key real (`dense:` rows), and per phase the sum over its shapes of
launches x time (`phase:` rows; a shape's launches are the phase's, its
time that of its kept masks).
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
    device span, per call (ms), and each kernel's launches in the window.  chip_smoke.py's kernel times and its serve
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
    by_kernel, counts, spans = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                      # host ops; their kernels are listed
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us > 0:
            # a record_function range (e.g. Optimizer.step) shows on the
            # device as the span of its kernels, gaps included: kept apart,
            # or device_ms would count its kernels twice
            if getattr(e, "is_user_annotation", False):
                spans[e.key] = us / reps / 1e3
            else:
                by_kernel[e.key] = us / reps / 1e3
                counts[e.key] = e.count
    return {"wall_ms": wall * 1e3, "device_ms": sum(by_kernel.values()),
            "by_kernel_ms": by_kernel, "by_kernel_count": counts, "spans_ms": spans}


# the port's kernels in a torch.profiler trace (names hold one of these)
PORT_KERNELS = ("scan_kernel", "mha_tc_kernel", "mha_f32_kernel", "probe_split_kernel",
                "probe_f32_kernel", "bucket_kernel", "read_sum_kernel")


def _both(fn, profile: bool) -> dict:
    out = {"ms": _ms(fn, 20, 1), "device_ms": _ms(fn, 5, 10)}
    if profile:
        prof = _profile(fn)
        out["kernel_ms"] = sum(ms for key, ms in prof["by_kernel_ms"].items()
                               if any(name in key for name in PORT_KERNELS))
        top = sorted(prof["by_kernel_ms"].items(), key=lambda kv: -kv[1])[:6]
        out["profile"] = {**prof, "by_kernel_ms": {key[:60]: ms for key, ms in top}}
    return out


F32_SCANS = ((384, "exact", 1, 20), (384, "exact", 8, 20), (384, "exact", 64, 20),
             (384, "packed", 8, 64), (768, "exact", 8, 20))


def _f32_scan_rows(g, profile: bool) -> dict:
    """The f32 scans: F32_SCANS over 1M rows, #3 bucketed over 2M x 384."""
    import torch

    from tpu_rag_torch.ops import topk as tk

    dev, out = g.device, {}
    kernels = {"exact": tk._exact_scan_cuda, "packed": tk._packed_scan_cuda}
    for d in (384, 768):
        x = torch.randn((1_000_000, d), generator=g, device=dev)
        x /= x.norm(dim=1, keepdim=True)
        ns = torch.randint(0, 4, (x.shape[0],), generator=g, device=dev, dtype=torch.int32)
        ns[-1000:] = tk.PAD_TAG
        for dd, mode, nq, k in F32_SCANS:
            if dd != d:
                continue
            q = torch.randn((nq, d), generator=g, device=dev)
            args = (q, x, None, ns, ns, None, -1, -1, k)
            out[f"{mode}_scan[f32,n=1M,d={d},q={nq},k={k}]"] = _both(
                lambda: kernels[mode](*args), profile)
        del x, ns
        torch.cuda.empty_cache()
    x = torch.randn((2_000_000, 384), generator=g, device=dev)
    x /= x.norm(dim=1, keepdim=True)
    ns = torch.zeros((x.shape[0],), device=dev, dtype=torch.int32)
    q = torch.randn((64, 384), generator=g, device=dev)
    out["bucketed_scan[f32,n=2M,d=384,q=64]"] = _both(
        lambda: tk._bucketed_scan_cuda(q, x, None, ns, ns, -1, -1), profile)
    del x, ns
    torch.cuda.empty_cache()
    return out


def _f32_list_rows(g, profile: bool) -> dict:
    """#6 on f32 lists: cap 1024, nprobe 16, k 40, q 1 and 3, d 384 and 768."""
    import torch

    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.topk import PAD_TAG

    dev, out = g.device, {}
    nlist, cap, nprobe = 256, 1024, 16
    for d in (384, 768):
        vec = torch.randn((nlist, cap, d), generator=g, device=dev)
        vec /= vec.norm(dim=2, keepdim=True)
        scale = torch.ones((nlist, cap), device=dev)
        ns = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
        ns[:, -100:] = PAD_TAG
        centroids = torch.randn((nlist, d), generator=g, device=dev)
        for nq in (1, 3):
            q = torch.randn((nq, d), generator=g, device=dev)
            q /= q.norm(dim=1, keepdim=True)
            args = (q, ip._top_lists(q, centroids, nprobe), vec, scale, ns, ns, -1, -1, 40)
            out[f"ivf_probe_per_list[f32,q={nq},d={d}]"] = _both(
                lambda: ip._probe_list_cuda(*args), profile)
        del vec, scale, ns
        torch.cuda.empty_cache()
    return out


def f32_worker(profile: bool) -> dict:
    """The f32 scans, #5 in f32, #6 and #7 on f32 lists, on data seeded the
    same in every checkout."""
    import torch

    from tpu_rag_torch.ops import attention as att

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = _f32_scan_rows(g, profile)
    for hd in (32, 64):
        for t in (160, 256, 512):
            q, k_, v = (torch.randn((64, t, 12, hd), generator=g, device=dev) for _ in range(3))
            lens = torch.randint(1, t + 1, (64,), generator=g, device=dev)
            mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).to(torch.int32)
            out[f"fused_mha[f32,B=64,T={t},H=12,D={hd}]"] = _both(
                lambda: att._fused_mha_cuda(q, k_, v, mask), profile)
            del q, k_, v
    return {**out, **_f32_list_rows(g, profile), **_f32_bucket_rows(g, profile)}


def _f32_bucket_rows(g, profile: bool) -> dict:
    """#7 on f32 lists: cap 1024, nprobe 16, m 2, q 8 and 80, d 384 and 768."""
    import torch

    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.topk import PAD_TAG

    dev, out = g.device, {}
    nlist, cap, nprobe = 256, 1024, 16
    for d in (384, 768):
        vec = torch.randn((nlist, cap, d), generator=g, device=dev)
        vec /= vec.norm(dim=2, keepdim=True)
        scale = torch.ones((nlist, cap), device=dev)
        ns = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
        ns[:, -100:] = PAD_TAG
        centroids = torch.randn((nlist, d), generator=g, device=dev)
        for nq in (8, 80):
            q = torch.randn((nq, d), generator=g, device=dev)
            q /= q.norm(dim=1, keepdim=True)
            uniq, n_uniq, _ = ip._dedup(ip._top_lists(q, centroids, nprobe), nlist)
            args = (q, uniq, n_uniq, vec, scale, ns, ns, -1, -1, 2)
            out[f"ivf_probe_batched[f32,q={nq},d={d},union={int(n_uniq)}]"] = _both(
                lambda: ip._probe_batched_cuda(*args), profile)
        del vec, scale, ns
        torch.cuda.empty_cache()
    return out


def bucket_worker(profile: bool) -> dict:
    """#7 alone: int8 and bf16 lists as worker() seeds them, f32 lists as
    f32_worker() does."""
    import torch

    import chip_smoke
    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    nlist, cap, d = chip_smoke.IVF_NLIST, chip_smoke.IVF_CAP, 384
    vec = torch.randint(-127, 128, (nlist, cap, d), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand((nlist, cap), generator=g, device=dev) * 1e-3 + 1e-3
    tags = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
    centroids = torch.randn((nlist, d), generator=g, device=dev)
    out = {}
    for dtype in ("int8", "bf16"):
        lists = vec if dtype == "int8" else vec.to(torch.bfloat16).mul_(1e-3)
        for nq in (8, 64):
            qf = torch.randn((nq, d), generator=g, device=dev)
            q_in = (quantize_int8_rows(qf)[0] if dtype == "int8"
                    else (qf / qf.norm(dim=1, keepdim=True)).to(torch.bfloat16))
            uniq, n_uniq, _ = ip._dedup(ip._top_lists(qf, centroids, chip_smoke.IVF_NPROBE),
                                        nlist)
            args = (q_in, uniq, n_uniq, lists, scale if dtype == "int8" else torch.ones_like(
                scale), tags, tags, -1, -1, 2)
            out[f"ivf_probe_batched[{dtype},q={nq},union={int(n_uniq)}]"] = _both(
                lambda: ip._probe_batched_cuda(*args), profile)
        del lists
    del vec, scale, tags
    torch.cuda.empty_cache()
    return {**out, **_f32_bucket_rows(g, profile)}


def list_worker(profile: bool) -> dict:
    """#6 alone: int8 and bf16 lists as worker() seeds them, f32 lists as
    f32_worker() does."""
    import torch

    import chip_smoke
    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    nlist, cap, d = chip_smoke.IVF_NLIST, chip_smoke.IVF_CAP, 384
    vec = torch.randint(-127, 128, (nlist, cap, d), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand((nlist, cap), generator=g, device=dev) * 1e-3 + 1e-3
    tags = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
    centroids = torch.randn((nlist, d), generator=g, device=dev)
    out = {}
    for dtype in ("int8", "bf16"):
        lists_v = vec if dtype == "int8" else vec.to(torch.bfloat16).mul_(1e-3)
        for nq in (1, 3):
            qf = torch.randn((nq, d), generator=g, device=dev)
            q_in = (quantize_int8_rows(qf)[0] if dtype == "int8"
                    else (qf / qf.norm(dim=1, keepdim=True)).to(torch.bfloat16))
            args = (q_in, ip._top_lists(qf, centroids, chip_smoke.IVF_NPROBE), lists_v,
                    scale if dtype == "int8" else torch.ones_like(scale), tags, tags, -1, -1,
                    chip_smoke.IVF_KSCAN)
            out[f"ivf_probe_per_list[{dtype},q={nq}]"] = _both(
                lambda: ip._probe_list_cuda(*args), profile)
        del lists_v
    del vec, scale, tags
    torch.cuda.empty_cache()
    return {**out, **_f32_list_rows(g, profile)}


WIDE_SCANS = tuple((384,) + case for case in SCANS) + (
    (768, "exact", "bf16", 1, 20), (768, "exact", "bf16", 8, 20), (768, "exact", "bf16", 64, 20),
    (768, "exact", "bf16", 8, 512), (768, "packed", "bf16", 8, 512),
    (768, "exact", "int8", 64, 40))
# (B, T, H, D, dense) of #5 in bf16: ragged rows (lengths uniform in 1..T),
# or every key real
WIDE_ATTENTION = tuple((64, t, 12, 32, False) for t in ATTENTION_T) + (
    (32, 256, 12, 32, False), (256, 160, 12, 32, False), (64, 128, 12, 64, False),
    (64, 256, 12, 64, False), (64, 512, 12, 64, False), (64, 256, 6, 64, False),
    (64, 256, 3, 64, False), (32, 256, 6, 32, False), (64, 256, 12, 32, True),
    (256, 160, 12, 32, True), (64, 512, 12, 64, True))


def wide_worker(profile: bool) -> dict:
    """#1 #2 at d 384 and 768 and #5 in bf16 at D 32 and 64, each beside
    its library call (matmul + topk; SDPA) on the same inputs."""
    import math

    import torch
    import torch.nn.functional as F

    from tpu_rag_torch.ops import attention as att
    from tpu_rag_torch.ops import topk as tk
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    kernels = {"exact": tk._exact_scan_cuda, "packed": tk._packed_scan_cuda}
    out = {}
    for d in (384, 768):
        x = torch.randn((1_000_000, d), generator=g, device=dev)
        x /= x.norm(dim=1, keepdim=True)
        ns = torch.randint(0, 4, (x.shape[0],), generator=g, device=dev, dtype=torch.int32)
        ns[-1000:] = tk.PAD_TAG
        canon = torch.zeros_like(ns)
        xb = x.to(torch.bfloat16)
        x8, s8 = quantize_int8_rows(x)
        del x
        for dd, mode, dtype, nq, k in WIDE_SCANS:
            if dd != d:
                continue
            qf = torch.randn((nq, d), generator=g, device=dev)
            if dtype == "bf16":
                args = (qf.to(torch.bfloat16), xb, None, ns, canon, None, -1, -1, k)
            else:
                q8, qs = quantize_int8_rows(qf)
                args = (q8, x8, s8, ns, canon, qs, -1, -1, k)

            def library(q=args[0], xx=args[1], sc=args[2], qs=args[5], k=k, packed=mode == "packed"):
                s = torch.matmul(q.to(torch.bfloat16), xx.to(torch.bfloat16).T).float()
                if sc is not None:
                    s = s * qs[:, None] * sc[None, :]
                s = torch.where((ns != tk.PAD_TAG)[None, :], s, -math.inf)
                return torch.topk(tk.round18(s) if packed else s, k, dim=1)

            name = f"{mode}_scan[{dtype},d={d},q={nq},k={k}]"
            out[name] = _both(lambda: kernels[mode](*args), profile)
            out[f"library:{name}"] = _both(library, profile)
        if d == 384:                              # #3 bf16 (eval_recall bucketed)
            qb = torch.randn((32, d), generator=g, device=dev).to(torch.bfloat16)
            out["bucketed_scan[bf16,d=384,q=32]"] = _both(
                lambda: tk._bucketed_scan_cuda(qb, xb, None, ns, canon, -1, -1), profile)
        del xb, x8, s8, ns, canon
        torch.cuda.empty_cache()
    for b, t, h, hd, dense in WIDE_ATTENTION:
        q, k_, v = (torch.randn((b, t, h, hd), generator=g, device=dev).to(torch.bfloat16)
                    for _ in range(3))
        lens = torch.randint(1, t + 1, (b,), generator=g, device=dev)
        if dense:
            lens.fill_(t)
        mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        qh, kh, vh = (z.permute(0, 2, 1, 3) for z in (q, k_, v))
        keep = (mask > 0)[:, None, None, :]
        name = f"fused_mha[bf16,B={b},T={t},H={h},D={hd}{',dense' if dense else ''}]"
        out[name] = _both(lambda: att._fused_mha_cuda(q, k_, v, mask), profile)
        out[f"library:{name}"] = _both(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep), profile)
        del q, k_, v, qh, kh, vh
    return out


def masks_worker(path: Path, profile: bool) -> dict:
    """#5 in bf16 on the masks chip_smoke.py --save-masks kept (module
    docstring); q/k/v seeded the same in every checkout."""
    import itertools

    import torch

    from tpu_rag_torch.ops import attention as att

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for phase, shapes in torch.load(path).items():
        totals = {"device_ms": 0.0, "kernel_ms": 0.0, "ms": 0.0}
        for shape, rec in shapes.items():
            b, t, h, hd = (int(x) for x in shape.split(","))
            q, k_, v = (torch.randn((b, t, h, hd), generator=g, device=dev).to(torch.bfloat16)
                        for _ in range(3))
            masks = [m.to(dev, torch.int32) for m in rec["masks"]]
            ring = itertools.cycle(masks)
            kept = _both(lambda: att._fused_mha_cuda(q, k_, v, next(ring)), profile)
            dense = torch.ones_like(masks[0])
            out[f"masks:{phase}[B={b},T={t},H={h},D={hd}]"] = {**kept, "calls": rec["calls"],
                                                              "kept": len(masks)}
            out[f"dense:{phase}[B={b},T={t},H={h},D={hd}]"] = _both(
                lambda: att._fused_mha_cuda(q, k_, v, dense), profile)
            for key in totals:
                totals[key] += rec["calls"] * kept.get(key, 0.0)
            del q, k_, v
        out[f"phase:{phase}"] = {**totals, "calls": sum(r["calls"] for r in shapes.values())}
    return out


def worker(root: Path, profile: bool, f32: bool = False, bucket: bool = False,
           lists: bool = False, wide: bool = False, masks: Path | None = None) -> dict:
    import torch

    sys.path.insert(0, str(root))
    from tpu_rag_torch.ops import attention as att
    from tpu_rag_torch.ops import topk as tk
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    if not Path(tk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {tk.__file__}, not the checkout at {root}")
    if f32:
        return f32_worker(profile)
    if bucket:
        return bucket_worker(profile)
    if lists:
        return list_worker(profile)
    if wide:
        return wide_worker(profile)
    if masks is not None:
        return masks_worker(masks, profile)
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
    profile, f32, bucket, lists, wide = ("--profile" in args, "--f32" in args,
                                         "--bucket" in args, "--list" in args, "--wide" in args)
    flags = [a for a in ("--profile", "--f32", "--bucket", "--list", "--wide") if a in args]
    args = [a for a in args if a not in flags]
    masks = None
    if "--masks" in args:
        i = args.index("--masks")
        masks = Path(args[i + 1]).resolve()
        flags += ["--masks", str(masks)]
        del args[i:i + 2]
    if len(args) == 2 and args[0] == "--worker":
        print(json.dumps(worker(Path(args[1]).resolve(), profile, f32, bucket, lists, wide,
                                masks)), flush=True)
        return 0
    roots = [Path(a).resolve() for a in args]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                               str(root)] + flags, capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(rows)
        print(json.dumps({"run": i, "root": str(root), "rows": rows}), flush=True)
    # a checkout's own chip_smoke.py rows may be named differently (a union
    # size in the name): a shape missing from a run reads None there
    names = list(dict.fromkeys(name for r in runs for name in r))
    summary = {name: {key: [r.get(name, {}).get(key) for r in runs]
                      for key in ("ms", "device_ms", "kernel_ms")}
               for name in names}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"runs": [str(r) for r in roots], "card": smi, "by_shape": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
