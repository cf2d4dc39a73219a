#!/usr/bin/env python3
"""Smoke run of the tpu_rag_torch port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line (any failure exits non-zero):

  build    compile every kernel of tpu_rag_torch/csrc with nvcc (sm_90a),
           all sources in parallel, into build/tpu_rag_torch/;
  kernels  hold each kernel against its plain PyTorch version on the card at
           the main path's shapes, and time kernel, plain version and one
           library call (CUDA events, median);
  serve    a 1,000,000 x 384 flat store (bf16, exact scan) behind the real
           HTTP server with all-MiniLM-L6-v2 at full width (seeded weights):
           /docs/save of ~200-token documents, then /search, some of it
           concurrent; the scan (#1) and attention (#5) counters must rise;
  scale    a 2,000,000-row FlatIndex in auto mode (int8 + bucketed scan, #3)
           searched through FlatIndex.search, recall@10 against f32 exact;
  ivf      a 4,000,000 x 384 IVF store (auto -> int8 lists, nlist 2048, cap
           factor 2.0, nprobe 64; a low-rank correlated corpus) built by
           k-means on the card, saved, and served over HTTP with
           INDEX_KIND=ivf: /docs/save, sequential /search (per-list probe
           #6) and a concurrent burst; then 64 perturbed corpus rows searched
           one at a time (#6) and as one batch (batch-shared probe #7),
           recall@10 against f32 exact, kernels against plain versions.

Then the kernels summary line, the card's name and power limit as nvidia-smi
reports them, and, last, {"ok": true, "device": {...}}.  Without a CUDA
device, or without the repository beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12                        # H100 SXM HBM3
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[kind]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int = 20, warmup: int = 3, batch: int = 1) -> float:
    """Median wall time of fn() on the device, CUDA events around each call
    (the wrapper's host time between them included, as a caller that waits
    for each result sees it) or, with batch > 1, around `batch` calls back
    to back, divided by batch (the device's own time, the host's launches
    overlapped)."""
    import torch

    for _ in range(warmup):
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


# ------------------------------------------------------------------ phases


def phase_build():
    from tpu_rag_torch import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    for name in paths:
        _build.load(name)
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.is_file() else []
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln][:12]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": _build.last_build["compiled"], "libraries": sorted(paths),
          "ptxas": ptxas})


def _id_check(k_sc, k_id, p_sc, p_id, tol: float) -> dict:
    """Ids equal except where neighbouring plain scores differ by < tol;
    scores within tol."""
    import torch

    fin = torch.isfinite(p_sc)
    err = float((k_sc[fin] - p_sc[fin]).abs().max()) if fin.any() else 0.0
    if not torch.equal(torch.isfinite(k_sc), fin):
        raise AssertionError("kernel and plain disagree on which slots are -inf")
    diff = (k_id != p_id).nonzero().tolist()
    unexplained = 0
    for qi, j in diff:
        near = [j2 for j2 in (j - 1, j + 1) if 0 <= j2 < p_sc.shape[1]]
        tied = any(abs(float(p_sc[qi, j]) - float(p_sc[qi, j2])) < tol for j2 in near)
        if not (tied or j == p_sc.shape[1] - 1):
            unexplained += 1
    if err > tol or unexplained:
        raise AssertionError(f"scan disagrees with its plain version: max score err "
                             f"{err:.3g}, {unexplained} unexplained id mismatches")
    return {"max_abs_err": err, "id_mismatches_in_ties": len(diff)}


def _packed_check(k_sc, k_id, p_sc, p_id) -> dict:
    """#2 against its plain version: both round scores to 18 bits, and a sum
    in another order can land one rounding step away, so scores agree within
    one step (2^-9 of the magnitude) and ids are equal except next to a plain
    neighbour within one step."""
    import torch

    fin = torch.isfinite(p_sc)
    if not torch.equal(torch.isfinite(k_sc), fin):
        raise AssertionError("packed scan: kernel and plain disagree on which slots are -inf")
    step = p_sc.abs() * 2.0 ** -9 + 1e-30
    err = float((k_sc[fin] - p_sc[fin]).abs().max()) if fin.any() else 0.0
    if fin.any() and bool(((k_sc - p_sc).abs()[fin] > step[fin]).any()):
        raise AssertionError(f"packed scan: scores more than one 18-bit step apart ({err:.3g})")
    unexplained = 0
    diff = (k_id != p_id).nonzero().tolist()
    for qi, j in diff:
        near = [j2 for j2 in (j - 1, j + 1) if 0 <= j2 < p_sc.shape[1]]
        tied = any(abs(float(p_sc[qi, j]) - float(p_sc[qi, j2])) <= float(step[qi, j])
                   for j2 in near)
        if not (tied or j == p_sc.shape[1] - 1):
            unexplained += 1
    if unexplained:
        raise AssertionError(f"packed scan: {unexplained} unexplained id mismatches")
    return {"max_abs_err": err, "id_mismatches_in_ties": len(diff)}


def phase_kernels() -> list[dict]:
    import torch

    from tpu_rag_torch.ops import topk as tk
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    d = 384

    def corpus(n):
        x = torch.randn((n, d), generator=g, device=dev)
        x = x / x.norm(dim=1, keepdim=True)
        ns = torch.randint(0, 4, (n,), generator=g, device=dev, dtype=torch.int32)
        canon = torch.randint(0, 2, (n,), generator=g, device=dev, dtype=torch.int32)
        ns[-1000:] = tk.PAD_TAG                       # padding rows
        x[77] = x[11]                                  # an exact tie in one block
        x[n - 5000] = x[5000]                          # and across two blocks' ranges
        return x, ns, canon

    floors = {}

    def floor_of(xx, key):
        """#4 over the matrix a scan reads: the read floor of that scan
        (back to back: the device's read rate, not the wrapper's)."""
        if key not in floors:
            floors[key] = cuda_ms(lambda: tk._read_sum_cuda(xx), iters=5, batch=10)
        return floors[key]

    # ---- #1 exact scan: 1M x 384, bf16 (q 8, 64; k_scan 20) and int8 (q 64;
    # 4k = 40; q 8, k_scan 1024: a rerank of 256 candidates on int8); #2
    # packed scan at the same rows, bf16 (q 8, k_scan 64 = packed_k_scan(10))
    # and int8 (q 64, k_scan 80 = packed_k_scan(20))
    n = 1_000_000
    x, ns, canon = corpus(n)
    xb = x.to(torch.bfloat16)
    x8, s8 = quantize_int8_rows(x)
    del x
    scans = {"exact": (tk._exact_scan_cuda, tk._exact_scan_plain, "tpu_rag/ops/topk.py:96"),
             "packed": (tk._packed_scan_cuda, tk._packed_scan_plain, "tpu_rag/ops/topk.py:201")}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem_of = _smem_check()
    for mode, dtype, nq, k in (("exact", "bf16", 8, 20), ("exact", "bf16", 1, 20),
                               ("exact", "bf16", 64, 20),
                               ("exact", "int8", 64, 40), ("exact", "int8", 8, 1024),
                               ("packed", "bf16", 8, 64), ("packed", "int8", 64, 80)):
        kernel, plain, replaces = scans[mode]
        packed = mode == "packed"
        qf = torch.randn((nq, d), generator=g, device=dev)
        qf[0] = xb[11].float()
        if nq > 1:
            qf[1] = xb[5000].float()
        if dtype == "bf16":
            xx, sc, q_in, qs, elt = xb, None, qf.to(torch.bfloat16), None, 2
        else:
            q_in, qs = quantize_int8_rows(qf)
            xx, sc, elt = x8, s8, 1
        args = (q_in, xx, sc, ns, canon, qs, -1, -1, k)
        fargs = (q_in, xx, sc, ns, canon, qs, 2, 1, k)      # a filtered run
        k_sc, k_id = kernel(*args)
        p_sc, p_id = plain(*args)
        torch.cuda.synchronize()
        if packed:
            chk = _packed_check(k_sc, k_id, p_sc, p_id)
            if dtype == "int8" and not (torch.equal(k_id, p_id) and torch.equal(k_sc, p_sc)):
                raise AssertionError("packed int8 scan: ids or scores differ from the plain version")
            _packed_check(*kernel(*fargs), *plain(*fargs))
        else:
            chk = _id_check(k_sc, k_id, p_sc, p_id, 1e-4)
            _id_check(*kernel(*fargs), *plain(*fargs), 1e-4)
        plan = tk._scan_plan(n, d, nq, k, xx.dtype, sms, mode)
        smem_of(xx.dtype, plan, k, mode)
        if k_id[0, 0].item() != 11:
            raise AssertionError(f"{mode} scan: the tie must go to the lowest row")
        if nq > 1:
            if 5000 // plan.block_rows == (n - 5000) // plan.block_rows:
                raise AssertionError(f"rows 5000 and {n - 5000} share a block: {plan}")
            if k_id[1, 0].item() != 5000:
                raise AssertionError(f"{mode} scan: a tie across two blocks must go to "
                                     f"the lowest row, got {k_id[1, :2].tolist()}")

        def library(q_in=q_in, xx=xx, sc=sc, qs=qs, k=k, packed=packed):
            s = torch.matmul(q_in.to(torch.bfloat16), xx.to(torch.bfloat16).T).float()
            if sc is not None:
                s = s * qs[:, None] * sc[None, :]
            s = torch.where((ns != tk.PAD_TAG)[None, :], s, -math.inf)
            return torch.topk(tk.round18(s) if packed else s, k, dim=1)

        nbytes = n * d * elt + n * 8 + (n * 4 if sc is not None else 0) + nq * d * elt + nq * k * 8
        b_ms, b_by = bound(nbytes, 2.0 * n * d * nq, dtype)
        ms = cuda_ms(lambda: kernel(*args))
        floor = floor_of(xx, dtype)
        row = {"name": f"{mode}_scan[{dtype},n={n},q={nq},k={k}]", "route": "cuda",
               "plan": plan._asdict(),
               "source": "tpu_rag_torch/csrc/topk.cu", "replaces": replaces, "counter": mode,
               "max_abs_err": chk["max_abs_err"], "ms": ms,
               "plain_ms": cuda_ms(lambda: plain(*args), iters=5),
               "library_ms": cuda_ms(library, iters=5),
               "bound_ms": b_ms, "bound_by": b_by,
               "floor_ms": floor, "pct_of_floor": 100.0 * floor / ms}
        if packed:
            row["exact_ms_same_shape"] = cuda_ms(lambda: tk._exact_scan_cuda(*args))
            row["library"] = "composite: torch.matmul + round18 + torch.topk"
        rows.append(row)

    # ---- #4 read-rate probe on the 1M x 384 bf16 matrix (the 2M int8 below)
    rows.append(_floor_row(xb, "bf16", floors.get("bf16")))
    del xb, x8, s8, ns, canon
    torch.cuda.empty_cache()

    # ---- #3 bucketed scan: 2M x 384 int8, q 64, k_scan 40
    n, nq, k = 2_000_000, 64, 40
    x, ns, canon = corpus(n)
    x8, s8 = quantize_int8_rows(x)
    del x
    q8, qs = quantize_int8_rows(torch.randn((nq, d), generator=g, device=dev))
    bargs = (q8, x8, s8, ns, canon, -1, -1)
    bplan = tk._scan_plan(n, d, nq, 0, torch.int8, sms, "bucketed")
    smem_of(torch.int8, bplan, 0, "bucketed")
    k_sc, k_id = tk._bucketed_scan_cuda(*bargs)
    p_sc, p_id = tk._bucketed_scan_plain(*bargs)
    torch.cuda.synchronize()
    # per-bucket maxima: compare the top k the wrapper keeps, as for #1
    chk = _id_check(*tk.select_topk(k_sc, k_id, k), *tk.select_topk(p_sc, p_id, k), 1e-4)
    if not torch.equal(k_id[torch.isfinite(p_sc)], p_id[torch.isfinite(p_sc)]):
        raise AssertionError("bucketed scan: bucket winners differ from the plain version")

    def bucket_library():
        s = torch.matmul(q8.to(torch.bfloat16), x8.to(torch.bfloat16).T).float() * s8[None, :]
        s = torch.where((ns != tk.PAD_TAG)[None, :], s, -math.inf)
        bm = s.view(nq, -1, tk.BUCKET).amax(dim=2)
        return torch.topk(bm, k, dim=1)

    nbytes = n * d + n * 12 + nq * d + nq * (n // tk.BUCKET) * 8
    b_ms, b_by = bound(nbytes, 2.0 * n * d * nq, "int8")
    ms = cuda_ms(lambda: tk._bucketed_scan_cuda(*bargs))
    floor = cuda_ms(lambda: tk._read_sum_cuda(x8), iters=5, batch=10)
    rows.append({"name": f"bucketed_scan[int8,n={n},q={nq}]", "route": "cuda",
                 "source": "tpu_rag_torch/csrc/topk.cu",
                 "replaces": "tpu_rag/ops/topk.py:284", "counter": "bucketed",
                 "plan": bplan._asdict(),
                 "max_abs_err": chk["max_abs_err"], "ms": ms,
                 "plain_ms": cuda_ms(lambda: tk._bucketed_scan_plain(*bargs), iters=5),
                 "library_ms": cuda_ms(bucket_library, iters=5),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "floor_ms": floor, "pct_of_floor": 100.0 * floor / ms})
    rows.append(_floor_row(x8, "int8", floor))
    del x8, s8, ns, canon
    torch.cuda.empty_cache()

    # ---- #5 attention: B 64, H 12, D 32, bf16, ragged masks, at the
    # encoder's document buckets T 128, 256 and 512
    for t in (256, 128, 512):
        rows.append(_attention_row(g, 64, t, 12, 32))
    rows += _probe_kernel_rows(g)
    floats = {**_batched_checks(g), **_probe_float_checks(g)}
    emit({"phase": "kernels", "checked": [r["name"] for r in rows] + list(floats),
          "max_abs_err": {**{r["name"]: r["max_abs_err"] for r in rows}, **floats}})
    return rows


def _attention_row(g, b: int, t: int, h: int, hd: int) -> dict:
    """#5 against its plain version (in f32, tolerance 2e-2) with a full
    row, a one-token row and an all-pad row; times beside SDPA's."""
    import torch
    import torch.nn.functional as F

    from tpu_rag_torch.ops import attention as att

    dev = torch.device("cuda")
    q, k_, v = (torch.randn((b, t, h, hd), generator=g, device=dev).to(torch.bfloat16)
                for _ in range(3))
    lens = torch.randint(1, t + 1, (b,), generator=g, device=dev)
    lens[0], lens[1] = t, 1
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).to(torch.int32)
    mask[2] = 0                                        # an all-pad row
    out = att._fused_mha_cuda(q, k_, v, mask)
    ref = att.fused_mha_plain(q.float(), k_.float(), v.float(), mask)
    torch.cuda.synchronize()
    err = float((out.float() - ref).abs().max())
    pad_err = float((out[2].float() - v[2].float().mean(dim=0, keepdim=True)).abs().max())
    if not (err <= 2e-2 and pad_err <= 2e-2):
        raise AssertionError(f"attention T={t} disagrees with its plain version: {err}, "
                             f"all-pad row {pad_err}")
    bool_mask = (mask > 0)[:, None, None, :]
    qh, kh, vh = (z.permute(0, 2, 1, 3) for z in (q, k_, v))
    nbytes = 4 * b * t * h * hd * 2 + b * t * 4
    b_ms, b_by = bound(nbytes, 4.0 * b * h * t * t * hd, "bf16")
    return {"name": f"fused_mha[bf16,B={b},T={t},H={h},D={hd}]", "route": "cuda",
            "source": "tpu_rag_torch/csrc/attention.cu",
            "replaces": "tpu_rag/ops/attention.py:41", "counter": "mha",
            "max_abs_err": err, "all_pad_row_err": pad_err,
            "ms": cuda_ms(lambda: att._fused_mha_cuda(q, k_, v, mask)),
            "plain_ms": cuda_ms(lambda: att.fused_mha_plain(q, k_, v, mask)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=bool_mask)),
            "bound_ms": b_ms, "bound_by": b_by}


def _smem_check():
    """A check that the wrapper's launch plan (ops/topk.py _scan_plan, pure
    Python) and the kernel (csrc/topk.cu tr_scan_smem_bytes) agree on a
    block's shared-memory bytes."""
    import ctypes

    from tpu_rag_torch import _build
    from tpu_rag_torch.ops import topk as tk

    fn = _build.load("topk").tr_scan_smem_bytes
    fn.argtypes = [_build.I] * 6
    fn.restype = ctypes.c_size_t

    def check(dtype, plan, k: int, mode: str) -> None:
        got = int(fn(tk._DTYPE_CODE[dtype], 384, plan.qc, k if mode != "bucketed" else 0,
                     tk._SCAN_MODE[mode], plan.stages))
        if got != plan.smem:
            raise AssertionError(f"scan plan {plan} says {plan.smem} bytes, the kernel {got}")
    return check


def _floor_row(x, dtype: str, ms: float | None) -> dict:
    """#4 on a scan's database, against x.sum(dtype=float32) on the card,
    with the JAX package's tolerance (1% of the sum, plus 1).  `ms` is
    timed back to back (floor_of); `ms_per_call` as the other rows are."""
    import torch

    from tpu_rag_torch.ops import topk as tk

    got = float(tk._read_sum_cuda(x))
    ref = float(tk._read_sum_plain(x))
    err = abs(got - ref)
    if not err < abs(ref) * 1e-2 + 1.0:
        raise AssertionError(f"read-rate probe: sum {got} against {ref}")
    nbytes = x.numel() * x.element_size()
    b_ms, b_by = bound(nbytes, float(x.numel()), "f32")
    ms = ms if ms is not None else cuda_ms(lambda: tk._read_sum_cuda(x), iters=5, batch=10)
    return {"name": f"dma_floor_scan[{dtype},n={x.shape[0]},d={x.shape[1]}]", "route": "cuda",
            "source": "tpu_rag_torch/csrc/topk.cu",
            "replaces": "tpu_rag/ops/topk.py:612", "counter": "floor",
            "max_abs_err": err, "ms": ms,
            "ms_per_call": cuda_ms(lambda: tk._read_sum_cuda(x)),
            "plain_ms": cuda_ms(lambda: tk._read_sum_plain(x), iters=5),
            "library_ms": cuda_ms(lambda: torch.sum(x, dtype=torch.float32), iters=5),
            "library": "torch.sum(x, dtype=torch.float32)",
            "bound_ms": b_ms, "bound_by": b_by,
            "read_tb_s": nbytes / (ms * 1e-3) / 1e12}


# IVF geometry of the ivf phase, which the kernels phase also uses: 4M rows
# of d = 384 in 2048 lists of cap 3968 (2.0 x the mean of 1953, rounded up
# to 128-slot buckets), int8, nprobe 64, k_scan 40 (k = 10, int8 refine 4x)
IVF_ROWS, IVF_NLIST, IVF_CAP, IVF_NPROBE, IVF_KSCAN = 4_000_000, 2048, 3968, 64, 40


def _probe_kernel_rows(g) -> list[dict]:
    """#6 and #7 against their plain versions at the ivf phase's shapes, on
    random int8 lists; each list is ~half filled, the rest PAD, as there."""
    import torch

    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.quant import quantize_int8_rows
    from tpu_rag_torch.ops.topk import PAD_TAG

    dev = torch.device("cuda")
    d, nlist, cap, nprobe, k_eff, m = 384, IVF_NLIST, IVF_CAP, IVF_NPROBE, IVF_KSCAN, 2
    vec = torch.randint(-127, 128, (nlist, cap, d), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand((nlist, cap), generator=g, device=dev) * 1e-3 + 1e-3
    fill = torch.randint(cap // 3, (2 * cap) // 3, (nlist, 1), generator=g, device=dev)
    ns = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
    ns = torch.where(torch.arange(cap, device=dev)[None, :] < fill, ns, PAD_TAG).contiguous()
    canon = torch.randint(0, 2, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
    vec[3, 7] = vec[3, 2]                                   # an exact tie in a bucket
    scale[3, 7] = scale[3, 2]
    centroids = torch.randn((nlist, d), generator=g, device=dev)
    centroids /= centroids.norm(dim=1, keepdim=True)
    rows = []
    for nq in (1, 8, 64):
        qf = torch.randn((nq, d), generator=g, device=dev)
        qf[0] = centroids[3]                                # probes list 3 first
        lists = ip._top_lists(qf, centroids, nprobe)
        q8, _ = quantize_int8_rows(qf)
        if nq == 1:                                         # ---- #6
            args = (q8, lists, vec, scale, ns, canon, -1, -1, k_eff)
            k_sc, k_id = ip._probe_list_cuda(*args)
            p_sc, p_id = ip._probe_list_plain(*args)
            torch.cuda.synchronize()
            chk = _id_check(k_sc.view(-1, k_eff), k_id.view(-1, k_eff),
                            p_sc.view(-1, k_eff), p_id.view(-1, k_eff), 1e-4)
            _id_check(*(t.view(-1, k_eff) for t in ip._probe_list_cuda(*args[:6], 2, 1, k_eff)),
                      *(t.view(-1, k_eff) for t in ip._probe_list_plain(*args[:6], 2, 1, k_eff)),
                      1e-4)
            flat = lists.reshape(-1)

            def library(flat=flat, q8=q8):
                x = vec[flat].to(torch.bfloat16)                       # (Q*nprobe, cap, d)
                qv = q8.to(torch.bfloat16).repeat_interleave(nprobe, 0)[:, :, None]
                s = torch.bmm(x, qv)[..., 0].float() * scale[flat]
                s = torch.where(ns[flat] != PAD_TAG, s, -math.inf)
                return torch.topk(s, k_eff, dim=1)

            nbytes = nq * nprobe * cap * (d + 12) + nq * d + nq * nprobe * k_eff * 8
            b_ms, b_by = bound(nbytes, 2.0 * nq * nprobe * cap * d, "int8")
            rows.append({"name": f"ivf_probe_per_list[int8,q={nq},nprobe={nprobe},cap={cap},"
                                 f"k={k_eff}]", "route": "cuda",
                         "source": "tpu_rag_torch/csrc/ivf_probe.cu",
                         "replaces": "tpu_rag/ops/ivf_probe.py:41", "counter": "per_list",
                         "max_abs_err": chk["max_abs_err"],
                         "ms": cuda_ms(lambda: ip._probe_list_cuda(*args)),
                         "plain_ms": cuda_ms(lambda: ip._probe_list_plain(*args), iters=5),
                         "library_ms": cuda_ms(library, iters=5),
                         "library": "composite: list gather + torch.bmm + torch.topk",
                         "bound_ms": b_ms, "bound_by": b_by})
            continue
        uniq, n_uniq, _ = ip._dedup(lists, nlist)         # ---- #7
        args = (q8, uniq, n_uniq, vec, scale, ns, canon, -1, -1, m)
        k_sc, k_id = ip._probe_batched_cuda(*args)
        p_sc, p_id = ip._probe_batched_plain(*args)
        f_sc, f_id = (ip._probe_batched_cuda(*args[:7], 2, 1, m),
                      ip._probe_batched_plain(*args[:7], 2, 1, m))
        torch.cuda.synchronize()
        err = 0.0
        for (ks, ki), (ps, pi) in (((k_sc, k_id), (p_sc, p_id)), (f_sc, f_id)):
            fin = torch.isfinite(ps)
            if not (torch.equal(torch.isfinite(ks), fin) and torch.equal(ki, pi)):
                raise AssertionError("batched probe: bucket winners differ from the plain version")
            err = max(err, float((ks[fin] - ps[fin]).abs().max()))
        if err > 0.0:
            raise AssertionError(f"batched probe int8 scores differ from the plain version: {err}")
        nu = int(n_uniq)
        lst = uniq[:nu].long()

        def library(lst=lst, q8=q8, nq=nq):
            x = vec[lst].to(torch.bfloat16)                           # (U, cap, d)
            s = torch.bmm(x, q8.to(torch.bfloat16).T.expand(len(lst), d, nq)).float()
            s = s * scale[lst][..., None]
            s = torch.where((ns[lst] != PAD_TAG)[..., None], s, -math.inf)
            s = s.transpose(1, 2).reshape(len(lst), nq, cap // 128, 128)
            return torch.topk(s, m, dim=3)

        nbytes = nu * cap * (d + 12) + nq * d + nu * nq * m * (cap // 128) * 8
        b_ms, b_by = bound(nbytes, 2.0 * nu * cap * d * nq, "int8")
        ms = cuda_ms(lambda: ip._probe_batched_cuda(*args))
        rows.append({"name": f"ivf_probe_batched[int8,q={nq},nprobe={nprobe},cap={cap},"
                             f"m={m},union={nu}]", "route": "cuda",
                     "source": "tpu_rag_torch/csrc/ivf_probe.cu",
                     "replaces": "tpu_rag/ops/ivf_probe.py:237", "counter": "batched",
                     "plan": ip._bucket_plan(uniq.shape[0], cap // 128, nq, d, torch.int8,
                                             torch.cuda.get_device_properties(dev)
                                             .multi_processor_count)._asdict(),
                     "max_abs_err": err, "ms": ms,
                     "device_ms": cuda_ms(lambda: ip._probe_batched_cuda(*args), iters=5,
                                          batch=10),
                     "plain_ms": cuda_ms(lambda: ip._probe_batched_plain(*args), iters=5),
                     "library_ms": cuda_ms(library, iters=5),
                     "library": "composite: list gather + torch.bmm + torch.topk",
                     "bound_ms": b_ms, "bound_by": b_by, "pct_of_bound": 100.0 * b_ms / ms})
    del vec, scale, ns, canon
    torch.cuda.empty_cache()
    return rows


def _batched_checks(g) -> dict:
    """#7 on int8 and bf16 lists of the ivf phase's geometry (~half of each
    list PAD) against its plain version over the whole (u_max, nq, m * nb)
    output: q 8, 64 and 80 (two query chunks), m 1-4, with and without
    filters, a tie across the warps of one bucket (slots 20 and 100 of list
    3, the self match of query 1) and n_uniq < u_max.  int8: ids and scores
    torch.equal; bf16: the same -inf slots, scores within 1e-4 (summation
    order) and the tie's ids, with the count of other id differences (near
    ties) reported.  Also holds each launch plan against the kernel's
    tr_probe_smem_bytes."""
    import torch

    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.quant import quantize_int8_rows
    from tpu_rag_torch.ops.topk import _DTYPE_CODE, PAD_TAG

    dev = torch.device("cuda")
    d, nlist, cap, nprobe, tol = 384, IVF_NLIST, IVF_CAP, IVF_NPROBE, 1e-4
    nb = cap // 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    vec = torch.randint(-127, 128, (nlist, cap, d), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand((nlist, cap), generator=g, device=dev) * 1e-3 + 1e-3
    fill = torch.randint(cap // 3, (2 * cap) // 3, (nlist, 1), generator=g, device=dev)
    ns = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
    ns = torch.where(torch.arange(cap, device=dev)[None, :] < fill, ns, PAD_TAG).contiguous()
    canon = torch.randint(0, 2, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
    vec[3, 100] = vec[3, 20]                      # rows 20 and 100: warp row tiles 0 and 3
    scale[3, 100] = scale[3, 20]
    ns[3, [20, 100]], canon[3, [20, 100]] = 2, 1  # live under both filters
    centroids = torch.randn((nlist, d), generator=g, device=dev)
    centroids /= centroids.norm(dim=1, keepdim=True)
    out, short_union = {}, False
    for dtype in (torch.int8, torch.bfloat16):
        lists_v = vec if dtype == torch.int8 else vec.to(torch.bfloat16).mul_(1e-3)
        sc_v = scale if dtype == torch.int8 else torch.ones_like(scale)
        err, id_diff = 0.0, 0
        for nq in (8, 64, 80):
            qf = torch.randn((nq, d), generator=g, device=dev)
            qf[0] = centroids[3]                      # list 3 is in the union
            qf[1] = lists_v[3, 20].float()
            lists = ip._top_lists(qf, centroids, nprobe)
            uniq, n_uniq, _ = ip._dedup(lists, nlist)
            nu = int(n_uniq)
            short_union |= nu < uniq.shape[0]
            u3 = int((uniq[:nu] == 3).nonzero()[0, 0])
            if dtype == torch.int8:
                q_in, _ = quantize_int8_rows(qf)
            else:
                q_in = (qf / qf.norm(dim=1, keepdim=True)).to(torch.bfloat16)
                q_in[1] = lists_v[3, 20]
            plan = ip._bucket_plan(uniq.shape[0], nb, nq, d, dtype, sms)
            got = ip._smem_bytes(1, _DTYPE_CODE[dtype], d, plan.qc, 0, plan.stages)
            if got != plan.smem:
                raise AssertionError(f"bucket plan {plan} says {plan.smem} bytes, the kernel {got}")
            for m in (1, 2, 3, 4):
                for wants in ((-1, -1), (2, 1)):
                    args = (q_in, uniq, n_uniq, lists_v, sc_v, ns, canon, *wants, m)
                    k_sc, k_id = ip._probe_batched_cuda(*args)
                    p_sc, p_id = ip._probe_batched_plain(*args)
                    torch.cuda.synchronize()
                    what = f"batched probe {str(dtype)[6:]} q {nq} m {m} wants {wants}"
                    fin = torch.isfinite(p_sc)
                    if not torch.equal(torch.isfinite(k_sc), fin):
                        raise AssertionError(f"{what}: -inf slots differ from the plain version")
                    if dtype == torch.int8:
                        if not (torch.equal(k_id, p_id) and torch.equal(k_sc, p_sc)):
                            raise AssertionError(f"{what}: ids or scores differ "
                                                 f"({int((k_id != p_id).sum())} ids)")
                    else:
                        e = float((k_sc[fin] - p_sc[fin]).abs().max())
                        err = max(err, e)
                        id_diff = max(id_diff, int((k_id != p_id).sum()))
                        if e > tol:
                            raise AssertionError(f"{what}: score error {e}")
                    tie = k_id[u3, 1, :min(m, 2) * nb:nb].tolist()
                    if tie != [20, 100][:m]:
                        raise AssertionError(f"{what}: the tie across warps gave {tie}")
                    if not (torch.isneginf(k_sc[nu:]).all() and (k_id[nu:] == -1).all()):
                        raise AssertionError(f"{what}: union slots past n_uniq not -inf/-1")
        name = f"ivf_probe_batched[{str(dtype)[6:]},q=8/64/80,m=1-4,nprobe={nprobe},cap={cap}]"
        out[name] = err
        if dtype == torch.bfloat16:       # near-ties that a sum in another order reorders
            out[name + "_most_id_mismatches"] = id_diff
    if not short_union:
        raise AssertionError("no batched check ran with n_uniq < u_max")
    del vec, scale, ns, canon, lists_v
    torch.cuda.empty_cache()
    return out


def _probe_float_checks(g) -> dict:
    """#6 and #7 on f32 and bf16 lists (IVFIndex's default dtype is bf16),
    with more than 64 queries for #7's query chunks: scores within 1e-4 of
    the plain versions (summation order), ids equal except inside ties."""
    import torch

    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.topk import PAD_TAG

    dev = torch.device("cuda")
    nlist, cap, d, nprobe, k_eff, m, tol = 256, 1024, 384, 16, 40, 2, 1e-4
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        vec = torch.randn((nlist, cap, d), generator=g, device=dev)
        vec = (vec / vec.norm(dim=2, keepdim=True)).to(dtype)
        scale = torch.ones((nlist, cap), device=dev)
        ns = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
        ns[:, -100:] = PAD_TAG
        canon = torch.randint(0, 2, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
        centroids = torch.randn((nlist, d), generator=g, device=dev)
        q = torch.randn((80, d), generator=g, device=dev)
        q = (q / q.norm(dim=1, keepdim=True)).to(dtype)
        lists = ip._top_lists(q, centroids, nprobe)
        err = 0.0
        for wants in ((-1, -1), (2, 1)):
            args = (q[:3], lists[:3], vec, scale, ns, canon, *wants, k_eff)
            chk = _id_check(*(t.view(-1, k_eff) for t in ip._probe_list_cuda(*args)),
                            *(t.view(-1, k_eff) for t in ip._probe_list_plain(*args)), tol)
            err = max(err, chk["max_abs_err"])
            uniq, n_uniq, _ = ip._dedup(lists, nlist)
            args = (q, uniq, n_uniq, vec, scale, ns, canon, *wants, m)
            (k_sc, k_id), (p_sc, p_id) = ip._probe_batched_cuda(*args), ip._probe_batched_plain(*args)
            fin = torch.isfinite(p_sc)
            if not torch.equal(torch.isfinite(k_sc), fin):
                raise AssertionError("batched probe: -inf slots differ from the plain version")
            e = float((k_sc[fin] - p_sc[fin]).abs().max())
            if e > tol:
                raise AssertionError(f"batched probe {dtype}: score error {e}")
            err = max(err, e)
        out[f"ivf_probes[{str(dtype)[6:]},q=3/80,nprobe={nprobe},cap={cap}]"] = err
    torch.cuda.empty_cache()
    return out


def _counters():
    from tpu_rag_torch.ops import attention as att
    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops import topk as tk

    return {"exact": tk._exact_scan_cuda, "packed": tk._packed_scan_cuda,
            "bucketed": tk._bucketed_scan_cuda, "floor": tk._read_sum_cuda,
            "mha": att._fused_mha_cuda, "per_list": ip._probe_list_cuda,
            "batched": ip._probe_batched_cuda}


def _reset_counters() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counters() -> dict[str, int]:
    return {name: fn.launches for name, fn in _counters().items()}


def _unit_rows(n: int, d: int, seed: int):
    import numpy as np

    x = np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _http(port: int, method: str, path: str, body=None, timeout: float = 300.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _doc_text(i: int) -> str:
    words = ["river", "ember", "crown", "harbor", "glass", "falcon", "marble", "thunder",
             "orchard", "lantern", "copper", "meadow", "silver", "winter", "shadow", "canyon"]
    return " ".join(f"{words[(i * 7 + j * 3) % len(words)]}{(i * 31 + j) % 97}"
                    for j in range(200))


def _profile_window(engine, texts: list[str]) -> dict:
    """One fused embed+search window of len(texts) queries, in process (no
    HTTP): wall time, device time by kernel (torch.profiler), idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine._fused_vector_hits_batch(texts, 5, None, None, cache_qv=False)
    torch.cuda.synchronize()
    reps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine._fused_vector_hits_batch(texts, 5, None, None, cache_qv=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                      # host ops; their kernels are listed
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            by_kernel[e.key[:80]] = us / reps / 1e3
    device_ms = sum(by_kernel.values())
    scan_ms = sum(v for key, v in by_kernel.items() if "scan_kernel" in key)
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    # host split of one more window, profiler off: tokenize, then the
    # index's own timers (snapshot / forward+scan+readback / decode)
    t0 = time.perf_counter()
    ids = engine.encoder.tokenize_query_ids(texts)
    t1 = time.perf_counter()
    engine.index.search_fused(engine.encoder.forward_ids, ids, len(texts), 5,
                              return_qv=False)
    split = {"tokenize_ms": (t1 - t0) * 1e3, "total_ms": (time.perf_counter() - t0) * 1e3}
    split.update({k.replace("_s", "_ms"): v * 1e3
                  for k, v in engine.index.last_search_stats.items()})
    return {"queries": len(texts), "wall_ms": wall * 1e3, "device_ms": device_ms,
            "scan_ms": scan_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / (wall * 1e3)),
            "top_device_ms": top, "host_split_ms": split}


@contextlib.contextmanager
def _served(cfg):
    """The app for cfg (it loads the saved store) behind the real HTTP
    server on a free port; counters are zeroed just before it starts.
    Yields (app, engine, /health reply)."""
    from tpu_rag_torch.api.app import create_app
    from tpu_rag_torch.api.server import HTTPServer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        cfg.port = s.getsockname()[1]
    app = create_app(cfg)
    engine = app.state["engine"]
    server = HTTPServer(app, cfg.host, cfg.port, executor_workers=cfg.http_executor_workers)
    thread = threading.Thread(target=server.run, daemon=True)
    _reset_counters()
    thread.start()
    try:
        deadline = time.time() + 60
        while True:
            try:
                health = _http(cfg.port, "GET", "/health", timeout=10)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        yield app, engine, health
    finally:
        server.stop()
        thread.join(timeout=30)
        engine.shutdown()


def _vector_ids(engine, texts: list[str], k: int) -> list[list[str]]:
    """Top-k ids of the fused embed + scan path, in process."""
    hits = engine._fused_vector_hits_batch(texts, k, None, None, cache_qv=False)
    return [[h["id"] for h in hs] for hs in hits]


def phase_serve(work: Path) -> dict:
    import torch

    from tpu_rag_torch.config import Config
    from tpu_rag_torch.index.flat import FlatIndex
    from tpu_rag_torch.index.store import MANIFEST, save_index
    from tpu_rag_torch.utils.metrics import GLOBAL_METRICS

    n, d = 1_000_000, 384
    t0 = time.perf_counter()
    store = FlatIndex(d, dtype="auto", device="cuda")
    store._bulk_adopt_rows(_unit_rows(n, d, SEED), (f"syn-{i}" for i in range(n)),
                           (("", {}) for _ in range(n)), count=n)
    cfg = Config(persist_dir=str(work / "vs"), kb_db_path=str(work / "db" / "kb.sqlite3"),
                 db_path=str(work / "db" / "app.sqlite3"), docs_dir=str(work / "docs"),
                 embedding_model="sentence-transformers/all-MiniLM-L6-v2",
                 host="127.0.0.1", device="cuda")
    store_dir = Path(cfg.persist_dir) / cfg.collection_name
    save_index(store, store_dir)
    del store
    build_s = time.perf_counter() - t0

    with _served(cfg) as (app, engine, health):      # loads the saved store
        assert engine.index.count() == n
        texts = [_doc_text(i) for i in range(4)]
        saved = []
        t_save = time.perf_counter()
        for i, text in enumerate(texts):
            r = _http(cfg.port, "POST", "/docs/save",
                      {"title": f"Smoke doc {i}", "content": text,
                       "metadata": {"namespace": "smoke"}})
            saved.append(r["id"])
        while engine.index.count() < n + len(texts):      # background indexer
            if time.perf_counter() - t_save > 600:
                raise TimeoutError("background indexing did not finish")
            time.sleep(0.2)
        save_s = time.perf_counter() - t_save
        assert engine.encoder.spec.hidden == 384 and engine.encoder.spec.layers == 6
        assert engine.encoder.spec.heads == 12

        queries = texts + [f"{w} tale of the {w} keeper" for w in
                           ("harbor", "falcon", "orchard", "winter", "glass", "copper",
                            "meadow", "canyon")]
        lat = []

        def one(qtext):
            t1 = time.perf_counter()
            r = _http(cfg.port, "POST", "/search", {"query": qtext, "k": 5})
            lat.append(time.perf_counter() - t1)
            return r

        first = [one(q) for q in queries[:4]]                 # sequential
        with ThreadPoolExecutor(8) as pool:                   # concurrent windows
            rest = list(pool.map(one, queries))
        for i, r in enumerate(first + rest[:4]):
            top = r["hits"][0]
            assert top["id"] == saved[i % 4], (i, top["id"])
            assert abs(top["score"]) < 1e-2                   # distance ~ 0: itself
        for r in first + rest:
            assert r["hits"] and all(math.isfinite(h["score"]) for h in r["hits"])
        r = _http(cfg.port, "POST", "/search", {"query": texts[1], "k": 5,
                                                "namespace": "smoke"})
        assert r["hits"][0]["id"] == saved[1] and len(r["hits"]) == 4
        counts = _read_counters()
        windows = {k: v for k, v in GLOBAL_METRICS._counters.items()
                   if k.startswith("vector_microbatch_window_le_")}
        # warm, one at a time: end-to-end latency and the route's stage split
        warm, stages = [], {}
        for qtext in queries[4:]:
            t1 = time.perf_counter()
            r = _http(cfg.port, "POST", "/search", {"query": qtext + " again", "k": 5})
            warm.append((time.perf_counter() - t1) * 1e3)
            for name, ms in r["timings_ms"].items():
                stages.setdefault(name, []).append(ms)
        profile = _profile_window(engine, queries[4:])
        exact_top10 = _vector_ids(engine, queries[4:], 10)
        snapshot = dict(engine.index.snapshot_stats)
        while json.loads((store_dir / MANIFEST).read_text())["count"] < n + len(texts):
            if time.perf_counter() - t_save > 600:            # the saves persist
                raise TimeoutError("the store was not rewritten")
            time.sleep(0.2)
    if counts["exact"] < 1 or counts["mha"] < 1:
        raise AssertionError(f"the main path did not launch the kernels: {counts}")
    del app, engine
    torch.cuda.empty_cache()
    packed = _serve_packed(cfg, queries[4:], exact_top10, n + len(texts))
    out = {"phase": "serve", "rows": n, "store_build_s": build_s,
           "docs_saved": len(saved), "docs_index_s": save_s,
           "searches": len(lat), "search_ms_p50": statistics.median(lat) * 1e3,
           "search_ms_max": max(lat) * 1e3, "windows": windows,
           "warm_search_ms": warm, "warm_search_ms_p50": statistics.median(warm),
           "warm_stage_ms_p50": {k: statistics.median(v) for k, v in stages.items()},
           "profile_8q_window": profile, "snapshot": snapshot,
           "health_device": health["device"], "launches": counts, "packed": packed}
    emit(out)
    return {name: counts[name] + packed["launches"][name] for name in counts}


def _serve_packed(cfg, queries: list[str], exact_top10, rows: int) -> dict:
    """The same store served again with INDEX_SEARCH_MODE=packed: /search
    latency one request at a time, recall@10 of the fused path against the
    exact run's, and the packed scan (#2), not the exact one (#1), launched."""
    cfg.index_search_mode = "packed"
    with _served(cfg) as (_app, engine, _health):
        index = engine.index
        if index.count() != rows or index.effective_search_mode(rows) != "packed":
            raise AssertionError(f"packed serve: {index.count()} rows, mode "
                                 f"{index.effective_search_mode(rows)}")
        lat, stages = [], {}
        for qtext in [queries[0]] + queries:                 # the first one warms up
            t1 = time.perf_counter()
            r = _http(cfg.port, "POST", "/search", {"query": qtext, "k": 5})
            lat.append((time.perf_counter() - t1) * 1e3)
            assert r["hits"] and all(math.isfinite(h["score"]) for h in r["hits"])
            for name, ms in r["timings_ms"].items():
                stages.setdefault(name, []).append(ms)
        top10 = _vector_ids(engine, queries, 10)
        counts = _read_counters()
        profile = _profile_window(engine, queries)
    if counts["packed"] < 1 or counts["exact"] != 0:
        raise AssertionError(f"packed serve launched {counts}")
    recall = statistics.mean(len(set(a) & set(b)) / 10 for a, b in zip(top10, exact_top10))
    if recall < 0.9:
        raise AssertionError(f"packed serve: recall@10 {recall} against the exact run")
    return {"warm_search_ms": lat[1:], "warm_search_ms_p50": statistics.median(lat[1:]),
            "warm_stage_ms_p50": {k: statistics.median(v[1:]) for k, v in stages.items()},
            "profile_8q_window": profile, "recall_at_10_vs_exact": recall,
            "launches": counts}


def phase_scale() -> dict:
    import numpy as np
    import torch

    from tpu_rag_torch.index.flat import FlatIndex

    n, d, nq = 2_000_000, 384, 64
    t0 = time.perf_counter()
    x = _unit_rows(n, d, SEED + 1)
    idx = FlatIndex(d, dtype="auto", device="cuda")
    idx._bulk_adopt_rows(x, (f"r{i}" for i in range(n)), (("", {}) for _ in range(n)),
                         count=n)
    rng = np.random.default_rng(SEED + 2)
    base = rng.choice(n, nq, replace=False)
    q = x[base] + 0.05 * rng.standard_normal((nq, d), dtype=np.float32) / math.sqrt(d)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    assert idx.dtype == "int8" and idx.effective_search_mode(n) == "bucketed"
    snap = idx.device_snapshot()
    assert "r_vectors" in snap                  # the device residual refine
    build_s = time.perf_counter() - t0
    xt = torch.from_numpy(x).to("cuda")
    truth = torch.topk(torch.from_numpy(q).to("cuda") @ xt.T, 10, dim=1).indices.cpu().numpy()
    del xt
    from tpu_rag_torch.ops.topk import dma_floor_scan

    _reset_counters()
    modes = {}
    for mode, counter in (("bucketed", "bucketed"), ("packed", "packed")):
        idx.search_mode = mode
        before = _read_counters()[counter]
        lat = []
        for _ in range(3):                      # the first call warms up
            t1 = time.perf_counter()
            res = idx.search(q, 10)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
        if _read_counters()[counter] - before < 3:    # a seeded scan launches twice
            raise AssertionError(f"the 2M-row {mode} search did not launch its scan")
        got = np.asarray([[int(i[1:]) for i in ids] for ids in res.ids])
        recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, truth)]))
        self_hit = float(np.mean(got[:, 0] == base))
        if recall < 0.95 or self_hit < 1.0:
            raise AssertionError(f"2M int8 {mode} recall@10 {recall}, self hit {self_hit}")
        modes[mode] = {"search_ms_64q_first": lat[0], "search_ms_64q_warm": lat[1:],
                       "recall_at_10": recall, "split_ms": {
                           k_.replace("_s", "_ms"): v * 1e3
                           for k_, v in idx.last_search_stats.items()}}
    # the read floor of these scans (#4 over the snapshot's int8 rows)
    t1 = time.perf_counter()
    dma_floor_scan(snap["vectors"])
    torch.cuda.synchronize()
    floor_first_ms = (time.perf_counter() - t1) * 1e3
    floor_ms = cuda_ms(lambda: dma_floor_scan(snap["vectors"]), iters=3, warmup=1, batch=10)
    counts = _read_counters()
    out = {"phase": "scale", "rows": n, "dtype": idx.dtype, "build_s": build_s,
           "modes": modes, "read_floor_ms": floor_ms, "read_floor_ms_first": floor_first_ms,
           "read_tb_s": snap["vectors"].numel() / (floor_ms * 1e-3) / 1e12,
           "launches": counts}
    emit(out)
    del idx, snap
    torch.cuda.empty_cache()
    return counts


def _ivf_corpus(n: int, d: int, nq: int, seed: int):
    """The scale_10m corpus of bench.py, regenerated with torch: a low-rank
    correlated Gaussian (covariance eigen-spectrum 1/i) of unit rows, and nq
    queries that are corpus rows perturbed by tau = 0.25 of the same noise.
    Returns (rows (n, d) f32 numpy, queries (nq, d) f32 numpy, base rows)."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bq, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev).cpu())
    b = (bq * torch.arange(1, d + 1, dtype=torch.float32).rsqrt()[:, None]).to(dev)

    def unit(z):
        return z * torch.rsqrt((z * z).sum(dim=1, keepdim=True) + 1e-9)

    x = np.empty((n, d), np.float32)
    for i in range(0, n, 500_000):
        r = min(500_000, n - i)
        x[i:i + r] = unit(torch.randn((r, d), generator=g, device=dev) @ b).cpu().numpy()
    base = torch.randperm(n, generator=g, device=dev)[:nq].cpu().numpy()
    eps = unit(torch.randn((nq, d), generator=g, device=dev) @ b)
    q = unit(torch.from_numpy(x[base]).to(dev) + 0.25 * eps)
    return x, q.cpu().numpy(), base


@contextlib.contextmanager
def _plain_probes():
    """Route the IVF probes through their plain versions (on the same CUDA
    tensors) for a comparison run; the kernels' counters do not move."""
    from tpu_rag_torch.ops import ivf_probe as ip

    saved = ip.probe_list_topk, ip.probe_batched_buckets
    ip.probe_list_topk, ip.probe_batched_buckets = ip._probe_list_plain, ip._probe_batched_plain
    try:
        yield
    finally:
        ip.probe_list_topk, ip.probe_batched_buckets = saved


def phase_ivf(work: Path) -> dict:
    import numpy as np
    import torch

    from tpu_rag_torch.config import Config
    from tpu_rag_torch.index.ivf import IVFIndex
    from tpu_rag_torch.index.store import MANIFEST, save_index
    from tpu_rag_torch.utils.metrics import GLOBAL_METRICS

    n, d, nq, k = IVF_ROWS, 384, 64, 10
    t0 = time.perf_counter()
    x, q, base = _ivf_corpus(n, d, nq, SEED + 3)
    gen_s = time.perf_counter() - t0
    xt = torch.from_numpy(x).to("cuda")
    truth = torch.topk(torch.from_numpy(q).to("cuda") @ xt.T, k, dim=1).indices.cpu().numpy()
    del xt
    torch.cuda.empty_cache()

    # ---- build: k-means on the card, lists, int8; then the store
    store = IVFIndex(d, dtype="auto", nlist=IVF_NLIST, nprobe=IVF_NPROBE,
                     list_cap_factor=2.0, device="cuda")
    store._bulk_adopt_rows(x, (f"syn-{i}" for i in range(n)), (("", {}) for _ in range(n)),
                           count=n)
    t1 = time.perf_counter()
    snap = store.device_snapshot()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    geometry = {"dtype": snap["dtype"], "nlist": snap["nlist"],
                "cap": int(snap["vec_lists"].shape[1]), "overflow_rows": len(snap["ov_rows"])}
    if geometry["dtype"] != "int8" or geometry["cap"] % 128:
        raise AssertionError(f"unexpected IVF geometry {geometry}")
    cfg = Config(persist_dir=str(work / "vs"), kb_db_path=str(work / "db" / "kb.sqlite3"),
                 db_path=str(work / "db" / "app.sqlite3"), docs_dir=str(work / "docs"),
                 embedding_model="sentence-transformers/all-MiniLM-L6-v2",
                 host="127.0.0.1", device="cuda", index_kind="ivf",
                 ivf_nlist=IVF_NLIST, ivf_nprobe=IVF_NPROBE)
    store_dir = Path(cfg.persist_dir) / cfg.collection_name
    t1 = time.perf_counter()
    save_index(store, store_dir)
    save_s = time.perf_counter() - t1
    del store, snap, x
    torch.cuda.empty_cache()

    # ---- serve the store over HTTP (the engine loads it: kind "ivf")
    with _served(cfg) as (app, engine, _health):
        index = engine.index
        assert type(index) is IVFIndex and index.count() == n
        index.list_cap_factor = 2.0  # a store records no cap factor; the build's
        t1 = time.perf_counter()
        _http(cfg.port, "POST", "/search", {"query": "first light", "k": 5})
        first_search_s = time.perf_counter() - t1   # encoder init + snapshot from the store
        if index.device_snapshot()["vec_lists"].shape[1] != geometry["cap"]:
            raise AssertionError("the served lists differ from the built ones")

        # two saves: each rewrites the whole store (persist_index)
        texts = [_doc_text(i) for i in range(2)]
        saved, save_times = [], []
        for i, text in enumerate(texts):
            t1 = time.perf_counter()
            r = _http(cfg.port, "POST", "/docs/save",
                      {"title": f"IVF doc {i}", "content": text,
                       "metadata": {"namespace": "smoke"}})
            saved.append(r["id"])
            while index.count() < n + i + 1:
                if time.perf_counter() - t1 > 600:
                    raise TimeoutError("background indexing did not finish")
                time.sleep(0.05)
            searchable = time.perf_counter() - t1
            while json.loads((store_dir / MANIFEST).read_text())["count"] < n + i + 1:
                if time.perf_counter() - t1 > 600:
                    raise TimeoutError("the store was not rewritten")
                time.sleep(0.2)
            save_times.append({"searchable_s": searchable,
                               "persisted_s": time.perf_counter() - t1})
        for i, text in enumerate(texts):
            r = _http(cfg.port, "POST", "/search", {"query": text, "k": 5})
            if r["hits"][0]["id"] != saved[i]:
                raise AssertionError(f"saved doc {i} is not its own top hit: {r['hits'][0]}")

        queries = [f"{w} tale of the {w} keeper" for w in
                   ("harbor", "falcon", "orchard", "winter", "glass", "copper", "meadow",
                    "canyon")]

        def one(qtext):
            t1 = time.perf_counter()
            r = _http(cfg.port, "POST", "/search", {"query": qtext, "k": 5})
            assert len(r["hits"]) == 5 and all(math.isfinite(h["score"]) for h in r["hits"])
            return (time.perf_counter() - t1) * 1e3, r["timings_ms"]

        def summary(results):
            stages = {}
            for _, tm in results:
                for name, ms in tm.items():
                    stages.setdefault(name, []).append(ms)
            return {"ms": [ms for ms, _ in results],
                    "ms_p50": statistics.median(ms for ms, _ in results),
                    "stage_ms_p50": {kk: statistics.median(v) for kk, v in stages.items()}}

        seq = summary([one(qtext) for qtext in queries])        # sequential: Q = 1
        bursts = []
        for round_ in range(2):                                 # microbatch windows
            with ThreadPoolExecutor(8) as pool:
                bursts.append(summary(list(pool.map(
                    one, [f"{qtext} burst {round_}" for qtext in queries]))))
        windows = {kk: v for kk, v in GLOBAL_METRICS._counters.items()
                   if kk.startswith("vector_microbatch_window_le_")}
        http_counts = _read_counters()

        # ---- in process: per-route recall@10 against f32 exact, kernel and plain
        def recall(id_lists):
            got = [[int(i[4:]) for i in ids if i.startswith("syn-")] for ids in id_lists]
            return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(got, truth)]))

        def split_ms():
            return {kk.replace("_s", "_ms"): v * 1e3 for kk, v in index.last_search_stats.items()}

        def run_routes():
            out = {}
            lat, hits, splits = [], [], []
            for i in range(nq):                                # Q = 1: per-list #6
                t1 = time.perf_counter()
                res = index.search(q[i:i + 1], k)
                lat.append((time.perf_counter() - t1) * 1e3)
                assert index.last_probe_route == "per_list"
                hits.append(res.ids[0])
                splits.append(split_ms())
            out["q1"] = {"recall_at_10": recall(hits),
                         "search_ms_p50": statistics.median(lat),
                         "split_ms_p50": {kk: statistics.median(s_[kk] for s_ in splits)
                                          for kk in splits[0]}}
            lat = []
            for _ in range(5):                                 # Q = 64: batched #7
                t1 = time.perf_counter()
                res = index.search(q, k)
                lat.append((time.perf_counter() - t1) * 1e3)
                assert index.last_probe_route == "batched"
            out["q64"] = {"recall_at_10": recall(res.ids), "search_ms_p50": statistics.median(lat),
                          "split_ms_last": split_ms(),
                          "self_hit": float(np.mean([
                              int(ids[0][4:]) == b for ids, b in zip(res.ids, base)]))}
            return out

        kernel = run_routes()
        counts = _read_counters()
        with _plain_probes():
            plain = run_routes()
        if _read_counters() != counts:
            raise AssertionError("the plain run launched a probe kernel")
        snapshot = dict(index.snapshot_stats)
    if counts["per_list"] < 1 or counts["batched"] < 1 or http_counts["per_list"] < 1:
        raise AssertionError(f"the IVF path did not launch the probe kernels: {counts}")
    for route in ("q1", "q64"):
        if abs(kernel[route]["recall_at_10"] - plain[route]["recall_at_10"]) > 0.01:
            raise AssertionError(f"{route}: kernel and plain recall differ: {kernel} {plain}")
    if kernel["q1"]["recall_at_10"] < 0.9 or kernel["q64"]["recall_at_10"] < 0.85:
        raise AssertionError(f"IVF recall@10 below its floor: {kernel}")
    out = {"phase": "ivf", "rows": n, "corpus_gen_s": gen_s, "build_s_kmeans_lists": build_s,
           "store_save_s": save_s, "geometry": geometry,
           "first_search_s_from_store": first_search_s, "doc_saves": save_times,
           "http_search_seq": seq, "http_search_burst8": bursts, "windows": windows,
           "routes_kernel": kernel, "routes_plain": plain,
           "snapshot": snapshot, "launches_http": http_counts, "launches": counts}
    emit(out)
    del app, engine, index
    torch.cuda.empty_cache()
    return counts


# scripts/rehearse_host_ivf.py's geometry (nprobe 64, cap factor 2.0, chunks
# of 250K, a 262,144-row training sample, k 10, batches of 8 queries, its
# low-rank generator), cut from 50M rows / 16,384 lists to 12.5M / 4,096 for
# the run's time limit, which keeps ~3,052 rows a list
HIVF_ROWS, HIVF_NLIST, HIVF_NPROBE, HIVF_CHUNK, HIVF_TRAIN = (
    12_500_000, 4096, 64, 250_000, 262_144)


def phase_host_ivf(work: Path, n: int = HIVF_ROWS, nlist: int = HIVF_NLIST,
                   device: str = "cuda") -> dict:
    """HostArenaIVF at a corpus whose lists live in host RAM: built from
    chunks born on the card, searched in batches of 8 (the gathered union
    through #1, one batch through #2), saved and loaded with mmap."""
    import numpy as np
    import torch

    from tpu_rag_torch.index.host_ivf import HostArenaIVF
    from tpu_rag_torch.ops.quant import quantize_int8_rows
    from tpu_rag_torch.ops.topk import fused_matmul_topk

    d, k, qb, nbatch = 384, 10, 8, 4
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    bq, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev).cpu())
    basis = (bq * torch.arange(1, d + 1, dtype=torch.float32).rsqrt()[:, None]).to(dev)

    def gen(rows):
        z = torch.randn((rows, d), generator=g, device=dev) @ basis
        return z * torch.rsqrt((z * z).sum(dim=1, keepdim=True) + 1e-9)

    ivf = HostArenaIVF(d, nlist=nlist, nprobe=HIVF_NPROBE, cap_factor=2.0,
                       expected_rows=n, max_overflow=max(2_000_000, n // 4), device=dev)
    t0 = time.perf_counter()
    ivf.train(gen(min(HIVF_TRAIN, n)))
    sync()
    train_s = time.perf_counter() - t0
    # the int8 corpus stays on the card too: the recall reference is #1 over it
    x8 = torch.empty((n, d), dtype=torch.int8, device=dev)
    s8 = torch.empty((n,), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    for off in range(0, n, HIVF_CHUNK):
        c = gen(min(HIVF_CHUNK, n - off))
        if off == 0:
            first = c[:qb * nbatch].clone()
        ivf.add(c)
        x8[off:off + len(c)], s8[off:off + len(c)] = quantize_int8_rows(c)
    sync()
    add_s = time.perf_counter() - t0
    eps = gen(qb * nbatch)
    q = first + 0.25 * eps
    q = (q / q.norm(dim=1, keepdim=True)).cpu().numpy()
    batches = [q[i:i + qb] for i in range(0, len(q), qb)]

    _reset_counters()
    ivf.search(batches[0], k)                      # first use: staging buffers
    lat, splits, rows = [], [], {}
    for _ in range(2):
        for i, b in enumerate(batches):
            t1 = time.perf_counter()
            _, rows[i] = ivf.search(b, k)
            lat.append((time.perf_counter() - t1) * 1e3)
            splits.append(ivf.last_search_stats)
    t1 = time.perf_counter()
    p_sc, p_rows = ivf.search(batches[0], k, mode="packed")
    packed_ms = (time.perf_counter() - t1) * 1e3
    counts = _read_counters()
    if counts["exact"] < 1 or counts["packed"] < 1:
        raise AssertionError(f"host-arena search did not launch #1 and #2: {counts}")

    t1 = time.perf_counter()
    truth = fused_matmul_topk(torch.from_numpy(q).to(dev), x8, k, db_scales=s8)[1].cpu().numpy()
    truth_ms = (time.perf_counter() - t1) * 1e3

    def recall(got, want):
        return float(np.mean([len(set(a[a >= 0].tolist()) & set(b.tolist())) / k
                              for a, b in zip(got, want)]))

    rec = recall(np.concatenate([rows[i] for i in range(nbatch)]), truth)
    rec_packed = recall(p_rows, truth[:qb])
    rec_exact0 = recall(rows[0], truth[:qb])
    if rec < 0.7 or rec_packed < 0.7:
        raise AssertionError(f"host-arena recall@10 {rec}, packed {rec_packed}")

    t1 = time.perf_counter()
    ivf.save(str(work / "hivf"))
    save_s = time.perf_counter() - t1
    sc0, rows0 = ivf.search(batches[1], k)
    t1 = time.perf_counter()
    back = HostArenaIVF.load(str(work / "hivf"), mmap=True, device=dev)
    sc1, rows1 = back.search(batches[1], k)
    reload_ms = (time.perf_counter() - t1) * 1e3
    if not (np.array_equal(rows0, rows1) and np.allclose(sc0, sc1, rtol=0, atol=1e-5)):
        raise AssertionError("the mmap-loaded store searches differently")
    keys = ("probe_ms", "gather_ms", "upload_ms", "scan_ms", "merge_ms", "device_ms")
    out = {"phase": "host_ivf", "rows": n, "nlist": nlist, "cap": ivf.cap,
           "nprobe": HIVF_NPROBE, "spilled_rows": ivf.spilled_rows,
           "host_list_bytes": int(ivf._vec.nbytes + 4 * ivf._scale.nbytes + ivf._fill.nbytes),
           "build_s": {"train": train_s, "add": add_s},
           "batch_ms": lat, "batch_ms_p50": statistics.median(lat),
           "split_ms_p50": {kk: statistics.median(s_[kk] for s_ in splits)
                            for kk in keys if kk in splits[0]},
           "lists_per_batch": [s_["lists"] for s_ in splits],
           "recall_at_10_vs_int8_exact": rec, "packed_batch": {
               "ms": packed_ms, "recall_at_10_vs_int8_exact": rec_packed,
               "exact_recall_same_batch": rec_exact0},
           "truth_scan_ms": truth_ms, "save_s": save_s,
           "mmap_load_and_search_ms": reload_ms, "launches": counts}
    emit(out)
    del ivf, back, x8, s8
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,serve,scale,ivf,host_ivf",
                    help="comma-separated subset of build,kernels,serve,scale,ivf,host_ivf")
    args = ap.parse_args()
    phases = args.phases.split(",")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (REPO / "tpu_rag_torch" / "csrc").is_dir():
        print(f"chip_smoke: the tpu_rag_torch package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi})

    rows, launches = [], {}
    (REPO / "build").mkdir(exist_ok=True)
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        rows = phase_kernels()
    # each phase drives its part of the path with the counters zeroed first;
    # a kernel's launches are the sum over the phases that ran
    runs = {"serve": phase_serve, "scale": lambda _work: phase_scale(),
            "ivf": phase_ivf, "host_ivf": phase_host_ivf}
    for name, run in runs.items():
        if name in phases:
            with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_",
                                             dir=REPO / "build") as work:
                for kern, count in run(Path(work)).items():
                    launches[kern] = launches.get(kern, 0) + count
    for r in rows:
        r["launches"] = launches.get(r.pop("counter"))
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
