#!/usr/bin/env python3
"""Smoke run of the tpu_rag_torch port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line (any failure exits non-zero):

  build    compile every kernel of tpu_rag_torch/csrc with nvcc (sm_90a),
           all sources in parallel, into build/tpu_rag_torch/;
  kernels  hold each kernel against its plain PyTorch version on the card at
           the main path's shapes, d 384 and bge-base's d 768 (head dim 64
           for #5, and one model rank's 6 or 3 heads), and time kernel, plain version and one library call
           (CUDA events, median); every launch plan at d 384 and 768 against
           the kernels' own shared-memory arithmetic;
  serve    a 1,000,000 x 384 flat store (bf16, exact scan) behind the real
           HTTP server with all-MiniLM-L6-v2 at full width, its seeded
           weights written by this script as a HF model.safetensors and
           loaded through EMBEDDING_WEIGHTS: /docs/save of ~200-token
           documents, then /search, some of it concurrent; the scan (#1) and
           attention (#5) counters must rise.  Then /search with rerank: the
           ms-marco-MiniLM-L-6-v2 geometry (a seeded HF pytorch_model.bin,
           RERANK_WEIGHTS) over 20 candidates at T 256, logits held against
           the same checkpoint at f32 on the CPU, one forward profiled; and
           /compose, /compose_stream and /threads on the extractive backend;
  scale    a 2,000,000-row FlatIndex in auto mode (int8 + bucketed scan, #3)
           searched through FlatIndex.search, recall@10 against f32 exact;
  ivf      a 4,000,000 x 384 IVF store (auto -> int8 lists, nlist 2048, cap
           factor 2.0, nprobe 64; a low-rank correlated corpus) built by
           k-means on the card, saved, and served over HTTP with
           INDEX_KIND=ivf: /docs/save (with one /search while the save
           rewrites the store), sequential /search (per-list probe #6) and a
           concurrent burst; then 64 perturbed corpus rows searched
           one at a time (#6) and as one batch (batch-shared probe #7),
           recall@10 against f32 exact, kernels against plain versions;
  host_ivf a 12,500,000 x 384 HostArenaIVF (int8 lists in host RAM)
           through scripts/rehearse_host_ivf.py (build, exact truth, nprobe
           sweep), batches of 8, save and mmap load;
  train    train_semantic at full width (MiniLM-L6, batch 512, T 128 / 48,
           bf16), cut to 1,000 steps over make_corpus's 20,000 docstrings of
           the installed packages (built beside the kernel build): every
           step timed by CUDA events, one profiled; the loss must fall and
           #5 must not launch in training (it has no backward: a call under
           autograd must raise); the checkpoint (a HF directory) through
           the labeled eval (trained recall@10 at least seeded + 0.05; its
           embeds launch #5), the card's embeddings against the CPU's f32
           forward of the same checkpoint (cosine >= 0.99), then served
           over HTTP (EMBEDDING_WEIGHTS, TOKENIZER_PATH): 500 held-out
           /docs/save, 32 /search at k 10, #1 and #5 launched;
  scripts  the offline tools in process: build_index + query_local over
           examples/docs, eval_recall --synthetic 1,000,000 (bf16, int8,
           bucketed on bf16 rows, ivf: #1, #3, #7), prove_checkpoint of the
           train phase's checkpoint (exit 0; #5's f32 kernel), bench_scale
           flat-1m-bf16 at d 768 (#1-#4) and encoder-minilm, and the
           CPU HNSW baseline at 100,000 x 384 (built in a process of its own
           from the start);
  rehearse scripts/rehearse_scale.py at its defaults over the train phase's
           corpus (or one of its own): bge-base (768 wide, head dim 64)
           embeds 20,000 documents, 1,000,000 x 768 rows served through the
           index API and HTTP against f32 exact, bench_http's load.
  shard    the sharded serving path (tpu_rag_torch/parallel) on cuda:0 named
           4 times: a 4,000,000 x 384 ShardedFlatIndex (int8, 1M rows a
           shard: #1 on every shard, the host refine) served over HTTP with a
           data-parallel MiniLM-L6 encoder (/docs/save into the first build,
           32 /search with #1's launches counted a window, a re-save whose
           old row dies by a shard-local kill), recall@10 against f32 exact
           and ids against the plain scans, the same snapshot bucketed (#3
           on every shard); a 2,000,000 x 384 int8 ShardedIVFIndex (nlist
           1024, cap factor 2.0, nprobe 64: #6 on every shard) with a
           main-list and an overflow kill; two processes in a gloo group
           on cuda:0 loading their halves of a 1,000,000 x 384 bf16 store;
           and rehearse_100m (8 shards, 384 wide, rows cut as PERF.md
           section 4 says) in a process of its own beside them;
  tp       data x tensor parallel on data:2,model:2 of cuda:0 named 4
           times: bge-base (12 heads of 64, 6 a model rank) over a
           1,000,000 x 768 bf16 ShardedFlatIndex (2 data shards) behind the
           HTTP server, 64 /docs/save and 32 /search (each doc its own top
           hit; #5 once a layer, rank and data slice of every T >= 128
           forward, #1 once a data shard a window), its embeddings against
           the unsharded encoder on the card (cosine >= 0.999) and the
           CPU's f32 forward (>= 0.99); bge-base at model:4 (3 heads a
           rank) over 256 documents at T 256; the DP x TP contrastive
           trainer (MiniLM-L6, batch 512, T 128 / 48): 3 f32 steps against
           the unsharded trainer, 30 bf16 steps (the loss falls, no kernel
           launches), ms/step beside the unsharded step's, the gathered
           checkpoint served unsharded;
  mbert_attn  ModernBERT's attention kernels (csrc/ragged_attention.cu) at
           the train-4k cell's documents (B 32, T 4,096, H 16, D 64), global
           and banded (w 64), on rows of the traffic's lengths and all-real
           rows: forward and backward against the plain version (f32), then
           timed beside their bound (the real pairs' operations, the real
           rows' reads), the plain version and the library's fused
           attention on the same call (`library_ms`, which the port never
           calls on the card), and the library at full length with no mask
           as the rate to hold the kernels to; the nvcc build's seconds;
           then 4 of the cell's training steps (ModernBERT-large,
           ContrastiveTrainer: eager, captured, replayed), whose kernel
           launches and device runs must be 112 forward, 56 backward a
           step; fails at 0 launches or another count;
  rerank_train  train_reranker at MiniLM-L6 width over the train phase's
           corpus and bi-encoder (batch 256 pairs, T 160, bf16, 1,500 steps
           at lr 1e-4) with a val eval and two mining rounds: every step
           timed by CUDA events, one profiled; the loss must fall and no
           kernel may launch in training; the held-out lift through the
           serving CrossEncoder (#5 at B 256, T 160; trained recall@10 at
           least seeded + 0.05), the checkpoint loaded without a spec on the
           card against the CPU (RERANK_LOGIT_TOL) and its logits on the
           probe pairs spread (RERANK_LOGIT_STD_MIN, own body above a
           neighbour's on average), then the trained pair served
           with RERANK_MODE=ensemble over the train phase's store: 32
           /search with rerank, every reply reranked, #1 and #5 launched;
  (rerank_train and scripts read what train writes: run them with it.)
  Every WordPiece tokenizer a phase builds must run natively.

Then the seconds of each phase with, per phase, bf16 #5's launches and
the share of their 64-key chunks whose keys are all masked in a row with
a real key (work a kernel could skip; --save-masks PATH keeps the first
masks of each shape for kernel_ab.py --masks), the kernels summary
line, the card's name and power limit as nvidia-smi reports them, and,
last, {"ok": true, "device": {...}}.  Without a CUDA device, or without the repository beside
this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
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
# card (bf16) against CPU (f32) cross-encoder logits: this share of the
# largest CPU logit's magnitude (or of 1), set before any chip run
RERANK_LOGIT_TOL = 0.05
# the f32 per-list probe's (#6) name in a torch.profiler trace
F32_PROBE_KERNEL = "probe_f32_kernel"


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


class _LostRecords(AssertionError):
    """The profiler saw the named kernel, but in no window all of its
    launches."""


def kernel_ms(fn, name: str, reps: int = 10) -> float:
    """Device time a call of fn spends in the kernels whose name holds
    `name` (kernel_ab.py's torch.profiler window over `reps` calls): the
    kernel's own time, which calls back to back (cuda_ms with batch > 1)
    give only where the device, not the host's launches, sets the pace.
    Raises AssertionError where no window held a kernel of that name, and
    _LostRecords where every window held only a part of its launches."""
    from kernel_ab import _profile

    seen, named = {}, False
    for _ in range(3):
        # CUPTI now and then delivers none or only some of a window's
        # records of the kernel (a time under the kernel's bound): every
        # call launches it equally often, so a whole window holds a
        # multiple of `reps` launches; profile again rather than report a
        # part of the time
        prof = _profile(fn, reps)
        seen = prof["by_kernel_ms"]
        keys = [key for key in seen if name in key]
        named = named or bool(keys)
        ms = sum(seen[key] for key in keys)
        launches = sum(prof["by_kernel_count"][key] for key in keys)
        if ms > 0.0 and launches % reps == 0:
            return ms
    if not named:
        raise AssertionError(f"no kernel named {name} in three profiler windows; "
                             f"they held {sorted(seen)[:6]}")
    raise _LostRecords(f"the profiler saw no whole window of {name} in three")


def _device_ms(fn, name: str, bound_ms: float, lost_ok: bool = False) -> dict:
    """The kernel's own time (kernel_ms), where it came from, and its share
    of the bound.  Where the profiler saw the kernel but lost a part of its
    launches in all three windows, 10 calls back to back timed by CUDA
    events (the wrapper's other kernels included) and no share of the
    bound; with lost_ok (the shard rows: full runs lose whole windows
    there, PERF.md section 7) also where it saw none of the kernel's."""
    try:
        ms = kernel_ms(fn, name)
        return {"device_ms": ms, "device_ms_from": "torch.profiler",
                "pct_of_bound": 100.0 * bound_ms / ms}
    except AssertionError as err:
        if not (lost_ok or isinstance(err, _LostRecords)):
            raise
        return {"device_ms": cuda_ms(fn, iters=5, batch=10), "pct_of_bound": None,
                "device_ms_from": "CUDA events over 10 calls back to back (the profiler "
                                  f"lost records: {err})"}


# ------------------------------------------------------------------ phases


def phase_build():
    from tpu_rag_torch import _build
    from tpu_rag_torch.native import binding

    t0 = time.perf_counter()
    paths = _build.build_all()
    for name in paths:
        _build.load(name)
    t1 = time.perf_counter()
    for name in ("wordpiece", "hnsw"):              # the host libraries (g++)
        binding.load(name)
    host_s = time.perf_counter() - t1
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.is_file() else []
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln][:12]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "host_libraries_s": host_s,
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


def _corpus(g, n: int, d: int):
    """n unit rows of width d on the card with random ns/canon tags, the
    last 1,000 rows PAD, and exact ties within one block (rows 11 and 77)
    and across two blocks' ranges (5000 and n - 5000)."""
    import torch

    from tpu_rag_torch.ops import topk as tk

    dev = torch.device("cuda")
    x = torch.randn((n, d), generator=g, device=dev)
    x = x / x.norm(dim=1, keepdim=True)
    ns = torch.randint(0, 4, (n,), generator=g, device=dev, dtype=torch.int32)
    canon = torch.randint(0, 2, (n,), generator=g, device=dev, dtype=torch.int32)
    ns[-1000:] = tk.PAD_TAG                       # padding rows
    x[77] = x[11]                                  # an exact tie in one block
    x[n - 5000] = x[5000]                          # and across two blocks' ranges
    return x, ns, canon


def _scan_rows(g, n: int, d: int, cases, sms: int, floor_of) -> tuple[list, tuple]:
    """#1 (exact) and #2 (packed) against their plain versions on n x d rows,
    bf16, int8 and f32 (FlatIndex(dtype="float32"): no refine, so the scan
    is the whole device path), one row for each (mode, dtype, nq, k) of
    `cases`, with and without filters; the ties of _corpus go to the
    lowest row.  f32 exact rows by _f32_id_check (1e-4), packed rows by
    _packed_check (a sum in another order can round one 18-bit step the
    other way); every row with the kernel's own device time and the kernel
    its plan launches (box_scan_kernel or pipe_scan_kernel); the
    composite is torch.matmul (bf16, or f32 with TF32 off as main() sets
    it) + torch.topk.  Returns the rows and the database (bf16 rows, int8
    rows, their scales, ns, canon) for the rows after them."""
    import torch

    from tpu_rag_torch.native.binding import layout
    from tpu_rag_torch.ops import topk as tk
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    dev = torch.device("cuda")
    x, ns, canon = _corpus(g, n, d)
    xb = x.to(torch.bfloat16)
    x8, s8 = quantize_int8_rows(x)
    if not any(dtype == "f32" for _, dtype, _, _ in cases):
        del x
    scans = {"exact": (tk._exact_scan_cuda, tk._exact_scan_plain, "tpu_rag/ops/topk.py:96"),
             "packed": (tk._packed_scan_cuda, tk._packed_scan_plain, "tpu_rag/ops/topk.py:201")}
    rows = []
    for mode, dtype, nq, k in cases:
        kernel, plain, replaces = scans[mode]
        packed, f32 = mode == "packed", dtype == "f32"
        qf = torch.randn((nq, d), generator=g, device=dev)
        qf[0] = xb[11].float()
        if nq > 1:
            qf[1] = xb[5000].float()
        if dtype == "bf16":
            xx, sc, q_in, qs, elt = xb, None, qf.to(torch.bfloat16), None, 2
        elif f32:
            xx, sc, q_in, qs, elt = x, None, qf, None, 4
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
        elif f32:
            chk = _f32_id_check(k_sc, k_id, p_sc, p_id, q_in, xx, 1e-4)
            _f32_id_check(*kernel(*fargs), *plain(*fargs), q_in, xx, 1e-4)
        else:
            chk = _id_check(k_sc, k_id, p_sc, p_id, 1e-4)
            _id_check(*kernel(*fargs), *plain(*fargs), 1e-4)
        plan = tk._scan_plan(n, d, nq, k, xx.dtype, sms, mode)
        if k_id[0, 0].item() != 11:
            raise AssertionError(f"{dtype} {mode} scan: the tie must go to the lowest row")
        if nq > 1:
            if 5000 // plan.block_rows == (n - 5000) // plan.block_rows:
                raise AssertionError(f"rows 5000 and {n - 5000} share a block: {plan}")
            if k_id[1, 0].item() != 5000:
                raise AssertionError(f"{dtype} {mode} scan: a tie across two blocks must go "
                                     f"to the lowest row, got {k_id[1, :2].tolist()}")

        def library(q_in=q_in, xx=xx, sc=sc, qs=qs, k=k, packed=packed, f32=f32):
            s = (torch.matmul(q_in, xx.T) if f32
                 else torch.matmul(q_in.to(torch.bfloat16), xx.to(torch.bfloat16).T).float())
            if sc is not None:
                s = s * qs[:, None] * sc[None, :]
            s = torch.where((ns != tk.PAD_TAG)[None, :], s, -math.inf)
            return torch.topk(tk.round18(s) if packed else s, k, dim=1)

        nbytes = n * d * elt + n * 8 + (n * 4 if sc is not None else 0) + nq * d * elt + nq * k * 8
        b_ms, b_by = bound(nbytes, 2.0 * n * d * nq, dtype)
        ms = cuda_ms(lambda: kernel(*args))
        floor = floor_of(xx)
        box = layout().tr_box_route(tk._DTYPE_CODE[xx.dtype])
        kname = "box_scan_kernel" if box else "pipe_scan_kernel"
        row = {"name": f"{mode}_scan[{dtype},n={n},d={d},q={nq},k={k}]", "route": "cuda",
               "plan": plan._asdict(),
               "source": "tpu_rag_torch/csrc/topk.cu", "replaces": replaces,
               "counter": f"{mode}_f32" if f32 else f"{mode}_bf16_int8", **chk, "ms": ms,
               "kernel": kname, **_device_ms(lambda: kernel(*args), kname, b_ms),
               "plain_ms": cuda_ms(lambda: plain(*args), iters=5),
               "library_ms": cuda_ms(library, iters=5),
               "bound_ms": b_ms, "bound_by": b_by,
               "floor_ms": floor, "pct_of_floor": 100.0 * floor / ms}
        if packed:
            row["exact_ms_same_shape"] = cuda_ms(lambda: tk._exact_scan_cuda(*args))
            row["library"] = "composite: torch.matmul + round18 + torch.topk"
        rows.append(row)
    return rows, (xb, x8, s8, ns, canon)


def phase_kernels() -> list[dict]:
    import torch

    from tpu_rag_torch.ops import topk as tk
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    floors = {}

    def floor_of(xx):
        """#4 over the matrix a scan reads: the read floor of that scan
        (back to back: the device's read rate, not the wrapper's)."""
        key = (xx.dtype, tuple(xx.shape))
        if key not in floors:
            floors[key] = cuda_ms(lambda: tk._read_sum_cuda(xx), iters=5, batch=10)
        return floors[key]

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans_checked = _plan_sweep(sms)
    # ---- #1 exact scan: 1M x 384, bf16 (q 8, 64; k_scan 20) and int8 (q 64;
    # 4k = 40; q 8, k_scan 1024: a rerank of 256 candidates on int8); #2
    # packed scan at the same rows, bf16 (q 8, k_scan 64 = packed_k_scan(10))
    # and int8 (q 64, k_scan 80 = packed_k_scan(20)); f32 rows
    # (FlatIndex(dtype="float32")): exact at q 1, 8 and 64 (k 20), packed at
    # q 8 (k 64)
    n = 1_000_000
    rows, (xb, x8, s8, ns, canon) = _scan_rows(
        g, n, 384, (("exact", "bf16", 8, 20), ("exact", "bf16", 1, 20),
                    ("exact", "bf16", 64, 20), ("exact", "int8", 64, 40),
                    ("exact", "int8", 8, 1024), ("packed", "bf16", 8, 64),
                    ("packed", "int8", 64, 80), ("exact", "f32", 1, 20),
                    ("exact", "f32", 8, 20), ("exact", "f32", 64, 20),
                    ("packed", "f32", 8, 64)), sms, floor_of)
    # ---- #3 bucketed scan on the same 1M x 384 bf16 rows, q 32: eval_recall's
    # `bucketed` config (FlatIndex(search_mode="bucketed") over a bf16 store)
    rows.append(_bucketed_row(g, xb, None, ns, canon, 32, 20, sms, floor_of(xb)))
    # ---- #4 read-rate probe on the 1M x 384 bf16 matrix (the 2M int8 below)
    rows.append(_floor_row(xb, "bf16", floor_of(xb)))
    del xb, x8, s8, ns, canon
    torch.cuda.empty_cache()

    # ---- #3 bucketed scan: 2M x 384 int8, q 64, k_scan 40
    n = 2_000_000
    x, ns, canon = _corpus(g, n, 384)
    x8, s8 = quantize_int8_rows(x)
    del x
    rows.append(_bucketed_row(g, x8, s8, ns, canon, 64, 40, sms, floor_of(x8)))
    rows.append(_floor_row(x8, "int8", floor_of(x8)))
    del x8, s8, ns, canon
    floors.clear()
    torch.cuda.empty_cache()

    # ---- d 768 (bge-base, rehearse_scale's 1M rows): #1 exact at q 1, 8
    # and 64, bf16 (k_scan 20: k 10, bf16 refine 2x, the rehearsal's path;
    # box_scan_kernel) and int8 (k_scan 40: int8 refine 4x); #1 and #2 bf16
    # at q 8, k_scan 512 (RERANK_CANDIDATES 256 refined 2x;
    # packed_k_scan(128)); #1 f32 at q 8 (k 20); #3 bucketed int8 at 2M x 768
    n = 1_000_000
    cases = tuple(("exact", dt, nq, k) for dt, k in (("bf16", 20), ("int8", 40))
                  for nq in (1, 8, 64)) + (("exact", "bf16", 8, 512), ("packed", "bf16", 8, 512),
                                           ("exact", "f32", 8, 20))
    wide, (xb, x8, s8, ns, canon) = _scan_rows(g, n, 768, cases, sms, floor_of)
    rows += wide
    rows.append(_floor_row(xb, "bf16", floor_of(xb)))
    del xb, x8, s8, ns, canon
    floors.clear()
    torch.cuda.empty_cache()
    n = 2_000_000
    x, ns, canon = _corpus(g, n, 768)
    x8, s8 = quantize_int8_rows(x)
    del x
    rows.append(_bucketed_row(g, x8, s8, ns, canon, 64, 40, sms, floor_of(x8)))
    del x8, s8, ns, canon
    floors.clear()
    torch.cuda.empty_cache()

    # ---- #3 bucketed on f32 rows (FlatIndex(dtype="float32") from 2M
    # rows): 2M x 384, q 64 (3.07 GB)
    n = 2_000_000
    x, ns, canon = _corpus(g, n, 384)
    rows.append(_bucketed_row(g, x, None, ns, canon, 64, 20, sms, floor_of(x)))
    del x, ns, canon
    floors.clear()
    torch.cuda.empty_cache()

    # ---- #5 attention: B 64, H 12, D 32, bf16, ragged masks, at the
    # encoder's document buckets T 128, 256 and 512, the cross-encoder's
    # shape (20 rerank candidates -> batch 32, T 256), the trained
    # reranker's eval (B 256 at T 160: a ragged last 64-key chunk); then
    # head dim 64 (bge-base: 768 wide, 12 heads): mha_tc_kernel<64> at
    # T 128 (rehearse_scale's documents), 256 (the default EMBED_SEQ_LEN)
    # and 512 (the largest T); and the
    # f32 kernel (prove_checkpoint's f32 encoder), D 32 and 64, at B 64, T
    # 256, 512 and 160 (a ragged last chunk)
    for t in (256, 128, 512):
        rows.append(_attention_row(g, 64, t, 12, 32))
    rows.append(_attention_row(g, 32, 256, 12, 32))
    rows.append(_attention_row(g, 256, 160, 12, 32))
    for t in (128, 256, 512):
        rows.append(_attention_row(g, 64, t, 12, 64))
    for hd in (32, 64):
        for t in (256, 512, 160):
            rows.append(_attention_row(g, 64, t, 12, hd, torch.float32))
    # ---- #5 on one model rank's heads (the tp phase): bge-base at
    # model:2 (H 6) and model:4 (H 3), D 64, and MiniLM's D 32 at H 6
    for b, h, hd in ((64, 6, 64), (64, 3, 64), (32, 6, 32)):
        rows.append(_attention_row(g, b, 256, h, hd))
    rows += _probe_kernel_rows(g)
    rows += _probe_kernel_rows(g, d=768, dtypes=(torch.int8,))
    rows += _probe_float_rows(g)
    floats = {**_list_checks(g), **_batched_checks(g), **_probe_float_checks(g)}
    emit({"phase": "kernels", "checked": [r["name"] for r in rows] + list(floats),
          "plans_checked": plans_checked,
          "max_abs_err": {**{r["name"]: r["max_abs_err"] for r in rows}, **floats},
          "rows": rows})                 # the kernels line at the end adds the launches
    return rows


# #5 against its plain version: bf16 within 2e-2 (P is cast to bf16 before
# it is normalised); f32 within 1e-4 as well (the same f32 arithmetic in
# another order: a 64-key online softmax in the log2 domain)
ATT_TOL, ATT_TOL_F32 = 2e-2, 1e-4


def _attention_row(g, b: int, t: int, h: int, hd: int, dtype=None) -> dict:
    """#5 against its plain version (in f32, ATT_TOL; f32 inputs ATT_TOL_F32
    too) with a full row, a one-token row and an all-pad row; times beside
    SDPA's in the same dtype (bf16 by default: mha_tc_kernel; f32:
    mha_f32_kernel)."""
    import torch
    import torch.nn.functional as F

    from tpu_rag_torch.ops import attention as att

    dtype = dtype or torch.bfloat16
    dev = torch.device("cuda")
    q, k_, v = (torch.randn((b, t, h, hd), generator=g, device=dev).to(dtype)
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
    f32 = dtype == torch.float32
    tol = min(ATT_TOL, ATT_TOL_F32) if f32 else ATT_TOL
    if not (err <= tol and pad_err <= tol):
        raise AssertionError(f"attention T={t} D={hd} {dtype} disagrees with its plain "
                             f"version: {err}, all-pad row {pad_err} (tolerance {tol})")
    bool_mask = (mask > 0)[:, None, None, :]
    qh, kh, vh = (z.permute(0, 2, 1, 3) for z in (q, k_, v))
    nbytes = 4 * b * t * h * hd * q.element_size() + b * t * 4
    b_ms, b_by = bound(nbytes, 4.0 * b * h * t * t * hd, "f32" if f32 else "bf16")
    return {"name": f"fused_mha[{'f32' if f32 else 'bf16'},B={b},T={t},H={h},D={hd}]",
            "route": "cuda", "source": "tpu_rag_torch/csrc/attention.cu",
            "replaces": "tpu_rag/ops/attention.py:41",
            "counter": "mha_f32" if f32 else "mha_bf16", "tolerance": tol,
            "max_abs_err": err, "all_pad_row_err": pad_err,
            "ms": cuda_ms(lambda: att._fused_mha_cuda(q, k_, v, mask)),
            **_device_ms(lambda: att._fused_mha_cuda(q, k_, v, mask),
                         "mha_f32_kernel" if f32 else "mha_tc_kernel", b_ms),
            "plain_ms": cuda_ms(lambda: att.fused_mha_plain(q, k_, v, mask)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=bool_mask)),
            "bound_ms": b_ms, "bound_by": b_by}


def _bucketed_row(g, x, scale, ns, canon, nq: int, k: int, sms: int,
                  floor: float) -> dict:
    """#3 against its plain version on the rows x (int8 with `scale`, bf16
    or f32): the top k the wrapper keeps by _id_check (1e-4), and each
    bucket's winner the plain one's, exactly for int8 (integer sums) and,
    for bf16 and f32 (sums in another order), but where the two rows'
    scores, summed again in f64, lie within 1e-4 of each other; times
    beside the matmul + bucket max composite and the read floor of x, and
    the kernel's own device time (torch.profiler)."""
    import torch

    from tpu_rag_torch.native.binding import layout
    from tpu_rag_torch.ops import topk as tk
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    n, d = x.shape
    qf = torch.randn((nq, d), generator=g, device=x.device)
    int8, f32 = x.dtype == torch.int8, x.dtype == torch.float32
    q, qs = quantize_int8_rows(qf) if int8 else (qf.to(x.dtype), None)
    kind, elt = ("int8", 1) if int8 else ("f32", 4) if f32 else ("bf16", 2)
    bargs = (q, x, scale, ns, canon, -1, -1)
    plan = tk._scan_plan(n, d, nq, 0, x.dtype, sms, "bucketed")
    k_sc, k_id = tk._bucketed_scan_cuda(*bargs)
    p_sc, p_id = tk._bucketed_scan_plain(*bargs)
    torch.cuda.synchronize()
    chk = _id_check(*tk.select_topk(k_sc, k_id, k), *tk.select_topk(p_sc, p_id, k), 1e-4)
    fin = torch.isfinite(p_sc)
    if not torch.equal(torch.isfinite(k_sc), fin) or float((k_sc - p_sc)[fin].abs().max()) > 1e-4:
        raise AssertionError(f"bucketed {kind} scan: bucket maxima differ from the plain "
                             f"version by more than 1e-4")
    differ = ((k_id != p_id) & fin).nonzero().tolist()
    if int8 and differ:
        raise AssertionError(f"bucketed int8 scan: {len(differ)} bucket winners differ "
                             f"from the plain version")
    for qi, bi in differ:
        row, prow = int(k_id[qi, bi]), int(p_id[qi, bi])
        s_row = float(q[qi].double() @ x[row].double())
        s_plain = float(q[qi].double() @ x[prow].double())
        if abs(s_row - s_plain) > 1e-4:
            raise AssertionError(f"bucketed {kind} scan: bucket {bi} of query {qi} took row "
                                 f"{row} ({s_row}) over {prow} ({s_plain})")

    nb = -(-n // tk.BUCKET)

    def library():
        s = (torch.matmul(q, x.T) if f32
             else torch.matmul(q.to(torch.bfloat16), x.to(torch.bfloat16).T).float())
        if int8:
            s = s * scale[None, :]
        s = torch.where((ns != tk.PAD_TAG)[None, :], s, -math.inf)
        s = torch.nn.functional.pad(s, (0, nb * tk.BUCKET - n), value=-math.inf)
        return torch.topk(s.view(nq, nb, tk.BUCKET).amax(dim=2), k, dim=1)

    nbytes = n * d * elt + n * 8 + (n * 4 if int8 else 0) + nq * d * elt + nq * nb * 8
    b_ms, b_by = bound(nbytes, 2.0 * n * d * nq, kind)
    ms = cuda_ms(lambda: tk._bucketed_scan_cuda(*bargs))
    box = layout().tr_box_route(tk._DTYPE_CODE[x.dtype])
    kname = "box_scan_kernel" if box else "pipe_scan_kernel"
    row = {"name": f"bucketed_scan[{kind},n={n},d={d},q={nq}]", "route": "cuda",
           "source": "tpu_rag_torch/csrc/topk.cu",
           "replaces": "tpu_rag/ops/topk.py:284",
           "counter": "bucketed_f32" if f32 else "bucketed_bf16_int8",
           "plan": plan._asdict(), "max_abs_err": chk["max_abs_err"],
           "winners_differing_in_ties": len(differ), "ms": ms,
           "kernel": kname, **_device_ms(lambda: tk._bucketed_scan_cuda(*bargs), kname, b_ms),
           "plain_ms": cuda_ms(lambda: tk._bucketed_scan_plain(*bargs), iters=5),
           "library_ms": cuda_ms(library, iters=5),
           "bound_ms": b_ms, "bound_by": b_by,
           "floor_ms": floor, "pct_of_floor": 100.0 * floor / ms}
    if f32:
        row["library"] = "composite: torch.matmul (f32, no TF32) + 128-row max + torch.topk"
    return row


def _f32_id_check(k_sc, k_id, p_sc, p_id, q, x, tol: float) -> dict:
    """An f32 scan's top k against its plain version's: equal -inf slots,
    finite scores within tol (the sums run in another order), and equal
    rows but in ties: where the rows differ, their scores summed again in
    f64 lie within tol of each other."""
    import torch

    fin = torch.isfinite(p_sc)
    if not torch.equal(torch.isfinite(k_sc), fin):
        raise AssertionError("f32 scan: kernel and plain disagree on which slots are -inf")
    err = float((k_sc[fin] - p_sc[fin]).abs().max()) if fin.any() else 0.0
    if err > tol:
        raise AssertionError(f"f32 scan: score error {err}")
    diff = ((k_id != p_id) & fin).nonzero()
    if len(diff):
        qi, j = diff[:, 0], diff[:, 1]
        qd = q.double()[qi]
        s_k = (x[k_id[qi, j].long()].double() * qd).sum(dim=1)
        s_p = (x[p_id[qi, j].long()].double() * qd).sum(dim=1)
        worst = float((s_k - s_p).abs().max())
        if worst > tol:
            raise AssertionError(f"f32 scan: {len(diff)} rows differ, not in ties "
                                 f"(scores {worst} apart)")
    return {"max_abs_err": err, "id_mismatches_in_ties": int(len(diff))}


# the scan depths of tests/test_torch_scan_plan.py
PLAN_KS = (1, 2, 5, 10, 20, 40, 64, 80, 127, 128, 129, 160, 256, 512, 640, 1000, 1024)


def _plan_sweep(sms: int) -> dict:
    """Every scan plan (bf16/int8/f32 x exact/packed/bucketed x q 1-80 x the
    test's depths) and every IVF probe plan (#6 at q 1/3, k 1/40/128, f32
    lists too; #7 at q 8/64/80, on f32 lists at q 4-256) at d 384 and 768,
    each fitting its block's share of an SM, and #5's f32 block and bf16
    block (at T 1-512, at least two an SM), by csrc/layout.h's byte counts
    as this machine's build of native/layout.cc gives them; a scan plan
    that does not fit raises ValueError in _scan_plan and is counted, not
    launched."""
    import torch

    from tpu_rag_torch.native.binding import layout
    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops import topk as tk

    lay = layout()

    def fits(what: str, plan, per_sm: int = 1) -> None:
        if plan.smem > lay.tr_sm_share(per_sm):
            raise AssertionError(f"{what} plan {plan} does not fit {per_sm} a block an SM")

    out = {"scan_plans": 0, "box_scan_plans": 0, "scan_refused": [], "probe_plans": 0}
    for d in (384, 768):
        for dtype in (torch.bfloat16, torch.int8, torch.float32):
            for mode in ("exact", "packed", "bucketed"):
                for nq in (1, 2, 8, 9, 16, 32, 33, 64, 80):
                    for k in (PLAN_KS if mode != "bucketed" else (0,)):
                        try:
                            plan = tk._scan_plan(2_000_000, d, nq, k, dtype, sms, mode)
                        except ValueError:
                            out["scan_refused"].append(f"{str(dtype)[6:]} {mode} d {d} "
                                                       f"q {nq} k {k}")
                            continue
                        fits("scan", plan)
                        out["scan_plans"] += 1
                        out["box_scan_plans"] += lay.tr_box_route(tk._DTYPE_CODE[dtype])
            for nq in (1, 3):
                for k in (1, 40, 128):
                    plan = ip._list_plan(nq, IVF_NPROBE, IVF_CAP, d, dtype, k, sms)
                    fits("list", plan, plan.per_sm)
                    out["probe_plans"] += 1
            for nq in ((8, 64, 80) if dtype != torch.float32 else ()):
                fits("bucket", ip._bucket_plan(IVF_NLIST, IVF_CAP // 128, nq, d, dtype, sms))
                out["probe_plans"] += 1
        for nq in (4, 8, 16, 17, 33, 64, 80, 128, 256):     # #7 on f32 lists
            fits("f32 bucket",
                 ip._bucket_plan(IVF_NLIST, IVF_CAP // 128, nq, d, torch.float32, sms))
            out["probe_plans"] += 1
    out["attention_f32_smem"], out["attention_bf16_smem"] = {}, {}
    for hd in (32, 64):                                     # #5 in f32
        got = lay.tr_mha_smem(tk._DTYPE_CODE[torch.float32], hd, 512)
        if got > lay.tr_sm_share(1):
            raise AssertionError(f"mha_f32_kernel<{hd}>: {got} bytes do not fit a block")
        out["attention_f32_smem"][hd] = got
        for t in (1, 64, 65, 128, 160, 256, 320, 384, 512):  # #5 in bf16
            got = lay.tr_mha_smem(tk._DTYPE_CODE[torch.bfloat16], hd, t)
            if got > lay.tr_sm_share(2):
                raise AssertionError(f"mha_tc_kernel<{hd}> at T {t}: {got} bytes leave "
                                     f"room for fewer than two blocks an SM")
            out["attention_bf16_smem"][f"D {hd}, T {t}"] = got
    return out


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


def _probed(lists, ns) -> tuple[int, int]:
    """(distinct lists, live slots over them) of the probed `lists`.  The
    bounds of #6 and #7 count the tags of every slot of each list once, and
    a row and its scale only where the slot is live (ns != PAD_TAG): the
    function never needs a PAD slot's row, though the kernels read it."""
    import torch

    from tpu_rag_torch.ops.topk import PAD_TAG

    uniq = torch.unique(lists.reshape(-1))
    return len(uniq), int((ns[uniq.long()] != PAD_TAG).sum())


def _probe_kernel_rows(g, d: int = 384, dtypes=None) -> list[dict]:
    """#6 and #7 against their plain versions at the ivf phase's shapes (at
    width d), on random lists; each list is ~half filled, the rest PAD, as
    there.  #6 at one and three queries on int8 lists and at one on bf16
    lists (IVFIndex's default; `dtypes` (torch.int8,) leaves it out); #7 at
    8 and 64 queries on int8 lists.  #6's `device_ms` is its
    kernel's own time (torch.profiler; ten calls back to back would time
    the host's wrapper, which takes longer); `pct_of_bound` is the bound
    over `device_ms`.  No row filters, so the bounds count no canon tag."""
    import torch

    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.quant import quantize_int8_rows
    from tpu_rag_torch.ops.topk import PAD_TAG

    dev = torch.device("cuda")
    nlist, cap, nprobe, k_eff, m = IVF_NLIST, IVF_CAP, IVF_NPROBE, IVF_KSCAN, 2
    dtypes = dtypes or (torch.int8, torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
    for nq, dtype in ((1, torch.int8), (3, torch.int8), (1, torch.bfloat16)):   # ---- #6
        if dtype not in dtypes:
            continue
        qf = torch.randn((nq, d), generator=g, device=dev)
        qf[0] = centroids[3]                                # probes list 3 first
        lists = ip._top_lists(qf, centroids, nprobe)
        if dtype == torch.int8:
            lv, sv, q_in = vec, scale, quantize_int8_rows(qf)[0]
        else:
            lv, sv = vec.to(torch.bfloat16).mul_(1e-3), torch.ones_like(scale)
            q_in = (qf / qf.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        args = (q_in, lists, lv, sv, ns, canon, -1, -1, k_eff)
        k_sc, k_id = ip._probe_list_cuda(*args)
        p_sc, p_id = ip._probe_list_plain(*args)
        torch.cuda.synchronize()
        if dtype == torch.int8:
            if not (torch.equal(k_sc, p_sc) and torch.equal(k_id, p_id)):
                raise AssertionError(f"per-list probe int8 q {nq}: ids or scores differ")
            err = 0.0
        else:
            err = _id_check(k_sc.view(-1, k_eff), k_id.view(-1, k_eff),
                            p_sc.view(-1, k_eff), p_id.view(-1, k_eff), 1e-4)["max_abs_err"]
        flat = lists.reshape(-1)

        def library(flat=flat, q_in=q_in, nq=nq, lv=lv, int8=dtype == torch.int8):
            x = lv[flat].to(torch.bfloat16)                        # (Q*nprobe, cap, d)
            qv = q_in.to(torch.bfloat16).repeat_interleave(nprobe, 0)[:, :, None]
            s = torch.bmm(x, qv)[..., 0].float()
            if int8:
                s = s * scale[flat]
            s = torch.where(ns[flat] != PAD_TAG, s, -math.inf)
            return torch.topk(s, k_eff, dim=1)

        elt = lv.element_size()
        n_lists, live = _probed(lists, ns)
        live_pairs = int((ns[flat] != PAD_TAG).sum())     # live slots of each (query, list)
        nbytes = (n_lists * cap * 4 + live * (d * elt + (4 if dtype == torch.int8 else 0))
                  + nq * d * elt + lists.numel() * 4 + nq * nprobe * k_eff * 8)
        b_ms, b_by = bound(nbytes, 2.0 * live_pairs * d,
                           "int8" if dtype == torch.int8 else "bf16")
        ms = cuda_ms(lambda: ip._probe_list_cuda(*args))
        dev_ms = kernel_ms(lambda: ip._probe_list_cuda(*args), "probe_split_kernel")
        dt = str(dtype)[6:]
        rows.append({"name": f"ivf_probe_per_list[{dt},q={nq},nprobe={nprobe},cap={cap},"
                             f"d={d},k={k_eff}]", "route": "cuda",
                     "source": "tpu_rag_torch/csrc/ivf_probe.cu",
                     "replaces": "tpu_rag/ops/ivf_probe.py:41", "counter": "per_list_bf16_int8",
                     "plan": ip._list_plan(nq, nprobe, cap, d, dtype, k_eff, sms)._asdict(),
                     "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": cuda_ms(lambda: ip._probe_list_plain(*args), iters=5),
                     "library_ms": cuda_ms(library, iters=5),
                     "library": "composite: list gather + torch.bmm + torch.topk",
                     "bound_ms": b_ms, "bound_by": b_by, "pct_of_bound": 100.0 * b_ms / dev_ms})
        del lv
    for nq in (8, 64):                                     # ---- #7
        qf = torch.randn((nq, d), generator=g, device=dev)
        qf[0] = centroids[3]
        lists = ip._top_lists(qf, centroids, nprobe)
        q8, _ = quantize_int8_rows(qf)
        uniq, n_uniq, _ = ip._dedup(lists, nlist)
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

        _, live = _probed(lst, ns)
        nbytes = nu * cap * 4 + live * (d + 4) + nq * d + nu * 4 + nu * nq * m * (cap // 128) * 8
        b_ms, b_by = bound(nbytes, 2.0 * live * d * nq, "int8")
        ms = cuda_ms(lambda: ip._probe_batched_cuda(*args))
        rows.append({"name": f"ivf_probe_batched[int8,q={nq},nprobe={nprobe},cap={cap},"
                             f"d={d},m={m},union={nu}]", "route": "cuda",
                     "source": "tpu_rag_torch/csrc/ivf_probe.cu",
                     "replaces": "tpu_rag/ops/ivf_probe.py:237", "counter": "batched_bf16_int8",
                     "plan": ip._bucket_plan(uniq.shape[0], cap // 128, nq, d, torch.int8,
                                             sms)._asdict(),
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


def _list_checks(g) -> dict:
    """#6 against its plain version over the whole (nq, nprobe, k) output,
    at one and three queries, k 1, 40 and 128, with and without filters, on
    the ivf phase's geometry (a list split over 2 blocks) and on a small one
    (cap 1000, not a multiple of 128, nprobe 16: clusters of 8 blocks).
    Each geometry puts an exact tie across the first boundary of the plan's
    ranges (list 3, probed first by query 0, which is one of the two rows)
    and makes list 5, probed first by query 1, all PAD (f32 plans split
    each list only as far as one wave of blocks allows: at three queries
    the tie lies inside one range).  int8: ids and scores torch.equal;
    bf16 and f32 (the int8 values scaled: exact, so the tie stays one):
    _id_check at 1e-4."""
    import torch

    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.quant import quantize_int8_rows
    from tpu_rag_torch.ops.topk import PAD_TAG

    dev = torch.device("cuda")
    d, tol = 384, 1e-4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out, f32_straddles = {}, 0
    for nlist, cap, nprobe in ((IVF_NLIST, IVF_CAP, IVF_NPROBE), (256, 1000, 16)):
        vec = torch.randint(-127, 128, (nlist, cap, d), generator=g, device=dev,
                            dtype=torch.int8)
        scale = torch.rand((nlist, cap), generator=g, device=dev) * 1e-3 + 1e-3
        fill = torch.randint(cap // 3, (2 * cap) // 3, (nlist, 1), generator=g, device=dev)
        ns = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
        ns = torch.where(torch.arange(cap, device=dev)[None, :] < fill, ns, PAD_TAG)
        canon = torch.randint(0, 2, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
        boundary = ip._list_ranges(cap, ip._list_plan(1, nprobe, cap, d, torch.int8, 40,
                                                      sms).split)[1][0]
        tie = [boundary - 20, boundary + 5]                   # ranks 0 and 1
        vec[3, tie[1]], scale[3, tie[1]] = vec[3, tie[0]], scale[3, tie[0]]
        ns[3, tie], canon[3, tie] = 2, 1                      # live under both filters
        ns[5] = PAD_TAG                                       # every slot PAD
        ns = ns.contiguous()
        centroids = torch.randn((nlist, d), generator=g, device=dev)
        for dtype in (torch.int8, torch.bfloat16, torch.float32):
            if dtype == torch.int8:
                lv, sv = vec, scale
            else:
                lv, sv = vec.to(dtype).mul_(1e-3), torch.ones_like(scale)
            qf = torch.randn((3, d), generator=g, device=dev)
            qf[0] = lv[3, tie[0]].float()                     # the tie leads list 3
            q_in = (quantize_int8_rows(qf)[0] if dtype == torch.int8
                    else (qf / qf.norm(dim=1, keepdim=True)).to(dtype))
            lists = ip._top_lists(qf, centroids, nprobe)
            lists[0, 0], lists[1, 0] = 3, 5
            err, id_diff = 0.0, 0
            for nq in (1, 3):
                for k in (1, 40, 128):
                    plan = ip._list_plan(nq, nprobe, cap, d, dtype, k, sms)
                    ranges = ip._list_ranges(cap, plan.split)
                    straddles = plan.split >= 2 and tie[0] < ranges[1][0] <= tie[1]
                    if not straddles and dtype != torch.float32:
                        raise AssertionError(f"the tie {tie} does not straddle {ranges[:2]}")
                    f32_straddles += straddles and dtype == torch.float32
                    for wants in ((-1, -1), (2, 1)):
                        args = (q_in[:nq], lists[:nq], lv, sv, ns, canon, *wants, k)
                        k_sc, k_id = ip._probe_list_cuda(*args)
                        p_sc, p_id = ip._probe_list_plain(*args)
                        torch.cuda.synchronize()
                        what = f"per-list probe {str(dtype)[6:]} cap {cap} q {nq} k {k} {wants}"
                        if dtype == torch.int8:
                            if not (torch.equal(k_sc, p_sc) and torch.equal(k_id, p_id)):
                                raise AssertionError(f"{what}: ids or scores differ "
                                                     f"({int((k_id != p_id).sum())} ids)")
                        else:
                            chk = _id_check(k_sc.view(-1, k), k_id.view(-1, k),
                                            p_sc.view(-1, k), p_id.view(-1, k), tol)
                            err = max(err, chk["max_abs_err"])
                            id_diff = max(id_diff, chk["id_mismatches_in_ties"])
                        if k_id[0, 0, :2].tolist() != tie[:k]:
                            raise AssertionError(f"{what}: the tie across blocks gave "
                                                 f"{k_id[0, 0, :2].tolist()}")
                        if nq == 3 and not ((k_id[1, 0] == -1).all()
                                            and torch.isneginf(k_sc[1, 0]).all()):
                            raise AssertionError(f"{what}: the all-PAD list is not -inf/-1")
            name = f"ivf_probe_per_list[{str(dtype)[6:]},cap={cap},nprobe={nprobe},q=1/3,k=1/40/128]"
            out[name] = err
            if dtype != torch.int8:
                out[name + "_most_id_mismatches"] = id_diff
            del lv
        del vec, scale, ns, canon
        torch.cuda.empty_cache()
    if f32_straddles < 2:      # f32 plans split to one wave: at q 1 the tie straddles
        raise AssertionError(f"the tie straddled f32 ranges in {f32_straddles} plans")
    return out


def _batched_checks(g) -> dict:
    """#7 on int8 and bf16 lists of the ivf phase's geometry (~half of each
    list PAD) against its plain version over the whole (u_max, nq, m * nb)
    output: q 8, 64 and 80 (two query chunks), m 1-4, with and without
    filters, a tie across the warps of one bucket (slots 20 and 100 of list
    3, the self match of query 1) and n_uniq < u_max.  int8: ids and scores
    torch.equal; bf16: the same -inf slots, scores within 1e-4 (summation
    order) and the tie's ids, with the count of other id differences (near
    ties) reported."""
    import torch

    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.quant import quantize_int8_rows
    from tpu_rag_torch.ops.topk import PAD_TAG

    dev = torch.device("cuda")
    d, nlist, cap, nprobe, tol = 384, IVF_NLIST, IVF_CAP, IVF_NPROBE, 1e-4
    nb = cap // 128
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


def _bucket_id_check(k_sc, k_id, p_sc, p_id, q, vec, uniq, tol: float) -> dict:
    """#7's winners against its plain version's: equal -inf slots, finite
    scores within tol, and equal slots but in ties: where the slots differ,
    their scores, summed again in f64, lie within tol of each other."""
    import torch

    fin = torch.isfinite(p_sc)
    if not torch.equal(torch.isfinite(k_sc), fin):
        raise AssertionError("batched probe: -inf slots differ from the plain version")
    err = float((k_sc[fin] - p_sc[fin]).abs().max()) if fin.any() else 0.0
    if err > tol:
        raise AssertionError(f"batched probe: score error {err}")
    diff = ((k_id != p_id) & fin).nonzero()
    if len(diff):
        u, qi = diff[:, 0], diff[:, 1]
        lst = uniq.long()[u]
        qd = q.double()[qi]
        s_k = (vec[lst, k_id[u, qi, diff[:, 2]].long()].double() * qd).sum(dim=1)
        s_p = (vec[lst, p_id[u, qi, diff[:, 2]].long()].double() * qd).sum(dim=1)
        worst = float((s_k - s_p).abs().max())
        if worst > tol:
            raise AssertionError(f"batched probe: {len(diff)} slots differ, not in ties "
                                 f"(scores {worst} apart)")
    return {"max_abs_err": err, "id_mismatches_in_ties": int(len(diff))}


def _probe_float_rows(g) -> list[dict]:
    """Rows for #6 and #7 on f32 lists (probe_f32_kernel and
    batched_bucket_kernel, the f32 forms of IVFIndex(dtype="float32")) at
    _probe_float_checks's geometry, every list ~90% live and one probed list
    wholly PAD: #6 at one and three queries, #7 at 8 and 80 queries (two
    query chunks), d 384 and 768; each against its plain version (scores
    within 1e-4, equal -inf slots, ids but in ties) and timed beside it and
    the gather + bmm + topk composite."""
    import torch

    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.topk import PAD_TAG

    dev = torch.device("cuda")
    nlist, cap, nprobe, k_eff, m, tol = 256, 1024, 16, 40, 2, 1e-4
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for d, cases in ((384, (1, 3, 8, 80)), (768, (1, 3, 8, 80))):
        vec = torch.randn((nlist, cap, d), generator=g, device=dev)
        vec = vec / vec.norm(dim=2, keepdim=True)
        scale = torch.ones((nlist, cap), device=dev)
        ns = torch.randint(0, 4, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
        ns[:, -100:] = PAD_TAG
        canon = torch.randint(0, 2, (nlist, cap), generator=g, device=dev, dtype=torch.int32)
        centroids = torch.randn((nlist, d), generator=g, device=dev)
        for nq in cases:
            q = torch.randn((nq, d), generator=g, device=dev)
            q = q / q.norm(dim=1, keepdim=True)
            lists = ip._top_lists(q, centroids, nprobe)
            flat = lists.reshape(-1)
            ns_q = ns.clone()
            ns_q[int(lists[0, 0])] = PAD_TAG                  # a probed list wholly PAD
            if nq <= 3:                                               # ---- #6
                args = (q, lists, vec, scale, ns_q, canon, -1, -1, k_eff)
                kern, plain, what = ip._probe_list_cuda, ip._probe_list_plain, "per_list_f32"
                chk = _id_check(*(t.view(-1, k_eff) for t in kern(*args)),
                                *(t.view(-1, k_eff) for t in plain(*args)), tol)

                def library(flat=flat, q=q, ns=ns_q):
                    s = torch.bmm(vec[flat], q.repeat_interleave(nprobe, 0)[:, :, None])[..., 0]
                    s = torch.where(ns[flat] != PAD_TAG, s, -math.inf)
                    return torch.topk(s, k_eff, dim=1)

                n_lists, live = _probed(lists, ns_q)
                pairs = int((ns_q[flat] != PAD_TAG).sum())
                nbytes = (n_lists * cap * 4 + live * d * 4 + nq * d * 4 + lists.numel() * 4
                          + nq * nprobe * k_eff * 8)
                b_ms, b_by = bound(nbytes, 2.0 * pairs * d, "f32")
                name = f"ivf_probe_per_list[f32,q={nq},nprobe={nprobe},cap={cap},d={d},k={k_eff}]"
                replaces, kname = "tpu_rag/ops/ivf_probe.py:41", F32_PROBE_KERNEL
                plan = ip._list_plan(nq, nprobe, cap, d, torch.float32, k_eff, sms)._asdict()
            else:                                                     # ---- #7
                uniq, n_uniq, _ = ip._dedup(lists, nlist)
                args = (q, uniq, n_uniq, vec, scale, ns_q, canon, -1, -1, m)
                kern, plain, what = ip._probe_batched_cuda, ip._probe_batched_plain, "batched_f32"
                chk = _bucket_id_check(*kern(*args), *plain(*args), q, vec, uniq, tol)
                nu = int(n_uniq)
                lst = uniq[:nu].long()

                def library(lst=lst, q=q, nq=nq, ns=ns_q, d=d):
                    s = torch.bmm(vec[lst], q.T.expand(len(lst), d, nq))
                    s = torch.where((ns[lst] != PAD_TAG)[..., None], s, -math.inf)
                    s = s.transpose(1, 2).reshape(len(lst), nq, cap // 128, 128)
                    return torch.topk(s, m, dim=3)

                _, live = _probed(lst, ns_q)
                nbytes = (nu * cap * 4 + live * d * 4 + nq * d * 4 + nu * 4
                          + nu * nq * m * (cap // 128) * 8)
                b_ms, b_by = bound(nbytes, 2.0 * live * d * nq, "f32")
                name = (f"ivf_probe_batched[f32,q={nq},nprobe={nprobe},cap={cap},d={d},m={m},"
                        f"union={nu}]")
                replaces, kname = "tpu_rag/ops/ivf_probe.py:237", "batched_bucket_kernel"
                plan = ip._bucket_plan(uniq.shape[0], cap // 128, nq, d, torch.float32,
                                       sms)._asdict()
            torch.cuda.synchronize()
            dev_ms = kernel_ms(lambda: kern(*args), kname)
            rows.append({"name": name, "route": "cuda",
                         "source": "tpu_rag_torch/csrc/ivf_probe.cu", "replaces": replaces,
                         "counter": what, **chk, "plan": plan,
                         "ms": cuda_ms(lambda: kern(*args)), "device_ms": dev_ms,
                         "plain_ms": cuda_ms(lambda: plain(*args), iters=5),
                         "library_ms": cuda_ms(library, iters=5),
                         "library": "composite: list gather + torch.bmm + torch.topk",
                         "bound_ms": b_ms, "bound_by": b_by,
                         "pct_of_bound": 100.0 * b_ms / dev_ms})
        del vec, scale, ns, canon
        torch.cuda.empty_cache()
    return rows


def _threads(idents=None) -> list[dict]:
    """The live Python threads (those whose ident is not in `idents`): name,
    daemon flag, the function it was started on and the one it runs now."""
    frames = sys._current_frames()
    out = []
    for t in threading.enumerate():
        if idents is not None and t.ident in idents:
            continue
        f, target = frames.get(t.ident), getattr(t, "_target", None)
        out.append({"name": t.name, "daemon": t.daemon,
                    "target": getattr(target, "__qualname__", None),
                    "running": f"{Path(f.f_code.co_filename).name}:{f.f_code.co_name}"
                               if f is not None else None})
    return out


def _counters():
    """name -> (wrapper, attribute): each wrapper's count of its launches,
    and of those of its f32 kernel (#1 #2 #3 on f32 rows, #5
    mha_f32_kernel, #6 and #7 on f32 lists)."""
    from tpu_rag_torch.ops import attention as att
    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops import topk as tk

    return {"exact": (tk._exact_scan_cuda, "launches"),
            "exact_f32": (tk._exact_scan_cuda, "f32_launches"),
            "packed": (tk._packed_scan_cuda, "launches"),
            "packed_f32": (tk._packed_scan_cuda, "f32_launches"),
            "bucketed": (tk._bucketed_scan_cuda, "launches"),
            "bucketed_f32": (tk._bucketed_scan_cuda, "f32_launches"),
            "floor": (tk._read_sum_cuda, "launches"),
            "mha": (att._fused_mha_cuda, "launches"),
            "mha_f32": (att._fused_mha_cuda, "f32_launches"),
            "per_list": (ip._probe_list_cuda, "launches"),
            "per_list_f32": (ip._probe_list_cuda, "f32_launches"),
            "batched": (ip._probe_batched_cuda, "launches"),
            "batched_f32": (ip._probe_batched_cuda, "f32_launches")}


def _reset_counters() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _read_counters() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


# the kernels line's counter of each kernel: a wrapper's launches less
# those of its f32 kernel are its bf16/int8 kernel's
_SPLIT_COUNTERS = {"exact_bf16_int8": ("exact", "exact_f32"),
                   "packed_bf16_int8": ("packed", "packed_f32"),
                   "bucketed_bf16_int8": ("bucketed", "bucketed_f32"),
                   "mha_bf16": ("mha", "mha_f32"),
                   "per_list_bf16_int8": ("per_list", "per_list_f32"),
                   "batched_bf16_int8": ("batched", "batched_f32")}


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
    from kernel_ab import _profile

    prof = _profile(lambda: engine._fused_vector_hits_batch(texts, 5, None, None,
                                                            cache_qv=False))
    wall_ms, device_ms, by_kernel = prof["wall_ms"], prof["device_ms"], prof["by_kernel_ms"]
    scan_ms = sum(v for key, v in by_kernel.items() if "scan_kernel" in key)
    top = {key[:80]: v for key, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]}
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
    return {"queries": len(texts), "wall_ms": wall_ms, "device_ms": device_ms,
            "scan_ms": scan_ms, "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "top_device_ms": top, "host_split_ms": split}


@contextlib.contextmanager
def _served(cfg, engine=None):
    """The app for cfg (it loads the saved store, unless `engine` is given)
    behind the real HTTP server on a free port; counters are zeroed just
    before it starts.  Yields (app, engine, /health reply)."""
    from tpu_rag_torch.api.app import create_app
    from tpu_rag_torch.api.server import HTTPServer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        cfg.port = s.getsockname()[1]
    app = create_app(cfg, engine=engine)
    engine = app.state["engine"]
    server = HTTPServer(app, cfg.host, cfg.port, executor_workers=cfg.http_executor_workers)
    thread = threading.Thread(target=server.run, daemon=True, name=f"http-server-{cfg.port}")
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
        thread.join(timeout=60)
        engine.shutdown()
        if thread.is_alive():
            raise AssertionError(f"the HTTP server thread on port {cfg.port} outlived "
                                 f"its phase")


def _count_persists(engine) -> list[float]:
    """The times at which the indexer's store saves end, appended as each
    does: every /docs/save sets one off, and an earlier save may write the
    final count while a later one is still rewriting the files."""
    done = []
    persist = engine.indexer.persist_fn

    def counted():
        persist()
        done.append(time.perf_counter())
    engine.indexer.persist_fn = counted
    return done


def _vector_ids(engine, texts: list[str], k: int) -> list[list[str]]:
    """Top-k ids of the fused embed + scan path, in process."""
    hits = engine._fused_vector_hits_batch(texts, k, None, None, cache_qv=False)
    return [[h["id"] for h in hs] for hs in hits]


def _hf_bert_shapes(spec, prefix: str = "") -> dict[str, tuple]:
    """The state-dict names and shapes of a HF BertModel of `spec` (with its
    pooler); prefix "bert." gives them inside BertForSequenceClassification."""
    h, f = spec.hidden, spec.ffn
    out = {"embeddings.word_embeddings.weight": (spec.vocab_size, h),
           "embeddings.position_embeddings.weight": (spec.max_len, h),
           "embeddings.token_type_embeddings.weight": (spec.type_vocab, h),
           "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,)}
    for i in range(spec.layers):
        p = f"encoder.layer.{i}."
        for name, (o, n) in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                             ("attention.self.value", (h, h)),
                             ("attention.output.dense", (h, h)),
                             ("intermediate.dense", (f, h)), ("output.dense", (h, f))):
            out[p + name + ".weight"], out[p + name + ".bias"] = (o, n), (o,)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            out[p + name + ".weight"], out[p + name + ".bias"] = (h,), (h,)
    out["pooler.dense.weight"], out["pooler.dense.bias"] = (h, h), (h,)
    return {prefix + k: v for k, v in out.items()}


def _seeded_checkpoint(shapes: dict[str, tuple], seed: int) -> dict:
    """f32 CPU tensors for `shapes` from a seeded generator: LayerNorm scales
    near 1, small biases, embeddings and Linear weights with std
    1/sqrt(width)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        z = torch.randn(shape, generator=g)
        if "LayerNorm" in name:
            out[name] = 1.0 + 0.05 * z if name.endswith("weight") else 0.05 * z
        elif name.endswith("bias"):
            out[name] = 0.02 * z
        else:
            out[name] = z / math.sqrt(shape[-1])
    return out


def _write_checkpoints(work: Path, spec) -> tuple[Path, dict, Path, dict]:
    """A seeded HF-layout bi-encoder (BertModel) as model.safetensors and a
    seeded cross-encoder (BertForSequenceClassification, one label: the
    ms-marco-MiniLM-L-6-v2 geometry) as pytorch_model.bin."""
    import torch

    from tpu_rag_torch.models.hf_export import write_safetensors

    bi_dir, ce_dir = work / "bi-encoder", work / "cross-encoder"
    bi_dir.mkdir()
    ce_dir.mkdir()
    bi = _seeded_checkpoint(_hf_bert_shapes(spec), SEED + 1)
    write_safetensors(bi_dir / "model.safetensors", bi)
    ce_shapes = _hf_bert_shapes(spec, "bert.")
    ce_shapes.update({"classifier.weight": (1, spec.hidden), "classifier.bias": (1,)})
    ce = _seeded_checkpoint(ce_shapes, SEED + 2)
    torch.save(ce, ce_dir / "pytorch_model.bin")
    return bi_dir, bi, ce_dir, ce


def _check_loaded(module, written: dict, names: dict[str, str]) -> None:
    """The module's tensors named in `names` (ours -> checkpoint's) hold the
    checkpoint's values exactly."""
    import torch

    sd = module.state_dict()
    for ours, theirs in names.items():
        if not torch.equal(sd[ours].cpu(), written[theirs]):
            raise AssertionError(f"{ours} does not hold the checkpoint's {theirs}")


def _sse_events(port: int, body: dict) -> tuple[list[dict], bool]:
    """POST /compose_stream; its data events, runs of one type joined, and
    whether the stream ended with `event: done`."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/compose_stream",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        frames = r.read().decode()
    events = []
    for block in frames.split("\n\n"):
        if block.startswith("data: "):
            evt = json.loads(block[6:])
            if events and evt.get("type") and events[-1].get("type") == evt["type"]:
                events[-1]["data"] += evt["data"]
            else:
                events.append(evt)
    return events, frames.rstrip().endswith("event: done")


def _serve_rerank_compose(cfg, engine, ce_written: dict, queries: list[str],
                          saved: list[str]) -> tuple[dict, dict[str, int]]:
    """/search with rerank (the cross-encoder, #5 at B 32, T 256), the
    card's logits against the same checkpoint at f32 on the CPU, one forward
    profiled, then /compose, /compose_stream and /threads on the extractive
    backend.  Counters are zeroed just before and read just after."""
    import copy

    import numpy as np
    import torch

    from kernel_ab import _profile
    from tpu_rag_torch.models.biencoder import spec_for_model
    from tpu_rag_torch.models.crossencoder import CrossEncoder
    from tpu_rag_torch.models.tokenizer import encode_pair_batch

    r = _http(cfg.port, "POST", "/search", {"query": "warm the reranker", "k": 5,
                                            "rerank": True})       # builds the CE
    if r.get("reranked") is not True:
        raise AssertionError(f"rerank warm-up: {r.get('rerank_error')}")
    ce = engine.get_cross_encoder()
    if ce.spec != spec_for_model(cfg.rerank_model) or ce.seq_len != min(256, ce.spec.max_len):
        raise AssertionError(f"cross-encoder geometry {ce.seq_len} {ce.spec}")
    last = ce.spec.layers - 1
    _check_loaded(ce.module, ce_written, {
        "classifier.weight": "classifier.weight", "pooler.weight": "bert.pooler.dense.weight",
        "bert.word_embeddings.weight": "bert.embeddings.word_embeddings.weight",
        "bert.layers.0.intermediate.weight": "bert.encoder.layer.0.intermediate.dense.weight",
        f"bert.layers.{last}.output_ln.bias": f"bert.encoder.layer.{last}.output.LayerNorm.bias"})
    forwards = []
    forward_ids = ce.forward_ids

    def counted(*a):
        forwards.append(a[0].shape)
        return forward_ids(*a)

    ce.forward_ids = counted
    _reset_counters()
    rerank_ms, lat = [], []
    for qtext in queries:                                   # a dozen requests
        t1 = time.perf_counter()
        r = _http(cfg.port, "POST", "/search", {"query": qtext, "k": 5, "rerank": True})
        lat.append((time.perf_counter() - t1) * 1e3)
        if r.get("reranked") is not True or "rerank_error" in r:
            raise AssertionError(f"rerank: {r.get('rerank_error')}")
        scores = [h.get("rerank_score") for h in r["hits"]]
        if not (len(scores) == 5 and all(isinstance(v, float) and math.isfinite(v)
                                         for v in scores)
                and scores == sorted(scores, reverse=True)):
            raise AssertionError(f"rerank scores not finite and descending: {scores}")
        rerank_ms.append(r["timings_ms"]["rerank"])
    counts = _read_counters()
    ce.forward_ids = forward_ids
    if not forwards or counts["mha"] < ce.spec.layers * len(forwards):
        raise AssertionError(f"{len(forwards)} cross-encoder forwards launched #5 "
                             f"{counts['mha']} times (at least {ce.spec.layers} each)")

    # the card (bf16) against the same checkpoint at f32 on the CPU: 20
    # candidates (RERANK_CANDIDATES) of distinct texts, the saved documents
    # among them
    query = queries[4]
    texts = [_doc_text(i) for i in range(4)] + [_doc_text(i)[: 40 * (i % 7 + 1)]
                                                 for i in range(10, 26)]
    cands = [{"id": f"c{i}", "text": t, "score": 0.01 * i} for i, t in enumerate(texts)]
    card = engine.rerank(query, copy.deepcopy(cands))
    cpu_ce = CrossEncoder(cfg.rerank_model, weights_path=cfg.rerank_weights, device="cpu")
    cpu = cpu_ce.predict([(query, t) for t in texts])
    card_of = {h["id"]: h["rerank_score"] for h in card}
    diff = max(abs(card_of[c["id"]] - float(v)) for c, v in zip(cands, cpu))
    cpu_order = [cands[i]["id"] for i in np.argsort(-cpu, kind="stable")]
    moved = sum(a != h["id"] for a, h in zip(cpu_order, card))
    tol = RERANK_LOGIT_TOL * max(1.0, float(np.abs(cpu).max()))
    if not diff <= tol:
        raise AssertionError(f"card logits {diff} from the CPU f32 forward (tolerance {tol})")

    # one forward at the shape /search gives it (20 pairs -> batch 32, T 256)
    ids, mask, types = encode_pair_batch(ce.tokenizer, [(query, t) for t in texts],
                                         ce.seq_len, batch=ce.batch)
    prof = _profile(lambda: ce.forward_ids(ids, mask, types))
    mha_ms = sum(v for key, v in prof["by_kernel_ms"].items() if "mha_tc_kernel" in key)
    top = {key[:80]: v for key, v in sorted(prof["by_kernel_ms"].items(),
                                            key=lambda kv: -kv[1])[:8]}

    # compose on the extractive backend, against the saved documents
    compose_ms, thread = [], "smoke-thread"
    for qtext in queries[:4] + queries[4:8]:
        t1 = time.perf_counter()
        r = _http(cfg.port, "POST", "/compose", {"query": qtext, "k": 5, "language": "en",
                                                 "namespace": "smoke", "thread_id": thread})
        compose_ms.append((time.perf_counter() - t1) * 1e3)
        cited = [c["id"] for c in r["citations"]]
        if not (r.get("draft") and r.get("engine") == "extractive" and cited
                and set(cited) <= set(saved) and f"[{cited[0]}]" in r["draft"]):
            raise AssertionError(f"/compose: {r}")
    events, done = _sse_events(cfg.port, {"query": queries[1], "k": 5, "language": "en",
                                          "namespace": "smoke", "thread_id": "smoke-sse"})
    text = "".join(e["data"] for e in events if e.get("type") == "text")
    tail = [e for e in events if "citations" in e]
    if not (done and text and tail and tail[0]["citations"]
            and {c["id"] for c in tail[0]["citations"]} <= set(saved)
            and any(f"[{i}]" in text for i in saved)):
        raise AssertionError(f"/compose_stream: done={done} events={events[:4]}")
    threads = {t["thread_id"]: t["count"]
               for t in _http(cfg.port, "GET", "/threads")["threads"]}
    if threads.get(thread) != 16 or threads.get("smoke-sse") != 2:
        raise AssertionError(f"/threads: {threads}")
    out = {"cross_encoder": {"seq_len": ce.seq_len, "hidden": ce.spec.hidden,
                             "layers": ce.spec.layers, "heads": ce.spec.heads,
                             "batch": ce.batch},
           "requests": len(lat), "search_ms_p50": statistics.median(lat),
           "rerank_stage_ms": rerank_ms, "rerank_stage_ms_p50": statistics.median(rerank_ms),
           "ce_forwards": len(forwards), "ce_batch_shapes": sorted({tuple(s) for s in forwards}),
           "launches": counts,
           "logits_vs_cpu_f32": {"candidates": len(cands), "max_abs_diff": diff,
                                 "tolerance": tol, "order_positions_moved": moved},
           "ce_forward_b32_t256": {"wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                                   "mha_ms": mha_ms,
                                   "mha_share": mha_ms / prof["device_ms"],
                                   "device_idle_share": max(0.0, 1.0 - prof["device_ms"]
                                                            / prof["wall_ms"]),
                                   "top_device_ms": top},
           "compose_ms": compose_ms, "compose_ms_p50": statistics.median(compose_ms),
           "compose_stream_text_chars": len(text), "threads": threads}
    del cpu_ce
    torch.cuda.empty_cache()
    return out, counts


def phase_serve(work: Path) -> dict:
    import torch

    from tpu_rag_torch.config import Config
    from tpu_rag_torch.index.flat import FlatIndex
    from tpu_rag_torch.index.store import save_index
    from tpu_rag_torch.models.biencoder import spec_for_model
    from tpu_rag_torch.utils.metrics import GLOBAL_METRICS

    n, d = 1_000_000, 384
    t0 = time.perf_counter()
    bi_dir, bi_written, ce_dir, ce_written = _write_checkpoints(work, spec_for_model("minilm-l6"))
    weights_s = time.perf_counter() - t0
    store = FlatIndex(d, dtype="auto", device="cuda")
    store._bulk_adopt_rows(_unit_rows(n, d, SEED), (f"syn-{i}" for i in range(n)),
                           (("", {}) for _ in range(n)), count=n)
    cfg = Config(persist_dir=str(work / "vs"), kb_db_path=str(work / "db" / "kb.sqlite3"),
                 db_path=str(work / "db" / "app.sqlite3"), docs_dir=str(work / "docs"),
                 embedding_model="sentence-transformers/all-MiniLM-L6-v2",
                 embedding_weights=str(bi_dir), rerank_weights=str(ce_dir),
                 rerank_candidates=20, model_priority=("extractive",),
                 summarize_mode="off", host="127.0.0.1", device="cuda")
    store_dir = Path(cfg.persist_dir) / cfg.collection_name
    save_index(store, store_dir)
    del store
    build_s = time.perf_counter() - t0

    with _served(cfg) as (app, engine, health):      # loads the saved store
        assert engine.index.count() == n
        persists = _count_persists(engine)
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
        _check_loaded(engine.encoder.module, bi_written, {
            "word_embeddings.weight": "embeddings.word_embeddings.weight",
            "layers.0.attention.query.bias": "encoder.layer.0.attention.self.query.bias",
            "layers.5.output.weight": "encoder.layer.5.output.dense.weight",
            "layers.5.output_ln.weight": "encoder.layer.5.output.LayerNorm.weight"})

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
        # every save persists first: the searches above may have run beside
        # them (a save holds the index lock only to pin its rows, but its
        # Python loop shares the interpreter), the warm ones below do not,
        # and the packed serve below loads no store a save is rewriting
        while len(persists) < len(texts):
            if time.perf_counter() - t_save > 600:
                raise TimeoutError("the store was not rewritten")
            time.sleep(0.2)
        if _manifest_count(store_dir) != n + len(texts):
            raise AssertionError(f"the saves left {_manifest_count(store_dir)} rows")
        persisted_s = persists[-1] - t_save
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
        rerank, rerank_counts = _serve_rerank_compose(cfg, engine, ce_written, queries, saved)
    if counts["exact"] < 1 or counts["mha"] < 1:
        raise AssertionError(f"the main path did not launch the kernels: {counts}")
    del app, engine
    torch.cuda.empty_cache()
    packed = _serve_packed(cfg, queries[4:], exact_top10, n + len(texts))
    out = {"phase": "serve", "rows": n, "checkpoints_write_s": weights_s,
           "store_build_s": build_s - weights_s,
           "docs_saved": len(saved), "docs_index_s": save_s, "docs_persisted_s": persisted_s,
           "searches": len(lat), "search_ms_p50": statistics.median(lat) * 1e3,
           "search_ms_max": max(lat) * 1e3, "windows": windows,
           "warm_search_ms": warm, "warm_search_ms_p50": statistics.median(warm),
           "warm_stage_ms_p50": {k: statistics.median(v) for k, v in stages.items()},
           "profile_8q_window": profile, "snapshot": snapshot,
           "health_device": health["device"], "launches": counts, "packed": packed,
           "rerank_compose": rerank}
    emit(out)
    return {name: counts[name] + packed["launches"][name] + rerank_counts[name]
            for name in counts}


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


@contextlib.contextmanager
def _plain_scans():
    """Route the flat scans (#1 #2 #3) through their plain versions (on the
    same CUDA tensors) for a comparison run; the kernels' counters do not
    move."""
    from tpu_rag_torch.ops import topk as tk

    saved = tk.exact_scan, tk.packed_scan, tk.bucketed_scan
    tk.exact_scan, tk.packed_scan, tk.bucketed_scan = (
        tk._exact_scan_plain, tk._packed_scan_plain, tk._bucketed_scan_plain)
    try:
        yield
    finally:
        tk.exact_scan, tk.packed_scan, tk.bucketed_scan = saved


def _manifest_count(store_dir: Path) -> int:
    """The row count of a store's manifest (written whole, last, by a save;
    read again if a read caught it half written)."""
    from tpu_rag_torch.index.store import MANIFEST

    for _ in range(50):
        try:
            return json.loads((store_dir / MANIFEST).read_text())["count"]
        except json.JSONDecodeError:
            time.sleep(0.01)
    raise AssertionError(f"unreadable manifest in {store_dir}")


def phase_ivf(work: Path) -> dict:
    import numpy as np
    import torch

    from tpu_rag_torch.config import Config
    from tpu_rag_torch.index.ivf import IVFIndex
    from tpu_rag_torch.index.store import save_index
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

        # a save rewrites the whole store (persist_index, ~50 s at 4M
        # rows); one /search once the doc is searchable, while the save may
        # still be writing the store (the manifest, written last, still
        # counts the old rows): it must not wait for the save.  One save
        # (two until the train phase came: the script's time limit)
        texts = [_doc_text(i) for i in range(1)]
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
            old_before = _manifest_count(store_dir) < n + i + 1
            t2 = time.perf_counter()
            r = _http(cfg.port, "POST", "/search", {"query": text, "k": 5})
            during_ms = (time.perf_counter() - t2) * 1e3
            old_after = _manifest_count(store_dir) < n + i + 1
            if r["hits"][0]["id"] != saved[i]:
                raise AssertionError(f"saved doc {i} is not its own top hit during the save")
            while _manifest_count(store_dir) < n + i + 1:
                if time.perf_counter() - t1 > 600:
                    raise TimeoutError("the store was not rewritten")
                time.sleep(0.2)
            save_times.append({"searchable_s": searchable,
                               "search_during_save_ms": during_ms,
                               "manifest_old_before_search": old_before,
                               "manifest_old_after_search": old_after,
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
    del app, engine, index
    torch.cuda.empty_cache()
    f32_lists = _ivf_f32_routes()
    flat_f32 = _flat_f32_route()
    counts = {name: counts[name] + f32_lists["launches"][name] + flat_f32["launches"][name]
              for name in counts}
    out = {"phase": "ivf", "rows": n, "corpus_gen_s": gen_s, "build_s_kmeans_lists": build_s,
           "store_save_s": save_s, "geometry": geometry,
           "first_search_s_from_store": first_search_s, "doc_saves": save_times,
           "http_search_seq": seq, "http_search_burst8": bursts, "windows": windows,
           "routes_kernel": kernel, "routes_plain": plain,
           "snapshot": snapshot, "launches_http": http_counts, "launches": counts,
           "f32_lists": f32_lists, "flat_f32": flat_f32}
    emit(out)
    return counts


# IVFIndex(dtype="float32") (INDEX_KIND=ivf with INDEX_DTYPE=float32): the
# f32 lists' probes (#6 probe_list_kernel for 1-3 queries, #7
# batched_bucket_kernel for 4 and more) through IVFIndex.search, over
# 262,144 rows of the ivf phase's generator in 256 lists (cap factor 2.0),
# nprobe 16
IVF_F32_ROWS, IVF_F32_NLIST, IVF_F32_NPROBE = 262_144, 256, 16


def _ivf_f32_routes() -> dict:
    """Single queries (#6) and a batch of 64 (#7) on f32 lists through
    IVFIndex.search, recall@10 against f32 exact, the kernels' routes
    against their plain versions' (recall within 0.01)."""
    import numpy as np
    import torch

    from tpu_rag_torch.index.ivf import IVFIndex

    n, d, nq, k = IVF_F32_ROWS, 384, 64, 10
    x, q, _ = _ivf_corpus(n, d, nq, SEED + 5)
    truth = torch.topk(torch.from_numpy(q).cuda() @ torch.from_numpy(x).cuda().T, k,
                       dim=1).indices.cpu().numpy()
    index = IVFIndex(d, dtype="float32", nlist=IVF_F32_NLIST, nprobe=IVF_F32_NPROBE,
                     list_cap_factor=2.0, device="cuda")
    index._bulk_adopt_rows(x, (f"f32-{i}" for i in range(n)), (("", {}) for _ in range(n)),
                           count=n)
    snap = index.device_snapshot()
    geometry = {"dtype": str(snap["vec_lists"].dtype), "nlist": snap["nlist"],
                "cap": int(snap["vec_lists"].shape[1]), "overflow_rows": len(snap["ov_rows"])}
    if snap["vec_lists"].dtype != torch.float32 or geometry["cap"] % 128:
        raise AssertionError(f"unexpected f32 IVF geometry {geometry}")

    def recall(id_lists):
        return float(np.mean([len({int(i[4:]) for i in ids} & set(t.tolist())) / k
                              for ids, t in zip(id_lists, truth)]))

    def routes() -> dict:
        one = []
        for i in range(8):
            one.append(index.search(q[i:i + 1], k).ids[0])
            assert index.last_probe_route == "per_list"
        batch = index.search(q, k).ids
        assert index.last_probe_route == "batched"
        return {"q1_recall_at_10": recall(one), "q64_recall_at_10": recall(batch)}

    _reset_counters()
    kernel = routes()
    counts = _read_counters()
    with _plain_probes():
        plain = routes()
    if _read_counters() != counts:
        raise AssertionError("the plain f32 run launched a probe kernel")
    if counts["per_list_f32"] < 1 or counts["batched_f32"] < 1:
        raise AssertionError(f"the f32 IVF routes did not launch #6 and #7: {counts}")
    for r in ("q1_recall_at_10", "q64_recall_at_10"):
        if abs(kernel[r] - plain[r]) > 0.01:
            raise AssertionError(f"f32 lists {r}: kernel {kernel[r]}, plain {plain[r]}")
    del index, snap
    torch.cuda.empty_cache()
    return {"rows": n, "geometry": geometry, "nprobe": IVF_F32_NPROBE,
            "kernel": {r: kernel[r] for r in ("q1_recall_at_10", "q64_recall_at_10")},
            "plain": {r: plain[r] for r in ("q1_recall_at_10", "q64_recall_at_10")},
            "launches": counts}


def _flat_f32_route(device: str = "cuda") -> dict:
    """FlatIndex(dtype="float32") (INDEX_DTYPE=float32, exact below 2M
    rows: #1 on f32 rows is its whole device path) over the f32 IVF route's
    262,144 rows: 8 single queries and a batch of 64 through
    FlatIndex.search.  recall@10 against exact truth must be 1.0 but in
    ties, and the ids the plain scans' route returns, but in ties (a tie:
    two rows whose f64 scores lie within 1e-5).  Then the batch again with
    INDEX_SEARCH_MODE=packed (#2, refined from the f32 master: recall 1.0
    but in ties too) and bucketed (#3, the mode FlatIndex takes from 2M
    rows: recall@10 >= 0.95), each launching its f32 kernel."""
    import numpy as np
    import torch

    from tpu_rag_torch.index.flat import FlatIndex

    n, d, nq, k, tol = IVF_F32_ROWS, 384, 64, 10, 1e-5
    x, q, _ = _ivf_corpus(n, d, nq, SEED + 5)
    xd = torch.from_numpy(x).to(device).double()
    scores = torch.from_numpy(q).to(device).double() @ xd.T      # (nq, n) f64
    del xd
    truth = torch.topk(scores, k, dim=1)
    index = FlatIndex(d, dtype="float32", device=device)
    index._bulk_adopt_rows(x, (f"f32-{i}" for i in range(n)), (("", {}) for _ in range(n)),
                           count=n)
    snap = index.device_snapshot()
    if snap["vectors"].dtype != torch.float32 or index.effective_search_mode(n) != "exact":
        raise AssertionError(f"unexpected f32 flat store: {snap['vectors'].dtype}, "
                             f"{index.effective_search_mode(n)}")

    def route() -> np.ndarray:
        one = [index.search(q[i:i + 1], k).ids[0] for i in range(8)]
        return np.asarray([[int(i[4:]) for i in ids] for ids in one + index.search(q, k).ids])

    qrows = list(range(8)) + list(range(nq))       # the query of each result row

    def tied(qi: int, a: int, b: int) -> bool:
        return abs(float(scores[qi, a]) - float(scores[qi, b])) <= tol

    _reset_counters()
    kernel = route()
    counts = _read_counters()
    with _plain_scans():
        plain = route()
    if _read_counters() != counts:
        raise AssertionError("the plain f32 flat run launched a scan kernel")
    if counts["exact_f32"] < 1 or counts["exact"] != counts["exact_f32"]:
        raise AssertionError(f"the f32 flat route did not run on the f32 scan: {counts}")
    out = {}
    for name, got in (("kernel", kernel), ("plain", plain)):
        hits, unexplained = 0, 0
        for r, qi in enumerate(qrows):
            want = truth.indices[qi].tolist()
            hits += len(set(got[r]) & set(want))
            kth = float(truth.values[qi, k - 1])
            unexplained += sum(1 for i in set(want) - set(got[r].tolist())
                               if float(scores[qi, i]) - kth > tol)
        out[name] = {"recall_at_10": hits / (len(qrows) * k), "misses_not_in_ties": unexplained}
        if unexplained:
            raise AssertionError(f"f32 flat {name} route: {unexplained} misses outside ties")
    differ = [(r, j) for r, j in zip(*np.nonzero(kernel != plain))]
    if any(not tied(qrows[r], kernel[r, j], plain[r, j]) for r, j in differ):
        raise AssertionError("f32 flat route: the kernel's ids differ from the plain route's "
                             "outside ties")
    for mode, floor in (("packed", 1.0), ("bucketed", 0.95)):
        index.search_mode = mode
        before = _read_counters()[f"{mode}_f32"]
        got = [[int(i[4:]) for i in ids] for ids in index.search(q, k).ids]
        if _read_counters()[f"{mode}_f32"] <= before:
            raise AssertionError(f"the f32 flat {mode} search did not launch its f32 scan")
        hits = sum(len(set(g_) & set(truth.indices[qi].tolist())) for qi, g_ in enumerate(got))
        missed = sum(1 for qi, g_ in enumerate(got) for i in set(truth.indices[qi].tolist())
                     - set(g_) if float(scores[qi, i]) - float(truth.values[qi, k - 1]) > tol)
        out[mode] = {"recall_at_10": hits / (nq * k), "misses_not_in_ties": missed}
        if (missed if floor == 1.0 else out[mode]["recall_at_10"] < floor):
            raise AssertionError(f"f32 flat {mode} route: {out[mode]}")
    del index, snap, scores
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"rows": n, "mode": "exact", "queries": "8 x q 1, 1 x q 64; q 64 packed, bucketed",
            **out, "ids_differing_from_plain_in_ties": len(differ),
            "launches": _read_counters()}


# scripts/rehearse_host_ivf.py's geometry (nprobe 64, cap factor 2.0, chunks
# of 250K, a 262,144-row training sample, k 10, batches of 8 queries, its
# low-rank generator), cut from 50M rows / 16,384 lists to 12.5M / 4,096 for
# the run's time limit, which keeps ~3,052 rows a list
HIVF_ROWS, HIVF_NLIST, HIVF_NPROBE, HIVF_CHUNK, HIVF_TRAIN = (
    12_500_000, 4096, 64, 250_000, 262_144)


def phase_host_ivf(work: Path, n: int = HIVF_ROWS, nlist: int = HIVF_NLIST,
                   device: str = "cuda") -> dict:
    """HostArenaIVF at a corpus whose lists live in host RAM, through
    tpu_rag_torch/scripts/rehearse_host_ivf.py's run(): built from chunks
    born on the card, its exact truth (the stored int8 rows streamed to the
    card) and its nprobe sweep; then batches of 8 (the gathered union
    through #1, one batch through #2), saved and loaded with mmap."""
    import numpy as np
    import torch

    from tpu_rag_torch.index.host_ivf import HostArenaIVF
    from tpu_rag_torch.scripts import rehearse_host_ivf

    d, k, qb, nbatch = 384, 10, 8, 4
    args = rehearse_host_ivf.parser().parse_args([
        "--n", str(n), "--d", str(d), "--nlist", str(nlist), "--chunk", str(HIVF_CHUNK),
        "--queries", str(qb * nbatch), "--qbatch", str(qb), "--train-sample", str(HIVF_TRAIN),
        "--k", str(k), "--seed", str(SEED + 4), "--device", device])
    dev = torch.device(device)
    _reset_counters()
    rep, ivf, q, truth = rehearse_host_ivf.run(args)
    batches = [q[i:i + qb] for i in range(0, len(q), qb)]
    lat, splits, rows = [], [], {}
    for _ in range(2):
        for i, b in enumerate(batches):
            t1 = time.perf_counter()
            _, rows[i] = ivf.search(b, k, nprobe=HIVF_NPROBE)
            lat.append((time.perf_counter() - t1) * 1e3)
            splits.append(ivf.last_search_stats)
    t1 = time.perf_counter()
    p_sc, p_rows = ivf.search(batches[0], k, nprobe=HIVF_NPROBE, mode="packed")
    packed_ms = (time.perf_counter() - t1) * 1e3
    counts = _read_counters()
    if counts["exact"] < 1 or counts["packed"] < 1:
        raise AssertionError(f"host-arena search did not launch #1 and #2: {counts}")

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
    sc0, rows0 = ivf.search(batches[1], k, nprobe=HIVF_NPROBE)
    t1 = time.perf_counter()
    back = HostArenaIVF.load(str(work / "hivf"), mmap=True, device=dev)
    sc1, rows1 = back.search(batches[1], k, nprobe=HIVF_NPROBE)
    reload_ms = (time.perf_counter() - t1) * 1e3
    if not (np.array_equal(rows0, rows1) and np.allclose(sc0, sc1, rtol=0, atol=1e-5)):
        raise AssertionError("the mmap-loaded store searches differently")
    keys = ("probe_ms", "gather_ms", "upload_ms", "scan_ms", "merge_ms", "device_ms")
    out = {"phase": "host_ivf", "rows": n, "nlist": nlist, "cap": ivf.cap,
           "nprobe": HIVF_NPROBE, "spilled_rows": ivf.spilled_rows,
           "host_list_bytes": int(ivf._vec.nbytes + 4 * ivf._scale.nbytes + ivf._fill.nbytes),
           "build_s": {"train": rep["train_s"], "add": rep["build"]["seconds"]},
           "batch_ms": lat, "batch_ms_p50": statistics.median(lat),
           "split_ms_p50": {kk: statistics.median(s_[kk] for s_ in splits)
                            for kk in keys if kk in splits[0]},
           "lists_per_batch": [s_["lists"] for s_ in splits],
           "recall_at_10_vs_int8_exact": rec, "packed_batch": {
               "ms": packed_ms, "recall_at_10_vs_int8_exact": rec_packed,
               "exact_recall_same_batch": rec_exact0},
           "truth_s": rep["gt_seconds_host"], "save_s": save_s,
           "mmap_load_and_search_ms": reload_ms, "launches": counts,
           "rehearse_host_ivf": rep}
    emit(out)
    del ivf, back
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return counts


# train_semantic.py's geometry at full width (MiniLM-L6, batch 512, seq 128,
# q 48, lr 4e-4, tau 0.05) with two cuts: 1,000 steps, warmup 66 (its
# defaults 3000 and 200, the same ratio), over make_corpus's default 20,000
# docs of the installed site-packages and stdlib.  1,000 rather than 300
# steps: over a 300-step bi-encoder the reranker trained below ranks the
# held-out candidates little better than its seeded start (+0.026-0.052
# recall@10 after 1,200-1,500 steps), over a 1,000-step one by +0.10
# (rerank_sweep.py, PERF.md).  The checkpoint is served with 250
# held-out documents saved one by one: each save rewrites the store, so
# 1,970 took 127-194 s of the script's time limit, and 500 took 22-71 s
# beside the longer cuts above.  The eval's BM25 (SQLite FTS5, ~55-65 s on
# one core) runs beside the training loop
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_MAX_DOCS = 1000, 66, 20_000
TRAIN_SAVE_DOCS, TRAIN_QUERIES, TRAIN_PROBE_ROWS = 250, 32, 64
# the card's bf16 embeddings against the CPU's f32 forward of the same
# checkpoint: the least per-row cosine, set before any chip run
TRAIN_EMBED_COS_MIN = 0.99


def _train_step_flops(module, batch: int, q_len: int, d_len: int) -> float:
    """One training step's matmul FLOPs: 6 x non-embedding parameters x
    tokens (forward and backward), the attention's QK^T and PV (4 T^2 H a
    sequence a layer, forward and backward: three times), and one more
    forward of both for remat."""
    spec = module.spec
    params = sum(p.numel() for n, p in module.named_parameters()
                 if not n.endswith("_embeddings.weight"))
    tokens = batch * (q_len + d_len)
    attn = spec.layers * batch * 4 * spec.hidden * (q_len ** 2 + d_len ** 2)
    return 6 * params * tokens + 3 * attn + (2 * params * tokens + attn)


_KINDS = (("gemm", ("gemm", "cutlass", "nvjet", "xmma")), ("softmax", ("softmax",)),
          ("layer_norm", ("layer_norm", "gammabeta")),
          ("optimizer", ("multi_tensor_apply",)), ("gelu", ("gelu",)),
          ("where", ("where",)), ("copy", ("copy",)), ("reduce", ("reduce",)))


def _kernel_kinds(by_kernel: dict[str, float]) -> dict[str, float]:
    """Device ms by kind of kernel, from its name (first match of _KINDS;
    the rest is "other")."""
    out: dict[str, float] = {}
    for name, ms in by_kernel.items():
        low = name.lower()
        kind = next((k for k, keys in _KINDS if any(x in low for x in keys)), "other")
        out[kind] = out.get(kind, 0.0) + ms
    return out


def _serve_trained(work: Path, ckpt: str, vocab_path: str, docs: list[dict],
                   queries: list[dict], device: str, rerank: tuple[str, float] | None = None
                   ) -> dict:
    """The trained checkpoint behind the real HTTP server (EMBEDDING_WEIGHTS,
    TOKENIZER_PATH) over the store in work/vs: the server's encoder must
    hold the checkpoint's values; /docs/save of `docs` (held out from
    training), then /search of the held-out summaries of `queries` at k 10,
    each answered with 10 hits.  With `rerank` = (reranker checkpoint,
    alpha) the server also loads RERANK_WEIGHTS in RERANK_MODE=ensemble at
    RERANK_ENSEMBLE_ALPHA=alpha (20 candidates) and every /search asks for
    rerank: each reply must be reranked with no rerank_error.  Counters are
    zeroed as the server starts and read after the searches."""
    from tpu_rag_torch.config import Config
    from tpu_rag_torch.models.hf_import import bert_hf_names, read_safetensors

    cfg = Config(persist_dir=str(work / "vs"), kb_db_path=str(work / "db" / "kb.sqlite3"),
                 db_path=str(work / "db" / "app.sqlite3"), docs_dir=str(work / "docs"),
                 embedding_weights=ckpt, tokenizer_path=vocab_path,
                 model_priority=("extractive",), summarize_mode="off", host="127.0.0.1",
                 device=device)
    if rerank is not None:
        cfg.rerank_weights, cfg.rerank_ensemble_alpha = rerank
        cfg.rerank_mode, cfg.rerank_candidates = "ensemble", 20
    with _served(cfg) as (_app, engine, health):
        enc = engine.encoder
        names = bert_hf_names(enc.spec)
        last = enc.spec.layers - 1
        _check_loaded(enc.module, read_safetensors(Path(ckpt) / "model.safetensors"), {
            k: names[k] for k in ("word_embeddings.weight", "position_embeddings.weight",
                                  "layers.0.attention.key.weight",
                                  f"layers.{last}.output_ln.bias")})
        persists = _count_persists(engine)
        saved = {}
        t0 = time.perf_counter()
        for d in docs:
            # titles repeat across files, and a save replaces the document
            # of the same title: the corpus id keeps each one its own
            r = _http(cfg.port, "POST", "/docs/save",
                      {"title": f"{d['title']} {d['id']}", "content": d["body"],
                       "metadata": {"namespace": "corpus"}})
            saved[d["id"]] = r["id"]
        while len(persists) < len(docs) or engine.index.count() < len(docs):
            if time.perf_counter() - t0 > 900:
                raise TimeoutError(f"{engine.index.count()} of {len(docs)} documents "
                                   f"indexed, {len(persists)} saves persisted")
            time.sleep(0.2)
        out = {"docs_saved": len(docs), "docs_in_store": engine.index.count()}
        if docs:
            out["docs_indexed_and_persisted_s"] = persists[-1] - t0
        lat, rerank_ms = [], []
        for d in queries:
            t1 = time.perf_counter()
            r = _http(cfg.port, "POST", "/search",
                      {"query": d["query"], "k": 10, "rerank": rerank is not None})
            lat.append((time.perf_counter() - t1) * 1e3)
            if len(r["hits"]) != 10 or not all(math.isfinite(h["score"]) for h in r["hits"]):
                raise AssertionError(f"/search {d['query']!r}: {len(r['hits'])} hits")
            if rerank is not None:
                if r.get("reranked") is not True or "rerank_error" in r:
                    raise AssertionError(f"/search with rerank: {r.get('rerank_error')}")
                rerank_ms.append(r["timings_ms"]["rerank"])
        counts = _read_counters()
        if saved:
            vec = _vector_ids(engine, [d["query"] for d in queries], 10)
            out["own_doc_in_vector_top10"] = sum(saved[d["id"]] in ids
                                                 for d, ids in zip(queries, vec))
        if rerank is not None:
            ce = engine.get_cross_encoder()
            out.update(rerank_gate=engine._rerank_gate, rerank_stage_ms=rerank_ms,
                       rerank_stage_ms_p50=statistics.median(rerank_ms),
                       cross_encoder={"seq_len": ce.seq_len, "batch": ce.batch,
                                      "max_len": ce.spec.max_len,
                                      "vocab": ce.spec.vocab_size})
        spec = enc.spec
    out.update({"searches": len(lat), "search_ms": lat, "search_ms_p50": statistics.median(lat),
                "encoder": {"hidden": spec.hidden, "layers": spec.layers,
                            "max_len": spec.max_len, "vocab": spec.vocab_size},
                "health_device": health["device"], "launches": counts})
    return out


class _CorpusJob:
    """`python -m tpu_rag_torch.scripts.make_corpus` in a process of its
    own, started beside the kernel build: it parses the machine's packages
    on one core for a minute or more.  Leaving the context kills it if it
    still runs."""

    def __init__(self, work: Path) -> None:
        self.path = work / "corpus.jsonl"
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_rag_torch.scripts.make_corpus", "--out",
             str(self.path), "--max-docs", str(TRAIN_MAX_DOCS)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._done: dict = {}
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self) -> None:
        self._done["log"] = self._proc.communicate()[0]
        self._done["s"] = time.perf_counter() - self._t0

    def result(self, timeout: float = 900.0) -> tuple[Path, float, float]:
        """The corpus path, make_corpus's wall time, and how long the caller
        waited for it."""
        t0 = time.perf_counter()
        self._waiter.join(timeout)
        if self._waiter.is_alive():
            raise TimeoutError(f"make_corpus ran past {timeout} s")
        if self._proc.returncode != 0:
            raise RuntimeError(f"make_corpus exited {self._proc.returncode}: "
                               f"{self._done['log'][-2000:]}")
        print(self._done["log"].strip(), flush=True)
        return self.path, self._done["s"], time.perf_counter() - t0

    def __enter__(self) -> "_CorpusJob":
        return self

    def __exit__(self, *exc) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
        self._waiter.join(60)


# the CPU-ANN baseline: bench.py's vs_baseline geometry (100,000 x 384
# clustered rows, 256 centres, noise 0.25, 64 queries, k 10; M 16,
# ef_construction 100, ef 64)
HNSW_ROWS, HNSW_DIM, HNSW_QUERIES = 100_000, 384, 64


def hnsw_baseline() -> dict:
    """The port's CPU HNSW (tpu_rag_torch/baseline) on bench.py's corpus:
    build seconds, recall@10 against numpy's exact top 10, and QPS of 20
    batches of 64 queries on every core."""
    import os

    import numpy as np

    from tpu_rag_torch.baseline import CpuHnswIndex

    n, d, k = HNSW_ROWS, HNSW_DIM, 10
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((256, d)).astype(np.float32)
    x = (centers[rng.integers(0, 256, n)] + 0.25 * rng.standard_normal((n, d))).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = (centers[rng.integers(0, 256, HNSW_QUERIES)]
         + 0.25 * rng.standard_normal((HNSW_QUERIES, d))).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    truth = np.argsort(-(q @ x.T), axis=1, kind="stable")[:, :k]
    t0 = time.perf_counter()
    index = CpuHnswIndex(d, n, m=16, ef_construction=100)
    index.add(x)
    build_s = time.perf_counter() - t0
    index.search(q, k, ef=64)                      # warm
    t0 = time.perf_counter()
    for _ in range(20):
        ids, _ = index.search(q, k, ef=64)
    qps = HNSW_QUERIES * 20 / (time.perf_counter() - t0)
    recall = float(np.mean([len(set(ids[i]) & set(truth[i])) / k for i in range(len(q))]))
    return {"rows": n, "dim": d, "m": 16, "ef_construction": 100, "ef_search": 64,
            "build_s": build_s, "recall_at_10": recall, "qps": qps,
            "threads": os.cpu_count()}


class _HnswJob:
    """hnsw_baseline() in a process of its own, started beside the kernel
    build: the graph's build is single-threaded C++ for minutes, on one core
    of the card machine's eight.  Leaving the context kills it if it still
    runs."""

    def __init__(self) -> None:
        self._proc = subprocess.Popen(
            [sys.executable, "-c", "import json, chip_smoke; "
             "print(json.dumps(chip_smoke.hnsw_baseline()))"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self, timeout: float = 900.0) -> dict:
        out, err = self._proc.communicate(timeout=timeout)
        if self._proc.returncode != 0:
            raise RuntimeError(f"hnsw_baseline exited {self._proc.returncode}: {err[-2000:]}")
        return json.loads(out.strip().splitlines()[-1])

    def __enter__(self) -> "_HnswJob":
        return self

    def __exit__(self, *exc) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.communicate()


def phase_train(work: Path, corpus_job: _CorpusJob) -> dict:
    """train_semantic on the card: the corpus (make_corpus, started beside
    the build), vocab, contrastive training timed step by step (one step
    profiled), checkpoint, labeled eval, the card against the CPU on the
    same checkpoint, and the checkpoint served."""
    import numpy as np
    import torch

    from kernel_ab import _profile
    from tpu_rag_torch.models.biencoder import BiEncoder
    from tpu_rag_torch.models.tokenizer import load_tokenizer
    from tpu_rag_torch.ops import attention
    from tpu_rag_torch.scripts import train_semantic as ts
    from tpu_rag_torch.utils.metrics import GLOBAL_METRICS
    from tpu_rag_torch.utils.timing import SPANS

    cuda = torch.device("cuda")
    graph_counters = ("train_graph_captures_total", "train_graph_replays_total",
                      "train_eager_steps_total")
    corpus, corpus_s, corpus_wait_s = corpus_job.result()
    out = work / "semantic"
    args = ts.parse_args(["--corpus", str(corpus), "--out", str(out), "--steps",
                          str(TRAIN_STEPS), "--warmup", str(TRAIN_WARMUP), "--device", "cuda"])
    out.mkdir()
    vocab_path, ckpt = str(out / "vocab.txt"), str(out / "ckpt")
    docs = ts.load_corpus(args.corpus)
    train_docs, holdout = ts.split_holdout(docs, args.holdout_frac)

    def bm25_run():
        t = time.perf_counter()
        return ts.eval_bm25(docs, holdout), time.perf_counter() - t

    # the eval's BM25 needs no encoder: it runs on a thread of its own
    # (SQLite leaves the interpreter lock) while the card trains
    pool = ThreadPoolExecutor(1, thread_name_prefix="bm25")
    bm25_job = pool.submit(bm25_run)
    pool.shutdown(wait=False)                # its thread ends with the job
    t0 = time.perf_counter()
    vocab = ts.build_vocab(docs, args, vocab_path)
    vocab_s = time.perf_counter() - t0
    tok = load_tokenizer(vocab_path, vocab_size=args.vocab_size)
    spec = ts.semantic_spec(args)
    t0 = time.perf_counter()
    sample = ts.batch_sampler(train_docs, tok, args)
    pretokenize_s = time.perf_counter() - t0

    trainer = ts.make_trainer(args, spec, cuda)
    flops = _train_step_flops(trainer.module, args.batch, args.q_len, args.seq_len)
    losses, step_ms, prof = [], [], None
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    g0 = {n: GLOBAL_METRICS.counter(n) for n in graph_counters}
    t0 = time.perf_counter()
    while len(losses) < args.steps:
        if prof is None and len(losses) == args.steps // 2:
            # a warm-up step and one profiled step, batches drawn beforehand;
            # with the span recorder on, the trainer's spans (train.forward,
            # train.backward, ...) are named ranges of the trace
            batches = [sample(), sample()]
            SPANS.enable()
            try:
                prof = _profile(lambda: losses.append(trainer.train_step(batches.pop(0))),
                                reps=1)
            finally:
                SPANS.disable()
                SPANS.drain()
            continue
        batch = sample()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(trainer.train_step(batch))
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
    loop_s = time.perf_counter() - t0
    train_counts = _read_counters()
    # the loop's steps replay one CUDA graph (train/contrastive.py)
    graph = {n: GLOBAL_METRICS.counter(n) - g0[n] for n in graph_counters}
    print(f"train: {graph['train_graph_replays_total']:g} steps replayed / "
          f"{graph['train_graph_captures_total']:g} graphs captured, "
          f"{graph['train_eager_steps_total']:g} eager", flush=True)
    if graph["train_graph_replays_total"] < 1:
        raise AssertionError(f"the training loop replayed no step from a CUDA graph: {graph}")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(losses) != args.steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{len(losses)} losses, not all finite: {losses[:5]}")
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    if not last < first:
        raise AssertionError(f"the loss did not fall: first 20 {first}, last 20 {last}")
    if any(train_counts.values()):
        raise AssertionError(f"the training steps launched kernels: {train_counts}")
    q = torch.randn(8, 128, 12, 32, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    kv = torch.randn(8, 128, 12, 32, device=cuda, dtype=torch.bfloat16)
    try:
        attention.fused_mha(q, kv, kv, torch.ones(8, 128, dtype=torch.int32, device=cuda))
    except RuntimeError as e:
        guard = str(e)
    else:
        raise AssertionError("fused_mha on a q that requires grad did not raise")
    if "no backward" not in guard or attention._fused_mha_cuda.launches:
        raise AssertionError(f"fused_mha under autograd: {guard}")
    trainer.save(ckpt)
    del trainer, q, kv
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bm25, bm25_s = bm25_job.result()
    bm25_wait_s = time.perf_counter() - t0
    _reset_counters()
    t0 = time.perf_counter()
    results = ts.evaluate(args, spec, docs, holdout, vocab_path, ckpt, cuda, bm25=bm25)
    eval_s = time.perf_counter() - t0
    eval_counts = _read_counters()
    ts.write_report(args, spec, docs, holdout, results, ckpt, vocab_path)
    rows = {r["label"]: r for r in results}
    trained, seeded = rows["trained_biencoder"], rows["random_weights_round1"]
    if eval_counts["mha"] < 1:
        raise AssertionError(f"the eval's embeds did not launch #5: {eval_counts}")
    if not trained["recall@10"] >= seeded["recall@10"] + 0.05:
        raise AssertionError(f"trained recall@10 {trained['recall@10']} against seeded "
                             f"{seeded['recall@10']}")

    # the card (bf16) against the CPU (f32) on the same checkpoint, loaded
    # without a spec (config.json): held-out queries (T 32-64, plain
    # attention) and bodies (T 128, #5)
    probe = holdout[:TRAIN_PROBE_ROWS]
    encs = {dev: BiEncoder("minilm-l6-corpus", weights_path=ckpt, tokenizer_path=vocab_path,
                           seq_len=args.seq_len, batch=128, device=dev)
            for dev in ("cuda", "cpu")}
    if encs["cuda"].spec != spec or encs["cpu"].spec != spec:
        raise AssertionError(f"config.json gave {encs['cuda'].spec}, trained {spec}")
    cos = {}
    for name, texts in (("queries", [d["query"] for d in probe]),
                        ("bodies", [d["body"] for d in probe])):
        card, cpu = encs["cuda"].embed(texts), encs["cpu"].embed(texts)
        cos[name] = float(np.min(np.sum(card * cpu, axis=1)))
    if not min(cos.values()) >= TRAIN_EMBED_COS_MIN:
        raise AssertionError(f"card against CPU cosine {cos} (at least {TRAIN_EMBED_COS_MIN})")
    del encs
    torch.cuda.empty_cache()

    serve = _serve_trained(work, ckpt, vocab_path, holdout[:TRAIN_SAVE_DOCS],
                           holdout[:TRAIN_QUERIES], "cuda")
    if serve["launches"]["exact"] < 1 or serve["launches"]["mha"] < 1:
        raise AssertionError(f"serving the trained encoder did not launch #1 and #5: "
                             f"{serve['launches']}")

    ms = sorted(step_ms)
    p50, p90 = statistics.median(ms), ms[int(0.9 * (len(ms) - 1))]
    tokens = args.batch * (args.q_len + args.seq_len)
    top = sorted(prof["by_kernel_ms"].items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": "train", "cuts": {"steps": f"{TRAIN_STEPS} of 3000 (warmup "
                                              f"{TRAIN_WARMUP} of 200)",
                                     "corpus": f"make_corpus --max-docs {TRAIN_MAX_DOCS}"},
          "spec": {"hidden": spec.hidden, "layers": spec.layers, "heads": spec.heads,
                   "ffn": spec.ffn, "vocab": spec.vocab_size, "max_len": spec.max_len},
          "batch": args.batch, "seq_len": args.seq_len, "q_len": args.q_len,
          "lr": args.lr, "tau": args.tau, "compute_dtype": "bf16",
          "corpus_docs": len(docs), "train_docs": len(train_docs), "holdout": len(holdout),
          "vocab_tokens": len(vocab), "corpus_s": corpus_s,
          "corpus_wait_s": corpus_wait_s, "vocab_s": vocab_s,
          "pretokenize_s": pretokenize_s, "steps": len(losses), "timed_steps": len(step_ms),
          "step_ms_p50": p50, "step_ms_p90": p90, "step_ms_min": ms[0],
          "loop_s": loop_s, "tokens_per_step": tokens, "tokens_per_s": tokens / (p50 / 1e3),
          "step_tflop": flops / 1e12,
          "bf16_peak_share": flops / (p50 / 1e3) / PEAK_OPS_S["bf16"],
          "peak_mem_gib": peak_gb,
          "profiled_step": {"wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                            "device_idle_share": max(0.0, 1.0 - prof["device_ms"]
                                                     / prof["wall_ms"]),
                            "spans_ms": prof["spans_ms"],
                            "by_kind_ms": _kernel_kinds(prof["by_kernel_ms"]),
                            "top10_device_ms": [[k[:120], v] for k, v in top]},
          "loss_first": losses[0], "loss_last": losses[-1], "loss_first20_mean": first,
          "loss_last20_mean": last, "training_launches": train_counts,
          "graph_steps": graph,
          "grad_guard": guard, "eval": {"seconds": eval_s, "bm25_s": bm25_s,
                                        "bm25_wait_s": bm25_wait_s, "rows": results,
                                        "launches": eval_counts},
          "embed_cos_min_card_vs_cpu": cos, "embed_cos_tolerance": TRAIN_EMBED_COS_MIN,
          "serve": serve})
    return {name: eval_counts[name] + serve["launches"][name] for name in eval_counts}


# rerank_train: train_reranker's defaults at MiniLM-L6 width (batch 256 pairs
# = 64 groups of 1 + 3, T 160, 1,500 steps, warmup 150, hard-k 8, cand-k 20,
# bf16) over the train phase's corpus, vocab and bi-encoder, at lr 1e-4 (of
# 3e-4: at 3e-4 the CE's logits went constant in 3 of 4 sweep runs), with
# two mining rounds of 1,000 queries (of 1 and 8,000) and one val eval, at
# step 1,000 (the default is none), so that best-val keeping and re-mining
# run.  Evals every 100 steps picked by an ensemble recall saturated at the
# bi-encoder's (±0.005 from step to step) and restored steps 100-700 of a
# CE still learning (PERF.md)
RERANK_STEPS, RERANK_WARMUP, RERANK_LR, RERANK_EVAL_EVERY = 1500, 150, 1e-4, 1000
RERANK_MINE_ROUNDS, RERANK_MINE_QUERIES = 2, 1000
RERANK_PROBE_PAIRS, RERANK_QUERIES = 64, 32
# the trained CE's logit std over the probe pairs: constant logits read
# <= 0.002 (bf16 rounding), CEs kept from before they learned 0.09-0.8,
# learned ones 3.4-8.0 (rerank_sweep.py, PERF.md)
RERANK_LOGIT_STD_MIN = 0.5


def _rank_step_flops(module, batch: int, t: int) -> float:
    """One ranking step's matmul FLOPs: 6 x non-embedding parameters x
    tokens (forward and backward) and the attention's QK^T and PV (4 T^2 H
    a sequence a layer, forward and backward: three times); no remat."""
    spec = module.bert.spec
    params = sum(p.numel() for n, p in module.named_parameters()
                 if not n.endswith("_embeddings.weight"))
    return 6 * params * batch * t + 3 * spec.layers * batch * 4 * spec.hidden * t * t


# the tokenizers' speed: the pairs of this many held-out queries, each with
# cand_k bodies, as the held-out lift scores them
TOKENIZE_QUERIES = 200


def _tokenizer_speed(tok, vocab_path: str, data, cand_k: int) -> dict:
    """Tokens a second of the native WordPiece and of the Python one on
    (held-out query, body) pairs as train_reranker's held-out lift forms
    them (each query with cand_k bodies), on the host's CPU; the ids must
    be equal."""
    from tpu_rag_torch.models.tokenizer import WordPieceTokenizer

    if tok.backend != "native":
        raise AssertionError(f"the reranker's tokenizer is {tok.backend}")
    python = WordPieceTokenizer(vocab_path)
    python._native = None
    nb = len(data.bodies)
    pairs = [(d["query"], data.bodies[(data.id_pos[d["id"]] + j) % nb])
             for d in data.holdout[:TOKENIZE_QUERIES] for j in range(cand_k)]
    out, ids = {"pairs": len(pairs)}, {}
    for name, t in (("native", tok), ("python", python)):
        t0 = time.perf_counter()
        ids[name] = [(t.tokenize_ids(a), t.tokenize_ids(b)) for a, b in pairs]
        secs = time.perf_counter() - t0
        n_tok = sum(len(a) + len(b) for a, b in ids[name])
        out[name] = {"seconds": secs, "tokens": n_tok, "tokens_per_s": n_tok / secs}
    if ids["native"] != ids["python"]:
        raise AssertionError("the native and Python tokenizers disagree on the eval's pairs")
    out["native_over_python"] = out["native"]["tokens_per_s"] / out["python"]["tokens_per_s"]
    return out


def phase_rerank_train(work: Path, corpus: Path) -> dict:
    """train_reranker on the card over the train phase's corpus and
    bi-encoder (work/semantic): mining (the bi-encoder's embeds launch #5),
    ranking training timed step by step (one step profiled; no kernel may
    launch), the held-out lift through the serving CrossEncoder (#5 at B
    256, T 160), the checkpoint loaded without a spec on the card and on the
    CPU, then served: the trained bi-encoder and reranker behind HTTP over
    the train phase's store, 32 /search with rerank (#1 and #5)."""
    import numpy as np
    import torch

    from kernel_ab import _profile
    from tpu_rag_torch.models.crossencoder import CrossEncoder
    from tpu_rag_torch.models.tokenizer import load_tokenizer
    from tpu_rag_torch.scripts import train_reranker as tr

    # the Python threads alive as the phase starts (a busy one slows the
    # host's work here: tokenizing, batching, the eval's merges)
    threads_at_start = _threads()
    cuda = torch.device("cuda")
    semantic, out = work / "semantic", work / "reranker"
    args = tr.parse_args(["--corpus", str(corpus), "--biencoder", str(semantic), "--out",
                          str(out), "--steps", str(RERANK_STEPS), "--warmup",
                          str(RERANK_WARMUP), "--lr", str(RERANK_LR),
                          "--eval-every", str(RERANK_EVAL_EVERY),
                          "--mine-rounds", str(RERANK_MINE_ROUNDS), "--mine-queries",
                          str(RERANK_MINE_QUERIES), "--device", "cuda"])
    out.mkdir()
    vocab_path, ckpt = str(semantic / "vocab.txt"), str(out / "ckpt")
    seconds = {}
    t0 = time.perf_counter()
    tok = load_tokenizer(vocab_path, vocab_size=30522)
    data = tr.make_data(args, tr.load_corpus(args.corpus), tok)
    seconds["tokenize"] = time.perf_counter() - t0
    tok_speed = _tokenizer_speed(tok, vocab_path, data, args.cand_k)
    emit({"phase": "rerank_train", "tokenizer_speed": tok_speed})

    _reset_counters()
    t0 = time.perf_counter()
    bi, bi_sd = tr.load_biencoder(args, cuda)
    demb = bi.embed(data.bodies)
    spec, bert_sd = tr.reranker_spec(args, tok.vocab_size, bi_sd)
    mined = tr.mine(args, data, bi, demb)
    seconds["mine"] = time.perf_counter() - t0
    mine_counts = _read_counters()
    if mine_counts["mha"] < 1 or spec.max_len != 160 or args.seq_len != 160:
        raise AssertionError(f"mining launched {mine_counts}; spec {spec}, T {args.seq_len}")

    trainer = tr.make_trainer(args, spec, bert_sd, cuda)
    flops = _rank_step_flops(trainer.module, args.batch, args.seq_len)
    step_ms, prof = [], {}
    step = trainer.train_step

    def timed(*batch):
        if not prof and len(step_ms) == args.steps // 2:
            losses = []
            prof.update(_profile(lambda: losses.append(step(*batch)), reps=1, warmup=False))
            return losses[0]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        loss = step(*batch)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        return loss

    trainer.train_step = timed
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    summary = tr.train(args, data, mined, trainer, ckpt)
    seconds["train"] = time.perf_counter() - t0
    train_counts = _read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = summary["losses"]
    if len(losses) != args.steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{len(losses)} losses, not all finite: {losses[:5]}")
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    if not last < first:
        raise AssertionError(f"the ranking loss did not fall: first 20 {first}, last 20 {last}")
    if any(train_counts.values()):
        raise AssertionError(f"the ranking training launched kernels: {train_counts}")
    if len(summary["val"]) != args.steps // args.eval_every - (args.steps % args.eval_every == 0):
        raise AssertionError(f"val evals: {summary['val']}")
    del trainer
    torch.cuda.empty_cache()

    _reset_counters()
    t0 = time.perf_counter()
    results, alpha, curve = tr.heldout_lift(args, data, bi, demb, ckpt, spec, vocab_path, cuda)
    seconds["eval"] = time.perf_counter() - t0
    eval_counts = _read_counters()
    report = tr.write_report(args, data, results, alpha, curve, ckpt, vocab_path)
    rows = {r["label"]: r for r in results}
    trained, seeded = rows["trained_reranker"], rows["random_weights_round1"]
    bi_row = rows["biencoder_top20_no_rerank"]
    if eval_counts["mha"] < 1:
        raise AssertionError(f"the eval's cross-encoder did not launch #5: {eval_counts}")
    if not trained["recall@10"] >= seeded["recall@10"] + 0.05:
        raise AssertionError(f"trained recall@10 {trained['recall@10']} against seeded "
                             f"{seeded['recall@10']}")
    del bi, demb
    torch.cuda.empty_cache()

    # the card (bf16) against the CPU (f32) on the checkpoint loaded without
    # a spec: each held-out query with its own body and a neighbour's
    pairs = tr.probe_pairs(data, RERANK_PROBE_PAIRS)
    ces = {dev: CrossEncoder(weights_path=ckpt, tokenizer_path=vocab_path, seq_len=256,
                             device=dev) for dev in ("cuda", "cpu")}
    if ces["cuda"].spec != spec or ces["cpu"].spec != spec or ces["cuda"].seq_len != 160:
        raise AssertionError(f"config.json gave {ces['cuda'].spec}, trained {spec}")
    card, cpu = ces["cuda"].predict(pairs), ces["cpu"].predict(pairs)
    diff = float(np.abs(card - cpu).max())
    tol = RERANK_LOGIT_TOL * max(1.0, float(np.abs(cpu).max()))
    if not diff <= tol:
        raise AssertionError(f"card logits {diff} from the CPU f32 forward (tolerance {tol})")
    spread = tr.logit_spread(card)
    if not (spread["card_logit_std"] > RERANK_LOGIT_STD_MIN
            and spread["own_body_minus_neighbour_mean"] > 0):
        raise AssertionError(f"the trained reranker scores the probe pairs alike: {spread} "
                             f"(std floor {RERANK_LOGIT_STD_MIN})")
    del ces
    torch.cuda.empty_cache()

    holdout = data.holdout
    serve = _serve_trained(work, str(semantic / "ckpt"), vocab_path, [],
                           holdout[:RERANK_QUERIES], "cuda", rerank=(ckpt, alpha))
    if serve["launches"]["exact"] < 1 or serve["launches"]["mha"] < 1:
        raise AssertionError(f"reranked /search did not launch #1 and #5: {serve['launches']}")

    ms = sorted(step_ms)
    p50, p90 = statistics.median(ms), ms[int(0.9 * (len(ms) - 1))]
    top = sorted(prof["by_kernel_ms"].items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": "rerank_train",
          "cuts": {"steps": f"{RERANK_STEPS} of 1500 (warmup {RERANK_WARMUP} of 150)",
                   "lr": f"{RERANK_LR} (default 3e-4)",
                   "eval_every": f"{RERANK_EVAL_EVERY} (default 0: off)",
                   "mine": f"--mine-rounds {RERANK_MINE_ROUNDS} --mine-queries "
                           f"{RERANK_MINE_QUERIES} (defaults 1, 8000)",
                   "corpus": f"the train phase's (make_corpus --max-docs {TRAIN_MAX_DOCS})",
                   "profiled_step": "one step under the profiler, out of the timed ones"},
          "spec": {"hidden": spec.hidden, "layers": spec.layers, "heads": spec.heads,
                   "ffn": spec.ffn, "vocab": spec.vocab_size, "max_len": spec.max_len},
          "tokenizer_speed": tok_speed,
          "batch_pairs": args.batch, "group": 1 + args.neg_per_pos, "seq_len": args.seq_len,
          "lr": args.lr, "hard_k": args.hard_k, "cand_k": args.cand_k,
          "compute_dtype": "bf16", "train_docs": len(data.train_docs),
          "holdout": len(data.holdout), "seconds": seconds,
          "steps": len(losses), "timed_steps": len(step_ms), "step_ms_p50": p50,
          "step_ms_p90": p90, "step_ms_min": ms[0],
          "tokens_per_step": args.batch * args.seq_len, "step_tflop": flops / 1e12,
          "bf16_peak_share": flops / (p50 / 1e3) / PEAK_OPS_S["bf16"],
          "peak_mem_gib": peak_gb,
          "profiled_step": {"wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                            "device_idle_share": max(0.0, 1.0 - prof["device_ms"]
                                                     / prof["wall_ms"]),
                            "spans_ms": prof["spans_ms"],
                            "by_kind_ms": _kernel_kinds(prof["by_kernel_ms"]),
                            "top10_device_ms": [[k[:120], v] for k, v in top]},
          "loss_first": losses[0], "loss_last": losses[-1], "loss_first20_mean": first,
          "loss_last20_mean": last, "chance": float(np.log(1 + args.neg_per_pos)),
          "val": summary["val"], "best_step": summary["best_step"],
          "restored_best": summary["restored_best"], "rollbacks": summary["rollbacks"],
          "skipped_steps": summary["skipped_steps"],
          "launches": {"mine": mine_counts, "train": train_counts, "eval": eval_counts},
          "eval": {"rows": results, "alpha": alpha, "alpha_val_curve": curve,
                   "lift_recall@10_over_biencoder": trained["recall@10"] - bi_row["recall@10"],
                   "lift_recall@10_ensemble_over_biencoder":
                       rows[f"ensemble_bi+trained_ce(alpha={alpha})"]["recall@10"]
                       - bi_row["recall@10"]},
          # the spread of the trained CE's logits over the probe pairs: ~0
          # where training collapsed to constant logits (loss at ln 4)
          "logits_card_vs_cpu": {"pairs": len(pairs), "max_abs_diff": diff, "tolerance": tol,
                                 **spread, "card_logit_std_min": RERANK_LOGIT_STD_MIN},
          "threads_at_start": threads_at_start,
          "report_serving": report["serving"], "serve": serve})
    return {name: mine_counts[name] + eval_counts[name] + serve["launches"][name]
            for name in eval_counts}


@contextlib.contextmanager
def _dtypes_of(module, name: str):
    """Wrap module.<name> (a kernel wrapper) for the block: yields the list
    of the dtypes of its second argument (the rows, or k for #5) at each
    call.  The wrapper counts its launches on the module's name, so the
    stand-in carries the counts and hands them back."""
    fn, seen = getattr(module, name), []

    def recorded(*a, **k):
        seen.append(a[1].dtype)
        return fn(*a, **k)

    counts = [a for a in ("launches", "f32_launches") if hasattr(fn, a)]
    for a in counts:
        setattr(recorded, a, getattr(fn, a))
    setattr(module, name, recorded)
    try:
        yield seen
    finally:
        for a in counts:
            setattr(fn, a, getattr(recorded, a))
        setattr(module, name, fn)


@contextlib.contextmanager
def _environ(**env):
    import os

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_tool(main, argv: list[str]) -> tuple[object, str, float]:
    """An entry point's main(argv) in process: (its return, its stdout,
    seconds)."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue(), time.perf_counter() - t0


# scripts: eval_recall over 1,000,000 synthetic rows of 384
SCRIPTS_EVAL_ROWS = 1_000_000


def phase_scripts(work: Path, hnsw_job: _HnswJob) -> dict:
    """The offline entry points in process on the card, over the train
    phase's bi-encoder (work/semantic): build_index + query_local over
    examples/docs (#5, #1), eval_recall --synthetic 1,000,000 at bf16, int8,
    bucketed and ivf (#1, #3 on bf16 rows, #7), prove_checkpoint (the f32
    encoder: #5's f32 kernel), bench_scale flat-1m-bf16 at d 768 (its five
    paths: the plain scan, #1, #2, #3, #4) and encoder-minilm (short texts:
    the plain attention at T 32); and the CPU HNSW baseline, built in its
    own process since the phases began."""
    import torch

    from tpu_rag_torch.ops import attention as att
    from tpu_rag_torch.ops import topk as tk
    from tpu_rag_torch.scripts import (bench_scale, build_index, eval_recall,
                                       prove_checkpoint, query_local)

    semantic, root = work / "semantic", work / "scripts"
    out, launches = {}, {}

    def counted(name: str) -> dict[str, int]:
        counts = _read_counters()
        for kern, c in counts.items():
            launches[kern] = launches.get(kern, 0) + c
        out.setdefault("launches", {})[name] = counts
        return counts

    env = {"PERSIST_DIR": str(root / "vs"), "KB_DB_PATH": str(root / "db" / "kb.sqlite3"),
           "DB_PATH": str(root / "db" / "app.sqlite3"), "DOCS_DIR": str(REPO / "examples" / "docs"),
           "EMBEDDING_WEIGHTS": str(semantic / "ckpt"),
           "TOKENIZER_PATH": str(semantic / "vocab.txt"), "DEVICE": "cuda",
           "MODEL_PRIORITY": "extractive", "TPU_RAG_ENV_FILE": str(root / "none.env")}
    with _environ(**env):
        _reset_counters()
        _, text, secs = _run_tool(build_index.main, [])
        counts = counted("build_index")
        if "Done. Indexed logical documents: 254 (" not in text or counts["mha"] < 1:
            raise AssertionError(f"build_index: {text[-400:]} {counts}")
        out["build_index"] = {"seconds": secs, "last_line": text.strip().splitlines()[-1]}
        _reset_counters()
        _, text, secs = _run_tool(query_local.main, ["the moon temple on the silver cliff",
                                                     "--k", "5", "--json"])
        counts = counted("query_local")
        hits = json.loads(text)["hits"]
        if len(hits) != 5 or counts["exact"] < 1:
            raise AssertionError(f"query_local: {len(hits)} hits, {counts}")
        out["query_local"] = {"seconds": secs, "hits": [[h["id"], h["score"]] for h in hits]}

    _reset_counters()
    with _dtypes_of(tk, "_bucketed_scan_cuda") as bucketed_rows:
        _, text, secs = _run_tool(eval_recall.main, [
            "--synthetic", str(SCRIPTS_EVAL_ROWS), "--configs", "bf16,int8,bucketed,ivf",
            "--device", "cuda"])
    counts = counted("eval_recall")
    configs = {r["config"]: r for r in map(json.loads, text.strip().splitlines())}
    recall = {c: configs[c]["recall_at_k"] for c in ("bf16", "int8", "bucketed", "ivf")}
    if not (counts["exact"] >= 2 and torch.bfloat16 in bucketed_rows
            and counts["batched"] >= 1):
        raise AssertionError(f"eval_recall launched {counts}, #3 on {bucketed_rows}")
    if not all(0.0 <= v <= 1.0 for v in recall.values()) or min(
            recall["bf16"], recall["int8"], recall["bucketed"]) < 0.95:
        raise AssertionError(f"eval_recall: {recall}")
    out["eval_recall"] = {"seconds": secs, "rows": SCRIPTS_EVAL_ROWS, "recall_at_10": recall,
                          "configs": configs}

    _reset_counters()
    with _dtypes_of(att, "_fused_mha_cuda") as mha_dtypes:
        rc, text, secs = _run_tool(prove_checkpoint.main, [
            "--embedding-weights", str(semantic / "ckpt"),
            "--tokenizer", str(semantic / "vocab.txt"), "--device", "cuda"])
    counts = counted("prove_checkpoint")
    report = json.loads(text.strip().splitlines()[-1])
    if rc != 0 or not report["bundled_recall_at_k"]["ok"] or torch.float32 not in mha_dtypes:
        raise AssertionError(f"prove_checkpoint exited {rc}: {report}; #5 on {set(mha_dtypes)}")
    out["prove_checkpoint"] = {"seconds": secs, "exit": rc, "report": report,
                               "mha_f32_launches": mha_dtypes.count(torch.float32)}

    _reset_counters()
    _, text, secs = _run_tool(bench_scale.main, ["--config", "flat-1m-bf16", "--d", "768",
                                                 "--device", "cuda"])
    counts = counted("bench_scale_flat")
    flat = json.loads(text.strip().splitlines()[-1])
    paths = set(flat["paths_ms"])
    if paths != set(bench_scale.PATHS.values()) or min(
            counts[c] for c in ("exact", "packed", "bucketed", "floor")) < 1:
        raise AssertionError(f"bench_scale flat-1m-bf16: paths {sorted(paths)}, {counts}")
    out["bench_scale_flat_1m_768"] = {"seconds": secs, **flat}
    _reset_counters()
    _, text, secs = _run_tool(bench_scale.main, ["--config", "encoder-minilm",
                                                 "--device", "cuda"])
    counted("bench_scale_encoder")      # its ~25-token texts run T 32: no #5
    enc = json.loads(text.strip().splitlines()[-1])
    if enc["dim"] != 384 or enc["n"] != 4096 or not enc["texts_per_second"] > 0:
        raise AssertionError(f"bench_scale encoder-minilm: {enc}")
    out["bench_scale_encoder_minilm"] = {"seconds": secs, **enc}

    t0 = time.perf_counter()
    hnsw = hnsw_job.result()
    out["hnsw_baseline"] = {**hnsw, "waited_s": time.perf_counter() - t0}
    if hnsw["recall_at_10"] < 0.9:
        raise AssertionError(f"the HNSW baseline's recall@10 is {hnsw['recall_at_10']}")
    emit({"phase": "scripts", **out})
    return launches


@contextlib.contextmanager
def _wordpiece_backends():
    """Record the backend ("native" or "python") of every WordPieceTokenizer
    built in the block: yields the list."""
    from tpu_rag_torch.models import tokenizer as tz

    init, built = tz.WordPieceTokenizer.__init__, []

    def recorded(self, *a, **k):
        init(self, *a, **k)
        built.append(self.backend)

    tz.WordPieceTokenizer.__init__ = recorded
    try:
        yield built
    finally:
        tz.WordPieceTokenizer.__init__ = init


# with --save-masks: the masks kept of each (B, T, H, D) shape in a phase
MASKS_KEPT = 8


@contextlib.contextmanager
def _attention_masks(keep: int = 0):
    """Record the key masks of every bf16 #5 call on the card in the block
    (the encoders' fused_mha, mha_tc_kernel): yields a dict that, once the
    block ends, holds the launches, the key chunks of their work (64 keys
    a chunk, counted once a 128-query tile and head) and those chunks
    whose keys are all masked in a batch row that has a real key: work
    that adds nothing to the output (mha_tc_kernel computes it).  `shapes` counts the launches of each
    (B, T, H, D); with keep > 0, `masks` holds the first `keep` masks of
    each (int8, on the CPU) for kernel_ab.py --masks."""
    import torch

    from tpu_rag_torch.models import bert

    fused, lock, chunks, skipped, kept = bert.fused_mha, threading.Lock(), [], [], {}

    def recorded(q, k, v, mask):
        if q.device.type == "cuda" and q.dtype == torch.bfloat16:
            b, t, h, hd = q.shape
            real = mask > 0
            if t % 64:
                real = torch.cat([real, real.new_zeros(b, -t % 64)], 1)
            real = real.view(b, -1, 64).any(-1)             # (B, chunks): a real key
            tiles = h * -(-t // 128)
            gone = (~real & real.any(-1, keepdim=True)).sum() * tiles
            with lock:
                chunks.append(real.numel() * tiles)
                skipped.append(gone)
                shape = kept.setdefault(f"{b},{t},{h},{hd}", {"calls": 0, "masks": []})
                shape["calls"] += 1
                if len(shape["masks"]) < keep:
                    shape["masks"].append(mask.detach().to(torch.int8).clone())
        return fused(q, k, v, mask)

    out = {}
    bert.fused_mha = recorded
    try:
        yield out
    finally:
        bert.fused_mha = fused
        gone = int(torch.stack(skipped).sum()) if skipped else 0
        out.update({"launches": len(chunks), "chunks": sum(chunks), "chunks_all_masked": gone,
                    "share_all_masked": gone / sum(chunks) if chunks else None,
                    "shapes": {key: r["calls"] for key, r in sorted(
                        kept.items(), key=lambda kv: -kv[1]["calls"])}})
        if keep:
            out["masks"] = {key: {"calls": r["calls"], "masks": [m.cpu() for m in r["masks"]]}
                            for key, r in kept.items()}


# rehearse: scripts/rehearse_scale.py's defaults (1M rows, 20,000 real
# documents, 16 queries, k 10, bge-base at T 128, batch 128)
REHEARSE_RECALL_MIN = 0.99


def phase_rehearse(work: Path, corpus: Path) -> dict:
    """tpu_rag_torch/scripts/rehearse_scale.py at its defaults on the card
    over `corpus` (make_corpus's): bge-base (768 wide, head dim 64: #5's
    mha_tc_kernel<64>) embeds 20,000 documents, a 1M x 768 FlatIndex (bf16:
    #1 at d 768) serves the index API and HTTP /search, and bench_http
    loads it from its own process.  Fails unless both recalls@10 against
    f32 exact reach REHEARSE_RECALL_MIN, the load had no failed request,
    #1 and #5 launched, and the tokenizer ran natively."""
    from tpu_rag_torch.scripts import rehearse_scale

    _reset_counters()
    with _wordpiece_backends() as built:
        rep, _, secs = _run_tool(rehearse_scale.main, ["--corpus", str(corpus),
                                                        "--device", "cuda"])
    counts = _read_counters()
    emit({"phase": "rehearse", "seconds": secs, "tokenizers_built": built,
          "launches": counts, "report": rep})
    load = rep.get("http_load", {})
    recalls = (rep["index_api"]["recall_at_10_vs_f32"], rep["http"]["recall_at_10_vs_f32"])
    if min(recalls) < REHEARSE_RECALL_MIN:
        raise AssertionError(f"rehearse_scale recall@10 (index API, HTTP) {recalls}")
    if "error" in load or load.get("requests_failed") != 0:
        raise AssertionError(f"rehearse_scale's bench_http load: {load}")
    if counts["exact"] < 1 or counts["mha"] < 1:
        raise AssertionError(f"rehearse_scale did not launch #1 and #5: {counts}")
    if rep["encoder"]["tokenizer"] != "native" or not built:
        raise AssertionError(f"rehearse_scale tokenized with {rep['encoder']['tokenizer']}")
    if rep["dim"] != 768 or rep["ingest"]["rows"] != 1_000_000:
        raise AssertionError(f"rehearse_scale ran {rep['dim']} x {rep['ingest']['rows']}")
    return counts


# ------------------------------------------------------------------ shard
# The sharded serving path (tpu_rag_torch/parallel) on cuda:0 named
# SHARD_COUNT times: a 4,000,000 x 384 ShardedFlatIndex (auto: int8, 1M
# rows a shard, the exact scan #1 with the host refine) served over HTTP;
# a 2,000,000 x 384 int8 ShardedIVFIndex (nlist 1024, cap factor 2.0,
# nprobe 64: #6 on every shard); two gloo processes loading their halves of
# a 1,000,000 x 384 bf16 store; and rehearse_100m cut from 100M rows to
# REHEARSE_100M_ROWS (PERF.md section 4: its SQLite ingest runs ~46,000
# rows/s; at 10M rows it held the phase 140 s past its other parts, at 6M
# 17.5 s, with the whole run, the tp phase added, at 1,002 s)
SHARD_COUNT = 4
SHARD_FLAT_ROWS, SHARD_IVF_ROWS, SHARD_DIST_ROWS = 4_000_000, 2_000_000, 1_000_000
SHARD_IVF_NLIST, SHARD_IVF_NPROBE = 1024, 64
REHEARSE_100M_ROWS = 4_000_000
# the shard phase's kernel rows (#1 and #6 on one shard's own tensors),
# added to the kernels line by main()
SHARD_ROWS: list[dict] = []


def _tie_check(got, plain, what: str) -> int:
    """Two SearchResults of the same queries: equal ids, but where the two
    results' f32 refine scores at that rank are within 1e-5 (a tie).
    Returns the count of positions that differ in ties."""
    differ = 0
    for a_ids, a_s, b_ids, b_s in zip(got.ids, got.similarities, plain.ids,
                                      plain.similarities):
        if len(a_ids) != len(b_ids):
            raise AssertionError(f"{what}: {len(a_ids)} hits against {len(b_ids)}")
        for ia, sa, ib, sb in zip(a_ids, a_s, b_ids, b_s):
            if ia != ib:
                if abs(sa - sb) > 1e-5:
                    raise AssertionError(f"{what}: ids differ outside ties ({ia} {sa}, "
                                         f"{ib} {sb})")
                differ += 1
    return differ


def _shard_scan_row(x, scale, ns, canon, nq: int, k: int, g) -> dict:
    """#1 (exact, int8) on one shard's own snapshot tensors: kernel against
    plain version (_id_check), times, bound, and the kernel's device time."""
    import torch

    from tpu_rag_torch.ops import topk as tk
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    n, d = x.shape
    qf = torch.randn((nq, d), generator=g, device=x.device)
    q8, qs = quantize_int8_rows(qf)
    args = (q8, x, scale, ns, canon, qs, -1, -1, k)
    chk = _id_check(*tk._exact_scan_cuda(*args), *tk._exact_scan_plain(*args), 1e-4)

    def library():
        s = torch.matmul(q8.to(torch.bfloat16), x.to(torch.bfloat16).T).float()
        s = s * qs[:, None] * scale[None, :]
        return torch.topk(torch.where((ns != tk.PAD_TAG)[None, :], s, -math.inf), k, dim=1)

    nbytes = n * d + n * 8 + n * 4 + nq * d + nq * k * 8
    b_ms, b_by = bound(nbytes, 2.0 * n * d * nq, "int8")
    return {"name": f"exact_scan[int8,shard of {SHARD_COUNT},n={n},d={d},q={nq},k={k}]",
            "route": "cuda", "source": "tpu_rag_torch/csrc/topk.cu",
            "replaces": "tpu_rag/ops/topk.py:96", "counter": "exact_bf16_int8",
            "plan": tk._scan_plan(n, d, nq, k, x.dtype, tk._sm_count(x.device),
                                  "exact")._asdict(),
            **chk, "ms": cuda_ms(lambda: tk._exact_scan_cuda(*args)),
            **_device_ms(lambda: tk._exact_scan_cuda(*args), "pipe_scan_kernel", b_ms,
                         lost_ok=True),
            "plain_ms": cuda_ms(lambda: tk._exact_scan_plain(*args), iters=5),
            "library_ms": cuda_ms(library, iters=5),
            "library": "composite: torch.matmul + torch.topk",
            "bound_ms": b_ms, "bound_by": b_by}


def _shard_probe_row(snap, s: int, q, k_eff: int, nprobe: int) -> dict:
    """#6 on shard s's own lists (cap a multiple of 8, not of 128):
    kernel against plain version, times, and the bound over live rows."""
    import torch

    from tpu_rag_torch.ops import ivf_probe as ip
    from tpu_rag_torch.ops.quant import quantize_int8_rows
    from tpu_rag_torch.ops.topk import PAD_TAG

    vec, scale = snap["vec_lists"][s], snap["scale_lists"][s]
    ns, canon = snap["ns_lists"][s], snap["canon_lists"][s]
    nq, (_nlist, cap, d) = q.shape[0], vec.shape
    lists = ip._top_lists(q, snap["centroids"][s], nprobe)
    q8 = quantize_int8_rows(q)[0]
    args = (q8, lists, vec, scale, ns, canon, -1, -1, k_eff)
    k_sc, k_id = ip._probe_list_cuda(*args)
    p_sc, p_id = ip._probe_list_plain(*args)
    if not (torch.equal(k_sc, p_sc) and torch.equal(k_id, p_id)):
        raise AssertionError("per-list probe on a shard: ids or scores differ from plain")
    flat = lists.reshape(-1)

    def library():
        x = vec[flat].to(torch.bfloat16)
        qv = q8.to(torch.bfloat16).repeat_interleave(nprobe, 0)[:, :, None]
        sc = torch.bmm(x, qv)[..., 0].float() * scale[flat]
        return torch.topk(torch.where(ns[flat] != PAD_TAG, sc, -math.inf), k_eff, dim=1)

    n_lists, live = _probed(lists, ns)
    live_pairs = int((ns[flat] != PAD_TAG).sum())
    nbytes = (n_lists * cap * 4 + live * (d + 4) + nq * d + lists.numel() * 4
              + nq * nprobe * k_eff * 8)
    b_ms, b_by = bound(nbytes, 2.0 * live_pairs * d, "int8")
    return {"name": f"ivf_probe_per_list[int8,shard of {SHARD_COUNT},q={nq},nprobe={nprobe},"
                    f"cap={cap},d={d},k={k_eff}]", "route": "cuda",
            "source": "tpu_rag_torch/csrc/ivf_probe.cu",
            "replaces": "tpu_rag/ops/ivf_probe.py:41", "counter": "per_list_bf16_int8",
            "plan": ip._list_plan(nq, nprobe, cap, d, torch.int8, k_eff,
                                  ip._sm_count(vec.device))._asdict(),
            "max_abs_err": 0.0, "ms": cuda_ms(lambda: ip._probe_list_cuda(*args)),
            **_device_ms(lambda: ip._probe_list_cuda(*args), "probe_split_kernel", b_ms,
                         lost_ok=True),
            "plain_ms": cuda_ms(lambda: ip._probe_list_plain(*args), iters=5),
            "library_ms": cuda_ms(library, iters=5),
            "library": "composite: list gather + torch.bmm + torch.topk",
            "bound_ms": b_ms, "bound_by": b_by}


def _shard_flat(work: Path) -> dict:
    """ShardedFlatIndex over SHARD_FLAT_ROWS x 384 served over HTTP with a
    data-parallel MiniLM-L6 encoder (seeded checkpoint) on the same mesh;
    the store's saves are not run (each would rewrite 6 GB: the serve and
    ivf phases hold the store path)."""
    import numpy as np
    import torch

    from tpu_rag_torch.config import Config
    from tpu_rag_torch.engine import RagEngine
    from tpu_rag_torch.models.biencoder import BiEncoder, spec_for_model
    from tpu_rag_torch.parallel import ShardedFlatIndex, mesh_from_spec

    n, d, nq, k = SHARD_FLAT_ROWS, 384, 64, 10
    t0 = time.perf_counter()
    x, q, _base = _ivf_corpus(n, d, nq, SEED + 7)
    xt = torch.from_numpy(x).cuda()
    truth = torch.topk(torch.from_numpy(q).cuda() @ xt.T, k, dim=1).indices.cpu().numpy()
    del xt
    torch.cuda.empty_cache()
    gen_s = time.perf_counter() - t0
    mesh = mesh_from_spec("", ["cuda:0"] * SHARD_COUNT)
    index = ShardedFlatIndex(d, mesh=mesh, dtype="auto", master_backing="ram")
    index._bulk_adopt_rows(x, (f"syn-{i}" for i in range(n)), (("", {}) for _ in range(n)),
                           count=n)
    del x
    bi_dir, _bi, _ce_dir, _ce = _write_checkpoints(work, spec_for_model("minilm-l6"))
    cfg = Config(persist_dir=str(work / "vs"), kb_db_path=str(work / "db" / "kb.sqlite3"),
                 db_path=str(work / "db" / "app.sqlite3"), docs_dir=str(work / "docs"),
                 embedding_model="sentence-transformers/all-MiniLM-L6-v2",
                 embedding_weights=str(bi_dir), model_priority=("extractive",),
                 summarize_mode="off", host="127.0.0.1", device="cuda")
    encoder = BiEncoder(cfg.embedding_model, weights_path=str(bi_dir), device="cuda",
                        mesh=mesh)
    engine = RagEngine(cfg, encoder=encoder, index=index)
    engine.indexer.persist_fn = None
    with _served(cfg, engine) as (_app, engine, _health):
        texts = [_doc_text(i + 40) for i in range(4)]
        saved = []
        t_save = time.perf_counter()
        for i, text in enumerate(texts):                 # into the first build
            saved.append(_http(cfg.port, "POST", "/docs/save",
                               {"title": f"Shard doc {i}", "content": text,
                                "metadata": {"namespace": "smoke"}})["id"])
        while index.count() < n + len(texts):
            if time.perf_counter() - t_save > 600:
                raise TimeoutError("background indexing did not finish")
            time.sleep(0.2)
        save_s = time.perf_counter() - t_save
        t1 = time.perf_counter()
        _http(cfg.port, "POST", "/search", {"query": "first light", "k": 5})
        build_s = time.perf_counter() - t1             # the sharded build + one search
        snap = index.device_snapshot()
        geometry = {"dtype": snap["dtype"], "shards": len(snap["vectors"]),
                    "shard_rows": snap["shard_rows"], "n_pad": snap["n_pad"],
                    "mode": index.effective_search_mode(n // SHARD_COUNT)}
        if (geometry["dtype"] != "int8" or geometry["mode"] != "exact"
                or {str(v.device) for v in snap["vectors"]} != {"cuda:0"}):
            raise AssertionError(f"unexpected sharded flat geometry {geometry}")
        queries = texts + [f"{w} tale of the {w} keeper" for w in (
            "harbor", "falcon", "orchard", "winter", "glass", "copper", "meadow", "canyon")]
        queries = (queries * 3)[:32]
        windows, lat = [], []
        for i, qtext in enumerate(queries):              # one window a request
            before = _read_counters()["exact"]
            t1 = time.perf_counter()
            r = _http(cfg.port, "POST", "/search", {"query": f"{qtext} #{i}"
                                                    if i >= 4 else qtext, "k": 5})
            lat.append((time.perf_counter() - t1) * 1e3)
            windows.append(_read_counters()["exact"] - before)
            if i < 4 and r["hits"][0]["id"] != saved[i]:
                raise AssertionError(f"saved doc {i} is not its own top hit: {r['hits'][0]}")
            assert r["hits"] and all(math.isfinite(h["score"]) for h in r["hits"])
        if min(windows) < SHARD_COUNT:
            raise AssertionError(f"#1 launched {windows} times a window: fewer than one "
                                 f"launch a shard")
        http_counts = _read_counters()
        # a new version of doc 0: the old row dies by a shard-local kill
        kills0, rebuilds0 = (index.snapshot_stats["incremental_kills"],
                             index.snapshot_stats["full_rebuilds"])
        owner = (n + 0) // snap["shard_rows"]
        ns_before = snap["ns"]
        new_id = _http(cfg.port, "POST", "/docs/save",
                       {"title": "Shard doc 0", "content": _doc_text(90),
                        "metadata": {"namespace": "smoke"}})["id"]
        t1 = time.perf_counter()
        while index.get(new_id) is None or index.get(saved[0]) is not None:
            if time.perf_counter() - t1 > 600:
                raise TimeoutError("the re-save was not indexed")
            time.sleep(0.1)
        resave_s = time.perf_counter() - t1
        old_hits = [h["id"] for h in _http(cfg.port, "POST", "/search",
                                           {"query": texts[0], "k": 10})["hits"]]
        top_new = _http(cfg.port, "POST", "/search", {"query": _doc_text(90), "k": 3})
        snap2 = index.device_snapshot()
        touched = [s_ for s_ in range(SHARD_COUNT) if snap2["ns"][s_] is not ns_before[s_]]
        if (saved[0] in old_hits or top_new["hits"][0]["id"] != new_id
                or index.snapshot_stats["incremental_kills"] - kills0 != 1
                or index.snapshot_stats["full_rebuilds"] != rebuilds0 or touched != [owner]):
            raise AssertionError(f"shard-local kill: old hits {old_hits[:3]}, top "
                                 f"{top_new['hits'][0]['id']}, touched shards {touched} "
                                 f"(owner {owner}), {index.snapshot_stats}")

        # in process: recall against f32 exact, ids against the plain scans
        def recall(res):
            got = [[int(i[4:]) for i in ids if i.startswith("syn-")] for ids in res.ids]
            return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(got, truth)]))

        before = _read_counters()
        t1 = time.perf_counter()
        res = index.search(q, k)
        q64_ms = (time.perf_counter() - t1) * 1e3
        one = [index.search(q[i:i + 1], k) for i in range(8)]
        counts_q = {name: v - before[name] for name, v in _read_counters().items()}
        with _plain_scans():
            plain = index.search(q, k)
            plain_one = [index.search(q[i:i + 1], k) for i in range(8)]
        ties = _tie_check(res, plain, "sharded flat") + sum(
            _tie_check(a, b, "sharded flat q 1") for a, b in zip(one, plain_one))
        exact_recall = recall(res)
        if exact_recall < 0.99:
            raise AssertionError(f"sharded flat recall@10 {exact_recall} < 0.99")
        # the same snapshot bucketed: #3 on every shard, the plain rule
        index.search_mode = "bucketed"
        before = _read_counters()["bucketed"]
        bres = index.search(q, k)
        if _read_counters()["bucketed"] - before < SHARD_COUNT:
            raise AssertionError("the bucketed search did not launch #3 on every shard")
        with _plain_scans():
            bplain = index.search(q, k)
        bties = _tie_check(bres, bplain, "sharded bucketed")
        index.search_mode = "auto"
        counts = _read_counters()
        g = torch.Generator(device="cuda").manual_seed(SEED + 9)
        rows = [_shard_scan_row(snap2["vectors"][0], snap2["scales"][0], snap2["ns"][0],
                                snap2["canon"][0], nq_, 40, g) for nq_ in (1, 8)]
    SHARD_ROWS.extend(rows)
    rows_view = index._vectors[:n]
    del index, engine, snap, snap2
    torch.cuda.empty_cache()
    by_shards = _shard_windows(rows_view, q)
    return {"rows": n, "geometry": geometry, "corpus_and_truth_s": gen_s,
            "docs_index_s": save_s, "build_and_first_search_s": build_s,
            "search_ms": lat, "search_ms_p50": statistics.median(lat),
            "exact_launches_per_window": windows, "resave_indexed_s": resave_s,
            "q64_search_ms": q64_ms, "recall_at_10": exact_recall,
            "ids_differing_from_plain_in_ties": ties,
            "bucketed": {"recall_at_10": recall(bres), "ids_differing_from_plain_in_ties": bties},
            "launches_http": http_counts, "launches_in_process": counts_q,
            "launches": counts, "persist": "off", "windows_by_shard_count": by_shards}


def _shard_windows(rows, q) -> list[dict]:
    """The same rows as 1, 2 and 4 shards of cuda:0, each searched exactly
    (int8, k 10 -> k_scan 40, the host refine) at q 1 and q 8 under
    torch.profiler: wall and device ms of one window, and #1's share.  The
    counters are read after this, so these launches are not the path's."""
    import torch

    from kernel_ab import _profile
    from tpu_rag_torch.parallel import ShardedFlatIndex, mesh_from_spec

    n, d = rows.shape
    out = []
    for shards in (1, 2, SHARD_COUNT):
        index = ShardedFlatIndex(d, mesh=mesh_from_spec("", ["cuda:0"] * shards),
                                 dtype="int8", search_mode="exact")
        index._bulk_adopt_rows(rows, (f"syn-{i}" for i in range(n)),
                               (("", {}) for _ in range(n)), count=n)
        t0 = time.perf_counter()
        index.device_snapshot()
        torch.cuda.synchronize()
        row = {"shards": shards, "build_s": time.perf_counter() - t0}
        for nq in (1, 8):
            prof = _profile(lambda nq=nq: index.search(q[:nq], 10))
            scan = sum(v for key, v in prof["by_kernel_ms"].items() if "scan_kernel" in key)
            row[f"q{nq}"] = {"wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                             "scan_ms": scan,
                             "device_idle_share": max(0.0, 1 - prof["device_ms"] / prof["wall_ms"])}
        out.append(row)
        del index
        torch.cuda.empty_cache()
    return out


def _shard_ivf() -> dict:
    """ShardedIVFIndex over SHARD_IVF_ROWS x 384 int8: 64 perturbed rows one
    at a time and as one batch (#6 on every shard either way), recall@10
    against f32 exact, ids against the plain probes, and a main-list and an
    overflow row killed in place."""
    import numpy as np
    import torch

    from tpu_rag_torch.parallel import ShardedIVFIndex, mesh_from_spec

    n, d, nq, k = SHARD_IVF_ROWS, 384, 64, 10
    x, q, _base = _ivf_corpus(n, d, nq, SEED + 8)
    truth = torch.topk(torch.from_numpy(q).cuda() @ torch.from_numpy(x).cuda().T, k,
                       dim=1).indices.cpu().numpy()
    torch.cuda.empty_cache()
    mesh = mesh_from_spec("", ["cuda:0"] * SHARD_COUNT)
    index = ShardedIVFIndex(d, mesh=mesh, dtype="int8", nlist=SHARD_IVF_NLIST,
                            nprobe=SHARD_IVF_NPROBE, list_cap_factor=2.0,
                            master_backing="ram")
    index._bulk_adopt_rows(x, (f"syn-{i}" for i in range(n)), (("", {}) for _ in range(n)),
                           count=n)
    del x
    t0 = time.perf_counter()
    snap = index.device_snapshot()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    geometry = {"nlist": snap["nlist"], "cap": snap["cap"], "ov_cap": snap["ov_cap"],
                "shards": len(snap["vec_lists"]),
                "overflow_rows": int((index._s_ov_of >= 0).sum())}

    def recall(id_lists):
        got = [[int(i[4:]) for i in ids] for ids in id_lists]
        return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(got, truth)]))

    def routes():
        one = [index.search(q[i:i + 1], k) for i in range(nq)]
        assert index.last_probe_route == "per_list"
        per_search = []
        for i in range(4):
            before = _read_counters()["per_list"]
            index.search(q[i:i + 1], k)
            per_search.append(_read_counters()["per_list"] - before)
        batch = index.search(q, k)
        assert index.last_probe_route == "per_list"
        return one, batch, per_search

    _reset_counters()
    t0 = time.perf_counter()
    one, batch, per_search = routes()
    routes_s = time.perf_counter() - t0
    counts = _read_counters()
    with _plain_probes():
        p_one, p_batch, _ = routes()
    if _read_counters() != counts:
        raise AssertionError("the plain sharded IVF run launched a probe kernel")
    if min(per_search) < SHARD_COUNT:
        raise AssertionError(f"#6 launched {per_search} times a search: fewer than one a shard")
    ties = _tie_check(batch, p_batch, "sharded ivf q 64") + sum(
        _tie_check(a, b, "sharded ivf q 1") for a, b in zip(one, p_one))
    rec1, rec64 = recall([r.ids[0] for r in one]), recall(batch.ids)
    if min(rec1, rec64) < 0.95:
        raise AssertionError(f"sharded IVF recall@10 {rec1} (q 1), {rec64} (q 64) < 0.95")
    # kills: one main-list row and one overflow row, in place
    main_row = next(r for r in batch.rows[0] if index._s_slot_of[r] >= 0)
    ov_rows = np.flatnonzero(index._s_ov_of >= 0)
    victims = [f"syn-{main_row}"] + ([f"syn-{int(ov_rows[0])}"] if len(ov_rows) else [])
    vec_of = {v: np.asarray(index.get(v)["vector"]) for v in victims}
    index.delete(ids=victims)
    after = index.search(np.stack(list(vec_of.values())), k)
    if any(v in ids for v in victims for ids in after.ids) or \
            index.snapshot_stats["full_rebuilds"] != 1:
        raise AssertionError(f"sharded IVF kills: {victims} in {after.ids}, "
                             f"{index.snapshot_stats}")
    SHARD_ROWS.append(_shard_probe_row(snap, 0, torch.from_numpy(q[:1]).cuda(), 40,
                                       SHARD_IVF_NPROBE))
    del index, snap
    torch.cuda.empty_cache()
    return {"rows": n, "geometry": geometry, "build_s": build_s, "routes_s": routes_s,
            "recall_at_10": {"q1": rec1, "q64": rec64},
            "plain_recall_at_10": {"q1": recall([r.ids[0] for r in p_one]),
                                   "q64": recall(p_batch.ids)},
            "ids_differing_from_plain_in_ties": ties, "per_list_launches_per_search": per_search,
            "killed": victims, "launches": counts}


_DIST_WORKER = """
import json, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
from tpu_rag_torch.ops import topk as tk
from tpu_rag_torch.parallel.distributed import load_sharded_flat_distributed, maybe_init_distributed

t0 = time.perf_counter()
assert maybe_init_distributed(backend="gloo", device="cuda")
idx = load_sharded_flat_distributed({store!r}, dtype="bfloat16", device="cuda")
load_s = time.perf_counter() - t0
snap = idx.device_snapshot()
q = np.load({queries!r})
tk._exact_scan_cuda.launches = 0
res = idx.search(q, 10)
print("RESULT " + json.dumps({{"rank": dist.get_rank(), "world": dist.get_world_size(),
      "backend": dist.get_backend(), "ids": res.ids, "sims": res.similarities,
      "row0": snap["row0"], "rows": sum(int(t.shape[0]) for t in snap["vectors"]),
      "devices": [str(t.device) for t in snap["vectors"]], "n_pad": snap["n_pad"],
      "exact_launches": tk._exact_scan_cuda.launches, "load_s": load_s}}), flush=True)
dist.destroy_process_group()
"""


def _shard_distributed(work: Path) -> dict:
    """Two processes on cuda:0 join a gloo group (NCCL takes one card a
    rank), each loads its half of a saved SHARD_DIST_ROWS x 384 bf16 store
    and answers the same 8 queries; both must give a single-process
    load_index's ids (refined on the host, as the distributed index is)."""
    import numpy as np

    from tpu_rag_torch.index.flat import FlatIndex
    from tpu_rag_torch.index.store import load_index, save_index

    n, d = SHARD_DIST_ROWS, 384
    x = _unit_rows(n, d, SEED + 11)
    store = FlatIndex(d, dtype="bfloat16", device="cuda")
    store._bulk_adopt_rows(x, (f"d-{i}" for i in range(n)), (("", {}) for _ in range(n)),
                           count=n)
    t0 = time.perf_counter()
    save_index(store, work / "dist_store")
    save_s = time.perf_counter() - t0
    del store
    rng = np.random.default_rng(SEED + 12)
    q = x[rng.choice(n, 8, replace=False)] + 0.02 * rng.standard_normal((8, d), dtype=np.float32)
    del x
    np.save(work / "dist_queries.npy", q.astype(np.float32))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = _DIST_WORKER.format(repo=str(REPO), store=str(work / "dist_store"),
                               queries=str(work / "dist_queries.npy"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "MASTER_ADDR": "127.0.0.1",
                                   "MASTER_PORT": str(port), "WORLD_SIZE": "2",
                                   "RANK": str(rank)})
             for rank in (0, 1)]
    outs = []
    try:
        for pr in procs:
            out, err = pr.communicate(timeout=300)
            if pr.returncode != 0:
                raise AssertionError(f"distributed worker exit {pr.returncode}:\n{err[-3000:]}")
            outs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    workers_s = time.perf_counter() - t0
    results = sorted((json.loads(ln[len("RESULT "):]) for out in outs
                      for ln in out.splitlines() if ln.startswith("RESULT ")),
                     key=lambda r: r["rank"])
    single = load_index(work / "dist_store", device="cuda")
    single.device_refine = False             # refined on the host, as the shards are
    want = single.search(q, 10)
    del single
    if [r["rank"] for r in results] != [0, 1] or any(r["backend"] != "gloo" for r in results):
        raise AssertionError(f"distributed workers: {results}")
    for r in results:
        if r["ids"] != want.ids or r["exact_launches"] < 1 or r["devices"] != ["cuda:0"]:
            raise AssertionError(f"rank {r['rank']}: ids {r['ids'][:1]} against "
                                 f"{want.ids[:1]}, #1 launched {r['exact_launches']}")
    if results[0]["ids"] != results[1]["ids"]:
        raise AssertionError("the two ranks disagree")
    return {"rows": n, "store_save_s": save_s, "workers_s": workers_s,
            "ranks": [{k_: r[k_] for k_ in ("rank", "row0", "rows", "n_pad", "devices",
                                           "exact_launches", "load_s")} for r in results],
            "ids_equal_single_process": True, "backend": "gloo",
            "nccl": "not run: NCCL takes one card a rank, and this machine has one card; "
                    "the two ranks share cuda:0 over gloo"}


def _start_rehearse_100m(work: Path):
    """rehearse_100m in a process of its own (a clean anonymous-RSS
    baseline), beside the other parts of the phase."""
    out = open(work / "rehearse_100m.out", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_rag_torch.scripts.rehearse_100m", "--device", "cuda",
         "--shards", "8", "--rows", str(REHEARSE_100M_ROWS), "--dim", "384",
         "--workdir", str(work / "rehearse_100m")],
        cwd=str(REPO), stdout=out, stderr=subprocess.STDOUT, text=True)
    return proc, out


def phase_shard(work: Path) -> dict:
    """The sharded serving path on SHARD_COUNT shards of cuda:0 (module
    comment above): flat over HTTP, IVF, two gloo processes, and
    rehearse_100m, which runs in its own process from the start."""
    t0 = time.perf_counter()
    proc, out = _start_rehearse_100m(work)
    try:
        parts, seconds = {}, {}
        for name, run in (("flat", lambda: _shard_flat(work)), ("ivf", _shard_ivf),
                          ("distributed", lambda: _shard_distributed(work))):
            t1 = time.perf_counter()
            _reset_counters()
            parts[name] = run()
            seconds[name] = time.perf_counter() - t1
        t1 = time.perf_counter()
        rc = proc.wait(timeout=900)
        seconds["rehearse_100m_wait"] = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out.seek(0)
    text = out.read()
    out.close()
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    rep = json.loads(lines[-1]) if lines else {"error": text[-3000:]}
    parts["rehearse_100m"] = rep
    seconds["rehearse_100m_total"] = time.perf_counter() - t0
    counts = {name: parts["flat"]["launches"][name] + parts["ivf"]["launches"][name]
              for name in parts["flat"]["launches"]}
    emit({"phase": "shard", "shards": SHARD_COUNT, "device": "cuda:0", "seconds": seconds,
          **parts, "launches": counts})
    if (rc != 0 or not rep.get("passed") or rep.get("device_bytes_in_budget")
            or rep.get("rss_anon_peak_mb", 0) <= 0):
        raise AssertionError(f"rehearse_100m (exit {rc}) did not pass on the card: {rep}")
    return counts


# tp: data x tensor parallel on TP_MESH, cuda:0 named once a mesh entry
# (the ranks and data positions run one after another).  Serving: bge-base
# (768 wide, 12 heads of 64: 6 a rank) over TP_ROWS bf16 rows in two data
# shards, behind the HTTP server (TP_DOCS /docs/save, TP_QUERIES /search at
# k 5); an embed-only check at model:4 (3 heads a rank) over TP_M4_DOCS at
# T 256.  Training: MiniLM-L6 at batch TP_BATCH, T TP_D_LEN / TP_Q_LEN:
# TP_PARITY_STEPS f32 steps against the unsharded trainer from one init
# (losses within TP_LOSS_RTOL relative, parameters within TP_PARAM_TOL, the
# key biases within Adam's bound of the start: their true gradient is
# zero), then TP_TRAIN_STEPS bf16 steps over seeded batches whose queries
# are drawn from their documents' tokens, and TP_TIMED_STEPS of the
# unsharded step beside them.  Embeddings: TP against unsharded on the card
# at cosine >= TP_COS_CARD per row, against the CPU's f32 forward at
# >= TP_COS_CPU (the train phase's tolerance)
TP_MESH, TP_MODEL = "data:2,model:2", "BAAI/bge-base-en-v1.5"
TP_ROWS, TP_DOCS, TP_QUERIES, TP_M4_DOCS = 1_000_000, 64, 32, 256
TP_BATCH, TP_Q_LEN, TP_D_LEN, TP_LR = 512, 48, 128, 1e-4
TP_PARITY_STEPS, TP_TRAIN_STEPS, TP_TIMED_STEPS = 3, 30, 10
# parameters: half of one Adam step (an element that stepped the other way
# once would be 2 lr apart); at MiniLM's width on the CPU (2 layers, batch
# 64) they stayed within 0.08 lr
TP_LOSS_RTOL, TP_PARAM_TOL = 1e-4, TP_LR / 2
TP_COS_CARD, TP_COS_CPU = 0.999, 0.99


def _cos_min(a, b) -> float:
    """The least cosine of two row-aligned sets of unit rows."""
    import numpy as np

    return float(np.min(np.sum(np.asarray(a) * np.asarray(b), axis=1)))


def _tp_serve(work: Path) -> dict:
    """bge-base served data x tensor parallel over HTTP (module comment
    above), its launches counted; then its embeddings against the
    unsharded encoder on the card and the CPU's f32 forward, and the
    model:4 embed."""
    import torch

    from tpu_rag_torch.config import Config
    from tpu_rag_torch.engine import RagEngine
    from tpu_rag_torch.models.bert import TensorParallelEncoder
    from tpu_rag_torch.models.biencoder import BiEncoder, spec_for_model
    from tpu_rag_torch.models.hf_export import write_safetensors
    from tpu_rag_torch.parallel import ShardedFlatIndex, mesh_from_spec

    spec, seconds = spec_for_model(TP_MODEL), {}
    t0 = time.perf_counter()
    bi_dir = work / "bge-base"
    bi_dir.mkdir()
    write_safetensors(bi_dir / "model.safetensors",
                      _seeded_checkpoint(_hf_bert_shapes(spec), SEED + 13))
    mesh = mesh_from_spec(TP_MESH, ["cuda:0"] * 4)
    encoder = BiEncoder(TP_MODEL, weights_path=str(bi_dir), device="cuda", mesh=mesh)
    ranks = [s.layers[0].attention.heads for s in encoder.module.shards]
    if (not isinstance(encoder.module, TensorParallelEncoder) or len(encoder._groups) != 2
            or ranks != [spec.heads // 2] * 2):
        raise AssertionError(f"the encoder on {TP_MESH} is not 2 groups of 2 ranks: "
                             f"{type(encoder.module).__name__}, {ranks}")
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x = torch.randn((TP_ROWS, spec.hidden), generator=g, device="cuda")
    x = torch.nn.functional.normalize(x, dim=1).cpu().numpy()
    index = ShardedFlatIndex(spec.hidden, mesh=mesh, dtype="bfloat16", search_mode="exact",
                             master_backing="ram")
    index._bulk_adopt_rows(x, (f"syn-{i}" for i in range(TP_ROWS)),
                           (("", {}) for _ in range(TP_ROWS)), count=TP_ROWS)
    del x
    seconds["setup"] = time.perf_counter() - t0
    cfg = Config(persist_dir=str(work / "vs"), kb_db_path=str(work / "db" / "kb.sqlite3"),
                 db_path=str(work / "db" / "app.sqlite3"), docs_dir=str(work / "docs"),
                 embedding_model=TP_MODEL, embedding_weights=str(bi_dir), mesh_shape=TP_MESH,
                 model_priority=("extractive",), summarize_mode="off", host="127.0.0.1",
                 device="cuda")
    engine = RagEngine(cfg, encoder=encoder, index=index)
    engine.indexer.persist_fn = None
    calls = []                                   # the (B, T) of every TP forward
    forward = encoder.forward_ids
    encoder.forward_ids = lambda ids: calls.append(tuple(ids.shape)) or forward(ids)
    texts = [_doc_text(i + 200) for i in range(TP_DOCS)]
    with _served(cfg, engine) as (_app, engine, _health):
        t0 = time.perf_counter()
        saved = [_http(cfg.port, "POST", "/docs/save",
                       {"title": f"TP doc {i}", "content": text,
                        "metadata": {"namespace": "tp"}})["id"]
                 for i, text in enumerate(texts)]
        while index.count() < TP_ROWS + TP_DOCS:
            if time.perf_counter() - t0 > 600:
                raise TimeoutError("background indexing did not finish")
            time.sleep(0.1)
        seconds["docs_index"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _http(cfg.port, "POST", "/search", {"query": "first light", "k": 5})
        seconds["build_and_first_search"] = time.perf_counter() - t0   # the shards' build
        t0 = time.perf_counter()
        windows, lat = [], []
        for i in range(TP_QUERIES):                      # one window a request
            before = _read_counters()["exact"]
            t1 = time.perf_counter()
            r = _http(cfg.port, "POST", "/search", {"query": texts[i], "k": 5})
            lat.append((time.perf_counter() - t1) * 1e3)
            windows.append(_read_counters()["exact"] - before)
            if r["hits"][0]["id"] != saved[i]:
                raise AssertionError(f"saved doc {i} is not its own top hit: {r['hits'][0]}")
        seconds["search"] = time.perf_counter() - t0
        counts = _read_counters()
    encoder.forward_ids = forward
    long_calls = sum(1 for _b, t in calls if t >= 128)
    mha_min = spec.layers * 2 * 2 * long_calls           # layers x ranks x data slices
    if counts["mha"] < mha_min or min(windows) < 2:
        raise AssertionError(f"#5 launched {counts['mha']} times for {long_calls} forwards "
                             f"at T >= 128 (at least {mha_min}); #1 {windows} a window "
                             f"(at least one a data shard)")

    # the same documents through the unsharded encoder on the card and on
    # the CPU in f32 (comparisons: their launches are not the path's)
    t0 = time.perf_counter()
    tp_emb = encoder.embed(texts)
    single = BiEncoder(TP_MODEL, weights_path=str(bi_dir), device="cuda")
    card_emb = single.embed(texts)
    cpu_emb = BiEncoder(TP_MODEL, weights_path=str(bi_dir), device="cpu").embed(texts)
    cos = {"tp_vs_card": _cos_min(tp_emb, card_emb), "tp_vs_cpu_f32": _cos_min(tp_emb, cpu_emb)}
    seconds["compare"] = time.perf_counter() - t0
    del encoder, engine, index
    torch.cuda.empty_cache()

    # model:4: 3 heads a rank, one group, the embed alone
    t0 = time.perf_counter()
    enc4 = BiEncoder(TP_MODEL, weights_path=str(bi_dir), device="cuda",
                     mesh=mesh_from_spec("model:4", ["cuda:0"] * 4))
    docs4 = [_doc_text(i + 1000) for i in range(TP_M4_DOCS)]
    _reset_counters()
    emb4 = enc4.embed(docs4)
    counts4 = _read_counters()
    cos["model4_vs_card"] = _cos_min(emb4, single.embed(docs4))
    seconds["model4"] = time.perf_counter() - t0
    heads4, batch4 = [s.layers[0].attention.heads for s in enc4.module.shards], enc4.batch
    batches4 = -(-TP_M4_DOCS // batch4)
    if heads4 != [spec.heads // 4] * 4 or counts4["mha"] < spec.layers * 4 * batches4:
        raise AssertionError(f"model:4: heads a rank {heads4}, #5 {counts4['mha']} times "
                             f"(at least {spec.layers * 4 * batches4})")
    if not (cos["tp_vs_card"] >= TP_COS_CARD and cos["model4_vs_card"] >= TP_COS_CARD
            and cos["tp_vs_cpu_f32"] >= TP_COS_CPU):
        raise AssertionError(f"TP embeddings: cosines {cos}")
    del enc4, single
    torch.cuda.empty_cache()
    return {"model": TP_MODEL, "mesh": TP_MESH, "rows": TP_ROWS, "docs": TP_DOCS,
            "seconds": seconds, "search_ms": lat, "search_ms_p50": statistics.median(lat),
            "exact_launches_per_window": windows, "tp_forwards": len(calls),
            "tp_forwards_t128_plus": long_calls, "mha_launches_min": mha_min,
            "embed_cos_min": cos, "embed_cos_tolerance": {"card": TP_COS_CARD,
                                                          "cpu_f32": TP_COS_CPU},
            "model4": {"heads_a_rank": heads4, "docs": TP_M4_DOCS, "batch": batch4,
                       "launches": counts4},
            "launches_http": counts,
            "launches": {name: counts[name] + counts4[name] for name in counts}}


def _tp_batches(rng, n: int, vocab: int):
    """Seeded contrastive batches: documents of TP_D_LEN / 2 to TP_D_LEN
    random tokens (pad 0 after), each query TP_Q_LEN tokens drawn from its
    document's, so the pairs can be learned."""
    import numpy as np

    out = []
    for _ in range(n):
        d_ids = rng.integers(1000, vocab, (TP_BATCH, TP_D_LEN))
        lens = rng.integers(TP_D_LEN // 2, TP_D_LEN + 1, TP_BATCH)
        d_mask = (np.arange(TP_D_LEN)[None, :] < lens[:, None]).astype(np.int64)
        d_ids *= d_mask
        pick = (rng.random((TP_BATCH, TP_Q_LEN)) * lens[:, None]).astype(np.int64)
        q_ids = np.take_along_axis(d_ids, pick, axis=1)
        out.append({"q_ids": q_ids, "q_mask": np.ones_like(q_ids), "d_ids": d_ids,
                    "d_mask": d_mask})
    return out


def _tp_train(work: Path) -> dict:
    """The DP x TP contrastive trainer (module comment above)."""
    import numpy as np
    import torch

    from tpu_rag_torch.models.biencoder import BiEncoder, init_params, spec_for_model
    from tpu_rag_torch.parallel import mesh_from_spec
    from tpu_rag_torch.train.contrastive import ContrastiveTrainer

    spec, cuda, seconds = spec_for_model("minilm-l6"), torch.device("cuda:0"), {}
    mesh = mesh_from_spec(TP_MESH, ["cuda:0"] * 4)
    rng = np.random.default_rng(SEED + 15)

    # parity: f32, one init (init_params(spec, SEED) in both)
    t0 = time.perf_counter()
    tp = ContrastiveTrainer(spec, lr=TP_LR, device=cuda, mesh=mesh, seed=SEED)
    ref = ContrastiveTrainer(spec, lr=TP_LR, device=cuda, seed=SEED)
    losses = [(tp.train_step(b), ref.train_step(b))
              for b in _tp_batches(rng, TP_PARITY_STEPS, spec.vocab_size)]
    start = init_params(spec, SEED)
    got, want = tp.module.state_dict(), ref.module.state_dict()
    key_bias = {f"layers.{i}.attention.key.bias" for i in range(spec.layers)}
    param_diff = max(float((got[n] - want[n]).abs().max()) for n in want if n not in key_bias)
    key_moved = max(float((sd[n].cpu() - start[n]).abs().max())
                    for n in key_bias for sd in (got, want))
    loss_rel = max(abs(a - b) / abs(b) for a, b in losses)
    seconds["parity"] = time.perf_counter() - t0
    if not (loss_rel <= TP_LOSS_RTOL and param_diff <= TP_PARAM_TOL
            and key_moved <= TP_PARITY_STEPS * TP_LR * 1.01):
        raise AssertionError(f"DP x TP f32 steps against unsharded: losses {losses} "
                             f"(relative {loss_rel}), parameters {param_diff}, key biases "
                             f"moved {key_moved}")
    del tp, ref, got, want
    torch.cuda.empty_cache()

    # bf16: TP_TRAIN_STEPS timed steps, no kernel launched
    trainer = ContrastiveTrainer(spec, lr=TP_LR, compute_dtype=torch.bfloat16, device=cuda,
                                 mesh=mesh, seed=SEED)
    batches = _tp_batches(rng, TP_TRAIN_STEPS, spec.vocab_size)

    def timed(tr, batch) -> tuple[float, float]:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        loss = tr.train_step(batch)
        b.record()
        b.synchronize()
        return loss, a.elapsed_time(b)

    t0 = time.perf_counter()
    _reset_counters()
    steps = [timed(trainer, b) for b in batches]
    counts = _read_counters()
    seconds["train_bf16"] = time.perf_counter() - t0
    losses_bf16 = [loss for loss, _ms in steps]
    first, last = statistics.mean(losses_bf16[:5]), statistics.mean(losses_bf16[-5:])
    if any(counts.values()) or not (all(map(math.isfinite, losses_bf16)) and last < first):
        raise AssertionError(f"bf16 DP x TP training: launches {counts}, losses first 5 "
                             f"{first}, last 5 {last}")
    t0 = time.perf_counter()
    single = ContrastiveTrainer(spec, lr=TP_LR, compute_dtype=torch.bfloat16, device=cuda,
                                seed=SEED)
    single_ms = [timed(single, b)[1] for b in batches[:TP_TIMED_STEPS + 2]][2:]
    flops = _train_step_flops(single.module, TP_BATCH, TP_Q_LEN, TP_D_LEN)
    del single
    seconds["unsharded_steps"] = time.perf_counter() - t0

    # the gathered checkpoint, served unsharded, against the TP module
    t0 = time.perf_counter()
    ckpt = work / "tp-trained"
    trainer.save(ckpt)
    enc = BiEncoder("minilm-l6-tp-trained", weights_path=str(ckpt), device="cuda",
                    seq_len=TP_D_LEN, batch=64)
    if enc.spec != spec or enc.pad_id != 0:
        raise AssertionError(f"the gathered checkpoint: {enc.spec}, pad id {enc.pad_id}")
    ids = batches[0]["d_ids"][:64]
    served = enc.forward_ids(ids).cpu().numpy()
    with torch.no_grad():
        ids_t = torch.as_tensor(ids, device=cuda)
        tp_emb = trainer._embed(ids_t, (ids_t != 0).to(torch.int64)).cpu().numpy()
    ckpt_cos = _cos_min(served, tp_emb)
    seconds["checkpoint"] = time.perf_counter() - t0
    if not ckpt_cos >= TP_COS_CARD:
        raise AssertionError(f"the gathered checkpoint served unsharded: cosine {ckpt_cos}")
    tp_ms = sorted(ms for _loss, ms in steps[2:])
    return {"model": "minilm-l6", "mesh": TP_MESH, "batch": TP_BATCH, "q_len": TP_Q_LEN,
            "d_len": TP_D_LEN, "lr": TP_LR, "seconds": seconds,
            "parity_f32": {"losses_tp_unsharded": losses, "loss_rel_max": loss_rel,
                           "param_abs_max": param_diff, "key_bias_moved_max": key_moved,
                           "tolerance": {"loss_rel": TP_LOSS_RTOL, "param": TP_PARAM_TOL}},
            "bf16": {"loss_first": losses_bf16[0], "loss_last": losses_bf16[-1],
                     "loss_first5_mean": first, "loss_last5_mean": last,
                     "step_ms_p50": statistics.median(tp_ms), "step_ms_min": tp_ms[0],
                     "unsharded_step_ms_p50": statistics.median(single_ms),
                     "unsharded_step_ms_min": min(single_ms),
                     "step_tflop": flops / 1e12,
                     "bf16_peak_share": flops / (statistics.median(tp_ms) / 1e3)
                                        / PEAK_OPS_S["bf16"]},
            "training_launches": counts, "checkpoint_cos_min_unsharded_vs_tp": ckpt_cos}


def phase_tp(work: Path) -> dict:
    """Data x tensor parallel serving and training on TP_MESH of cuda:0
    (module comment above TP_MESH)."""
    t0 = time.perf_counter()
    serve = _tp_serve(work)
    t1 = time.perf_counter()
    train = _tp_train(work)
    emit({"phase": "tp", "device": "cuda:0", "seconds": {"serve": t1 - t0,
                                                        "train": time.perf_counter() - t1},
          "serve": serve, "train": train})
    return serve["launches"]



# ------------------------------------------------------------------ ModernBERT attention
MBERT_SHAPE = (32, 4096, 16, 64)              # B, T, H, D of the train-4k cell's documents
MBERT_TRAFFIC = REPO / "perfbench" / "traffic" / "train-4k.json"


def _mbert_lengths(b: int, t: int, seed: int) -> list[int]:
    """Document rows as train_semantic's sampler draws them in the train-4k
    cell: a body drawn from the traffic's measured lengths (cut at its
    8,192), cropped to a width uniform in 32..t - 2, plus [CLS] and [SEP]."""
    import numpy as np

    spec = json.loads(MBERT_TRAFFIC.read_text())["body_tokens"]
    rng = np.random.default_rng(seed)
    qs = np.asarray(spec["quantiles"], np.float64)
    bodies = np.minimum(np.interp(rng.random(b) * 100, np.arange(101), qs), spec["max"])
    widths = rng.integers(32, t - 1, b)
    return [int(min(n, w)) + 2 for n, w in zip(bodies.astype(np.int64), widths)]


def _mbert_rel(a, e, real) -> float:
    return float((a[real] - e[real]).norm() / e[real].norm().clamp_min(1e-30))


def _mbert_row(q, k, v, do, lengths, window, what: str) -> dict:
    """The kernels against the plain version (f32 on the same inputs: each
    output and gradient within 2x the plain version's own bf16 error +
    1e-3, relative, over the real rows; pad rows exactly 0), then forward
    and backward timed beside their bound over the visited tiles, the
    plain version and the library's fused attention on the same call."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tpu_rag_torch.ops import ragged_attention as ra

    b, t, h, d = q.shape
    w = -1 if window is None else window
    real = torch.arange(t, device=q.device)[None, :] < lengths[:, None]

    def grads(fn, dtype):
        xs = [x.detach().to(dtype).requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs)
        return [out.detach().float()] + [g.float() for g in torch.autograd.grad(out, xs, do.to(dtype))]

    got = grads(lambda *x: ra.ragged_attention(*x, lengths, window), torch.bfloat16)
    lib = grads(lambda *x: ra.ragged_attention_plain(*x, lengths, window), torch.bfloat16)
    want = grads(lambda *x: ra.ragged_attention_plain(*x, lengths, window), torch.float32)
    errs = {}
    for name, a, lb, e in zip(("o", "dq", "dk", "dv"), got, lib, want):
        err, lib_err = _mbert_rel(a, e, real), _mbert_rel(lb, e, real)
        pad = float(a[~real].abs().max()) if (~real).any() else 0.0
        errs[name] = {"rel_err": err, "library_rel_err": lib_err}
        if not (err <= 2 * lib_err + 1e-3 and pad == 0.0 and bool(torch.isfinite(a).all())):
            raise AssertionError(f"ragged attention {what} {name}: {err} against the library's "
                                 f"{lib_err}, pad rows {pad}")
    del got, lib, want

    lens = lengths.tolist()
    slots = h * ra.visited_slots(lens, t, window)
    real_pairs = h * sum(n * n if window is None else
                         n * n - max(n - window - 1, 0) * max(n - window, 0) for n in lens)
    o, lse = ra._forward_cuda(q, k, v, lengths, w)
    # the bound is the function's own work: 2 products forward and 5
    # backward over the real pairs; q, k, v (o, dO) read on the real rows,
    # o (dq, dk, dv) written over all of T, the log-sum-exp (f32) written
    # for every row and read back for the real ones
    fwd_ops, bwd_ops = 4.0 * d * real_pairs, 10.0 * d * real_pairs
    row_bytes, real_rows = h * d * q.element_size(), sum(lens)
    fwd_bytes = (3 * real_rows + b * t) * row_bytes + b * h * t * 4
    bwd_bytes = (5 * real_rows + 3 * b * t) * row_bytes + real_rows * h * 4
    fb_ms, fb_by = bound(fwd_bytes, fwd_ops, "bf16")
    bb_ms, bb_by = bound(bwd_bytes, bwd_ops, "bf16")

    def fwd():
        return ra._forward_cuda(q, k, v, lengths, w)

    def bwd():
        return ra._backward_cuda(q, k, v, o, do, lse, lengths, w)

    def plain_fwd():
        return ra.ragged_attention_plain(q, k, v, lengths, window)

    mask = real.to(torch.int32)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        bias = ra.key_bias(mask, q.dtype)

        def lib_fwd():      # the library's fused attention as the port called it before
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
    else:
        bias = ra.band_bias(mask, window, q.dtype)

        def lib_fwd():
            return ra.band_attention(q, k, v, bias, window)

    def fwd_bwd(fn):
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def call():
            out = fn(*xs)
            torch.autograd.grad(out, xs, do if out.shape == do.shape else do.transpose(1, 2))
        return call

    if window is None:
        lib_step = fwd_bwd(lambda a, b_, c: F.scaled_dot_product_attention(
            a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2), attn_mask=bias))
    else:
        lib_step = fwd_bwd(lambda a, b_, c: ra.band_attention(a, b_, c, bias, window))
    row = {"name": f"ragged_attention[{what},B={b},T={t},H={h},D={d},"
                   f"window={window}]",
           "source": "tpu_rag_torch/csrc/ragged_attention.cu", "replaces": None,
           "mean_length": float(np.mean(lens)), "errors": errs,
           "visited_slots": slots, "real_pairs": real_pairs,
           "waste_pct": 100.0 * (1 - real_pairs / slots),
           "forward": {"ms": cuda_ms(fwd), **_device_ms(fwd, "ragged_fwd_kernel", fb_ms),
                       "bound_ms": fb_ms, "bound_by": fb_by,
                       "plain_ms": cuda_ms(plain_fwd), "library_ms": cuda_ms(lib_fwd),
                       "library_device_ms": cuda_ms(lib_fwd, iters=5, batch=10)},
           "backward": {"ms": cuda_ms(bwd), **_device_ms(bwd, "ragged_d", bb_ms),
                        "bound_ms": bb_ms, "bound_by": bb_by,
                        "library_fwd_bwd_ms": cuda_ms(lib_step, iters=5, batch=5)}}
    for part, products in (("forward", 2), ("backward", 5)):
        ms = row[part]["device_ms"]
        row[part]["tflops_on_visited"] = 2.0 * products * d * slots / ms / 1e9
        row[part]["tflops_on_real_pairs"] = 2.0 * products * d * real_pairs / ms / 1e9
    return row


def _mbert_train_steps(steps: int = 4) -> dict:
    """ModernBERT-large's training step at the train-4k cell's shape (B 32,
    queries of T 64, documents of T 4,096 at the traffic's lengths, a new
    draw each step) through ContrastiveTrainer on the card: one eager
    step, one captured (and replayed), the rest replayed.  The attention
    kernels' host launches and device runs over those steps, counted from
    just before them, must be 28 layers x 2 towers x (forward + recompute)
    forward runs and 28 x 2 backward runs a step (the banded forward runs
    on the 18 local layers), the runs every step and the launches the
    eager and the capturing one's; fails where they differ or are 0."""
    import numpy as np
    import torch

    from tpu_rag_torch.models.biencoder import MODEL_SPECS
    from tpu_rag_torch.ops import ragged_attention as ra
    from tpu_rag_torch.train.contrastive import ContrastiveTrainer
    from tpu_rag_torch.utils.metrics import GLOBAL_METRICS

    spec = MODEL_SPECS["modernbert-large"]
    b, td = MBERT_SHAPE[:2]
    tq = 64
    dev = torch.device("cuda")
    with torch.device("meta"):
        shapes = {n: x.shape for n, x in spec.encoder().state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(SEED)
    # drawn on the card: products N(0, 1 / fan-in), norms' scales 1
    weights = {n: torch.randn(s, generator=g, device=dev) * s[-1] ** -0.5 if len(s) > 1
               else torch.ones(s, device=dev) for n, s in shapes.items()}
    trainer = ContrastiveTrainer(spec, lr=1e-4, compute_dtype=torch.bfloat16, device=dev,
                                 state_dict=weights)
    del weights
    rng = np.random.default_rng(SEED)

    def batch(step: int) -> dict:
        out = {}
        for side, t, lens in (("q", tq, rng.integers(4, tq + 1, b)),
                              ("d", td, _mbert_lengths(b, td, SEED + 1 + step))):
            mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.int64)
            out[f"{side}_ids"] = rng.integers(5, spec.vocab_size, (b, t)) * mask
            out[f"{side}_mask"] = mask
        return out

    batches = [batch(i) for i in range(steps)]
    steps_kept = ("train_eager_steps_total", "train_graph_captures_total",
                  "train_graph_replays_total")
    attn = ("attn_local_key_slots_total", "attn_global_key_slots_total", "attn_real_pairs_total")
    torch.cuda.synchronize(dev)
    c0 = [GLOBAL_METRICS.counter(n) for n in steps_kept + attn]
    host0 = (ra._forward_cuda.launches, ra._backward_cuda.launches,
             ra._forward_cuda.banded_launches)
    runs0 = ra.device_runs(dev)
    losses, times = [], []
    for x in batches:
        t0 = time.perf_counter()
        losses.append(trainer.train_step(x))        # reads the loss back: a whole step
        times.append(time.perf_counter() - t0)
    eager, captured, replayed, local, glob, real = (
        GLOBAL_METRICS.counter(n) - c for n, c in zip(steps_kept + attn, c0))
    launches = dict(zip(("forward", "backward", "banded"),
                        (a - z for a, z in zip((ra._forward_cuda.launches,
                                                ra._backward_cuda.launches,
                                                ra._forward_cuda.banded_launches), host0))))
    runs = {k: v - runs0[k] for k, v in ra.device_runs(dev).items()}
    n_local = sum(not spec.is_global(i) for i in range(spec.layers))
    per_step = {"forward": 2 * spec.layers * 2, "backward": 2 * spec.layers,
                "banded": 2 * n_local * 2}
    want_runs = {k: n * (eager + replayed) for k, n in per_step.items()}
    want_launches = {k: n * (eager + captured) for k, n in per_step.items()}
    out = {"steps": {"eager": eager, "captured": captured, "replayed": replayed},
           "launches": launches, "device_runs": runs, "expected_launches": want_launches,
           "expected_device_runs": want_runs, "losses": losses, "step_s": times,
           "attn_waste_pct": 100.0 * (1 - real / (local + glob))}
    del trainer
    torch.cuda.empty_cache()
    if (runs != want_runs or launches != want_launches or replayed == 0
            or min(runs.values()) == 0 or not all(np.isfinite(losses))):
        raise AssertionError(f"ModernBERT's training steps and the attention kernels: {out}")
    return out


def phase_mbert_attn() -> dict:
    """ModernBERT's attention kernels at the train-4k cell's document
    shape, global and banded (w 64), on rows of the traffic's lengths and
    on all-real rows, beside the library's fused attention at full length
    (no mask: its fastest path) as the rate to hold the kernels to; the
    kernels' nvcc build seconds where this process built them; then the
    cell's training step itself (_mbert_train_steps).  Fails at 0
    launches, and where the trainer's steps did not run the kernels as
    many times as its layers ask."""
    import torch
    import torch.nn.functional as F

    from tpu_rag_torch import _build
    from tpu_rag_torch.ops import ragged_attention as ra

    b, t, h, d = MBERT_SHAPE
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = (torch.randn((b, t, h, d), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    t0 = time.perf_counter()
    _build.load(ra.LIBRARY)
    load_s = time.perf_counter() - t0
    launches0 = (ra._forward_cuda.launches, ra._backward_cuda.launches)
    ragged = torch.tensor(_mbert_lengths(b, t, SEED), dtype=torch.int32, device=dev)
    full = torch.full((b,), t, dtype=torch.int32, device=dev)
    rows = [_mbert_row(q, k, v, do, lens, window, what)
            for what, lens in (("traffic", ragged), ("all_real", full))
            for window in (None, 64)]
    # the library at full length, no mask: 4 B H T^2 D operations forward,
    # 2.5x that forward and backward (5 products)
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    xs = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]

    def dense_step():
        torch.autograd.grad(F.scaled_dot_product_attention(*xs), xs, doh)

    dense_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=5, batch=10)
    dense_step_ms = cuda_ms(dense_step, iters=5, batch=5)
    ops = 4.0 * b * h * t * t * d
    library = {"forward_ms": dense_fwd, "forward_tflops": ops / dense_fwd / 1e9,
               "backward_ms": dense_step_ms - dense_fwd,
               "backward_tflops": 2.5 * ops / (dense_step_ms - dense_fwd) / 1e9}
    full_global = rows[2]
    ratio = {part: full_global[part]["tflops_on_visited"] / library[f"{part}_tflops"]
             for part in ("forward", "backward")}
    launches = (ra._forward_cuda.launches - launches0[0], ra._backward_cuda.launches - launches0[1])
    runs = ra.device_runs(dev)
    if min(launches) == 0 or min(runs["forward"], runs["backward"]) == 0:
        raise AssertionError(f"ragged attention launched {launches}, ran {runs}")
    del q, k, v, do, qh, kh, vh, doh, xs
    torch.cuda.empty_cache()
    train = _mbert_train_steps()
    emit({"phase": "mbert_attn", "rows": rows, "library_full_length": library,
          "rate_over_library_at_full_length": ratio,
          "build_s": _build.build_seconds.get(ra.LIBRARY), "load_s": load_s,
          "launches": {"forward": launches[0], "backward": launches[1]},
          "device_runs": runs, "train_steps": train})
    return {"ragged_fwd": launches[0] + train["launches"]["forward"],
            "ragged_bwd": launches[1] + train["launches"]["backward"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    all_phases = ("build,kernels,serve,scale,ivf,host_ivf,train,scripts,rehearse,shard,tp,"
                  "mbert_attn,rerank_train")
    ap.add_argument("--phases", default=all_phases,
                    help=f"comma-separated subset of {all_phases}; rerank_train and "
                         f"scripts read what train writes")
    ap.add_argument("--save-masks", metavar="PATH",
                    help="save the first masks of each shape that bf16 #5 is given "
                         "in each phase (torch.save) for kernel_ab.py --masks")
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(all_phases.split(","))
    if unknown or ({"rerank_train", "scripts"} & set(phases) and "train" not in phases):
        ap.error(f"unknown phases {sorted(unknown)}, or rerank_train/scripts without train")
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
    with contextlib.ExitStack() as stack:
        if {"train", "rehearse"} & set(phases):
            corpus_dir = stack.enter_context(tempfile.TemporaryDirectory(
                prefix="chip_smoke_corpus_", dir=REPO / "build"))
            corpus = stack.enter_context(_CorpusJob(Path(corpus_dir)))
        if "scripts" in phases:
            hnsw = stack.enter_context(_HnswJob())
        if "train" in phases:
            # train, rerank_train and scripts share one work directory: the
            # corpus, the bi-encoder and the served store carry over
            trained = Path(stack.enter_context(tempfile.TemporaryDirectory(
                prefix="chip_smoke_train_", dir=REPO / "build")))
        seconds, backends, threads_left, sharded, tp_counts = {}, {}, {}, {}, {}
        att_masks = {}
        if "build" in phases:
            t0 = time.perf_counter()
            phase_build()
            seconds["build"] = time.perf_counter() - t0
        if "kernels" in phases:
            t0 = time.perf_counter()
            rows = phase_kernels()
            seconds["kernels"] = time.perf_counter() - t0
        # each phase drives its part of the path with the counters zeroed
        # first; a kernel's launches are the sum over the phases that ran
        # rerank_train last: the phases that need only train's work run
        # (and report) whatever its outcome
        runs = {"serve": phase_serve, "scale": lambda _work: phase_scale(),
                "ivf": phase_ivf, "host_ivf": phase_host_ivf,
                "train": lambda _work: phase_train(trained, corpus),
                "scripts": lambda _work: phase_scripts(trained, hnsw),
                "rehearse": lambda work: phase_rehearse(work, corpus.result()[0]),
                "shard": phase_shard, "tp": phase_tp,
                "mbert_attn": lambda _work: phase_mbert_attn(),
                "rerank_train": lambda _work: phase_rerank_train(trained, corpus.path)}
        for name, run in runs.items():
            if name in phases:
                before = {t.ident for t in threading.enumerate()}
                t0 = time.perf_counter()
                with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_",
                                                 dir=REPO / "build") as work, \
                        _wordpiece_backends() as built, \
                        _attention_masks(MASKS_KEPT if args.save_masks else 0) as masks:
                    for kern, count in run(Path(work)).items():
                        launches[kern] = launches.get(kern, 0) + count
                        if name == "shard":
                            sharded[kern] = count
                        if name == "tp":
                            tp_counts[kern] = count
                seconds[name] = time.perf_counter() - t0
                att_masks[name] = masks
                backends[name] = sorted(set(built))
                threads_left[name] = _threads(before)  # started and left running
                if set(built) - {"native"}:
                    raise AssertionError(f"the {name} phase tokenized in Python: {built}")
    if args.save_masks:
        torch.save({name: m.pop("masks") for name, m in att_masks.items()}, args.save_masks)
    emit({"phase_seconds": seconds, "wordpiece_backends": backends,
          "threads_left": threads_left, "attention_masks": att_masks})
    for counts in (launches, sharded, tp_counts):
        for name, (whole, f32) in _SPLIT_COUNTERS.items():
            if whole in counts:
                counts[name] = counts[whole] - counts.get(f32, 0)
    rows = rows + SHARD_ROWS
    for r in rows:
        counter = r.pop("counter")
        r["launches"] = launches.get(counter)
        if sharded:
            # the shard phase's share: its kernels launched on the shards
            r["launches_sharded"] = sharded.get(counter)
        if tp_counts:
            # the tp phase's share: its kernels launched on the model ranks
            r["launches_tp"] = tp_counts.get(counter)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
