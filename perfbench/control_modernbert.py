"""The control of a ModernBERT training cell's comparison, as control.py
makes it for the BERT cells: the plain reference (reference/modernbert.py)
in the program's place, computed in the precision below the
configuration's (bf16 compute -> float8 e4m3 under a per-tensor scale on
both operands of every product), at the cell's own sizes, read by the
numbers the cell's runs are judged by; and control.py's two faults, half
of every batch left out (the mean over the rest) and one token of every
batch altered.  A state left unchanged reads update_gap 1 and needs no
run.

  python3 perfbench/control_modernbert.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed.  Needs a CUDA card unless --device cpu is
given (the tests run it there at small widths).  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cfg: dict, tr: dict, seed: int, dev) -> dict:
    """The control's and the faults' readings on one seed."""
    import torch

    from perfbench import judge, modernbert, textgen
    from perfbench.drivers.train import corpus
    from perfbench.reference import modernbert as ref_mb
    from perfbench.reference import train as ref_train
    from perfbench.reference.bert import f32_matmul, fp8_round
    from perfbench.reference.tokenizer import WordPiece

    tcfg = cfg["train"]
    tok = WordPiece(textgen.VOCAB)
    batches = [{k: torch.as_tensor(v, dtype=torch.int64, device=dev) for k, v in b.items()}
               for b in ref_train.batches(corpus(tr, seed), tok.ids, tcfg, seed, tok.special, 3,
                                          body_cut=tcfg["body_cut"])]
    altered = []
    for b in batches:
        b2 = dict(b)
        b2["q_ids"] = b["q_ids"].clone()
        b2["q_ids"][0, 1] = (b["q_ids"][0, 1] + 1) % cfg["vocab_size"]
        altered.append(b2)
    w = modernbert.seeded(cfg, seed, dev)
    out = {}
    with f32_matmul():
        t0 = time.monotonic()
        ref = ref_mb.three_steps(w, cfg, batches, tcfg)
        out["reference_s"] = time.monotonic() - t0
        for name, kw in (("control", {"quant": fp8_round}),
                         ("fault_half_batch", {"keep_rows": tcfg["batch"] // 2}),
                         ("fault_token", {"batches": altered})):
            got = ref_mb.three_steps(w, cfg, kw.pop("batches", batches), tcfg, **kw)
            nums = judge.train_numbers(got, ref)
            out[name] = {k: nums[k] for k in ("loss_gap", "grad_gap", "update_gap")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("control: no device", file=sys.stderr)
        return 2
    bench = harness.load_bench(ROOT)
    cell = harness.cell_of(bench, args.workload)
    cfg = harness.config_of(ROOT, bench, cell["config"])
    tr = harness.traffic_of(harness.PKG, cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(cfg, tr, seed, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
