"""The control of each cell's comparison: the plain reference put in the
program's place and computed in the precision below the configuration's
(bf16 compute -> float8 e4m3 with a per-tensor scale on both operands of
every product), at the cell's own sizes, read by the same numbers the
cell's runs are judged by.  For a training cell also the faults a run
can have, planted in the reference: half of every batch left out (the mean
over the rest), one token of every batch altered.  A state left unchanged
reads update_gap 1 and needs no run.

  python3 perfbench/control.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed.  Needs a CUDA card unless --device cpu is
given (the tests run it there at small widths).  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def train(cfg: dict, tr: dict, seed: int, dev) -> dict:
    import torch

    from perfbench import judge, textgen, weights
    from perfbench.drivers.train import corpus
    from perfbench.reference import bert
    from perfbench.reference import train as ref_train
    from perfbench.reference.tokenizer import WordPiece

    tcfg = cfg["train"]
    tok = WordPiece(textgen.VOCAB)
    batches = [{k: torch.as_tensor(v, dtype=torch.int64, device=dev) for k, v in b.items()}
               for b in ref_train.batches(corpus(tr, seed), tok.ids, tcfg, seed, tok.special, 3)]
    altered = []
    for b in batches:
        b2 = dict(b)
        b2["q_ids"] = b["q_ids"].clone()
        b2["q_ids"][0, 1] = (b["q_ids"][0, 1] + 1) % cfg["vocab_size"]
        altered.append(b2)
    w = weights.seeded_bert(cfg, seed, dev)
    out = {}
    with bert.f32_matmul():
        ref = ref_train.three_steps(w, cfg, batches, tcfg)
        for name, kw in (("control", {"quant": bert.fp8_round}),
                         ("fault_half_batch", {"keep_rows": tcfg["batch"] // 2}),
                         ("fault_token", {"batches": altered})):
            got = ref_train.three_steps(w, cfg, kw.pop("batches", batches), tcfg, **kw)
            nums = judge.train_numbers(got, ref)
            out[name] = {k: nums[k] for k in ("loss_gap", "grad_gap", "update_gap")}
    return out


def readings(root: Path, workload: str, seed: int, dev, cfg=None, tr=None) -> dict:
    """The control's (and faults') readings of one cell on one seed; cfg
    and tr replace the cell's configuration and traffic where given."""
    from perfbench import harness

    if cfg is None or tr is None:
        bench = harness.load_bench(root)
        cell = harness.cell_of(bench, workload)
        cfg = cfg or harness.config_of(root, bench, cell["config"])
        tr = tr or harness.traffic_of(harness.PKG, cell["traffic"])
    return {"train": train}[tr["driver"]](cfg, tr, seed, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("control: no device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(ROOT, args.workload, seed, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
