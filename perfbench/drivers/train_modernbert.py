"""Contrastive training of ModernBERT: `ContrastiveTrainer.train_step` on a
ModernBertSpec at the configuration's `train` settings, through
train_semantic's batch sampler with its `--body-cut`.

Set-up as drivers/train.py's: a corpus of `docs` documents drawn from the
seed (corpus(): bodies and summaries of the traffic's measured token
lengths), train_semantic's sampler over it with the program's tokenizer,
a trainer that starts from the configuration's weights drawn from the
seed on the card (modernbert.seeded), and its first three steps on the
sampler's first three batches (eager, captured, replayed), which warm
every shape and give the readings the reference is held to.  The window
then runs the sampler and a step until `seconds` have passed; the rate
counts the real tokens of every step.

The reference (reference/modernbert.py) takes the same three steps in
f32 on the first three batches, redrawn from the same texts with its own
tokenizer.  It runs in a child process of its own (reference(); `python
-m perfbench.drivers.train_modernbert <job.json> <out.json>`), started
as the run's set-up starts, so that its ~20 s on the card overlap the
program's host-bound imports, tokenizer and trainer construction; the
program waits for it before its first step (the two at once can outgrow
the card's memory), so that the program has the card to itself from
there.  `setup_s` leaves out the reference's batches and that wait: it
is the program's set-up.

The traced slice's layer data adds the attention counters of
models/modernbert.py (read before and after the slice) and the model
FLOPs of modernbert.train_step_flops.  The eager, captured and replayed
steps of the window go to the log.

Traffic keys: docs, body_tokens and summary_tokens (length specs,
textgen.py), slice_s.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]

ATTN_COUNTERS = {"local": "attn_local_key_slots_total", "global": "attn_global_key_slots_total",
                 "real": "attn_real_pairs_total"}
STEP_COUNTERS = ("train_eager_steps_total", "train_graph_captures_total",
                 "train_graph_replays_total")


def port_spec(cfg: dict):
    """The program's ModernBertSpec of a configuration file."""
    from tpu_rag_torch.models.modernbert import ModernBertSpec

    return ModernBertSpec(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"], ffn=cfg["intermediate_size"],
        max_len=cfg["max_position_embeddings"], global_every=cfg["global_attn_every_n_layers"],
        window=cfg["local_attention"], global_rope_theta=cfg["global_rope_theta"],
        local_rope_theta=cfg["local_rope_theta"], ln_eps=cfg["norm_eps"])


def _counters(names) -> list[float]:
    from tpu_rag_torch.utils.metrics import GLOBAL_METRICS

    return [GLOBAL_METRICS.counter(n) for n in names]


def run(ctx) -> dict:
    marks = [("start", time.monotonic())]
    ref_proc, ref_out = _start_reference(ctx)
    try:
        return _run(ctx, marks, ref_proc, ref_out)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()


def _run(ctx, marks: list, ref_proc, ref_out: Path) -> dict:
    # the program's modules first: a program without ModernBERT fails here,
    # before any set-up
    from tpu_rag_torch.device import compute_dtype
    from tpu_rag_torch.models.modernbert import ModernBertSpec  # noqa: F401
    from tpu_rag_torch.models.tokenizer import load_tokenizer
    from tpu_rag_torch.scripts.train_semantic import batch_sampler
    from tpu_rag_torch.train.contrastive import ContrastiveTrainer, warmup_cosine_decay

    import torch

    from perfbench import common, judge, modernbert, textgen
    from perfbench.drivers.train import corpus, sampler_args
    from perfbench.trace import Slice, Spans

    cfg, tr, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    tcfg = cfg["train"]

    # ---- set-up: corpus, tokens, trainer, its first three steps; the
    # reference's result
    marks.append(("imports", time.monotonic()))
    docs = corpus(tr, seed)
    tok = load_tokenizer(str(textgen.VOCAB), vocab_size=cfg["vocab_size"])
    marks.append(("corpus", time.monotonic()))
    _send_batches(ref_proc, ref_out, docs, tcfg, seed)
    marks.append(("the reference's batches", time.monotonic()))
    args = sampler_args(tcfg, seed)
    args.body_cut = tcfg["body_cut"]
    sampler = batch_sampler(docs, tok, args)
    marks.append(("tokenize", time.monotonic()))
    lr = warmup_cosine_decay(0.0, tcfg["lr"], tcfg["warmup"], tcfg["steps"], tcfg["lr"] * 0.02)
    trainer = ContrastiveTrainer(port_spec(cfg), lr=lr, tau=tcfg["tau"],
                                 compute_dtype=compute_dtype(dev), device=dev,
                                 state_dict=modernbert.seeded(cfg, seed, dev))
    marks.append(("trainer", time.monotonic()))
    # the program's steps wait: both on the card at once can outgrow it
    ref = _reference_result(ref_proc, ref_out)
    marks.append(("the wait for the reference", time.monotonic()))
    params = dict(trainer.module.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    losses = [trainer.train_step(sampler())]
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    # a step that left no optimizer state reads as a first gradient of 0
    grad = {k: float(trainer.optimizer.state.get(p, {}).get("exp_avg", torch.zeros(1)).norm())
            / (1.0 - beta1) for k, p in params.items()}
    losses += [trainer.train_step(sampler()) for _ in range(2)]
    update = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    del start
    prog = {"losses": losses, "grad": grad, "update": update}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("three steps", time.monotonic()))
    # harness work in the set-up: the reference's batches and the wait for it
    harness_s = sum(t - p for (_, p), (name, t) in zip(marks, marks[1:])
                    if name.startswith("the "))

    # ---- the window: whole steps
    tokens, steps, bad, slice_steps, sl, traced, spans = 0, 0, 0, [], None, None, Spans()
    done: list[tuple[float, float]] = []
    attn0 = attn1 = None
    steps0 = _counters(STEP_COUNTERS)
    t0 = time.monotonic()
    while True:
        if ctx.trace and sl is None and traced is None \
                and time.monotonic() - t0 >= (ctx.seconds - tr["slice_s"]) / 2:
            sl = Slice(ctx.tmpdir)
            sl.start()
            attn0 = _counters(ATTN_COUNTERS.values())
        with spans("train_semantic.batch_sampler"):
            batch = sampler()
        with spans("ContrastiveTrainer.train_step"):
            loss = trainer.train_step(batch)
        bad += not np.isfinite(loss)
        steps += 1
        step_tokens = int(batch["q_mask"].sum()) + int(batch["d_mask"].sum())
        tokens += step_tokens
        done.append((time.monotonic(), step_tokens))
        if sl is not None:
            slice_steps.append((batch["q_mask"].sum(1), batch["d_mask"].sum(1)))
            if time.monotonic() - sl.t0 >= tr["slice_s"]:
                sl.stop()
                attn1 = _counters(ATTN_COUNTERS.values())
                traced, sl = sl, None
        if time.monotonic() - t0 >= ctx.seconds and sl is None:
            break
    elapsed = time.monotonic() - t0
    setup_s = t0 - ctx.t_start - harness_s
    window_steps = [b - a for a, b in zip(steps0, _counters(STEP_COUNTERS))]
    peak = common.memory_peak(dev)
    trace = traced.read(spans) if traced is not None else None
    ctx.log("set-up s: " + ", ".join(f"{name} {t - p:.2f}" for (_, p), (name, t) in
                                     zip(marks, marks[1:]))
            + f"; in all {setup_s:.2f} (the reference's batches and the wait left out); "
            f"tokens/s by sixths of the window: "
            f"{common.segment_rates(done, t0, ctx.seconds)}")
    ctx.log(f"window: {steps} steps, eager / captured / replayed {window_steps}; "
            f"peak {peak / 2**30:.2f} GiB")

    # ---- judged: the first three steps against the plain reference's
    nums = judge.train_numbers(prog, ref)
    lim = ctx.limits
    checks = [("failed_steps", float(bad), 0.0),
              ("loss_gap", nums["loss_gap"], lim["loss_gap"]),
              ("grad_gap", nums["grad_gap"], lim["grad_gap"]),
              ("update_gap", nums["update_gap"], lim["update_gap"])]
    ctx.log(f"reference {ref['seconds']:.1f} s in its process, the run so far "
            f"{time.monotonic() - ctx.t_start:.1f} s; worst leaves: gradient "
            f"{nums['grad_leaf']}, change {nums['update_leaf']}; left out (no reference "
            f"gradient): {nums['leaves_left_out']}")

    layer = {"trace": trace, "partial": ["the profiler lost a slice marker"]
             if trace is not None and trace.lost else []}
    if trace is not None:
        layer["flops"] = sum(modernbert.train_step_flops(cfg, q.tolist(), d.tolist())
                             for q, d in slice_steps)
        layer["attn"] = {k: b - a for k, a, b in zip(ATTN_COUNTERS, attn0, attn1)}
        spec = port_spec(cfg)
        local_rows = sum(not spec.is_global(i) for i in range(spec.layers)) * sum(
            len(q) * tcfg["query_len"] + len(d) * tcfg["doc_len"] for q, d in slice_steps)
        ctx.log(f"slice: {len(slice_steps)} steps; attention counters {layer['attn']}; local "
                f"key slots a query row {layer['attn']['local'] / max(local_rows, 1):.1f}")
    return {"e2e": {"train_tokens_per_s": tokens / elapsed, "setup_s": setup_s},
            "layer_data": layer, "checks": checks, "attempted": steps, "failed": bad,
            "memory_peak_bytes": peak, "device_kind": common.device_kind(dev)}


def reference(cfg: dict, batches: list[dict], w: dict, dev) -> dict:
    """The plain reference's three steps ({"losses", "grad", "update"},
    and the "seconds" they took) on `batches` (numpy {q_ids, q_mask,
    d_ids, d_mask}) from the weights `w` (modernbert.seeded)."""
    import torch

    from perfbench.reference import modernbert as ref_mb
    from perfbench.reference.bert import f32_matmul

    batches = [{k: torch.as_tensor(v, dtype=torch.int64, device=dev) for k, v in b.items()}
               for b in batches]
    t = time.monotonic()
    with f32_matmul():
        out = ref_mb.three_steps(w, cfg, batches, cfg["train"])
    return {**out, "seconds": time.monotonic() - t}


def _start_reference(ctx):
    """The reference's process for this run, and the file it writes.  It
    imports and draws its weights while the run draws its batches
    (_send_batches)."""
    import torch

    job, out = Path(ctx.tmpdir) / "reference_job.json", Path(ctx.tmpdir) / "reference.json"
    job.write_text(json.dumps({"cfg": ctx.cfg, "seed": ctx.seed, "device": str(ctx.device),
                               "threads": torch.get_num_threads()}))
    # its standard error is the run's; its standard output goes nowhere, so
    # that the result line stays the run's last
    proc = subprocess.Popen([sys.executable, "-m", "perfbench.drivers.train_modernbert",
                             str(job), str(out)], cwd=ROOT, stdin=subprocess.PIPE,
                            stdout=subprocess.DEVNULL)
    return proc, out


def _send_batches(proc, out: Path, docs: list[dict], tcfg: dict, seed: int) -> None:
    """The first three batches, drawn by the reference's tokenizer from the
    run's texts, to the reference's process: a file beside `out`, then the
    end of its standard input."""
    from perfbench import textgen
    from perfbench.reference import train as ref_train
    from perfbench.reference.tokenizer import WordPiece

    rtok = WordPiece(textgen.VOCAB)
    batches = ref_train.batches(docs, rtok.ids, tcfg, seed, rtok.special, 3,
                                body_cut=tcfg["body_cut"])
    np.savez(out.with_suffix(".npz"),
             **{f"{i}.{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    proc.stdin.close()


def _reference_result(proc, out: Path) -> dict:
    """What the reference's process wrote, once it has ended."""
    if proc.wait() != 0:
        raise RuntimeError(f"the reference's process exited with {proc.returncode}")
    return json.loads(out.read_text())


def main(argv: list[str]) -> int:
    """python -m perfbench.drivers.train_modernbert <job.json> <out.json>:
    reference() of the job's cfg, seed and device on the batches in
    <out>.npz, once its standard input ends, as JSON in <out.json>."""
    import torch

    from perfbench import modernbert

    job, out = json.loads(Path(argv[0]).read_text()), Path(argv[1])
    dev = torch.device(job["device"])
    if dev.type == "cpu":
        torch.set_num_threads(job["threads"])
    # the weights, while the run draws the batches
    w = modernbert.seeded(job["cfg"], job["seed"], dev)
    sys.stdin.buffer.read()
    arrays = np.load(out.with_suffix(".npz"))
    batches = [{k: arrays[f"{i}.{k}"] for k in ("q_ids", "q_mask", "d_ids", "d_mask")}
               for i in range(3)]
    out.write_text(json.dumps(reference(job["cfg"], batches, w, dev)))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main(sys.argv[1:]))
