"""The ModernBERT cell's pieces: its FLOP count, its three readers, its
reference's import rule, its seeded weights, and a whole run on the CPU at
small widths (correct, and not correct under a planted fault)."""

import json
import subprocess
import sys
import tempfile
import time

import pytest
import torch
from conftest import ROOT, tiny_parts

from perfbench import harness, judge, modernbert, readers, textgen, trace
from perfbench.drivers.train import corpus
from perfbench.reference import modernbert as ref_mb
from perfbench.reference import train as ref_train
from perfbench.reference.tokenizer import WordPiece

CELL = "modernbert-large.train-4k"


def _cfg():
    return json.loads((ROOT / "perfbench/configs/modernbert-large.json").read_text())


def _tiny():
    """The cell at small widths, with a window (16) narrower than the
    documents (64) and 3 layers: global, local, local."""
    root, bench, cell, cfg, tr = tiny_parts(CELL)
    cfg.update(local_attention=16, num_hidden_layers=3)
    return root, bench, cell, cfg, tr


def test_model_flops():
    cfg = _cfg()
    # 28 x (1024 x 3072 + 1024^2 + 1024 x 5248 + 2624 x 1024 + 2 x 1024) - 1024
    # (layer 0 has no attn_norm) + 2 x 1024 (embedding norm, final norm)
    assert modernbert.nonembedding_params(cfg) == 343_204_864
    assert sum(torch.Size(s).numel() for s in modernbert.shapes(cfg).values()) == 394_781_696
    one = modernbert.forward_flops(cfg, [200])
    assert one == 2 * 343_204_864 * 200 + 4 * 1024 * (10 * 200 * 200 + 18 * 200 * 129)
    assert modernbert.forward_flops(cfg, [100]) == 2 * 343_204_864 * 100 + 4 * 1024 * 28 * 100**2
    step = modernbert.train_step_flops(cfg, [10, 20], [200, 100])
    assert step == 3 * (modernbert.forward_flops(cfg, [10, 20])
                        + modernbert.forward_flops(cfg, [200, 100]))


def test_readers():
    reader = harness.reader_of(harness.PKG, "attn_waste.mbert4k")
    assert reader.read({"attn": {"local": 300, "global": 100, "real": 100}}) == 75.0
    assert reader.read({}) is None
    assert reader.read({"attn": {"local": 0, "global": 0, "real": 0}}) is None
    tr = trace.Trace(device=[("gemm", 0.0, 0.5)], lo=0.0, hi=1.0, wall_s=1.0)
    data = {"trace": tr, "flops": 989e12 * 0.25}
    # the cell's MFU and idle share are the train metrics' readers over its
    # own FLOPs
    assert harness.reader_of(harness.PKG, "mfu.train").read(data) == pytest.approx(25.0)
    assert harness.reader_of(harness.PKG, "device_idle.train").read(data) == 50.0
    bench = harness.load_bench(ROOT)
    listed = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", ())}
    assert listed == {"device_idle.train", "mfu.train", "cast_share.train", "attn_waste.mbert4k"}
    assert readers.mfu_pct({"trace": tr}) is None


def test_reference_imports_neither_jax_nor_the_program():
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'flax', 'tpu_rag', 'tpu_rag_torch'):\n"
        "    sys.modules[n] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import perfbench.reference.modernbert, perfbench.modernbert, perfbench.control_modernbert\n"
        "import perfbench.harness\n"
        "perfbench.harness.driver_of(perfbench.harness.PKG, {'driver': 'train_modernbert'})\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_seeded_weights_fit_the_ports_encoder():
    from perfbench.drivers.train_modernbert import port_spec
    from tpu_rag_torch.models.modernbert import ModernBertEncoder

    _, _, _, cfg, _ = _tiny()
    w = modernbert.seeded(cfg, 5, "cpu")
    with torch.device("meta"):
        sd = ModernBertEncoder(port_spec(cfg)).state_dict()
    assert {k: tuple(v.shape) for k, v in w.items()} == {k: tuple(v.shape) for k, v in sd.items()}
    again = modernbert.seeded(cfg, 5, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    big = _cfg()
    with torch.device("meta"):
        sd = ModernBertEncoder(port_spec(big)).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == modernbert.shapes(big)


def test_reference_steps_match_the_ports_trainer():
    """The port's trainer (f32 on the CPU) and the reference take the same
    three steps on the same batches: losses to 1e-5, each leaf's change to
    1e-3 (AdamW's first steps divide by a tiny second moment, so rounding
    in the gradient shows in the update)."""
    from perfbench.drivers.train_modernbert import port_spec
    from tpu_rag_torch.train.contrastive import ContrastiveTrainer, warmup_cosine_decay

    _, _, _, cfg, tr = _tiny()
    tcfg = cfg["train"]
    tok = WordPiece(textgen.VOCAB)
    batches = ref_train.batches(corpus(tr, 3), tok.ids, tcfg, 3, tok.special, 3,
                                body_cut=tcfg["body_cut"])
    w = modernbert.seeded(cfg, 3, "cpu")
    lr = warmup_cosine_decay(0.0, tcfg["lr"], tcfg["warmup"], tcfg["steps"], tcfg["lr"] * 0.02)
    trainer = ContrastiveTrainer(port_spec(cfg), lr=lr, tau=tcfg["tau"], device="cpu")
    trainer.module.load_state_dict(w)
    start = {k: p.detach().clone() for k, p in trainer.module.named_parameters()}
    losses = [trainer.train_step(b) for b in batches]
    ref = ref_mb.three_steps(w, cfg, [{k: torch.as_tensor(v, dtype=torch.int64)
                                       for k, v in b.items()} for b in batches], tcfg)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    assert judge.kept_leaves(ref["grad"]) == list(ref["grad"])
    for k, p in trainer.module.named_parameters():
        assert float((p.detach() - start[k]).norm()) == pytest.approx(ref["update"][k], rel=1e-3)


def _run(seed: int = 2**31 + 77) -> dict:
    root, bench, cell, cfg, tr = _tiny()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Context(bench=bench, pkg=harness.PKG, workload=CELL, cell=cell, cfg=cfg,
                              traffic=tr, limits=harness.limits_of(harness.PKG, CELL), seed=seed,
                              seconds=2.0, trace=False, device=torch.device("cpu"), tmpdir=tmp,
                              t_start=time.monotonic(), log=lambda *a: None)
        return harness.execute(ctx)


def test_a_sound_run_is_correct():
    line = _run()
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_half_a_batch_left_out_is_not_correct(monkeypatch):
    from tpu_rag_torch.train import contrastive

    orig = contrastive.info_nce_loss

    def half(q, d, tau=0.05):
        keep = q.shape[0] // 2
        return orig(q[:keep], d[:keep], tau)

    monkeypatch.setattr(contrastive, "info_nce_loss", half)
    assert not _run()["correct"]


def test_control_reads_far_above_a_sound_run_on_the_cpu():
    from perfbench import control_modernbert

    _, _, _, cfg, tr = _tiny()
    ctl = control_modernbert.readings(cfg, tr, 7, torch.device("cpu"))
    sound = _run(seed=7)["checks"]
    assert max(ctl["control"][k] / max(sound[k]["value"], 1e-7)
               for k in ("loss_gap", "grad_gap", "update_gap")) > 100
    assert ctl["fault_half_batch"]["loss_gap"] > 0.05
    assert ctl["fault_token"]["loss_gap"] > 0
