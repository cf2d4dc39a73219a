"""A whole run, on the CPU at small widths, with the timed path broken
underneath: each fault the cell can have turns `correct` false, and the
same run unbroken is correct."""

import pytest
import torch
from conftest import tiny_run


def test_sound_runs_are_correct():
    line = tiny_run("minilm-l6-1m.train")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"]


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch_loss(monkeypatch):
    from tpu_rag_torch.train import contrastive

    orig = contrastive.info_nce_loss

    def half(q, d, tau=0.05):
        keep = q.shape[0] // 2
        return orig(q[:keep], d[:keep], tau)

    monkeypatch.setattr(contrastive, "info_nce_loss", half)


def _alter_loss(monkeypatch):
    from tpu_rag_torch.train.contrastive import ContrastiveTrainer

    orig = ContrastiveTrainer.train_step
    monkeypatch.setattr(ContrastiveTrainer, "train_step",
                        lambda self, batch: orig(self, batch) * 1.01)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_loss, _alter_loss])
def test_train_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = tiny_run("minilm-l6-1m.train")
    assert not line["correct"], line["checks"]
