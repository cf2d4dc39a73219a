"""ModernBERT's attention kernels (csrc/ragged_attention.cu, through
ops/ragged_attention.py) on the card; each test skips without one.

This file imports no JAX, so that it runs on a machine with a card and no
JAX: `python -m pytest --noconftest tests/test_torch_modernbert_attention_card.py -q`.

- The kernels against the plain version, forward and backward, at B 32,
  H 16, D 64 and T 64, 4,096 and 8,192, both window modes (64 and every
  key), rows of 2, 63, 64, 65, 129, T - 1 and T real tokens (those that
  fit), the rest of the batch drawn uniformly in 1..T.  The yardstick is
  the plain version in f32 on the same bf16 inputs; the kernels, which
  round P and dS to bf16 for their products and write bf16, may stray
  from it by at most twice what the plain version in bf16 (the library's
  fused attention) strays, plus 1e-3, as a share of the f32 result's norm
  over the real rows.  Pad rows and their gradients: exactly zero.
- Two backward calls agree bit for bit (no atomics).
- A trainer's steps, replayed ones included, run the kernels on the
  device: the device's run counters count every replayed step, the
  wrapper's host counters only the eager and the captured ones.
"""

import numpy as np
import pytest
import torch

from tpu_rag_torch.models.modernbert import ModernBertSpec
from tpu_rag_torch.ops import ragged_attention as ra
from tpu_rag_torch.train.contrastive import ContrastiveTrainer

pytestmark = pytest.mark.cuda

B, H, D = 32, 16, 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _lengths(t: int, dev) -> torch.Tensor:
    fixed = [n for n in (2, 63, 64, 65, 129) if n <= t] + [t - 1, t]
    rng = np.random.default_rng(t)
    rest = rng.integers(1, t + 1, B - len(fixed))
    return torch.tensor(fixed + rest.tolist(), dtype=torch.int32, device=dev)


def _inputs(t: int, dev, seed: int = 0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, t, H, D, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    do = torch.randn(B, t, H, D, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, do


def _grads(fn, q, k, v, do, dtype):
    xs = [x.detach().to(dtype).requires_grad_(True) for x in (q, k, v)]
    out = fn(*xs)
    grads = torch.autograd.grad(out, xs, do.to(dtype))
    return [out.detach().float()] + [x.float() for x in grads]


def _rel(a: torch.Tensor, e: torch.Tensor, real: torch.Tensor) -> float:
    return float((a[real] - e[real]).norm() / e[real].norm().clamp_min(1e-30))


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("t", [64, 4096, 8192])
def test_kernels_match_the_plain_version(card, t, window):
    lengths = _lengths(t, card)
    q, k, v, do = _inputs(t, card, seed=t)
    real = torch.arange(t, device=card)[None, :] < lengths[:, None]
    got = _grads(lambda *x: ra.ragged_attention(*x, lengths, window), q, k, v, do,
                 torch.bfloat16)
    lib = _grads(lambda *x: ra.ragged_attention_plain(*x, lengths, window), q, k, v, do,
                 torch.bfloat16)
    want = _grads(lambda *x: ra.ragged_attention_plain(*x, lengths, window), q, k, v, do,
                  torch.float32)
    torch.cuda.synchronize()
    for name, a, lb, e in zip(("o", "dq", "dk", "dv"), got, lib, want):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a[~real], torch.zeros_like(a[~real])), f"{name}: pad rows"
        err, lib_err = _rel(a, e, real), _rel(lb, e, real)
        assert err <= 2 * lib_err + 1e-3, f"{name}: {err} against the library's {lib_err}"


def test_backward_is_deterministic(card):
    t = 4096
    lengths = _lengths(t, card)
    q, k, v, do = _inputs(t, card, seed=1)
    runs = []
    for _ in range(2):
        for window in (None, 64):
            o, lse = ra._forward_cuda(q, k, v, lengths, -1 if window is None else window)
            runs.append(ra._backward_cuda(q, k, v, o, do, lse, lengths,
                                          -1 if window is None else window))
    for a, b in zip(runs[:2], runs[2:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_the_kernels_run_in_replayed_steps(card):
    """4 trainer steps of one shape (eager, captured and replayed, replayed,
    replayed): the device counts 4 steps' runs, the host 2 steps'
    launches; a step runs each layer's forward twice (remat) in both
    towers and its backward once."""
    spec = ModernBertSpec(vocab_size=512, hidden=128, layers=3, heads=2, ffn=192, max_len=128,
                          window=16)
    tr = ContrastiveTrainer(spec, lr=1e-4, compute_dtype=torch.bfloat16, seed=3, device=card)
    rng = np.random.default_rng(2)

    def batch():
        out = {}
        for side, t in (("q", 16), ("d", 80)):
            n = rng.integers(2, t + 1, 8)
            mask = (np.arange(t)[None, :] < n[:, None]).astype(np.int32)
            out[f"{side}_ids"] = rng.integers(4, 512, (8, t)).astype(np.int32) * mask
            out[f"{side}_mask"] = mask
        return out

    host0 = (ra._forward_cuda.launches, ra._backward_cuda.launches,
             ra._forward_cuda.banded_launches)
    tr.train_step(batch())                 # the first kernel call makes the run counters
    dev0 = ra.device_runs(card)
    host1 = (ra._forward_cuda.launches, ra._backward_cuda.launches,
             ra._forward_cuda.banded_launches)
    for _ in range(3):
        tr.train_step(batch())
    dev1 = ra.device_runs(card)
    host2 = (ra._forward_cuda.launches, ra._backward_cuda.launches,
             ra._forward_cuda.banded_launches)
    per_step = (2 * 3 * 2, 2 * 3, 2 * 2 * 2)    # towers x layers x (forward + recompute), ...
    assert tuple(a - b for a, b in zip(host1, host0)) == per_step
    assert tuple(a - b for a, b in zip(host2, host1)) == per_step     # the capture only
    assert [dev1[k] - dev0[k] for k in ("forward", "backward", "banded")] == [
        3 * n for n in per_step]
