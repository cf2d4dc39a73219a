"""ModernBERT's attention wrapper (tpu_rag_torch/ops/ragged_attention.py)
on the CPU: its plain version, the count of the tiles its kernels visit,
and the contract that the callers' masks are real prefixes.

- The plain version against the band/full attention under the masks'
  additive biases (band_attention, global_attention, which the trunk ran
  before the wrapper) on every real query row, output and q/k/v
  gradients, f32: exact, the same ops on the same rows (rtol 0, atol 0 on
  outputs; gradients 1e-6 absolute on unit-scale inputs, since the pad
  rows' zeroing is one more product in the backward's sums);
- both against a dense masked softmax written out pair by pair, in f64:
  1e-6 absolute (another order of the sums);
- pad query rows: zeros, and no gradient through them;
- the card refusing another compute dtype than bf16 for ModernBERT, in
  the spec's hook that the trainer and the bi-encoder call and in
  prove_checkpoint, whose forward is f32;
- visited_slots against a count that walks the kernels' loops block by
  block, warp by warp and chunk by chunk, and those loops covering every
  real pair.
"""

import numpy as np
import pytest
import torch

from tpu_rag_torch.models import modernbert as mb
from tpu_rag_torch.models.biencoder import MODEL_SPECS
from tpu_rag_torch.models.tokenizer import encode_batch, load_tokenizer
from tpu_rag_torch.ops import ragged_attention as ra
from tpu_rag_torch.scripts import train_semantic

torch.set_num_threads(1)

LENGTHS = (2, 63, 64, 65, 129)
H, D = 2, 16


def _lengths(t: int) -> torch.Tensor:
    """Ragged lengths around the 64-key chunks that fit in t, then t - 1, t
    and 0."""
    return torch.tensor([n for n in LENGTHS if n <= t] + [t - 1, t, 0], dtype=torch.int32)


def _qkv(b: int, t: int, seed: int, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, t, H, D, generator=g, dtype=torch.float64).to(dtype)
            .requires_grad_(True) for _ in range(3)]


def _real(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return torch.arange(t)[None, :] < lengths[:, None]


def _dense(q, k, v, lengths, window):
    """softmax over the kept pairs (key real, |i - j| <= window), every
    score written out; query rows with no kept key give zeros."""
    t = q.shape[1]
    pos = torch.arange(t)
    keep = _real(lengths, t)[:, None, :] & _real(lengths, t)[:, :, None]
    if window is not None:
        keep = keep & ((pos[:, None] - pos[None, :]).abs() <= window)[None]
    s = torch.einsum("bihd,bjhd->bhij", q, k) / q.shape[-1] ** 0.5
    s = s.masked_fill(~keep[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhij,bjhd->bihd", p, v)


def _present(q, k, v, lengths, window):
    """The trunk's attention before the wrapper: the full or banded
    attention under the mask's additive bias."""
    mask = _real(lengths, q.shape[1]).to(torch.int32)
    if window is None:
        return ra.global_attention(q, k, v, ra.key_bias(mask, q.dtype))
    return ra.band_attention(q, k, v, ra.band_bias(mask, window, q.dtype), window)


@pytest.mark.parametrize("window", [None, 64, 4])
@pytest.mark.parametrize("t", [64, 256])
def test_plain_version_equals_the_present_attention_on_real_rows(t, window):
    lengths = _lengths(t)
    q, k, v = _qkv(len(lengths), t, seed=t + (window or 0))
    real = _real(lengths, t)
    got = ra.ragged_attention(q, k, v, lengths, window)
    want = _present(q, k, v, lengths, window)
    torch.testing.assert_close(got[real], want[real], rtol=0, atol=0)
    r = torch.randn(got.shape, generator=torch.Generator().manual_seed(1)) * real[..., None, None]
    g_got = torch.autograd.grad((got * r).sum(), (q, k, v))
    g_want = torch.autograd.grad((want * r).sum(), (q, k, v))
    for a, e in zip(g_got, g_want):
        torch.testing.assert_close(a, e, rtol=0, atol=1e-6)


@pytest.mark.parametrize("window", [None, 64, 4])
@pytest.mark.parametrize("t", [64, 256])
def test_plain_version_equals_a_dense_masked_softmax(t, window):
    lengths = _lengths(t)
    q, k, v = _qkv(len(lengths), t, seed=2 * t + (window or 0), dtype=torch.float64)
    got = ra.ragged_attention(q, k, v, lengths, window)
    want = _dense(q, k, v, lengths, window)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    r = torch.randn(got.shape, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    for a, e in zip(torch.autograd.grad((got * r).sum(), (q, k, v)),
                    torch.autograd.grad((want * r).sum(), (q, k, v))):
        torch.testing.assert_close(a, e, rtol=0, atol=1e-6)


@pytest.mark.parametrize("window", [None, 64])
def test_pad_query_rows_are_zeros_and_take_no_gradient(window):
    t = 256
    lengths = _lengths(t)
    q, k, v = _qkv(len(lengths), t, seed=7)
    pad = ~_real(lengths, t)
    out = ra.ragged_attention(q, k, v, lengths, window)
    assert torch.equal(out[pad], torch.zeros_like(out[pad]))
    # a gradient on every row, pad rows too, reaches q only at real rows,
    # and k and v as a gradient on the real rows alone does
    r = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    gq, gk, gv = torch.autograd.grad((out * r).sum(), (q, k, v))
    assert torch.equal(gq[pad], torch.zeros_like(gq[pad]))
    assert torch.equal(gk[pad], torch.zeros_like(gk[pad]))
    assert torch.equal(gv[pad], torch.zeros_like(gv[pad]))
    out2 = ra.ragged_attention(q, k, v, lengths, window)
    _, gk2, gv2 = torch.autograd.grad((out2 * r * (~pad)[..., None, None]).sum(), (q, k, v))
    assert torch.equal(gk, gk2) and torch.equal(gv, gv2)


def _walk(n: int, t: int, w: int | None) -> tuple[int, set]:
    """The slots ragged_fwd_kernel scores in a row of n real tokens padded
    to t, walking its grid, warpgroups and loops as the kernel does, and
    the (query, key) pairs those slots hold."""
    slots, pairs = 0, set()
    for i0 in range(0, t, ra.TILE):                          # blockIdx.x
        if i0 >= n:
            continue                                         # a tile of padding
        i1 = min(t, i0 + ra.TILE)
        lo = 0 if w is None else max(0, i0 - w)
        hi = n if w is None else min(n, min(n, i1) + w)
        lo = lo // ra.CHUNK * ra.CHUNK
        nch = -(-(hi - lo) // ra.CHUNK)
        for unit in range(ra.TILE // ra.UNIT_ROWS):         # the block's warpgroups
            r0 = i0 + unit * ra.UNIT_ROWS
            if r0 >= n:
                continue                                     # not live
            for ch in range(nch):
                c0 = lo + ch * ra.CHUNK
                if w is None or (c0 <= r0 + ra.UNIT_ROWS - 1 + w and c0 + ra.CHUNK - 1 >= r0 - w):
                    slots += ra.UNIT_ROWS * ra.CHUNK
                    pairs.update((i, j) for i in range(r0, r0 + ra.UNIT_ROWS)
                                 for j in range(c0, c0 + ra.CHUNK))
    return slots, pairs


@pytest.mark.parametrize("window", [None, 64, 4, 200])
def test_visited_slots_count_the_kernels_loops(window):
    t = 300
    lens = [0, 1, 2, 15, 16, 17, 63, 64, 65, 127, 128, 129, 200, 299, 300]
    walked = 0
    for n in lens:
        slots, pairs = _walk(n, t, window)
        walked += slots
        # the loops miss no real pair
        real = {(i, j) for i in range(n) for j in range(n)
                if window is None or abs(i - j) <= window}
        assert real <= pairs, f"n={n}: pairs the loops never visit"
    assert ra.visited_slots(lens, t, window) == walked


def test_tiled_counts_at_modernbert_large():
    """A full row scores T keys a query row on a global layer, as the plain
    version does, and 192 on a local one but at the row's two ends, where
    the plain version's blocks score keys before and after the row;
    ragged rows score their tiles."""
    big = MODEL_SPECS["modernbert-large"]
    d_local, d_glob, d_real = mb.attention_counts(big, [4096], 4096)
    local, glob, real = mb.attention_counts(big, [4096], 4096, tiled=True)
    assert (glob, real) == (d_glob, d_real)
    ends = 2 * 64 * 64                      # one chunk fewer for the warpgroup at each end
    assert local == d_local - 18 * ends
    lens = [1730, 32, 4094]
    local, glob, real = mb.attention_counts(big, lens, 4096, tiled=True)
    assert glob == 10 * sum(-(-n // 64) * 64 * -(-n // 64) * 64 for n in lens)
    assert local == 18 * ra.visited_slots(lens, 4096, 64)
    assert real == mb.attention_counts(big, lens, 4096)[2]
    assert 1 - real / (local + glob) < 0.15


def test_record_attention_counts_the_path_of_the_trainers_device():
    from tpu_rag_torch.utils.metrics import GLOBAL_METRICS

    names = ("attn_local_key_slots_total", "attn_global_key_slots_total",
             "attn_real_pairs_total")
    big = MODEL_SPECS["modernbert-large"]
    mask = (np.arange(4096)[None, :] < np.array([[100], [3000]])).astype(np.int32)
    for device, tiled in (("cpu", False), ("cuda", True)):
        before = [GLOBAL_METRICS.counter(n) for n in names]
        big.record_attention(mask, device=device)
        after = [GLOBAL_METRICS.counter(n) for n in names]
        want = mb.attention_counts(big, [100, 3000], 4096, tiled=tiled)
        assert [a - b for a, b in zip(after, before)] == list(want)


def test_the_callers_masks_are_real_prefixes():
    """The contract the wrapper takes: the tokenizer's and the sampler's
    masks are real on a prefix of each row; the CPU trunk refuses a mask
    with a hole."""
    from pathlib import Path

    vocab = Path(__file__).resolve().parent.parent / "examples" / "vocab.txt"
    tok = load_tokenizer(str(vocab))
    _, mask = encode_batch(tok, ["a short one", "a somewhat longer text of words here", ""], 16,
                           batch=4)
    assert ra.is_prefix(torch.as_tensor(mask))
    words = [w for w in vocab.read_text().splitlines() if w.isalpha() and w.islower()]
    rng = np.random.default_rng(4)
    docs = [{"id": f"d{i}", "query": " ".join(rng.choice(words, 5)),
             "body": " ".join(rng.choice(words, int(rng.integers(3, 300))))} for i in range(64)]
    args = train_semantic.parse_args(["--corpus", "x", "--out", "y", "--batch", "8",
                                      "--seq-len", "96", "--q-len", "16"])
    draw = train_semantic.batch_sampler(docs, tok, args)
    for _ in range(5):
        batch = draw()
        for side in ("q", "d"):
            assert ra.is_prefix(torch.as_tensor(batch[f"{side}_mask"]))
    spec = mb.ModernBertSpec(vocab_size=512, hidden=32, layers=3, heads=2, ffn=48, max_len=32,
                             window=8)
    holed = torch.ones(2, 12, dtype=torch.int32)
    holed[1, 4] = 0
    with pytest.raises(ValueError, match="prefix"):
        mb.ModernBertEncoder(spec)(torch.ones(2, 12, dtype=torch.int64), holed)


def test_modernbert_on_the_card_takes_bf16_only(tmp_path, monkeypatch, capsys):
    """The spec's hook, which ContrastiveTrainer and BiEncoder call before
    they build the trunk, refuses f32 on the card and nothing on the CPU;
    BERT's takes either.  prove_checkpoint, whose forward is f32, refuses
    a ModernBERT checkpoint on the card with that message."""
    from tpu_rag_torch import device as device_mod
    from tpu_rag_torch.models.biencoder import init_params
    from tpu_rag_torch.models.hf_export import save_bert
    from tpu_rag_torch.scripts import prove_checkpoint

    spec = mb.ModernBertSpec(vocab_size=512, hidden=32, layers=3, heads=2, ffn=48, max_len=64,
                             window=8)
    with pytest.raises(ValueError, match="bf16 only"):
        spec.prepare(torch.device("cuda"), torch.float32)
    spec.prepare(torch.device("cpu"), torch.float32)
    MODEL_SPECS["minilm-l6"].prepare(torch.device("cuda"), torch.float32)

    save_bert(init_params(spec, 0), spec, tmp_path)
    monkeypatch.setattr(device_mod, "resolve", lambda _d: torch.device("cuda"))
    with pytest.raises(SystemExit) as exit_:
        prove_checkpoint.main(["--embedding-weights", str(tmp_path), "--device", "cuda"])
    assert exit_.value.code == 2
    assert "bf16 only" in capsys.readouterr().err
