"""Plain float32 ModernBERT trunk, embeddings and contrastive steps.

The published forward (answerdotai/ModernBERT-large's config.json,
transformers' ModernBertModel): token embedding and a bias-free LayerNorm;
per layer i, x + Wo(attn(attn_norm(x))) (no attn_norm at layer 0) and
x + Wo(gelu(input) * gate) with input, gate = Wi(mlp_norm(x)) split in two;
a final bias-free LayerNorm, eps from the configuration.  Attention: Wqkv's
output is q | k | v, heads of hidden / heads; RoPE (rotate-half, angles in
f32) at global_rope_theta where i % global_attn_every_n_layers == 0 and
at local_rope_theta elsewhere; softmax(q.k / sqrt(head_dim)) over every
key on a global layer, and on a local layer with pairs |i - j| >
local_attention // 2 filled with finfo(f32).min, the published mask
applied plainly.  GELU is erf GELU.  Sentence embeddings are the mean of
the final hidden states over real tokens over their L2 norm.

Each row is taken at its real length (its real tokens, a prefix of the
row as the sampler writes them): what the padded batch computes at real
positions under a key mask.  The rows' real tokens are packed into one
matrix for every product and for attention, where a query sees only its
own row's keys: a global layer scores runs of whole rows of up to
GLOBAL_CHUNK tokens at once (a longer row alone, so its L x L scores come
a sequence at a time), and a local layer scores blocks of BAND_ROWS
queries against the keys from half a window before the block to half a
window after it, under the published mask, so that no score outside
those blocks is computed or held.  Each layer is checkpointed
(recomputed in the backward), so that of a batch of 32 rows of 4,096
positions in f32 only one layer's scores are held at a time (at most 32
x heads x 4,096^2 probabilities, 34 GB), beside the AdamW state.

Plain torch on f32 tensors, with TF32 off (bert.f32_matmul).  `quant`,
where given, rounds both operands of every matrix product (the control).
The contrastive steps are reference/train.py's: in-batch InfoNCE and AdamW
as Loshchilov & Hutter define it under the configuration's schedule;
`keep_rows` keeps only the first rows of every batch (a fault).  It
imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.train import info_nce, schedule


def _mm(x: torch.Tensor, w: torch.Tensor, quant) -> torch.Tensor:
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w.T


def _rope(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """RoPE on (N, heads, head_dim) x at token positions `pos` (N,)."""
    d = x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.int64, device=x.device).float() / d))
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    ang = torch.cat((ang, ang), dim=-1)[:, None, :]
    rot = torch.cat((-x[..., d // 2:], x[..., :d // 2]), dim=-1)
    return x * ang.cos() + rot * ang.sin()


BAND_ROWS = 512
GLOBAL_CHUNK = 2048


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, row: torch.Tensor,
               lens: list[int], half_window: int | None, quant) -> torch.Tensor:
    """Attention of packed rows: (N, heads, head_dim) q, k, v of rows of
    `lens` tokens one after another (`row`: each token's row), each query
    over the keys of its own row, all of them or (half_window given) those
    with |i - j| <= half_window."""
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))
    if quant is not None:
        q, k, v = quant(q), quant(k), quant(v)
    scale = math.sqrt(q.shape[-1])
    if half_window is not None:
        return _band(q, k, v, row, half_window, scale, quant).transpose(0, 1)
    # rows one after another in chunks of up to GLOBAL_CHUNK tokens (a
    # longer row alone), each chunk's scores at once, other rows' keys
    # masked
    chunks = _chunks(lens, GLOBAL_CHUNK)
    sizes = [sum(c) for c in chunks]
    out = []
    for c, qc, kc, vc, rc in zip(chunks, *(t.split(sizes, dim=1) for t in (q, k, v)),
                                 row.split(sizes)):
        s = qc @ kc.transpose(-1, -2) / scale
        if len(c) > 1:
            s = s.masked_fill(rc[:, None] != rc[None, :], torch.finfo(torch.float32).min)
        out.append(_softmax_av(s, vc, quant))
    return torch.cat(out, dim=1).transpose(0, 1)


def _chunks(lens: list[int], cap: int) -> list[list[int]]:
    """`lens` cut into consecutive runs of whole rows, each of at most
    `cap` tokens unless one row alone is longer."""
    out: list[list[int]] = [[]]
    for m in lens:
        if out[-1] and sum(out[-1]) + m > cap:
            out.append([])
        out[-1].append(m)
    return out


def _band(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, row: torch.Tensor,
          half_window: int, scale: float, quant) -> torch.Tensor:
    """(heads, N, head_dim) local attention: blocks of BAND_ROWS queries,
    each scored against the keys from half a window before the block to
    half a window after it (the sequence padded at both ends), under the
    published mask |i - j| <= half_window within a row."""
    n = q.shape[1]
    rows = min(BAND_ROWS, n)
    blocks, span = -(-n // rows), rows + 2 * half_window
    extra = blocks * rows - n
    qb = F.pad(q, (0, 0, 0, extra)).unflatten(1, (blocks, rows))
    # (heads, blocks, head_dim, span): block b's keys start at b x rows - half_window
    kw, vw = (F.pad(t, (0, 0, half_window, half_window + extra)).unfold(1, span, rows)
              for t in (k, v))
    i = torch.arange(blocks * rows, device=q.device).view(blocks, rows, 1)
    j = (torch.arange(blocks, device=q.device) * rows - half_window).view(blocks, 1, 1) \
        + torch.arange(span, device=q.device)
    far = ((i - j).abs() > half_window) | (j < 0) | (j >= n) \
        | (row[i.clamp(max=n - 1)] != row[j.clamp(0, n - 1)])
    s = (qb @ kw / scale).masked_fill(far, torch.finfo(torch.float32).min)
    o = _softmax_av(s, vw.transpose(-1, -2), quant)
    return o.flatten(1, 2)[:, :n]


def _softmax_av(s: torch.Tensor, v: torch.Tensor, quant) -> torch.Tensor:
    """softmax(s) @ v over the last axis of (heads, rows, keys) scores."""
    a = torch.softmax(s, dim=-1)
    if quant is not None:
        a = quant(a)
    return a @ v


def _layer(w: dict, cfg: dict, i: int, x: torch.Tensor, pos: torch.Tensor, row: torch.Tensor,
           lens: list[int], quant) -> torch.Tensor:
    """Layer i on the rows' (N, hidden) real-token states, packed row after
    row (`lens` tokens each, at positions `pos`, of rows `row`)."""
    h, nh, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg["norm_eps"]
    n = x.shape[0]
    p = f"layers.{i}."
    is_global = i % cfg["global_attn_every_n_layers"] == 0
    a = x if i == 0 else F.layer_norm(x, (h,), w[p + "attn_norm.weight"], None, eps)
    q, k, v = _mm(a, w[p + "attn.Wqkv.weight"], quant).view(n, 3, nh, h // nh).unbind(1)
    base = cfg["global_rope_theta"] if is_global else cfg["local_rope_theta"]
    q, k = _rope(q, pos, base), _rope(k, pos, base)
    half = None if is_global else cfg["local_attention"] // 2
    o = _attention(q, k, v, row, lens, half, quant).reshape(n, h)
    x = x + _mm(o, w[p + "attn.Wo.weight"], quant)
    m = F.layer_norm(x, (h,), w[p + "mlp_norm.weight"], None, eps)
    gin, gate = _mm(m, w[p + "mlp.Wi.weight"], quant).chunk(2, dim=-1)
    return x + _mm(F.gelu(gin) * gate, w[p + "mlp.Wo.weight"], quant)


class _Recomputed(torch.autograd.Function):
    """fn(x, *ws), its inputs kept and its forward run again in the
    backward pass: torch.utils.checkpoint by hand (whose first call imports
    torch._dynamo, ~10 s on the card's host)."""

    @staticmethod
    def forward(ctx, fn, x, *ws):
        ctx.fn = fn
        ctx.save_for_backward(x, *ws)
        return fn(x, *ws)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.fn(*inputs)
        need = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(out, need, grad))
        return (None, *(next(got) if t.requires_grad else None for t in inputs))


def embed(w, cfg, ids, mask, quant=None) -> torch.Tensor:
    """(B, hidden) f32 sentence embeddings of (B, T) ids under a 0/1 mask
    of real prefixes: the mean of each row's final hidden states,
    L2-normalised.  The rows' real tokens are packed into one (N, hidden)
    matrix; attention keeps to each row (_attention)."""
    h, eps = cfg["hidden_size"], cfg["norm_eps"]
    lens = [int(m) for m in (mask > 0).sum(dim=1).tolist()]
    pos = torch.cat([torch.arange(m) for m in lens]).to(ids.device)
    row = torch.repeat_interleave(torch.arange(len(lens)), torch.tensor(lens)).to(ids.device)
    x = F.layer_norm(w["embeddings.tok_embeddings.weight"][ids[mask > 0]], (h,),
                     w["embeddings.norm.weight"], None, eps)
    for i in range(cfg["num_hidden_layers"]):
        names = [k for k in w if k.startswith(f"layers.{i}.")]

        def layer(x, *ws, i=i, names=names):
            return _layer(dict(zip(names, ws)), cfg, i, x, pos, row, lens, quant)

        x = (_Recomputed.apply(layer, x, *(w[k] for k in names)) if torch.is_grad_enabled()
             else layer(x, *(w[k] for k in names)))
    x = F.layer_norm(x, (h,), w["final_norm.weight"], None, eps)
    pooled = torch.stack([part.mean(dim=0) for part in x.split(lens)])
    return pooled / torch.linalg.vector_norm(pooled, dim=1, keepdim=True).clamp(min=1e-12)


def three_steps(w0: dict[str, torch.Tensor], cfg: dict, batches: list[dict], tcfg: dict,
                quant=None, keep_rows: int | None = None,
                betas=(0.9, 0.999), eps: float = 1e-8, wd: float = 1e-4) -> dict:
    """Train from w0 over `batches` ({q_ids, q_mask, d_ids, d_mask} int
    tensors on w0's device).  Returns the losses, every leaf's norm of the
    first gradient and of the change after the last step."""
    lr = schedule(tcfg["lr"], tcfg["warmup"], tcfg["steps"], tcfg["lr"] * 0.02)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w0.items()}
    losses, grad_norms = [], {}
    for step, b in enumerate(batches):
        rows = slice(0, keep_rows)
        q = embed(params, cfg, b["q_ids"][rows], b["q_mask"][rows], quant)
        d = embed(params, cfg, b["d_ids"][rows], b["d_mask"][rows], quant)
        loss = info_nce(q, d, tcfg["tau"])
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if step == 0:
            grad_norms = {k: float(g.norm()) for k, g in zip(params, grads)}
        rate, t = lr(step), step + 1
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                p.mul_(1.0 - rate * wd)
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                v2[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                denom = (v2[k] / (1 - betas[1] ** t)).sqrt().add_(eps)
                p.addcdiv_(m[k], denom, value=-rate / (1 - betas[0] ** t))
        del grads, q, d, loss
    update = {k: float((params[k].detach() - w0[k]).norm()) for k in params}
    return {"losses": losses, "grad": grad_norms, "update": update}
