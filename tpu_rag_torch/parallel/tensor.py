"""Tensor parallelism over a mesh "model" axis: the partition rules of the
BertEncoder's parameters and the two collectives the port needs (port of
tpu_rag/models/bert.py:151-181, param_partition_spec and
make_param_shardings).

tpu_rag places its params with NamedShardings and lets XLA insert the
collectives.  The port splits a full state_dict into one dict a model rank
(`shard_state_dict`), runs each rank's share on its own device
(models/bert.py: TensorParallelEncoder) and moves the activations itself:

- column-parallel: intermediate.weight (F, H) and its bias split over F;
  attention.{query,key,value}.weight (heads * hd, H) and their flat
  biases split by whole heads;
- row-parallel: output.weight (H, F) and attention.out.weight
  (H, heads * hd) split over their input columns (F; whole heads); each
  rank's product is a partial sum, `reduce_partials` adds them, and their
  biases are added once, after the reduction;
- everything else (embeddings, LayerNorms, the row-parallel biases) is
  held once, by rank 0, whose device runs it: tpu_rag replicates it over
  the axis, and the results are the same.

tpu_rag replicates the 1-d FFN bias (F,) as well, since GSPMD reshards the
activation around it; an explicit column split must slice it with its
weight, so the port splits it.  tpu_rag pads a heads or FFN width that the
axis does not divide; the port raises (`check_divisible`).

A rank's slice of a column-parallel weight is a contiguous block of rows,
so its projection's output is its own contiguous (B, T, heads / tp, hd)
tensor: kernel #5 takes it as is.
"""

from __future__ import annotations

import torch

_COLUMN = ("intermediate.weight", "intermediate.bias",
           "attention.query.weight", "attention.query.bias",
           "attention.key.weight", "attention.key.bias",
           "attention.value.weight", "attention.value.bias")
_ROW = ("output.weight", "attention.out.weight")


def param_partition_spec(name: str, shape) -> tuple:
    """The split of the BertEncoder parameter `name` (a state_dict name,
    nn.Linear weights (out, in)) over "model": one entry a dimension,
    "model" on the split one, as a jax PartitionSpec; () is held by rank 0."""
    if not name.startswith("layers."):
        return ()
    parts = name.split(".")
    tail = ".".join(parts[-3:] if parts[-3:-2] == ["attention"] else parts[-2:])
    if tail in _COLUMN:
        return ("model",) + (None,) * (len(shape) - 1)
    if tail in _ROW:
        return (None, "model")
    return ()


def check_divisible(spec, tp: int) -> None:
    """Raise where the "model" axis does not divide the heads or the FFN
    width (tpu_rag pads them; the port keeps whole heads and equal slices)."""
    for what, n in (("attention heads", spec.heads), ("FFN width", spec.ffn)):
        if n % tp:
            raise ValueError(f'the "model" mesh axis of size {tp} does not divide the '
                             f"{what} ({n})")


def shard_state_dict(sd: dict[str, torch.Tensor], spec, tp: int) -> list[dict[str, torch.Tensor]]:
    """A full BertEncoder state_dict -> one dict a model rank: rank r holds
    the r-th of `tp` equal slices of every split parameter, and rank 0
    also every parameter held once (the names of
    BertEncoder(spec, tp=tp, rank=r).state_dict())."""
    check_divisible(spec, tp)
    shards: list[dict[str, torch.Tensor]] = [{} for _ in range(tp)]
    for name, t in sd.items():
        split = param_partition_spec(name, t.shape)
        if not split:
            shards[0][name] = t
            continue
        for rank, piece in enumerate(torch.chunk(t, tp, dim=split.index("model"))):
            shards[rank][name] = piece.contiguous()
    return shards


def gather_state_dict(shards: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """The inverse of shard_state_dict, on rank 0's tensors' device: every
    split parameter concatenated in rank order (exact)."""
    out = {}
    for name, t in shards[0].items():
        split = param_partition_spec(name, t.shape)
        out[name] = (torch.cat([s[name].to(t.device) for s in shards], dim=split.index("model"))
                     if split else t)
    return out


def reduce_partials(parts: list[torch.Tensor]) -> torch.Tensor:
    """Sum of the ranks' partial products onto the first rank's device, in
    rank order, so the result does not depend on timing (an all-reduce whose
    result rank 0 keeps).  Differentiable: the gradient of each part is the
    output's, copied back to its device."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(out.device)
    return out


def gather_rows(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The data positions' row slices concatenated in data order on
    `device` (the all-gather of the trainer's embeddings).  Differentiable."""
    return torch.cat([p.to(device) for p in parts], dim=0)
