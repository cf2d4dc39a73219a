"""Pieces the drivers share: the port's spec of a configuration, peak
memory, the card's name, freeing the program, the rate by parts of the
window."""

from __future__ import annotations

import gc


def port_spec(cfg: dict):
    """The port's BertSpec of a configuration file."""
    from tpu_rag_torch.models.bert import BertSpec

    return BertSpec(vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"],
                    layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
                    ffn=cfg["intermediate_size"], max_len=cfg["max_position_embeddings"],
                    type_vocab=cfg["type_vocab_size"], ln_eps=cfg["layer_norm_eps"])


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def device_kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def segment_rates(done: list[tuple[float, float]], t0: float, seconds: float,
                  parts: int = 6) -> str:
    """Work a second in each of `parts` equal stretches of the window, from
    (completion time, amount) pairs: whether the rate drifts in a run."""
    edges = [t0 + seconds * i / parts for i in range(parts + 1)]
    sums = [0.0] * parts
    for t, amount in done:
        for i in range(parts):
            if edges[i] <= t < edges[i + 1]:
                sums[i] += amount
    return " ".join(f"{v * parts / seconds:.0f}" for v in sums)
