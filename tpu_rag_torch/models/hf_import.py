"""HuggingFace BERT checkpoint -> the port's state dicts (port of
tpu_rag/models/hf_import.py).

Lets the port serve the reference's models (all-MiniLM-L6-v2 bi-encoder,
ms-marco-MiniLM-L-6-v2 cross-encoder) from a local `model.safetensors` or
`pytorch_model.bin`.  HF names map straight onto `BertEncoder`'s state-dict
names (the ones `params_from_flax` produces); HF Linear weights are already
(out, in), so nothing is transposed.  A ModernBERT checkpoint
(`model_type: modernbert`; ModernBertModel's names, or ModernBertForMaskedLM's
under "model.") loads into `ModernBertEncoder`, whose names are HF's own.

`model.safetensors` is read by `read_safetensors` below on every machine:
the format is a little-endian u64 header length, a JSON header of
{name: {dtype, shape, data_offsets}}, then the raw bytes.  No package of
safetensors is needed.

A checkpoint that is missing, lacks a key or does not fit the spec gives
None (the callers then use seeded weights), with a warning.  A directory
holding an orbax checkpoint (what tpu_rag's trainers write) raises
NotImplementedError: the port cannot read that format, and serving seeded
weights where tpu_rag would serve trained ones would be a silent fault.
"""

from __future__ import annotations

import json
import logging
import struct
from pathlib import Path

import torch

logger = logging.getLogger("tpu_rag_torch")

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
# files orbax's StandardCheckpointer writes at the top of a checkpoint dir
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, on the CPU (the format is
    little-endian, as is every machine the port runs on)."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, info in header.items():
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        buf = bytearray(data[base + start:base + end])
        flat = (torch.frombuffer(buf, dtype=dtype) if buf
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def _is_orbax_dir(p: Path) -> bool:
    return any((p / name).exists() for name in _ORBAX_MARKERS)


def _load_state_dict(path: str | Path) -> dict[str, torch.Tensor] | None:
    p = Path(path)
    if p.is_dir():
        if _is_orbax_dir(p):
            raise NotImplementedError(
                f"{p} holds an orbax checkpoint, which tpu_rag_torch cannot "
                "read; pass a model.safetensors or pytorch_model.bin")
        for name in ("model.safetensors", "pytorch_model.bin"):
            if (p / name).is_file():
                p = p / name
                break
        else:
            return None
    if not p.is_file():
        return None
    try:
        if p.suffix == ".safetensors":
            return read_safetensors(p)
        return dict(torch.load(str(p), map_location="cpu", weights_only=True))
    except Exception as e:
        logger.warning("could not read checkpoint %s (%s); ignoring it", p, e)
        return None


def _strip_prefix(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        for prefix in ("bert.", "model.", ""):
            if k.startswith(prefix):
                out[k[len(prefix):]] = v
                break
    return out


def bert_hf_names(spec) -> dict[str, str]:
    """BertEncoder(spec) state-dict name -> HF BertModel name (no "bert."
    prefix).  models/hf_export.py writes checkpoints through the same map."""
    names = {
        "word_embeddings.weight": "embeddings.word_embeddings.weight",
        "position_embeddings.weight": "embeddings.position_embeddings.weight",
        "token_type_embeddings.weight": "embeddings.token_type_embeddings.weight",
        "embeddings_ln.weight": "embeddings.LayerNorm.weight",
        "embeddings_ln.bias": "embeddings.LayerNorm.bias",
    }
    hf_layer = {
        "attention.query": "attention.self.query",
        "attention.key": "attention.self.key",
        "attention.value": "attention.self.value",
        "attention.out": "attention.output.dense",
        "attention_ln": "attention.output.LayerNorm",
        "intermediate": "intermediate.dense",
        "output": "output.dense",
        "output_ln": "output.LayerNorm",
    }
    for i in range(spec.layers):
        for ours, theirs in hf_layer.items():
            for leaf in ("weight", "bias"):
                names[f"layers.{i}.{ours}.{leaf}"] = f"encoder.layer.{i}.{theirs}.{leaf}"
    return names


def map_bert_state_dict(sd: dict, spec) -> dict[str, torch.Tensor]:
    """HF model state dict (BertModel's, or ModernBertModel's for a
    ModernBertSpec) -> state dict of the port's spec.encoder(), through
    spec.hf_names().  Raises KeyError for a missing name, ValueError for a
    shape that does not fit `spec`."""
    return _take(_strip_prefix(sd), spec.hf_names(), _shapes(type(spec).encoder, spec))


def _shapes(build, spec) -> dict[str, torch.Size]:
    """State-dict shapes of the module build(spec), with no memory
    allocated."""
    with torch.device("meta"):
        return {k: v.shape for k, v in build(spec).state_dict().items()}


def _take(sd: dict, names: dict[str, str], want: dict) -> dict[str, torch.Tensor]:
    """{ours: sd[theirs]} as f32, each shape checked against `want`."""
    out = {}
    for ours, theirs in names.items():
        v = torch.as_tensor(sd[theirs]).to(torch.float32)
        if v.shape != want[ours]:
            raise ValueError(f"{theirs}: shape {tuple(v.shape)}, the spec needs "
                             f"{tuple(want[ours])}")
        out[ours] = v.contiguous()
    return out


def spec_from_hf_config(path: str | Path):
    """BertSpec, or ModernBertSpec where `model_type` is "modernbert", from a
    checkpoint dir's config.json (HF convention), or None when no readable
    config.json is present.  A ModernBERT config with biases or another
    activation than erf GELU raises ValueError: the port's trunk has
    neither."""
    p = Path(path)
    if p.is_dir():
        cfg_file = p / "config.json"
    elif p.is_file():  # a weights file: look next to it
        cfg_file = p.parent / "config.json"
    else:
        return None
    if not cfg_file.is_file():
        return None
    try:
        cfg = json.loads(cfg_file.read_text())
    except (OSError, ValueError):
        return None
    from tpu_rag_torch.models.bert import BertSpec
    from tpu_rag_torch.models.modernbert import ModernBertSpec

    kind = ModernBertSpec if cfg.get("model_type") == "modernbert" else BertSpec
    return kind.from_hf_config(cfg)


def load_bert_params(path: str | Path, spec) -> dict[str, torch.Tensor] | None:
    """HF BertModel (or, for a ModernBertSpec, ModernBertModel) checkpoint
    -> the port's encoder state dict, or None."""
    sd = _load_state_dict(path)
    if sd is None:
        return None
    try:
        return map_bert_state_dict(sd, spec)
    except (KeyError, ValueError) as e:
        logger.warning("HF checkpoint %s does not match spec (%s); ignoring it", path, e)
        return None


def load_cross_encoder_params(path: str | Path, spec) -> dict[str, torch.Tensor] | None:
    """HF BertForSequenceClassification -> CrossEncoderModule state dict, or
    None."""
    from tpu_rag_torch.models.crossencoder import CrossEncoderModule

    sd = _load_state_dict(path)
    if sd is None:
        return None
    try:
        out = {"bert." + k: v for k, v in map_bert_state_dict(sd, spec).items()}
        head = {"pooler.weight": "pooler.dense.weight", "pooler.bias": "pooler.dense.bias",
                "classifier.weight": "classifier.weight",
                "classifier.bias": "classifier.bias"}
        out.update(_take(_strip_prefix(sd), head, _shapes(CrossEncoderModule, spec)))
        return out
    except (KeyError, ValueError) as e:
        logger.warning("HF cross-encoder checkpoint %s does not match spec (%s); "
                       "ignoring it", path, e)
        return None
