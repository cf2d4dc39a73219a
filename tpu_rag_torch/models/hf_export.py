"""The port's checkpoint format: a BertEncoder state dict written as a HF
BertModel directory, and a CrossEncoderModule state dict as a HF
BertForSequenceClassification directory (one label), the inverse of
models/hf_import.py.

    <dir>/model.safetensors   f32 tensors under HF names
    <dir>/config.json         the architecture, under HF BertConfig keys

`BiEncoder(weights_path=<dir>)` and `CrossEncoder(weights_path=<dir>)` with
no `spec=` take their architecture from config.json, so a checkpoint fixes
its own vocab, widths, depth and position table.  tpu_rag's HF import
(safetensors) and transformers' `from_pretrained` read the same
directories.  The safetensors layout
is written with plain torch/numpy: no package of safetensors is needed.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import torch

from tpu_rag_torch.models.hf_import import bert_hf_names


def write_safetensors(path: str | Path, tensors: dict[str, torch.Tensor]) -> None:
    """`tensors` as f32 in the safetensors layout: a little-endian u64
    header length, the JSON header (padded with spaces to 8 bytes), then the
    raw little-endian bytes in header order."""
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in tensors.items():
        raw = t.detach().to("cpu", torch.float32).numpy().astype("<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for raw in blobs:
            f.write(raw)


def _save(state_dict: dict[str, torch.Tensor], names: dict[str, str], what: str,
          config: dict, spec, path: str | Path) -> None:
    """`state_dict` under the HF `names` (ours -> theirs) as
    model.safetensors, beside a config.json of `spec` with erf GELU
    ("gelu"), as the trunk computes, and the `config` keys."""
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    if set(state_dict) != set(names):
        raise KeyError(f"state dict names differ from {what}({spec}): "
                       f"{sorted(set(state_dict) ^ set(names))[:6]}")
    write_safetensors(out / "model.safetensors",
                      {names[k]: state_dict[k] for k in names})
    config = {**config, "model_type": "bert",
              "vocab_size": spec.vocab_size, "hidden_size": spec.hidden,
              "num_hidden_layers": spec.layers, "num_attention_heads": spec.heads,
              "intermediate_size": spec.ffn, "max_position_embeddings": spec.max_len,
              "type_vocab_size": spec.type_vocab, "layer_norm_eps": spec.ln_eps,
              "hidden_act": "gelu"}
    (out / "config.json").write_text(json.dumps(config, indent=2) + "\n")


def save_bert(state_dict: dict[str, torch.Tensor], spec, path: str | Path) -> None:
    """Write BertEncoder(spec)'s `state_dict` as a HF BertModel directory at
    `path` (created if missing)."""
    _save(state_dict, bert_hf_names(spec), "BertEncoder",
          {"architectures": ["BertModel"]}, spec, path)


def save_cross_encoder(state_dict: dict[str, torch.Tensor], spec, path: str | Path) -> None:
    """Write CrossEncoderModule(spec)'s `state_dict` as a HF
    BertForSequenceClassification directory at `path` (created if missing):
    the trunk under "bert.", the tanh pooler as "bert.pooler.dense", the
    1-logit head as "classifier"; config.json has num_labels 1 and the
    trained position table's length."""
    names = {"bert." + ours: "bert." + theirs for ours, theirs in bert_hf_names(spec).items()}
    names.update({"pooler.weight": "bert.pooler.dense.weight",
                  "pooler.bias": "bert.pooler.dense.bias",
                  "classifier.weight": "classifier.weight",
                  "classifier.bias": "classifier.bias"})
    _save(state_dict, names, "CrossEncoderModule",
          {"architectures": ["BertForSequenceClassification"], "num_labels": 1,
           "id2label": {"0": "LABEL_0"}, "label2id": {"LABEL_0": 0}}, spec, path)
