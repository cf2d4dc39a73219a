"""The port's weight files: its own safetensors reader against the
safetensors package, HF BertModel checkpoints (model.safetensors and
pytorch_model.bin) against transformers and against tpu_rag's
map_bert_state_dict + Flax BertEncoder, the failure outcomes tpu_rag's
loader has (None, then seeded weights), and the divergence that an orbax
directory raises.

Tiny widths (vocab 128, hidden 32, 2 layers, 4 heads); hidden states agree
within 2e-4 on unmasked positions, pooled embeddings within 1e-5."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import safetensors.numpy
import transformers

from tpu_rag.models import hf_import as jax_hf
from tpu_rag.models.bert import BertEncoder as JaxBert
from tpu_rag.models.bert import BertSpec as JaxSpec
from tpu_rag.models.biencoder import BiEncoder as JaxBiEncoder
from tpu_rag_torch.models import hf_import
from tpu_rag_torch.models.bert import BertEncoder, BertSpec
from tpu_rag_torch.models.biencoder import BiEncoder
from tpu_rag_torch.models.crossencoder import CrossEncoder

TINY = dict(vocab_size=128, hidden=32, layers=2, heads=4, ffn=64, max_len=128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hf_config(**kw):
    return transformers.BertConfig(
        vocab_size=TINY["vocab_size"], hidden_size=TINY["hidden"],
        num_hidden_layers=TINY["layers"], num_attention_heads=TINY["heads"],
        intermediate_size=TINY["ffn"], max_position_embeddings=TINY["max_len"],
        hidden_act="gelu", **kw)


@pytest.fixture(scope="module")
def hf_bert(tmp_path_factory):
    """A tiny random HF BertModel saved both ways: (model, {format: dir})."""
    torch.manual_seed(3)
    model = transformers.BertModel(_hf_config()).eval()
    dirs = {}
    for fmt, safe in (("safetensors", True), ("bin", False)):
        d = tmp_path_factory.mktemp(f"hf_{fmt}")
        model.save_pretrained(d, safe_serialization=safe)
        dirs[fmt] = d
    assert (dirs["safetensors"] / "model.safetensors").is_file()
    assert (dirs["bin"] / "pytorch_model.bin").is_file()
    return model, dirs


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    rng = np.random.default_rng(0)
    tensors = {"a.weight": rng.standard_normal((7, 5)).astype(dtype),
               "b": rng.standard_normal((3,)).astype(dtype),
               "c.scalar": np.asarray(1.5, dtype),
               "d.empty": np.zeros((0, 4), dtype)}
    path = tmp_path / "t.safetensors"
    safetensors.numpy.save_file(tensors, str(path), metadata={"format": "pt"})
    want = safetensors.numpy.load_file(str(path))
    got = hf_import.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].numpy().dtype == arr.dtype
        np.testing.assert_array_equal(got[name].numpy(), arr)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_bert_checkpoint_matches_hf_and_tpu_rag(hf_bert, fmt):
    model, dirs = hf_bert
    spec = BertSpec(**TINY)
    sd = hf_import.load_bert_params(dirs[fmt], spec)
    assert sd is not None
    rng = np.random.default_rng(1)
    t = 24
    ids = rng.integers(4, TINY["vocab_size"], (3, t)).astype(np.int64)
    mask = np.ones((3, t), np.int64)
    mask[1, 10:] = 0
    mask[2, 3:] = 0
    types = np.zeros((3, t), np.int64)
    types[:, 5:] = 1
    with torch.no_grad():
        want_hf = model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                        token_type_ids=torch.from_numpy(types)).last_hidden_state.numpy()
        trunk = BertEncoder(spec)
        trunk.load_state_dict(sd)
        got = trunk(torch.from_numpy(ids), torch.from_numpy(mask).int(),
                    torch.from_numpy(types)).numpy()
    params = jax_hf.load_bert_params(dirs[fmt], JaxSpec(**TINY))
    want_jax = np.asarray(JaxBert(JaxSpec(**TINY)).apply(
        {"params": params}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
        jnp.asarray(types, jnp.int32)))
    keep = mask.astype(bool)
    np.testing.assert_allclose(got[keep], want_hf[keep], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got[keep], want_jax[keep], rtol=0, atol=2e-4)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_biencoder_weights_path_matches_tpu_rag(hf_bert, fmt):
    model, dirs = hf_bert
    enc = BiEncoder("tiny-hf", spec=BertSpec(**TINY), seq_len=128, batch=8,
                    device="cpu", weights_path=str(dirs[fmt]))
    np.testing.assert_array_equal(
        enc.module.word_embeddings.weight.detach().numpy(),
        model.embeddings.word_embeddings.weight.detach().numpy())
    jax_enc = JaxBiEncoder("tiny-hf", spec=JaxSpec(**TINY), seq_len=128, batch=8,
                           weights_path=str(dirs[fmt]))
    texts = ["the moon temple on the silver cliff", "dragons guard the pass",
             " ".join(f"w{i}" for i in range(70))]
    np.testing.assert_allclose(enc.embed(texts), jax_enc.embed(texts), rtol=0, atol=1e-5)


def test_spec_from_hf_config_matches_tpu_rag(hf_bert):
    _, dirs = hf_bert
    got = hf_import.spec_from_hf_config(dirs["bin"])
    want = jax_hf.spec_from_hf_config(dirs["bin"])
    assert got == BertSpec(**TINY)
    assert (got.vocab_size, got.hidden, got.layers, got.heads, got.ffn, got.max_len) == (
        want.vocab_size, want.hidden, want.layers, want.heads, want.ffn, want.max_len)
    assert hf_import.spec_from_hf_config(dirs["bin"] / "pytorch_model.bin") == got
    assert hf_import.spec_from_hf_config(dirs["bin"] / "nope") is None


def test_unusable_checkpoints_give_seeded_weights(tmp_path, hf_bert, caplog):
    """As in tpu_rag: no file, a missing key or a shape that does not fit the
    spec gives None, and the encoder serves seeded weights."""
    model, _ = hf_bert
    spec = BertSpec(**TINY)
    missing = tmp_path / "missing"
    missing.mkdir()
    sd = model.state_dict()
    torch.save({k: v for k, v in sd.items() if "layer.1.output.dense" not in k},
               missing / "pytorch_model.bin")
    wide = tmp_path / "wide"
    wide.mkdir()
    transformers.BertModel(_hf_config()).save_pretrained(wide)
    cases = [(tmp_path / "absent", TINY), (tmp_path, TINY), (missing, TINY),
             (wide, dict(TINY, hidden=64))]
    with caplog.at_level(logging.WARNING, logger="tpu_rag_torch"):
        for path, spec_kw in cases:
            assert hf_import.load_bert_params(path, BertSpec(**spec_kw)) is None, path
            assert jax_hf.load_bert_params(path, JaxSpec(**spec_kw)) is None, path
    assert sum(r.name == "tpu_rag_torch" and "does not match spec" in r.getMessage()
               for r in caplog.records) == 2            # the missing key, the shape
    enc = BiEncoder("x", spec=spec, device="cpu", weights_path=str(missing))
    want = BiEncoder("x", spec=spec, device="cpu")
    for k, v in want.module.state_dict().items():
        assert torch.equal(enc.module.state_dict()[k], v)


def test_orbax_directory_raises(tmp_path):
    """Divergence: tpu_rag restores an orbax directory (its trainers' format);
    the port cannot read it and raises instead of serving seeded weights."""
    import orbax.checkpoint as ocp

    path = tmp_path / "ckpt"
    ck = ocp.StandardCheckpointer()
    ck.save(str(path), {"bert": {"w": np.ones((2, 2), np.float32)}}, force=True)
    ck.wait_until_finished()
    spec = BertSpec(**TINY)
    with pytest.raises(NotImplementedError, match="orbax"):
        hf_import.load_bert_params(path, spec)
    with pytest.raises(NotImplementedError, match="orbax"):
        BiEncoder("x", spec=spec, device="cpu", weights_path=str(path))
    with pytest.raises(NotImplementedError, match="orbax"):
        CrossEncoder("x", spec=spec, device="cpu", weights_path=str(path))


def test_chip_smoke_checkpoints_load(tmp_path):
    """The checkpoints chip_smoke.py writes with plain torch/numpy (a
    model.safetensors bi-encoder, a pytorch_model.bin cross-encoder) read
    back equal through the safetensors package and load into the port."""
    import chip_smoke

    spec = BertSpec(**TINY)
    bi_dir, bi, ce_dir, ce = chip_smoke._write_checkpoints(tmp_path, spec)
    ref = safetensors.numpy.load_file(str(bi_dir / "model.safetensors"))
    assert sorted(ref) == sorted(bi)
    for name, arr in ref.items():
        np.testing.assert_array_equal(arr, bi[name].numpy())
    enc = BiEncoder("x", spec=spec, device="cpu", weights_path=str(bi_dir))
    assert torch.equal(enc.module.layers[1].output.weight,
                       bi["encoder.layer.1.output.dense.weight"])
    cross = CrossEncoder("x", spec=spec, device="cpu", weights_path=str(ce_dir))
    assert torch.equal(cross.module.classifier.weight, ce["classifier.weight"])
    assert torch.equal(cross.module.bert.word_embeddings.weight,
                       ce["bert.embeddings.word_embeddings.weight"])
