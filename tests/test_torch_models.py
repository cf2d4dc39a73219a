"""Parity of the port's BERT trunk and BiEncoder with tpu_rag's Flax models
on the CPU (both compute in f32 there).

A small spec (2 layers, hidden 64, 4 heads) is initialised by Flax and
carried into the port with params_from_flax.  Hidden states agree within
1e-4 at T = 32 (plain attention) and T = 128 (fused attention: the Pallas
kernel in interpret mode against the port's plain version); BiEncoder
embeddings within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_rag.models.bert import BertEncoder as JaxBert
from tpu_rag.models.bert import BertSpec as JaxSpec
from tpu_rag.models.biencoder import BiEncoder as JaxBiEncoder
from tpu_rag_torch.models.bert import BertEncoder, BertSpec, params_from_flax
from tpu_rag_torch.models.biencoder import BiEncoder, init_params

SMALL = dict(vocab_size=1024, hidden=64, layers=2, heads=4, ffn=128, max_len=256)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("t", [32, 128])
def test_bert_hidden_states_match_flax(t):
    rng = np.random.default_rng(t)
    jax_mod = JaxBert(JaxSpec(**SMALL), flash=True)
    ids = rng.integers(4, SMALL["vocab_size"], (2, t)).astype(np.int32)
    mask = np.ones((2, t), np.int32)
    mask[1, t // 3:] = 0
    ids[mask == 0] = 0
    params = jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"]
    want = np.asarray(jax_mod.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))

    mod = BertEncoder(BertSpec(**SMALL))
    mod.load_state_dict(params_from_flax(_numpy_tree(params)))
    with torch.no_grad():
        got = mod(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)   # pad rows too


def test_biencoder_embed_matches_flax():
    spec_kw = dict(vocab_size=1024, hidden=64, layers=2, heads=4, ffn=128, max_len=512)
    jax_enc = JaxBiEncoder("tiny-parity", spec=JaxSpec(**spec_kw), seq_len=256, batch=8)
    enc = BiEncoder("tiny-parity", spec=BertSpec(**spec_kw), seq_len=256, batch=8,
                    device="cpu", state_dict=params_from_flax(_numpy_tree(jax_enc.params)))
    texts = ["the moon temple on the silver cliff",
             "dragons guard the northern pass",
             " ".join(f"word{i}" for i in range(150)),   # T = 256 bucket: fused path
             "月之神殿"]
    want = jax_enc.embed(texts)
    got = enc.embed(texts)
    assert got.shape == (4, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(enc.tokenize_query_ids(texts[:2]),
                                  jax_enc.tokenize_query_ids(texts[:2]))
    np.testing.assert_allclose(enc.forward_ids(enc.tokenize_query_ids(texts[:2]))[:2].numpy(),
                               want[:2], rtol=0, atol=1e-5)


def test_seeded_weights_are_deterministic():
    a = init_params(BertSpec(**SMALL), 7)
    b = init_params(BertSpec(**SMALL), 7)
    assert all(torch.equal(a[k], b[k]) for k in a)
    enc = BiEncoder("tiny", device="cpu")
    assert enc.embed(["x"]).shape == (1, 64)
