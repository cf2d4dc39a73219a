"""Tensor parallelism over a mesh "model" axis in tpu_rag_torch against
tpu_rag, on the CPU: the counterparts of tests/test_vocab_and_dp_embed.py's
TP embeds and tests/test_train.py's DP x TP trainer.

tpu_rag runs on its 8-device virtual CPU mesh (tests/conftest.py), the port
on a mesh of ["cpu"] * 8 (its ranks run one after another), both from the
same Flax-initialised params (params_from_flax).  Tolerances: embeddings
within 1e-5 of tpu_rag's and of the unsharded port (tpu_rag's own TP tests
hold 1e-5), at T 32 (plain attention) and T 128 (kernel #5's plain version
on each rank's heads), at head dim 16 and 64; three DP x TP train steps
within 1e-5 of tpu_rag's losses and parameters (test_torch_train.py's
tolerance and its key-bias rule); the shard / gather round trip exact.
Widths are tiny and torch runs one thread."""

import json

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from test_torch_train import LR, SPEC, _batch
from tpu_rag.models.bert import BertSpec as JaxSpec
from tpu_rag.models.bert import param_partition_spec as jax_partition_spec
from tpu_rag.models.biencoder import BiEncoder as JaxBiEncoder
from tpu_rag.train.contrastive import ContrastiveTrainer as JaxTrainer
from tpu_rag_torch.models.bert import (BertEncoder, BertSpec, TensorParallelEncoder,
                                       params_from_flax)
from tpu_rag_torch.models.biencoder import BiEncoder
from tpu_rag_torch.parallel import mesh_from_spec
from tpu_rag_torch.parallel.tensor import (check_divisible, gather_rows, gather_state_dict,
                                           param_partition_spec, reduce_partials,
                                           shard_state_dict)
from tpu_rag_torch.train.contrastive import ContrastiveTrainer

CPU8 = ["cpu"] * 8
# head dim 16 (the repo's tiny test spec) and head dim 64 (bge-base's)
SPECS = {"hd16": dict(vocab_size=512, hidden=64, layers=2, heads=4, ffn=128, max_len=128),
         "hd64": dict(vocab_size=512, hidden=128, layers=2, heads=2, ffn=256, max_len=128)}
TEXTS = ([f"sentence number {i} about topic {i % 3}" for i in range(10)]
         + [" ".join(f"word{i}{j}" for j in range(150)) for i in range(3)])  # T 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def flax_params():
    """name -> (JaxSpec, tpu_rag's initial params as numpy) for SPECS."""
    out = {}
    for name, kw in SPECS.items():
        enc = JaxBiEncoder(spec=JaxSpec(**kw), seq_len=128, batch=8)
        out[name] = (JaxSpec(**kw), jax.tree_util.tree_map(np.asarray, enc.params))
    return out


def _jax_mesh(spec: str) -> JaxMesh:
    devs = np.array(jax.devices()[:8])
    if spec == "model:2":
        return JaxMesh(devs[:2], axis_names=("model",))
    return JaxMesh(devs.reshape(4, 2), axis_names=("data", "model"))


def test_model_groups():
    m = mesh_from_spec("data:4,model:2", [f"cpu:{i}" for i in range(8)])
    groups = [[d.index for d in g] for g in m.model_groups()]
    assert groups == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert [d.index for d in m.axis_devices("data")] == [0, 2, 4, 6]
    swapped = mesh_from_spec("model:2,data:4", [f"cpu:{i}" for i in range(8)])
    assert [[d.index for d in g] for g in swapped.model_groups()] == [
        [0, 4], [1, 5], [2, 6], [3, 7]]
    assert [len(g) for g in mesh_from_spec("model:2", CPU8[:2]).model_groups()] == [2]
    assert [len(g) for g in mesh_from_spec("", CPU8).model_groups()] == [1] * 8


def test_partition_rules_match_tpu_rag(flax_params):
    """Which model rank holds each element of every parameter, by tpu_rag's
    rules (its PartitionSpec over a (4, 2) mesh) carried through
    params_from_flax, against the port's: equal everywhere but the FFN's
    1-d bias, which tpu_rag replicates and the port's column split slices."""
    jspec, params = flax_params["hd16"]

    def labels(split, shape):
        out = np.full(shape, -1.0, np.float32)
        if "model" in split:
            axis = list(split).index("model")
            for rank, idx in enumerate(np.array_split(np.arange(shape[axis]), 2)):
                np.moveaxis(out, axis, 0)[idx] = rank
        return out

    jax_labels = params_from_flax(jax.tree_util.tree_map_with_path(
        lambda path, leaf: labels(tuple(jax_partition_spec(path, leaf)), leaf.shape), params))
    differ = []
    for name, want in jax_labels.items():
        got = torch.from_numpy(labels(param_partition_spec(name, want.shape), want.shape))
        if not torch.equal(got, want):
            differ.append(name)
            assert set(want.unique().tolist()) == {-1.0}           # replicated there
    assert differ == [f"layers.{i}.intermediate.bias" for i in range(jspec.layers)]
    assert sum(1 for n in jax_labels if param_partition_spec(n, jax_labels[n].shape)) == 10 * 2


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_gather_round_trip(flax_params, tp):
    spec = BertSpec(**SPECS["hd16"])
    sd = params_from_flax(flax_params["hd16"][1])
    shards = shard_state_dict(sd, spec, tp)
    for rank, part in enumerate(shards):
        want = BertEncoder(spec, tp=tp, rank=rank).state_dict()
        assert {k: tuple(v.shape) for k, v in part.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
    back = gather_state_dict(shards)
    assert list(back) == list(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    module = TensorParallelEncoder(spec, ["cpu"] * tp)
    module.load_state_dict(sd)
    out = module.state_dict()
    assert all(torch.equal(out[k], sd[k]) for k in sd)


def test_collectives_are_ordered_and_differentiable():
    parts = [torch.full((2, 3), float(i), requires_grad=True) for i in range(3)]
    total = reduce_partials(parts)
    rows = gather_rows([p * 2 for p in parts], torch.device("cpu"))
    assert torch.equal(total, torch.full((2, 3), 3.0)) and rows.shape == (6, 3)
    (total.sum() + rows.sum()).backward()
    assert all(torch.equal(p.grad, torch.full((2, 3), 3.0)) for p in parts)


@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("mesh_spec", ["data:4,model:2", "model:2"])
def test_tp_embed_matches_tpu_rag(flax_params, spec_name, mesh_spec):
    """The port's TP BiEncoder against tpu_rag's on the same mesh geometry
    and against the unsharded port, within 1e-5, over short texts (T 32)
    and long ones (T 128: #5's plain version on each rank's heads)."""
    jspec, params = flax_params[spec_name]
    jax_tp = JaxBiEncoder(spec=jspec, seq_len=128, batch=8, mesh=_jax_mesh(mesh_spec))
    jax_tp.params = jax.device_put(params, jax_tp._param_shardings)
    spec = BertSpec(**SPECS[spec_name])
    sd = params_from_flax(params)
    single = BiEncoder(spec=spec, seq_len=128, batch=8, device="cpu", state_dict=sd)
    mesh = mesh_from_spec(mesh_spec, CPU8[:8 if "data" in mesh_spec else 2])
    tp = BiEncoder(spec=spec, seq_len=128, batch=8, device="cpu", state_dict=sd, mesh=mesh)
    assert isinstance(tp.module, TensorParallelEncoder) and len(tp._replicas) == 1
    assert len(tp._groups) == mesh.shape.get("data", 1) and tp.batch == 8
    assert [s.layers[0].attention.heads for s in tp.module.shards] == [spec.heads // 2] * 2
    assert len(tp.tokenizer.tokenize_ids(TEXTS[-1])) > 126  # cut to 126 + 2: T 128
    got = tp.embed(TEXTS)
    assert got.shape == (len(TEXTS), spec.hidden)
    np.testing.assert_allclose(got, jax_tp.embed(TEXTS), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, single.embed(TEXTS), rtol=0, atol=1e-5)


def test_heads_or_ffn_the_model_axis_does_not_divide_raise():
    spec = BertSpec(**SPECS["hd16"])                        # 4 heads, FFN 128
    check_divisible(spec, 4)
    with pytest.raises(ValueError, match='"model" mesh axis of size 3 does not divide the '
                                         'attention heads'):
        check_divisible(spec, 3)
    with pytest.raises(ValueError, match="FFN width"):
        check_divisible(BertSpec(**{**SPECS["hd16"], "ffn": 130}), 4)
    with pytest.raises(ValueError, match='"model" mesh axis of size 8'):
        BiEncoder(spec=spec, device="cpu", mesh=mesh_from_spec("model:8", CPU8))
    with pytest.raises(ValueError, match='"model" mesh axis of size 3'):
        ContrastiveTrainer(spec, device="cpu", mesh=mesh_from_spec("data:2,model:3",
                                                                  ["cpu"] * 6))
    with pytest.raises(RuntimeError, match="TensorParallelEncoder"):
        BertEncoder(spec, tp=2)(torch.zeros(1, 4, dtype=torch.long),
                                torch.ones(1, 4, dtype=torch.int32))


def _jax_trainer_and_start():
    mesh = JaxMesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    jt = JaxTrainer(JaxSpec(**SPEC), mesh, lr=LR)
    return jt, params_from_flax(jax.device_get(jt.params))


def test_dp_tp_train_steps_match_tpu_rag():
    """Three steps of tpu_rag's trainer on its (4, 2) mesh and of the port's
    on data:4,model:2 of the CPU, from tpu_rag's initial parameters (remat
    on, lr 5e-4, half-masked rows): losses within 1e-5 at every step,
    parameters within 1e-5, but the key biases, whose true gradient is zero
    (test_torch_train.py::test_three_train_steps_match_tpu_rag): the port's
    is rounding noise, and both stay within Adam's bound of the start."""
    rng = np.random.default_rng(0)
    jt, start = _jax_trainer_and_start()
    trainer = ContrastiveTrainer(BertSpec(**SPEC), lr=LR, device="cpu",
                                 mesh=mesh_from_spec("data:4,model:2", CPU8))
    assert isinstance(trainer.module, TensorParallelEncoder)
    assert trainer.module.remat and not trainer.module.flash
    assert len(trainer._groups) == 4 and len(trainer.module.shards) == 2
    trainer.module.load_state_dict(start)
    for step in range(3):
        batch = _batch(rng)
        want, got = jt.train_step(batch), trainer.train_step(batch)
        assert abs(got - want) <= 1e-5, (step, got, want)

    ref = params_from_flax(jax.device_get(jt.params))
    sd = trainer.module.state_dict()
    key_bias = {f"layers.{i}.attention.key.bias" for i in range(SPEC["layers"])}
    for name in ref:
        if name in key_bias:
            continue
        np.testing.assert_allclose(sd[name].numpy(), ref[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
        assert not torch.equal(sd[name], start[name]), name
    for name in key_bias:
        rank_grads = [s.get_parameter(name).grad for s in trainer.module.shards]
        scale = max(float(s.get_parameter(name.replace("key", "query")).grad.abs().max())
                    for s in trainer.module.shards)
        assert max(float(g.abs().max()) for g in rank_grads) < 1e-4 * scale, name
        for params in (sd, ref):
            assert float((params[name] - start[name]).abs().max()) <= 3 * LR * 1.01


def test_tp_trainer_checkpoint_serves_unsharded_and_in_tpu_rag(tmp_path):
    """A DP x TP trainer's save gathers one HF directory: the port's
    unsharded BiEncoder holds the trained tensors bit for bit, a TP
    BiEncoder of it embeds within 1e-5 of the unsharded one, and tpu_rag's
    BiEncoder within 2e-4 (test_torch_train.py's checkpoint tolerance)."""
    trainer = ContrastiveTrainer(BertSpec(**SPEC), lr=1e-3, device="cpu",
                                 mesh=mesh_from_spec("data:2,model:2", CPU8[:4]))
    trainer.train_step(_batch(np.random.default_rng(3)))
    ckpt = str(tmp_path / "ckpt")
    trainer.save(ckpt)
    assert json.loads((tmp_path / "ckpt" / "config.json").read_text())["num_attention_heads"] == 4
    enc = BiEncoder(weights_path=ckpt, seq_len=64, batch=8, device="cpu")
    want = trainer.module.state_dict()
    got = enc.module.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    tp = BiEncoder(weights_path=ckpt, seq_len=64, batch=8, device="cpu",
                   mesh=mesh_from_spec("data:2,model:2", CPU8[:4]))
    texts = TEXTS[:4] + TEXTS[-1:]
    np.testing.assert_allclose(tp.embed(texts), enc.embed(texts), rtol=0, atol=1e-5)
    jax_enc = JaxBiEncoder(spec=JaxSpec(**SPEC), weights_path=ckpt, seq_len=64, batch=8)
    np.testing.assert_allclose(enc.embed(texts), jax_enc.embed(texts), rtol=0, atol=2e-4)
    trainer.load(ckpt)                                   # each rank takes its share back
    assert trainer.step == 0
    assert all(torch.equal(trainer.module.state_dict()[k], want[k]) for k in want)


def test_engine_serves_mesh_shape_data_model(tmp_path, monkeypatch):
    """MESH_SHAPE=data:2,model:2 through RagEngine (the mesh on ["cpu"] * 4,
    which the engine builds only from two or more cards: patched in): a TP
    encoder group per data position and a ShardedFlatIndex over the data
    axis; /docs/save, then /search finds each document first."""
    from test_torch_sharded import SLICE_DOCS
    from tpu_rag_torch.api.app import create_app
    from tpu_rag_torch.api.testclient import TestClient
    from tpu_rag_torch.config import Config
    from tpu_rag_torch.engine import RagEngine
    from tpu_rag_torch.parallel import ShardedFlatIndex

    mesh = mesh_from_spec("data:2,model:2", CPU8[:4])
    monkeypatch.setattr(RagEngine, "_mesh", lambda self: mesh)
    cfg = Config(persist_dir=str(tmp_path / "vs"), kb_db_path=str(tmp_path / "db" / "kb.sqlite3"),
                 db_path=str(tmp_path / "db" / "app.sqlite3"), docs_dir=str(tmp_path / "docs"),
                 embedding_model="tiny", mesh_shape="data:2,model:2", device="cpu",
                 model_priority=("extractive",), summarize_mode="off")
    engine = RagEngine(cfg)
    try:
        client = TestClient(create_app(cfg, engine=engine))
        for d in SLICE_DOCS:
            assert client.post("/docs/save", json=d).status_code == 200
        assert type(engine.index) is ShardedFlatIndex and len(engine.index.shard_devices()) == 2
        assert isinstance(engine.encoder.module, TensorParallelEncoder)
        assert len(engine.encoder._groups) == 2 and len(engine.encoder._replicas) == 1
        for d in SLICE_DOCS:
            r = client.post("/search", json={"query": d["content"], "k": 3}).json()
            assert r["hits"][0]["metadata"]["title"] == d["title"], r["hits"]
    finally:
        engine.shutdown()
