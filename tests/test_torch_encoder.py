"""The port's text encoder (cortex_tpu_torch.models, ops.encoder's plain
versions, TorchEncoderEmbedder, default_embedder, Cortex with a
"flax:<npz>" model) against the JAX package's on the CPU.

Inputs are made from seeds with numpy and go through both packages.
Criteria:
  * the forward (BertEncoder against cortex_tpu's bert_encode): max abs
    <= 1e-5 at TINY (hidden 32, 2 layers) and <= 1e-4 at the full
    BGE-small-en-v1.5 width (12 layers of float32 sums in another order);
  * E1's and E2's plain versions against the reference's `_layer_norm`
    and attention lines: max abs <= 1e-5 (outputs of order 1);
  * embedders: <= 1e-5 at TINY (the reference pads S to a bucket and B to
    a power of two, the port to the batch's longest row: padding is
    masked, so only the sums' order differs);
  * Cortex: the same hits, scores within 1e-4 (decay factors are taken
    at each call's own clock), ids equal but for exact ties.
"""

import copy
import inspect
import re
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cortex_tpu import Cortex as JaxCortex
from cortex_tpu.config import CortexConfig as JaxConfig
from cortex_tpu.models import encoder as jenc
from cortex_tpu.storage import MemoryStorage as JaxMemory
from cortex_tpu.types import Node as JaxNode
from cortex_tpu.types import Source as JaxSource
from cortex_tpu.vector import embedding as jemb
from cortex_tpu_torch import Cortex
from cortex_tpu_torch.config import CortexConfig
from cortex_tpu_torch.errors import DeviceUnavailable, EmbeddingError
from cortex_tpu_torch.models import encoder as tenc
from cortex_tpu_torch.models.tokenizer import WordPieceTokenizer
from cortex_tpu_torch.ops import encoder as ops
from cortex_tpu_torch.storage import MemoryStorage
from cortex_tpu_torch.types import Node
from cortex_tpu_torch.vector import embedding as temb

REPO = Path(__file__).resolve().parent.parent
TINY_ATOL = 1e-5
FULL_ATOL = 1e-4
CORTEX_ATOL = 1e-4
TINY = dict(vocab_size=120, hidden=32, layers=2, heads=2, intermediate=64,
            max_position=64)
WORDS = [f"w{i}" for i in range(60)] + [f"item{i}" for i in range(40)]
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
KINDS = ("fact", "event", "decision", "goal", "observation")
VOCAB = SPECIALS + ["fact", "event", "decision", "goal", "observation",
                    "tags", ":", ",", "##s"] + WORDS
TEXTS = ["w1 w2 w3", "item7 w40 w41 w42 w43 w44 w45 w46 w47 w48",
         "w5 unknownword", "", "items w9, w10: w11",
         " ".join(WORDS[:50]), "w59"]


def configs(**kw):
    """(reference config, port config) with the same fields."""
    fields = {**TINY, **kw}
    return jenc.BertEncoderConfig(**fields), tenc.BertEncoderConfig(**fields)


def padded_ids(cfg, b, s, seed):
    """[B, S] ids and a mask whose first row is full and whose others
    keep 2..S tokens (the padding holds token 0)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    lengths = rng.integers(2, s + 1, b)
    lengths[0] = s
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return ids * mask, mask


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ------------------------------------------------------------ copies


def _without_imports(text):
    return [line for line in text.splitlines()
            if not re.match(r"\s*(from|import)\s", line)]


@pytest.mark.parametrize("rel", ["models/tokenizer.py", "models/convert.py"])
def test_copy_matches_reference(rel):
    ref = (REPO / "cortex_tpu" / rel).read_text()
    port = (REPO / "cortex_tpu_torch" / rel).read_text()
    assert _without_imports(port) == _without_imports(ref)


@pytest.mark.parametrize("name", ["BertEncoderConfig", "init_params",
                                  "convert_hf_state_dict", "save_npz",
                                  "load_npz", "load_npz_tokenizer"])
def test_numpy_side_matches_reference(name):
    ref = inspect.getsource(getattr(jenc, name))
    port = inspect.getsource(getattr(tenc, name))
    assert _without_imports(port) == _without_imports(ref)


# ------------------------------------------------------------ forward


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_forward_matches_reference_tiny(pooling):
    jcfg, tcfg = configs(pooling=pooling)
    params = jenc.init_params(jcfg, seed=3)
    ids, mask = padded_ids(jcfg, 5, 17, seed=4)
    want = jenc.bert_encode(params, jcfg, ids, mask)
    module = tenc.BertEncoder.from_params(params, tcfg, device="cpu")
    got = tenc.bert_encode(module, ids, mask)
    assert got.shape == (5, 32) and got.dtype == np.float32
    assert max_abs(got, want) <= TINY_ATOL


def test_forward_matches_reference_full_width():
    jcfg, tcfg = jenc.BertEncoderConfig(), tenc.BertEncoderConfig()
    assert (tcfg.vocab_size, tcfg.hidden, tcfg.layers, tcfg.heads,
            tcfg.intermediate, tcfg.max_position, tcfg.layernorm_eps,
            tcfg.pooling) == (30522, 384, 12, 12, 1536, 512, 1e-12, "cls")
    params = jenc.init_params(jcfg, seed=11)
    wp = WordPieceTokenizer(VOCAB)
    ids, mask = wp.encode_batch(TEXTS[:4])
    want = jenc.bert_encode(params, jcfg, ids, mask)
    module = tenc.BertEncoder.from_params(params, tcfg, device="cpu")
    assert max_abs(tenc.bert_encode(module, ids, mask), want) <= FULL_ATOL


def test_eps_round_trip(tmp_path):
    jcfg, tcfg = configs(layernorm_eps=1e-3)
    params = tenc.init_params(tcfg, seed=2)
    path = str(tmp_path / "eps.npz")
    tenc.save_npz(path, params, tcfg)
    p_ref, c_ref = jenc.load_npz(path)
    p_port, c_port = tenc.load_npz(path)
    assert c_ref.layernorm_eps == c_port.layernorm_eps == 1e-3
    ids, mask = padded_ids(jcfg, 3, 9, seed=1)
    want = jenc.bert_encode(p_ref, c_ref, ids, mask)
    module = tenc.BertEncoder.from_params(p_port, c_port, device="cpu")
    assert max_abs(tenc.bert_encode(module, ids, mask), want) <= TINY_ATOL
    # the default eps gives other embeddings (the rows' variance is ~1e-3)
    module = tenc.BertEncoder.from_params(
        p_port, replace(c_port, layernorm_eps=1e-12), device="cpu")
    assert max_abs(tenc.bert_encode(module, ids, mask), want) > TINY_ATOL


@pytest.mark.parametrize("t,h,p", [(12, 32, 12), (12, 384, 4), (1, 37, 1)])
def test_layer_norm_plain_matches_reference(t, h, p):
    rng = np.random.default_rng(t * h)
    x, r = rng.normal(0.5, 3.0, (t, h)), rng.normal(0.0, 1.0, (p, h))
    g, b = rng.normal(1.0, 0.1, h), rng.normal(0.0, 0.1, h)
    x, r, g, b = (a.astype(np.float32) for a in (x, r, g, b))
    v = (x.reshape(-1, p, h) + r).reshape(t, h)
    want = jenc._layer_norm(jnp.asarray(v), g, b, 1e-12)
    got = ops.add_layer_norm(*(torch.from_numpy(a) for a in (x, r, g, b)),
                             1e-12)
    assert max_abs(got.numpy(), want) <= TINY_ATOL


def _reference_attention(q, k, v, mask_bias):
    """cortex_tpu/models/encoder.py:216-221 as written there."""
    dh = q.shape[-1]
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(jnp.float32(dh))
    scores = scores + mask_bias[:, None, None, :]
    attn = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", attn, v)


@pytest.mark.parametrize("b,h,s,dh", [(3, 2, 9, 16), (2, 12, 31, 32),
                                      (1, 4, 1, 64)])
def test_attention_plain_matches_reference(b, h, s, dh):
    rng = np.random.default_rng(s)
    q, k, v = (rng.normal(0, 1, (b, h, s, dh)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[1:, s // 2 + 1:] = 0
    bias = np.where(mask > 0, 0.0, -1e30).astype(np.float32)
    want = _reference_attention(q, k, v, bias)
    got = ops.masked_attention(*(torch.from_numpy(a)
                                 for a in (q, k, v, bias)))
    assert max_abs(got.numpy(), want) <= TINY_ATOL


@pytest.mark.parametrize("s,dh", [(40, 16), (129, 32), (200, 64)])
def test_attention_plain_matches_reference_on_mask_patterns(s, dh):
    # masks the card's kernel walks tile by tile: masked keys in front,
    # in the middle, a masked run of 64 between kept keys, only the last
    # key kept, and a row with every key masked (the mean of v)
    rng = np.random.default_rng(s + dh)
    q, k, v = (rng.normal(0, 1, (5, 2, s, dh)).astype(np.float32)
               for _ in range(3))
    keys = np.arange(s)
    mask = np.stack([keys >= s // 3,
                     (keys < s // 4) | (keys >= s // 2),
                     (keys < 64) | (keys >= 128),
                     keys == s - 1,
                     np.zeros(s, bool)])
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)
    want = _reference_attention(q, k, v, bias)
    got = ops.masked_attention(*(torch.from_numpy(a)
                                 for a in (q, k, v, bias)))
    assert max_abs(got.numpy(), want) <= TINY_ATOL


def test_encoder_layer_matches_reference():
    jcfg, tcfg = configs()
    params = jenc.init_params(jcfg, seed=8)
    lp = params["layers"][1]
    ids, mask = padded_ids(jcfg, 4, 11, seed=2)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 11, 32)).astype(np.float32)
    bias = np.where(mask > 0, 0.0, -1e30).astype(np.float32)
    want = jenc._encoder_layer(jnp.asarray(x), jnp.asarray(bias), lp, 2,
                               1e-12)
    layer = tenc._Layer(lp, torch.device("cpu"))
    got = layer(torch.from_numpy(x.reshape(44, 32)), torch.from_numpy(bias),
                2, 1e-12)
    assert max_abs(got.numpy().reshape(4, 11, 32), want) <= TINY_ATOL


# ------------------------------------------------------------ wrappers


def test_cpu_tensors_run_the_plain_versions_uncounted():
    before = (ops.add_layer_norm.launches, ops.masked_attention.launches)
    x = torch.randn(6, 16)
    ops.add_layer_norm(x, x, torch.ones(16), torch.zeros(16), 1e-12)
    q = torch.randn(1, 2, 5, 16)            # dh 16: only the kernel refuses
    ops.masked_attention(q, q, q, torch.zeros(1, 5))
    assert (ops.add_layer_norm.launches,
            ops.masked_attention.launches) == before


def test_other_devices_raise():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ops.add_layer_norm(x, x, torch.empty(8, device="meta"),
                           torch.empty(8, device="meta"), 1e-12)
    q = torch.empty(1, 1, 4, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ops.masked_attention(q, q, q, torch.empty(1, 4, device="meta"))


@pytest.mark.parametrize("bad", ["shape", "rows", "dtype", "bias"])
def test_argument_checks_raise(bad):
    x, q = torch.randn(6, 8), torch.randn(2, 2, 5, 32)
    with pytest.raises(ValueError):
        if bad == "shape":
            ops.add_layer_norm(x, x, torch.ones(7), torch.zeros(8), 1e-12)
        elif bad == "rows":
            ops.add_layer_norm(x, x[:4], torch.ones(8), torch.zeros(8), 1e-12)
        elif bad == "dtype":
            ops.masked_attention(q.double(), q.double(), q.double(),
                                 torch.zeros(2, 5))
        else:
            ops.masked_attention(q, q, q, torch.zeros(2, 4))


# ------------------------------------------------------------ npz


def _save(pkg, path, cfg, seed, vocab=VOCAB):
    enc = jenc if pkg == "reference" else tenc
    params = enc.init_params(cfg, seed=seed)
    enc.save_npz(path, params, cfg, vocab=vocab)
    return params


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_npz_interchange(tmp_path, writer):
    jcfg, tcfg = configs(pooling="mean")
    path = str(tmp_path / "enc.npz")
    _save(writer, path, jcfg if writer == "reference" else tcfg, seed=5)
    p_ref, c_ref = jenc.load_npz(path)
    p_port, c_port = tenc.load_npz(path)
    assert c_ref.__dict__ == c_port.__dict__
    assert (jenc.load_npz_tokenizer(path).vocab_list
            == tenc.load_npz_tokenizer(path).vocab_list == VOCAB)
    ids, mask = padded_ids(jcfg, 4, 13, seed=6)
    want = jenc.bert_encode(p_ref, c_ref, ids, mask)
    module = tenc.BertEncoder.from_params(p_port, c_port, device="cpu")
    assert max_abs(tenc.bert_encode(module, ids, mask), want) <= TINY_ATOL


# ------------------------------------------------------------ embedders


@pytest.fixture
def npz(tmp_path):
    path = str(tmp_path / "tiny.npz")
    _save("port", path, configs()[1], seed=7)
    return path


def _toy_tokenizer(texts):
    ids = np.zeros((len(texts), 12), np.int32)
    mask = np.zeros((len(texts), 12), np.int32)
    for r, t in enumerate(texts):
        toks = [2] + [5 + sum(map(ord, w)) % 100 for w in t.split()][:10]
        ids[r, :len(toks)] = toks
        mask[r, :len(toks)] = 1
    return ids, mask


@pytest.mark.parametrize("n", [1, 3, 5, 7])
@pytest.mark.parametrize("form", ["npz_vocab", "vocab_dir", "callable"])
def test_embed_batch_matches_reference(npz, tmp_path, n, form):
    texts = (TEXTS * 2)[:n]
    kw = {}
    if form == "vocab_dir":
        (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
        kw = {"tokenizer": str(tmp_path)}
    elif form == "callable":
        kw = {"tokenizer": _toy_tokenizer}
    ref = jemb.JaxEncoderEmbedder(npz, **kw)
    port = temb.TorchEncoderEmbedder(npz, device="cpu", **kw)
    assert port.model_name == ref.model_name == f"flax:{npz}"
    assert port.dimension == ref.dimension == 32
    got = port.embed_batch(texts)
    assert got.shape == (n, 32) and got.dtype == np.float32
    assert max_abs(got, ref.embed_batch(texts)) <= TINY_ATOL
    assert max_abs(port.embed(texts[-1]), got[-1]) <= TINY_ATOL


def test_embedder_truncates_to_max_position(npz):
    long = " ".join(WORDS * 2)                      # 200 words, 64 positions
    ref = jemb.JaxEncoderEmbedder(npz)
    port = temb.TorchEncoderEmbedder(npz, device="cpu")
    assert max_abs(port.embed_batch([long, "w1"]),
                   ref.embed_batch([long, "w1"])) <= TINY_ATOL


def test_chunks_are_value_transparent(npz, monkeypatch):
    port = temb.TorchEncoderEmbedder(npz, device="cpu")
    texts = TEXTS * 3
    whole = port.embed_batch(texts)
    ids, mask = WordPieceTokenizer(VOCAB).encode_batch(texts, max_length=64)
    # the CPU's plain attention: 3 [H, S, S] tensors beside the rest
    per_token = 4 * (6 * 32 + 2 * 64) + 4 * 3 * 2 * 64
    # two rows of max_position (64) a chunk: embed_batch tokenizes 11
    # chunks of 2 texts and embed_tokens runs 11 chunks of the batch's
    # ids, each cut to its own longest row
    monkeypatch.setattr(temb, "ACTIVATION_BUDGET_BYTES", per_token * 64 * 2)
    assert port.chunk_rows(64) == 2
    assert max_abs(port.embed_batch(texts), whole) <= TINY_ATOL
    assert max_abs(port.embed_tokens(ids, mask), whole) <= TINY_ATOL
    assert port.embed_batch([]).shape == (0, 32)
    assert port.embed_tokens(ids[:0], mask[:0]).shape == (0, 32)


def test_chunk_rows_at_bge_small():
    cfg = tenc.BertEncoderConfig()
    # the kernels hold no [H, S, S] scores; the plain attention does
    assert [temb.chunk_rows(cfg, s, plain_attention=False)
            for s in (512, 128)] == [195, 780]
    assert [temb.chunk_rows(cfg, s, plain_attention=True)
            for s in (512, 128)] == [44, 420]


def test_cpu_chunk_holds_its_attention_scores(npz):
    """A CPU embedder sizes its chunks for the plain attention: at S 512
    and BGE-small's 12 heads, a chunk's three [rows, H, S, S] float32
    score tensors and the rest of its activations stay within the
    budget."""
    port = temb.TorchEncoderEmbedder(npz, device="cpu")
    assert port.chunk_rows(64) == temb.chunk_rows(
        port._cfg, 64, plain_attention=True)
    cfg = tenc.BertEncoderConfig()
    rows = temb.chunk_rows(cfg, 512, plain_attention=True)
    scores = 3 * rows * cfg.heads * 512 * 512 * 4
    rest = rows * 512 * 4 * (6 * cfg.hidden + 2 * cfg.intermediate)
    assert rows == 44 and scores + rest <= temb.ACTIVATION_BUDGET_BYTES


def test_default_embedder_flax(npz, tmp_path):
    port = temb.default_embedder(f"flax:{npz}", device="cpu")
    ref = jemb.default_embedder(f"flax:{npz}")
    assert isinstance(port, temb.TorchEncoderEmbedder)
    assert port.model_name == ref.model_name
    assert max_abs(port.embed_batch(TEXTS), ref.embed_batch(TEXTS)) <= \
        TINY_ATOL
    # an npz without a vocab and no tokenizer falls back to hashing in
    # both packages
    bare = str(tmp_path / "bare.npz")
    _save("port", bare, configs()[1], seed=7, vocab=None)
    for fb in (temb.default_embedder(f"flax:{bare}", device="cpu"),
               jemb.default_embedder(f"flax:{bare}")):
        assert fb.model_name.startswith("hash")
    # the tokenizer after "::" is honoured
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    spec = f"flax:{bare}::{tmp_path}"
    assert isinstance(temb.default_embedder(spec, device="cpu"),
                      temb.TorchEncoderEmbedder)


def test_default_embedder_asks_for_the_card(npz):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the card is found")
    with pytest.raises(DeviceUnavailable):
        temb.default_embedder(f"flax:{npz}")
    # hashing needs no device
    assert temb.default_embedder("hash-64").model_name == "hash-64"


def test_st_embedder_asks_for_the_card(tmp_path):
    """STEmbedder runs on the card unless the caller names the CPU: with
    weights on disk (a local model dir) and no CUDA it raises rather
    than loading onto the CPU; without weights it raises EmbeddingError,
    on which default_embedder falls back to hashing."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the card is found")
    with pytest.raises(DeviceUnavailable):
        temb.STEmbedder(str(tmp_path))
    with pytest.raises(EmbeddingError):
        temb.STEmbedder(str(tmp_path / "absent"))


def test_default_embedder_serves_a_local_hf_snapshot(tmp_path, monkeypatch):
    """A tiny random HF BERT snapshot on disk: both packages convert it
    once into their model cache and serve the device encoder."""
    pytest.importorskip("transformers")
    from transformers import BertConfig, BertModel, BertTokenizerFast
    snap = tmp_path / "snapshot"
    hf_cfg = BertConfig(vocab_size=len(VOCAB), hidden_size=64,
                        num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=128, max_position_embeddings=64,
                        hidden_act="gelu", attention_probs_dropout_prob=0.0,
                        hidden_dropout_prob=0.0)
    torch.manual_seed(3)
    BertModel(hf_cfg, add_pooling_layer=False).eval().save_pretrained(snap)
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt")
                      ).save_pretrained(snap)
    out = {}
    for name, mod, kw in (("reference", jemb, {}),
                          ("port", temb, {"device": "cpu"})):
        monkeypatch.setenv("CORTEX_MODEL_CACHE", str(tmp_path / name))
        emb = mod.default_embedder(str(snap), **kw)
        assert emb.model_name == f"flax:{snap}" and emb.dimension == 64
        assert len(list((tmp_path / name).glob("*.npz"))) == 1
        out[name] = emb.embed_batch(TEXTS)
    assert isinstance(emb, temb.TorchEncoderEmbedder)
    assert max_abs(out["port"], out["reference"]) <= TINY_ATOL


def test_empty_local_dir_falls_back_to_hashing(tmp_path):
    emb = temb.default_embedder(str(tmp_path), device="cpu")
    assert emb.model_name == "hash-384"
    assert emb.model_name == jemb.default_embedder(str(tmp_path)).model_name


# ------------------------------------------------------------ Cortex


def _nodes(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        title = " ".join(rng.choice(WORDS[:60], 3)) + f" item{i}"
        body = " ".join(rng.choice(WORDS, int(rng.integers(3, 30))))
        out.append(JaxNode.new(KINDS[i % 5], title, body,
                               JaxSource(agent=f"agent{i % 3}"),
                               float(rng.uniform(0.2, 0.9))))
    return out


def assert_same(want, got):
    """Same scores rank by rank, and another id at a rank only where the
    scores tie."""
    ws = [s for s, _ in want]
    np.testing.assert_allclose([s for s, _ in got], ws, atol=CORTEX_ATOL)
    w = {n.id: s for s, n in want}
    g = {n.id: s for s, n in got}
    for (sw, nw), (_, ng) in zip(want, got):
        if nw.id != ng.id:
            assert abs(g.get(nw.id, sw) - sw) <= CORTEX_ATOL
            assert abs(w.get(ng.id, sw) - sw) <= CORTEX_ATOL


@pytest.mark.parametrize("index", ["flat", "ivf"])
def test_cortex_with_the_encoder_matches_reference(tmp_path, index):
    # mean pooling: the random TINY tower's CLS rows all lie within ~1e-5
    # of each other in cosine, its pooled means within ~0.05
    npz = str(tmp_path / "mean.npz")
    _save("port", npz, configs(pooling="mean")[1], seed=7)
    jcfg, tcfg = JaxConfig(), CortexConfig()
    for cfg in (jcfg, tcfg):
        cfg.embedding.model = f"flax:{npz}"
        cfg.embedding.dimension = 32
        cfg.embedding.index = index
        cfg.embedding.ivf_graph_degree = 0
        cfg.embedding.ivf_nlist = 4
    ref = JaxCortex(JaxMemory(), jcfg)
    port = Cortex(MemoryStorage(), tcfg, device="cpu")
    assert isinstance(port.embedder, temb.TorchEncoderEmbedder)
    assert port.embedder.model.device == torch.device("cpu")
    assert port.embedder.model_name == ref.embedder.model_name
    nodes = _nodes(40, seed=1)
    ref.store_batch(copy.deepcopy(nodes[:30]))
    port.store_batch([Node.from_dict(n.to_dict()) for n in nodes[:30]])
    for n in nodes[30:]:
        ref.store(copy.deepcopy(n))
        port.store(Node.from_dict(n.to_dict()))
    for n in nodes:
        want, got = ref.get_node(n.id), port.get_node(n.id)
        assert max_abs(got.embedding, want.embedding) <= TINY_ATOL
    for q in [f"{n.title} {n.body}" for n in nodes[::7]] + ["w3 w4 item2"]:
        want = ref.search(q, 8, record_access=False)
        got = port.search(q, 8, record_access=False)
        assert len(got) == 8
        assert_same(want, got)
