"""The text CAAT family of the torch port against the JAX package, on the
CPU at tiny dims (``tests/test_caat.py`` W2V_TINY / CAAT_TINY, every
dropout 0), seeded numpy weights converted by
``checkpoint/convert.text_caat_state_dict_from_jax``.

- ``read_text_manifest`` (a tsv, a ``src.txt,tgt.txt`` pair) and
  ``TextBatcher`` (a shared and a separate source dictionary, a row slice)
  equal the JAX package's;
- ``TextCaatModel``: the encoder output, ``caat_loss`` and every gradient
  equal JAX with a shared and with a separate source vocabulary;
  ``decode_step`` too;
- ``TextTransducerAgent`` emits the JAX agent's tokens, step by step;
- the converted tree loads with ``strict=True`` with and without a
  source vocabulary.

Tolerances as ``test_torch_port_fbank.py``: activations rtol / atol 1e-5,
losses rtol 1e-5, gradients rtol 1e-4 with an atol of 1e-6 of the largest
gradient, log-probs atol 1e-5; tokens, manifests and batches equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import _rngs
from tests.test_torch_port_fbank import CAAT, W2V, seeded_tree, to_torch
from tests.test_torch_port_greedy import _vocab
from tests.test_torch_port_import import port_cfg
from wav2vec_s_tpu.models import text_caat as jax_text
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu_torch.checkpoint.convert import (
    text_caat_state_dict_from_jax)
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.models import text_caat
from wav2vec_s_tpu_torch.models.caat import CaatConfig
from wav2vec_s_tpu_torch.train.recipes import make_caat_loss_fn

torch.set_num_threads(1)

ATOL = dict(rtol=1e-5, atol=1e-5)
SRC_VOCABS = {"shared": 0, "own": 41}


@functools.lru_cache(maxsize=None)
def jax_model(src_vocab=0, seed=7):
    """(flax TextCaatModel, seeded numpy params)."""
    model = jax_text.TextCaatModel(W2V, CAAT, src_vocab_size=src_vocab)
    shapes = jax.eval_shape(lambda: model.init(
        _rngs(), jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 4), jnp.int32),
        train=False))["params"]
    return model, seeded_tree(shapes, seed)


def port_model(params, src_vocab=0) -> text_caat.TextCaatModel:
    model = text_caat.TextCaatModel(port_cfg(Wav2Vec2Config, W2V),
                                    port_cfg(CaatConfig, CAAT), src_vocab)
    model.load_state_dict(text_caat_state_dict_from_jax(params), strict=True)
    return model


def make_batch(src_vocab=0, seed=0, B=3, S=19, U=5):
    """Seeded source tokens (row 1 padded from position 11, row 2 from 6)
    and random targets ending in eos (row 1 two labels shorter)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(4, src_vocab or CAAT.vocab_size, (B, S)).astype(
        np.int32)
    src[1, 11:] = CAAT.pad
    src[2, 6:] = CAAT.pad
    tgt = rng.integers(4, CAAT.vocab_size, (B, U)).astype(np.int32)
    tgt[:, -1] = CAAT.eos
    tgt[1, 3:] = CAAT.pad
    tgt[1, 2] = CAAT.eos
    return {"source": src, "targets": tgt}


# ---- host copies -------------------------------------------------------------

SRC = ["a b c", "d e", "a a a a f", "b"]
TGT = ["x y", "z", "y y x z", "x"]


@pytest.fixture
def manifests(tmp_path):
    (tmp_path / "src.txt").write_text("\n".join(SRC) + "\n")
    (tmp_path / "tgt.txt").write_text("\n".join(TGT) + "\n")
    rows = ["id\tsrc_text\ttgt_text"] + [
        f"s{i}\t{s}\t{t}" for i, (s, t) in enumerate(zip(SRC, TGT))]
    (tmp_path / "bitext.tsv").write_text("\n".join(rows) + "\n")
    return {"pair": f"{tmp_path / 'src.txt'},{tmp_path / 'tgt.txt'}",
            "tsv": str(tmp_path / "bitext.tsv")}


@pytest.mark.parametrize("kind", ["pair", "tsv"])
def test_read_text_manifest_copy_equals_jax(manifests, kind):
    from wav2vec_s_tpu.data.manifests import read_text_manifest as jax_read
    from wav2vec_s_tpu_torch.data.manifests import read_text_manifest

    got, want = (f(manifests[kind]) for f in (read_text_manifest, jax_read))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_frames == [4, 3, 6, 2]


@pytest.mark.parametrize("own_src_dict", [False, True],
                         ids=["shared", "own"])
def test_text_batcher_equals_jax(manifests, own_src_dict):
    from wav2vec_s_tpu.data import dataset as jds
    from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
    from wav2vec_s_tpu.data.manifests import read_text_manifest as jax_read
    from wav2vec_s_tpu.data.tokenizer import WordTokenizer as JaxWord
    from wav2vec_s_tpu_torch.data import dataset
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary
    from wav2vec_s_tpu_torch.data.manifests import read_text_manifest
    from wav2vec_s_tpu_torch.data.tokenizer import WordTokenizer

    batchers = []
    for ds, read, D, tok in ((dataset, read_text_manifest, Dictionary,
                              WordTokenizer),
                             (jds, jax_read, JaxDictionary, JaxWord)):
        tgt_d, src_d = D(), D()
        for w in "xyz":
            tgt_d.add_symbol(w)
        for w in "abcdef":
            (src_d if own_src_dict else tgt_d).add_symbol(w)
        batchers.append(ds.TextBatcher(
            read(manifests["tsv"]), tgt_d, tok(), src_buckets=(4, 8),
            target_buckets=(4, 8),
            src_dict=src_d if own_src_dict else None))
    for idx in ([0, 1], [2, 3, 0], [3]):
        got, want = (b.collate(np.asarray(idx)) for b in batchers)
        assert got.keys() == want.keys() == {"source", "targets"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a data rank's rows: the whole batch's buckets, its own rows
    whole = batchers[0].collate(np.asarray([2, 3, 0, 1]))
    part = batchers[0].collate(np.asarray([2, 3, 0, 1]), rows=slice(2, 4))
    for k in whole:
        np.testing.assert_array_equal(part[k], whole[k][2:4])


# ---- the model ---------------------------------------------------------------

@pytest.mark.parametrize("vocab", sorted(SRC_VOCABS))
def test_encoder_equals_jax(vocab):
    src_vocab = SRC_VOCABS[vocab]
    model_j, params = jax_model(src_vocab)
    src = make_batch(src_vocab)["source"]
    enc, pm = model_j.apply({"params": params}, jnp.asarray(src),
                            method=type(model_j).encode)
    got, got_pm = port_model(params, src_vocab).encode(
        torch.from_numpy(src).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(enc), **ATOL)
    np.testing.assert_array_equal(got_pm.numpy(), np.asarray(pm))


@pytest.mark.parametrize("vocab", sorted(SRC_VOCABS))
def test_caat_loss_and_every_gradient_match_jax(vocab):
    src_vocab = SRC_VOCABS[vocab]
    model_j, params = jax_model(src_vocab)
    batch = make_batch(src_vocab)
    loss_fn = jax_recipes.make_caat_loss_fn(model_j, CAAT)
    (want, (want_n, want_logs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), 0)
    model = port_model(params, src_vocab)
    loss, n, logs = make_caat_loss_fn(model, CAAT)(
        to_torch(batch), torch.Generator().manual_seed(0), 0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert n.item() == float(want_n)
    for k, v in logs.items():
        np.testing.assert_allclose(v.item(), float(want_logs[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    want_g = text_caat_state_dict_from_jax(jax.device_get(grads))
    scale = max(float(np.abs(v.numpy()).max()) for v in want_g.values())
    named = dict(model.named_parameters())
    assert named.keys() == want_g.keys() - {"decoder.lm.version"}
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=name)
    assert named["encoder.embed_tokens.weight"].grad.abs().max() > 0


def test_decode_step_equals_jax():
    model_j, params = jax_model()
    src = jnp.asarray(make_batch()["source"])
    enc, pm = model_j.apply({"params": params}, src,
                            method=type(model_j).encode)
    prev = np.asarray([[0, 5, 6, 1], [0, 7, 1, 1], [0, 8, 9, 4]], np.int32)
    lens = np.asarray([3, 2, 4], np.int32)
    want = model_j.apply({"params": params}, jnp.asarray(prev),
                         jnp.asarray(lens), enc, pm,
                         method=type(model_j).decode_step)
    model = port_model(params)
    p_enc, p_pm = model.encode(torch.from_numpy(np.asarray(src)).long())
    got = model.decode_step(torch.from_numpy(prev).long(),
                            torch.from_numpy(lens), p_enc, p_pm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("vocab", sorted(SRC_VOCABS))
def test_converted_weights_load_strict(vocab):
    _, params = jax_model(SRC_VOCABS[vocab])
    model = port_model(params, SRC_VOCABS[vocab])
    assert sorted(model.state_dict()) == sorted(
        text_caat_state_dict_from_jax(params))
    assert model.encoder.embed_tokens.weight.shape[0] == (
        SRC_VOCABS[vocab] or CAAT.vocab_size)


def test_text_agent_emits_the_jax_tokens():
    """Both agents read the same 9 source tokens one by one (the last one
    ends the stream): after each push they have popped the same tokens.
    The tree's blank row is scaled by 0.25 so that the agents emit."""
    from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary

    model_j, params = jax_model(seed=9)
    params = dict(params)
    e = params["embed_tokens"].copy()
    e[CAAT.bos] *= 0.25
    params["embed_tokens"] = e
    kw = dict(max_len=12, max_emit_per_step=3)
    ref = jax_text.TextTransducerAgent(model_j, params,
                                       _vocab(JaxDictionary), **kw)
    mine = text_caat.TextTransducerAgent(port_model(params),
                                         _vocab(Dictionary), **kw)
    src = [4, 9, 5, 17, 6, 7, 12, 8, 10]
    got, want = [], []
    for i, tok in enumerate(src):
        is_end = i == len(src) - 1
        for agent, out in ((ref, want), (mine, got)):
            agent.push(tok, is_end)
            step = []
            while (t := agent.pop_token()) is not None:
                step.append(t)
            out.append(step)
    assert got == want
    assert mine.finished and ref.finished
    assert sum(map(len, got)) > 0, "the agent emitted nothing"
