"""The fbank CAAT family of the torch port against the JAX package, on the
CPU at tiny dims (``tests/test_caat.py`` W2V_TINY / CAAT_TINY, every
dropout 0), seeded numpy weights converted by
``checkpoint/convert.fbank_state_dict_from_jax``.

- the host copies: ``logmel_fbank``, ``IncrementalFbank`` over several
  chunkings, ``Whiten`` and ``TFMask`` (its draws in order) and the fbank
  ``CaatBatcher`` equal the JAX package's bit for bit;
- each conv front-end equals JAX at an even and at an odd number of frames:
  these cases pin flax's ``padding="SAME"``, which pads a stride-2 axis by
  its length's parity (``nn.Conv2d(padding=1)`` would be off by a frame on
  every even length), and the NHWC flatten order; ``downsample_mask``
  equals JAX for every front-end's output length;
- each jointer equals JAX, grouped and full-context;
- ``caat_loss`` and every gradient equal JAX for each front-end (MHA
  jointer) and each jointer (shallow2d), ``decode_step`` for each jointer;
- the fbank agent (``FbankStreamingEngine`` under the host searcher)
  through ``SimulEvaluator`` gives the JAX evaluator's texts and delays
  (equal);
- the converted tree loads with ``strict=True`` for every front-end x
  jointer.

Tolerances: activations rtol 1e-5 / atol 1e-5 (float32, the same
operations in another order); losses rtol 1e-5; gradients rtol 1e-4 with
an atol of 1e-6 of the largest gradient (as ``test_torch_port_train.py``);
log-probs atol 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY, _rngs
from tests.test_torch_port_import import port_cfg
from wav2vec_s_tpu.models import fbank as jax_fbank
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu_torch.checkpoint.convert import fbank_state_dict_from_jax
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.models import fbank
from wav2vec_s_tpu_torch.models.caat import CaatConfig
from wav2vec_s_tpu_torch.train.recipes import make_caat_loss_fn

torch.set_num_threads(1)

W2V = dataclasses.replace(W2V_TINY, dropout=0.0, attention_dropout=0.0,
                          activation_dropout=0.0, encoder_layerdrop=0.0)
CAAT = dataclasses.replace(CAAT_TINY, rand_pos_decoder=0,
                           step_mode="constant")
FRONTENDS = ("shallow2d", "vgg2d", "resnet", "resnet_small")
JOINTERS = ("mha", "concat", "attention")
ATOL = dict(rtol=1e-5, atol=1e-5)


def seeded_tree(shapes, seed):
    """Seeded numpy weights in a flax tree of shapes (as
    ``test_torch_port_import.jax_caat``): matrices and kernels normal over
    the fan-in, norm scales 1 + 0.2 noise, other vectors 0.2 noise."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:
            return n * float(np.prod(leaf.shape[:-1])) ** -0.5
        scale = getattr(path[-1], "key", None) == "scale"
        return (1.0 if scale else 0.0) + 0.2 * n

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def jax_model(frontend="shallow2d", jointer="mha", w2v=W2V, caat=CAAT,
              seed=3):
    """(flax FbankCaatModel, seeded numpy params)."""
    model = jax_fbank.FbankCaatModel(w2v, caat, conv_type=frontend,
                                     jointer_type=jointer)
    shapes = jax.eval_shape(lambda: model.init(
        _rngs(), jnp.zeros((1, 40, 80)), jnp.zeros((1, 4), jnp.int32),
        train=False))["params"]
    return model, seeded_tree(shapes, seed)


def port_model(params, frontend="shallow2d", jointer="mha", w2v=W2V,
               caat=CAAT) -> fbank.FbankCaatModel:
    model = fbank.FbankCaatModel(port_cfg(Wav2Vec2Config, w2v), port_cfg(
        CaatConfig, dataclasses.replace(caat, frontend=frontend,
                                        jointer_type=jointer)))
    model.load_state_dict(fbank_state_dict_from_jax(params), strict=True)
    return model


def make_batch(T=41, seed=0, B=3, U=5):
    """Seeded log-mel-like features (row 2 padded from frame T - 9) and
    random targets ending in eos (row 1 two labels shorter)."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, 80)).astype(np.float32)
    pad = np.zeros((B, T), bool)
    pad[2, T - 9:] = True
    tgt = rng.integers(4, CAAT.vocab_size, (B, U)).astype(np.int32)
    tgt[:, -1] = CAAT.eos
    tgt[1, 3:] = CAAT.pad
    tgt[1, 2] = CAAT.eos
    return {"source": feats, "padding_mask": pad, "targets": tgt}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


# ---- host copies -------------------------------------------------------------

def _wav(n, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(
        np.float32)


@pytest.mark.parametrize("n", [250, 400, 559, 16000])
def test_logmel_fbank_copy_equals_jax(n):
    from wav2vec_s_tpu.data.audio import logmel_fbank as jax_logmel
    from wav2vec_s_tpu_torch.data.audio import logmel_fbank

    np.testing.assert_array_equal(logmel_fbank(_wav(n)), jax_logmel(_wav(n)))


@pytest.mark.parametrize("chunks", [[400, 160, 160, 1000],
                                    [100, 100, 100, 100, 5000], [4000],
                                    [399, 1, 161, 3000, 7]])
def test_incremental_fbank_copy_equals_jax(chunks):
    from wav2vec_s_tpu.stream.fbank_engine import (
        IncrementalFbank as JaxIncremental)
    from wav2vec_s_tpu_torch.stream.fbank_engine import IncrementalFbank

    wav = _wav(sum(chunks), seed=len(chunks))
    mine, theirs = IncrementalFbank(), JaxIncremental()
    for a, c in zip(np.cumsum(chunks), chunks):
        np.testing.assert_array_equal(mine.push(wav[a - c:a]),
                                      theirs.push(wav[a - c:a]))


@pytest.mark.parametrize("case", ["whiten", "whiten_global", "tfmask"])
def test_transform_copies_equal_jax(case):
    from wav2vec_s_tpu.data import transforms as jt
    from wav2vec_s_tpu_torch.data import transforms as tt

    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((n, 80)).astype(np.float32) * 3 + 1
             for n in (7, 120, 300)]
    if case == "whiten":
        pair = tt.Whiten(), jt.Whiten()
    elif case == "whiten_global":
        mean, std = rng.standard_normal(80), rng.uniform(0, 2, 80)
        pair = tt.Whiten(mean, std), jt.Whiten(mean, std)
    else:          # one generator each, drawn over consecutive calls
        pair = tt.TFMask(seed=7), jt.TFMask(seed=7)
    for f in feats:
        got, want = (t(f) for t in pair)
        np.testing.assert_array_equal(got, want)
    if case == "tfmask":
        assert not np.array_equal(got, feats[-1])


def test_fbank_batcher_equals_jax(tmp_path):
    """``CaatBatcher(features="fbank")`` with ``Whiten`` + ``TFMask``
    collates what the JAX one collates, batch after batch."""
    from wav2vec_s_tpu.data import dataset as jds
    from wav2vec_s_tpu.data import transforms as jt
    from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
    from wav2vec_s_tpu.data.manifests import read_s2t_manifest as jax_read
    from wav2vec_s_tpu.data.tokenizer import WordTokenizer as JaxWord
    from wav2vec_s_tpu_torch.data import dataset, transforms
    from wav2vec_s_tpu_torch.data.audio import write_wav
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary
    from wav2vec_s_tpu_torch.data.manifests import read_s2t_manifest
    from wav2vec_s_tpu_torch.data.tokenizer import WordTokenizer

    lines = ["id\taudio\tn_frames\ttgt_text"]
    for i, n in enumerate((3000, 5200, 4100)):
        write_wav(tmp_path / f"{i}.wav", _wav(n, i))
        lines.append(f"u{i}\t{tmp_path}/{i}.wav\t{n}\ta b {'c' * (i + 1)}")
    (tmp_path / "m.tsv").write_text("\n".join(lines) + "\n")
    batchers = []
    for ds, tf, read, D, tok in (
            (dataset, transforms, read_s2t_manifest, Dictionary,
             WordTokenizer),
            (jds, jt, jax_read, JaxDictionary, JaxWord)):
        d = D()
        for w in ("a", "b", "c", "cc", "ccc"):
            d.add_symbol(w)
        batchers.append(ds.CaatBatcher(
            read(tmp_path / "m.tsv"), d, tok(), (16, 32, 48),
            features="fbank", transforms=(tf.Whiten(), tf.TFMask(seed=2))))
    for idx in ([0, 2], [1], [2, 1, 0]):
        got, want = (b.collate(np.asarray(idx)) for b in batchers)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["source"].shape == (3, 32, 80)       # 31 frames of 5200


# ---- modules -----------------------------------------------------------------

@pytest.mark.parametrize("T", [40, 41], ids=["even", "odd"])
@pytest.mark.parametrize("frontend", FRONTENDS)
def test_frontend_equals_jax(frontend, T):
    """Even and odd T: flax SAME padding at stride 2 depends on the
    parity of the length (the ``conv2d_same`` trap)."""
    _, params = jax_model(frontend)
    feats = make_batch(T)["source"]
    front = jax_fbank.CONV_FRONTENDS[frontend](W2V.encoder_embed_dim)
    want = front.apply({"params": params["encoder"]["subsample"]},
                       jnp.asarray(feats))
    got = port_model(params, frontend).encoder.subsample(
        torch.from_numpy(feats), torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **ATOL)


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_downsample_mask_equals_jax(frontend):
    _, params = jax_model(frontend)
    model = port_model(params, frontend)
    rng = np.random.default_rng(1)
    for T in (37, 40, 41, 64):
        t_out = model.encoder.subsample(torch.zeros((1, T, 80)),
                                        torch.float32).shape[1]
        for n_pad in (0, 1, 5, 13):
            pad = np.zeros((4, T), bool)
            pad[:, T - n_pad:] = True
            pad[3] = rng.random(T) < 0.5
            got = fbank.downsample_mask(torch.from_numpy(pad), t_out)
            want = jax_fbank.downsample_mask(jnp.asarray(pad), t_out)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ds", [8, 3, -1], ids=["ds8", "ds3", "full"])
@pytest.mark.parametrize("jointer", JOINTERS)
def test_jointer_equals_jax(jointer, ds):
    _, params = jax_model("shallow2d", jointer)
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 5, CAAT.decoder_embed_dim)).astype(
        np.float32)
    enc = rng.standard_normal((2, 11, W2V.encoder_embed_dim)).astype(
        np.float32)
    pad = np.zeros((2, 11), bool)
    pad[1, 7:] = True
    want = jax_fbank.JOINTERS[jointer](CAAT).apply(
        {"params": params["jointer"]}, jnp.asarray(h), jnp.asarray(enc),
        jnp.asarray(pad), ds)
    got = port_model(params, "shallow2d", jointer).decoder.jointer(
        torch.from_numpy(h), torch.from_numpy(enc), torch.from_numpy(pad),
        ds)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **ATOL)


# front-ends under the MHA jointer, the other jointers under shallow2d
LOSS_CASES = ([(f, "mha") for f in FRONTENDS]
              + [("shallow2d", j) for j in JOINTERS[1:]])


def _assert_grads_equal(model, want_tree):
    want = fbank_state_dict_from_jax(want_tree)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    named = dict(model.named_parameters())
    assert named.keys() == want.keys() - {"decoder.lm.version"}
    for name, p in named.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(g, want[name].numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)


@pytest.mark.parametrize("frontend,jointer", LOSS_CASES)
def test_caat_loss_and_every_gradient_match_jax(frontend, jointer):
    model_j, params = jax_model(frontend, jointer)
    batch = make_batch()
    loss_fn = jax_recipes.make_caat_loss_fn(model_j, CAAT)
    (want, (want_n, want_logs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), 0)
    model = port_model(params, frontend, jointer)
    loss, n, logs = make_caat_loss_fn(model, CAAT)(
        to_torch(batch), torch.Generator().manual_seed(0), 0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert n.item() == float(want_n)
    for k, v in logs.items():
        np.testing.assert_allclose(v.item(), float(want_logs[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    _assert_grads_equal(model, jax.device_get(grads))


@pytest.mark.parametrize("jointer", JOINTERS)
def test_decode_step_equals_jax(jointer):
    model_j, params = jax_model("shallow2d", jointer)
    batch = make_batch()
    enc, enc_pad = model_j.apply(
        {"params": params}, jnp.asarray(batch["source"]),
        jnp.asarray(batch["padding_mask"]), method=type(model_j).encode)
    prev = np.asarray([[0, 5, 6, 1], [0, 7, 1, 1], [0, 8, 9, 4]], np.int32)
    lens = np.asarray([3, 2, 4], np.int32)
    want = model_j.apply({"params": params}, jnp.asarray(prev),
                         jnp.asarray(lens), enc, enc_pad,
                         method=type(model_j).decode_step)
    model = port_model(params, "shallow2d", jointer)
    t = to_torch(batch)
    p_enc, p_pad = model.encode(t["source"], t["padding_mask"])
    np.testing.assert_allclose(p_enc.numpy(), np.asarray(enc), **ATOL)
    np.testing.assert_array_equal(p_pad.numpy(), np.asarray(enc_pad))
    got = model.decode_step(torch.from_numpy(prev).long(),
                            torch.from_numpy(lens), p_enc, p_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("jointer", JOINTERS)
@pytest.mark.parametrize("frontend", FRONTENDS)
def test_converted_weights_load_strict(frontend, jointer):
    """Every front-end x jointer: the converted tree names every parameter
    and buffer of the port's model (``load_state_dict(strict=True)``) and
    nothing else."""
    _, params = jax_model(frontend, jointer)
    model = port_model(params, frontend, jointer)
    sd = fbank_state_dict_from_jax(params)
    assert sorted(model.state_dict()) == sorted(sd)
    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax


# ---- the streaming agent -----------------------------------------------------

ENGINE_KW = dict(main_context=W2V.main_context,
                 right_context=W2V.right_context,
                 feature_buckets=[32, 64, 128], token_buckets=[8, 16, 32])


def agent_params():
    """The shallow2d / MHA tree whose blank row is scaled by 0.25, so the
    agent emits on noise (and not only blanks)."""
    _, params = jax_model("shallow2d", "mha", seed=5)
    params = dict(params)
    e = params["embed_tokens"].copy()
    e[CAAT.bos] *= 0.25
    params["embed_tokens"] = e
    return params


def evaluators(params, step_read_blocks=1):
    from tests.test_torch_port_greedy import _vocab
    from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
    from wav2vec_s_tpu.stream import agent as jax_agent
    from wav2vec_s_tpu.stream.fbank_engine import (
        FbankStreamingEngine as JaxEngine)
    from wav2vec_s_tpu.stream.searcher import (
        StreamingTransducerSearcher as JaxSearcher)
    from wav2vec_s_tpu_torch.data.dictionary import Dictionary
    from wav2vec_s_tpu_torch.stream import agent
    from wav2vec_s_tpu_torch.stream.fbank_engine import FbankStreamingEngine
    from wav2vec_s_tpu_torch.stream.searcher import (
        StreamingTransducerSearcher)

    model_j = jax_fbank.FbankCaatModel(W2V, CAAT)
    ref = JaxSearcher(JaxEngine(model_j, params, **ENGINE_KW),
                      _vocab(JaxDictionary), eager=True, len_scale=0.7)
    port = StreamingTransducerSearcher(
        FbankStreamingEngine(port_model(params), **ENGINE_KW),
        _vocab(Dictionary), eager=True, len_scale=0.7)
    kw = dict(main_context=W2V.main_context,
              right_context=W2V.right_context, frame_samples=640,
              step_read_blocks=step_read_blocks, intra_beam=2, inter_beam=1,
              decoder_step_read=4, eager=True, max_len_a=0.3,
              max_len_b=-1.0, len_scale=0.7)
    return (jax_agent.SimulEvaluator(lambda: jax_agent.SpeechTransducerAgent(
                ref, jax_agent.AgentConfig(**kw)), segment_size_ms=25),
            agent.SimulEvaluator(lambda: agent.SpeechTransducerAgent(
                port, agent.AgentConfig(**kw)), segment_size_ms=25))


def test_fbank_agent_equals_jax():
    """Two clips through each package's ``SimulEvaluator`` over the fbank
    engine: texts, per-word delays and source lengths equal; the second
    clip is longer than the first, so the engine is reset between them."""
    from wav2vec_s_tpu.stream import agent as jax_agent
    from wav2vec_s_tpu_torch.stream import agent

    wavs = [_wav(n, seed=i + 20) for i, n in enumerate((9000, 14000))]
    refs = ["w1 w2", "w3"]
    ref_ev, port_ev = evaluators(agent_params())
    want = [ref_ev.run_instance(w, r) for w, r in zip(wavs, refs)]
    got = [port_ev.run_instance(w, r) for w, r in zip(wavs, refs)]
    for g, w in zip(got, want):
        assert (g.hypo, g.delays_ms, g.source_len_ms) == (
            w.hypo, w.delays_ms, w.source_len_ms)
    assert any(g.hypo for g in got), "the agent emitted nothing"
    got_s, want_s = (m.summarize(r, "wer") for m, r in
                     ((agent, got), (jax_agent, want)))
    got_s.pop("AL_CA"), want_s.pop("AL_CA")
    assert got_s == want_s
