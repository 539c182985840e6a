"""The offline-ASR heads of the torch port (``models/asr.py``, the CTC and
seq2seq recipes, ``eval/generator.py``) against the JAX package.

Tiny dims (``tests/test_caat.py`` W2V_TINY/CAAT_TINY), float32, seeded
numpy weights in the JAX trees, carried over by
``checkpoint/convert.{ctc,s2s}_state_dict_from_jax``; every dropout and
layerdrop 0 (the two packages draw from different streams by design).

- ``Wav2VecCtc`` and ``Wav2Vec2Seq2Seq`` (pre- and post-LN decoder):
  logits and padding (rtol 1e-5);
- the CTC and seq2seq recipes' losses and logs (rtol 1e-5) and every
  gradient (rtol 1e-4, atol 1e-6 of the largest), on the port's dense
  attention and on its flash twin (the JAX side dense: the two compute the
  same attention); CTC against the JAX recipe run in float64, whose own
  float32 gradients miss that tolerance (the test says by how much);
- a batch with one row whose labels cannot fit its frames: the loss equals
  optax's finite floor (rtol 1e-5) and its gradient is finite; the
  feasible rows' gradients within rtol 1e-4; the floor row's within
  2e-2 absolute, since the JAX value itself carries float32 rounding
  at |x| ~ 1e5, whose spacing is 7.8e-3;
- the host best-path decode, the three batched greedy decoders and
  ``Seq2SeqBeamGenerator``: token ids equal; ``TwoStageJointGenerator``
  with each package's first stage and one shared ``mt_score_fn``: the same
  hypotheses.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY, _rngs
from tests.test_torch_port_import import jax_caat, port_caat, port_cfg
from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
from wav2vec_s_tpu.eval import generator as jax_generator
from wav2vec_s_tpu.models import asr as jax_asr
from wav2vec_s_tpu.train import recipes as jax_recipes
from wav2vec_s_tpu_torch.checkpoint.convert import (
    ctc_state_dict_from_jax, s2s_state_dict_from_jax)
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.eval import generator
from wav2vec_s_tpu_torch.models import Wav2Vec2Config, asr
from wav2vec_s_tpu_torch.models.caat import CaatConfig
from wav2vec_s_tpu_torch.train.recipes import (
    make_ctc_loss_fn, make_s2s_loss_fn)

W2V = dataclasses.replace(W2V_TINY, dropout=0.0, attention_dropout=0.0,
                          activation_dropout=0.0, encoder_layerdrop=0.0)
CAAT = CAAT_TINY
V = CAAT.vocab_size
PAD, EOS, BLANK = CAAT.pad, CAAT.eos, CAAT.bos
JAX_RNG = jax.random.PRNGKey(0)


def _fill(shapes, seed):
    """The seeded numpy weights of ``test_torch_port_import.jax_caat``."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:
            return n * float(np.prod(leaf.shape[:-1])) ** -0.5
        scale = getattr(path[-1], "key", None) == "scale"
        return (1.0 if scale else 0.0) + 0.2 * n

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def jax_head(kind, caat=CAAT, seed=1):
    """(flax model, numpy params) of the CTC or seq2seq head."""
    src = jnp.zeros((1, 2400))
    if kind == "ctc":
        model = jax_asr.Wav2VecCtc(W2V, vocab_size=V)
        args = (src,)
    else:
        model = jax_asr.Wav2Vec2Seq2Seq(W2V, caat)
        args = (src, jnp.zeros((1, 5), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(_rngs(), *args,
                                               train=False))["params"]
    return model, _fill(shapes, seed)


def port_head(kind, caat=CAAT, impl="dense", seed=1):
    params = jax_head(kind, caat, seed)[1]
    w2v = port_cfg(Wav2Vec2Config, dataclasses.replace(
        W2V, attention_impl=impl))
    if kind == "ctc":
        model = asr.Wav2VecCtc(w2v, V)
        model.load_state_dict(ctc_state_dict_from_jax(params), strict=True)
    else:
        model = asr.Wav2Vec2Seq2Seq(w2v, port_cfg(CaatConfig, caat))
        model.load_state_dict(s2s_state_dict_from_jax(params), strict=True)
    return model


def make_batch(seed=0, B=3, S=2400, U=6):
    """Seeded noise audio (row 2 padded from sample 1800) and targets
    ending in eos (row 1 three labels shorter)."""
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((B, S)) * 0.3).astype(np.float32)
    tgt = rng.integers(4, V, (B, U)).astype(np.int32)
    tgt[:, -1] = EOS
    tgt[1, 3:] = PAD
    tgt[1, 2] = EOS
    pad = np.zeros((B, S), bool)
    pad[2, 1800:] = True
    return {"source": src, "targets": tgt, "padding_mask": pad}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def vocab_pair():
    """The same dictionary in both packages: w0 .. w25 after the specials."""
    a, b = JaxDictionary(), Dictionary()
    for i in range(V - b.nspecial):
        a.add_symbol(f"w{i}")
        b.add_symbol(f"w{i}")
    return a, b


PREV = np.asarray([[EOS, 5, 6, 7, 8], [EOS, 9, 4, PAD, PAD],
                   [EOS, 11, 12, 13, PAD]], np.int32)


@pytest.mark.parametrize("case", ["ctc", "s2s", "s2s_post_ln"])
def test_heads_forward_match_jax(case):
    b = make_batch()
    caat = (dataclasses.replace(CAAT, decoder_normalize_before=False)
            if case == "s2s_post_ln" else CAAT)
    kind = case.split("_")[0]
    model_j, params = jax_head(kind, caat)
    model = port_head(kind, caat)
    tb = to_torch(b)
    apply = jax.jit(model_j.apply)
    if kind == "ctc":
        want, want_pad = apply({"params": params}, jnp.asarray(b["source"]),
                               jnp.asarray(b["padding_mask"]))
        got, got_pad = model(tb["source"], tb["padding_mask"])
        np.testing.assert_array_equal(got_pad.numpy(), np.asarray(want_pad))
        assert got_pad[2].any() and not got_pad[0].any()
    else:
        want = apply({"params": params}, jnp.asarray(b["source"]),
                     jnp.asarray(PREV), jnp.asarray(b["padding_mask"]))
        got = model(tb["source"], torch.from_numpy(PREV).long(),
                    tb["padding_mask"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6 * scale)


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(kind, dtype="float32"):
    """(loss, count, logs, grads) of the JAX recipe on make_batch(), the
    model computing in ``dtype`` (float64 under ``jax.enable_x64``)."""
    params = jax_head(kind)[1]
    w2v = dataclasses.replace(W2V, dtype=dtype)
    caat = dataclasses.replace(CAAT, dtype=dtype)
    if kind == "ctc":
        model = jax_asr.Wav2VecCtc(w2v, vocab_size=V)
        loss_fn = jax_recipes.make_ctc_loss_fn(model, pad=PAD, eos=EOS,
                                               blank=BLANK)
    else:
        model = jax_asr.Wav2Vec2Seq2Seq(w2v, caat)
        loss_fn = jax_recipes.make_s2s_loss_fn(model, caat,
                                               label_smoothing=0.1)
    with jax.enable_x64(dtype == "float64"):
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype),
                                        params)
        batch = {k: jnp.asarray(v, dtype if v.dtype == np.float32 else None)
                 for k, v in make_batch().items()}
        (loss, (n, logs)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, batch, JAX_RNG, 0)
        return (float(loss), float(n), jax.device_get(logs),
                jax.tree_util.tree_map(
                    lambda g: np.asarray(g, np.float32), grads))


def _assert_grads_equal(model, want):
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    named = dict(model.named_parameters())
    assert named.keys() == want.keys()
    for name, p in named.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(g, want[name].numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kind", ["ctc", "s2s"])
def test_loss_logs_and_every_gradient_match_jax(kind, impl):
    """CTC is held to the JAX recipe computing in float64: its float32
    gradients sit up to 14x the tolerance from its own float64 ones (the
    CTC recursion at |log alpha| ~ 1e3), the port's (float32 model,
    float64 CTC) at 0.18x (measured)."""
    want_loss, want_n, want_logs, want_grads = jax_loss_and_grads(
        kind, "float64" if kind == "ctc" else "float32")
    model = port_head(kind, impl=impl)
    if kind == "ctc":
        fn = make_ctc_loss_fn(model, pad=PAD, eos=EOS, blank=BLANK)
        convert = ctc_state_dict_from_jax
    else:
        fn = make_s2s_loss_fn(model, port_cfg(CaatConfig, CAAT),
                              label_smoothing=0.1)
        convert = s2s_state_dict_from_jax
    loss, n, logs = fn(to_torch(make_batch()), torch.Generator(), 0)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    # ctc: eos and pad are not labels; s2s: every target token but pad
    assert float(n) == want_n == (12 if kind == "ctc" else 15)
    assert sorted(logs) == sorted(want_logs)
    for k, v in logs.items():
        np.testing.assert_allclose(v.item(), float(want_logs[k]),
                                   rtol=1e-5, err_msg=k)
    loss.backward()
    _assert_grads_equal(model, convert(want_grads))


def test_ctc_infeasible_row_takes_optax_floor():
    """Row 1's six equal labels need 11 frames and have 9: F.ctc_loss has
    no path there (inf, or 0 under zero_infinity); optax gives 1e5 plus the
    best path's cost."""
    rng = np.random.default_rng(3)
    B, T = 3, 40
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    lpad = np.zeros((B, T), bool)
    lpad[1, 9:] = True
    lpad[2, 30:] = True
    tgt = rng.integers(4, V, (B, 6)).astype(np.int32)
    tgt[1] = 7
    tpad = np.zeros((B, 6), bool)
    tpad[2, 4:] = True

    def optax_sum(lg):
        return optax.ctc_loss(lg, jnp.asarray(lpad, jnp.float32),
                              jnp.asarray(tgt), jnp.asarray(tpad,
                                                            jnp.float32),
                              blank_id=BLANK).sum()

    per = optax.ctc_loss(jnp.asarray(logits), jnp.asarray(lpad, jnp.float32),
                         jnp.asarray(tgt), jnp.asarray(tpad, jnp.float32),
                         blank_id=BLANK)
    assert 1e5 < float(per[1]) < 1.1e5 and float(per[0]) < 1e3
    want_g = np.asarray(jax.grad(optax_sum)(jnp.asarray(logits)))
    feasible = asr.ctc_feasible(torch.from_numpy(lpad), torch.from_numpy(tgt),
                                torch.from_numpy(tpad))
    assert feasible.tolist() == [True, False, True]
    lg = torch.from_numpy(logits).requires_grad_()
    loss = asr.ctc_loss(lg, torch.from_numpy(lpad),
                        torch.from_numpy(tgt).long(), torch.from_numpy(tpad),
                        blank=BLANK)
    np.testing.assert_allclose(loss.item(), float(per.sum()), rtol=1e-5)
    loss.backward()
    g = lg.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g[1]).max() > 0.1
    for r in (0, 2):
        np.testing.assert_allclose(g[r], want_g[r], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g[1], want_g[1], rtol=0, atol=2e-2)
    # the floor alone, row by row, equals optax's per-row value
    floor = asr.ctc_floor_loss(
        torch.log_softmax(torch.from_numpy(logits), -1),
        torch.from_numpy(lpad), torch.from_numpy(tgt),
        torch.from_numpy(tpad), BLANK)
    np.testing.assert_allclose(floor.numpy(), np.asarray(per), rtol=1e-5)


def test_ctc_host_decode_matches_jax():
    b = make_batch()
    model_j, params = jax_head("ctc")
    logits, lpad = jax.jit(model_j.apply)({"params": params},
                                          jnp.asarray(b["source"]),
                                          jnp.asarray(b["padding_mask"]))
    want = jax_asr.ctc_greedy_decode(logits, lpad, blank=BLANK)
    got = asr.ctc_greedy_decode(torch.from_numpy(np.asarray(logits)),
                                torch.from_numpy(np.asarray(lpad)), BLANK)
    assert got == want and any(len(s) > 3 for s in got)
    # the JAX test's collapse case: [0 5 5 0 6] -> [5, 6]
    lg = torch.full((1, 5, 8), -10.0)
    for t, v in enumerate([0, 5, 5, 0, 6]):
        lg[0, t, v] = 10.0
    assert asr.ctc_greedy_decode(lg, torch.zeros(1, 5, dtype=torch.bool)) \
        == [[5, 6]]


def _decoders(kind):
    """(JAX decode(source, pad), port decode(source, pad))."""
    jv, tv = vocab_pair()
    if kind == "ctc":
        model_j, params = jax_head("ctc")
        jd = jax_generator.make_ctc_greedy_decoder(model_j, jv, blank=BLANK)
        td = generator.make_ctc_greedy_decoder(port_head("ctc"), tv,
                                               blank=BLANK)
    elif kind.startswith("s2s"):
        seed = EMITS if kind == "s2s_cap" else 1
        model_j, params = jax_head("s2s", CAAT, seed)
        jd = jax_generator.make_s2s_greedy_decoder(model_j, jv, max_len=12)
        td = generator.make_s2s_greedy_decoder(
            port_head("s2s", seed=seed), tv, max_len=12)
    else:
        model_j, params = jax_caat(W2V, CAAT)
        jd = jax_generator.make_offline_greedy_decoder(
            model_j, jv, W2V.main_context, W2V.right_context, max_len=12)
        td = generator.make_offline_greedy_decoder(
            port_caat(params, W2V, CAAT), tv, W2V.main_context,
            W2V.right_context, max_len=12)
    return functools.partial(jd, params), td


#: weights of the seq2seq head (numpy seed) whose greedy decode runs to the
#: length cap; under seed 1 every row stops at once on eos
EMITS = 4


@pytest.mark.parametrize("kind", ["ctc", "s2s_stop", "s2s_cap",
                                  "transducer"])
def test_greedy_decoders_match_jax(kind):
    jd, td = _decoders(kind)
    b = make_batch(seed=4)
    want_p, want_l = (np.asarray(x) for x in jd(
        jnp.asarray(b["source"]), jnp.asarray(b["padding_mask"])))
    got_p, got_l = td(b["source"], b["padding_mask"])
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_p, want_p)
    if kind == "s2s_stop":
        assert (got_l == 1).all()
    else:
        assert got_l.max() > 2                 # something was emitted


def _beam_pair(beam=3, max_len_b=8, seed=EMITS):
    jv, tv = vocab_pair()
    model_j, params = jax_head("s2s", CAAT, seed)
    return (jax_generator.Seq2SeqBeamGenerator(model_j, params, jv,
                                               beam_size=beam,
                                               max_len_b=max_len_b),
            generator.Seq2SeqBeamGenerator(port_head("s2s", seed=seed), tv,
                                           beam_size=beam,
                                           max_len_b=max_len_b))


@pytest.mark.parametrize("beam,max_len_b", [(3, 8), (5, 4)])
def test_beam_generator_matches_jax(beam, max_len_b):
    jg, tg = _beam_pair(beam, max_len_b)
    src = make_batch(seed=5)["source"][:1]
    want, got = jg.generate(src), tg.generate(src)
    assert [h.tokens for h in got] == [h.tokens for h in want]
    np.testing.assert_allclose([h.score for h in got],
                               [h.score for h in want], rtol=1e-5)
    assert len(got) >= 1 and all(EOS not in h.tokens for h in got)


@pytest.mark.parametrize("asr_1best", [False, True])
def test_two_stage_joint_generator_matches_jax(asr_1best):
    jg, tg = _beam_pair(3, 6)
    model_j, params = jax_head("s2s", CAAT, EMITS)
    embed = np.asarray(params["decoder"]["embed_tokens"])
    jv, tv = vocab_pair()

    @jax.jit
    def scores(params, asr_tokens, prev_mt, lens):
        logits = model_j.apply({"params": params}, prev_mt,
                               jnp.asarray(embed)[asr_tokens],
                               asr_tokens == PAD,
                               method=jax_asr.Wav2Vec2Seq2Seq.decode_logits)
        k = jnp.arange(prev_mt.shape[0])
        return jax.nn.log_softmax(logits[k, lens - 1], -1)

    def mt_score_fn(asr_tokens, prev_mt, lens):
        """The JAX test's scorer: the decoder over transcript embeddings."""
        return np.asarray(scores(params, jnp.asarray(asr_tokens),
                                 jnp.asarray(prev_mt), jnp.asarray(lens)))

    src = make_batch(seed=6)["source"][:1]
    want = jax_generator.TwoStageJointGenerator(
        jg.generate, mt_score_fn, jv, beam_size=3, max_len=6,
        asr_1best=asr_1best).generate(src)
    got = generator.TwoStageJointGenerator(
        tg.generate, mt_score_fn, tv, beam_size=3, max_len=6,
        asr_1best=asr_1best).generate(src)
    assert got and len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["asr_tokens"], a["mt_tokens"]) == (b["asr_tokens"],
                                                     b["mt_tokens"])
        np.testing.assert_allclose([a["score"], a["asr_score"]],
                                   [b["score"], b["asr_score"]], rtol=1e-5)


def test_transducer_offline_decode_is_one_search():
    """``transducer_offline_decode`` is one whole-utterance search of the
    port's host searcher (the JAX function's arguments)."""
    calls = []

    class Searcher:
        def init_state(self):
            return "s0"

        def search(self, state, audio, **kw):
            calls.append((state, len(audio), kw))
            return "s1", ["w3", "w7"]

    out = generator.transducer_offline_decode(Searcher(), np.zeros(640),
                                              intra_beam=3, max_steps=6)
    assert out == "w3 w7"
    assert calls == [("s0", 640, dict(is_end=True, intra_beam=3,
                                      inter_beam=1, gen_beam=5.0,
                                      read_step=10 ** 9, max_steps=6))]
