"""The wait-k and MMA simultaneous baselines of the torch port against the
JAX package.

Tiny dims (``tests/test_caat.py`` W2V_TINY/CAAT_TINY; the flash cases on
``test_torch_port_oneshot.W2V_DH8``, 32 wide with dh 8, so that the JAX
side runs its Pallas kernels in interpret mode), float32, seeded numpy
weights carried across by ``checkpoint/convert.py``
(``waitk_state_dict_from_jax`` / ``mma_state_dict_from_jax``), every
dropout off.  The MMA energy noise: the port draws it from the step
generator, JAX from its ``mono_noise`` key; the port's draws are planted at
the JAX draw site (its ``jax.random.normal``) in the training cases.

- ``waitk_cross_bias``; wait-k and MMA logits (and MMA's ``alphas``), the
  training loss of ``tools/baseline_parity.sequence_loss`` and every
  gradient, dense and flash (MMA also without noise, the inference
  forward);
- ``expected_alignment`` and its gradient at p near 0, in the middle and
  near 1, with padded frames; ``hard_pointers``; ``hard_decode_step``
  (logits and ``need_more``); ``latency_loss`` and its gradient;
- ``WaitkAgent`` and ``MMAStreamingAgent`` under ``SimulEvaluator``: the
  words and delays of the JAX agents, and JAX's stuck-heads case (energy
  bias -50: no word while the stream is open);
- the MMA noise, held by its statistics.

Tolerances: logits, alphas and losses rtol 1e-5 (atol 1e-5 where values
cross 0, 1e-6 on alphas); gradients rtol 1e-4 with an atol of 1e-6 of the
largest gradient; pointers, masks, words and delays exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_full_context import _seeded
from tests.test_torch_port_import import port_cfg
from tests.test_torch_port_oneshot import W2V_DH8
from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
from wav2vec_s_tpu.models import mma as jax_mma
from wav2vec_s_tpu.models import waitk as jax_waitk
from wav2vec_s_tpu.stream.agent import SimulEvaluator as JaxSimulEvaluator
from wav2vec_s_tpu.stream.mma_agent import (
    MMAStreamingAgent as JaxMMAStreamingAgent)
from wav2vec_s_tpu_torch.checkpoint.convert import (
    mma_state_dict_from_jax, waitk_state_dict_from_jax)
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.models import mma, waitk
from wav2vec_s_tpu_torch.models.caat import CaatConfig
from wav2vec_s_tpu_torch.ops import dropout as port_dropout
from wav2vec_s_tpu_torch.stream.agent import SimulEvaluator
from wav2vec_s_tpu_torch.stream.mma_agent import MMAStreamingAgent
from wav2vec_s_tpu_torch.tools.baseline_parity import sequence_loss

torch.set_num_threads(1)

NO_DROP = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
               encoder_layerdrop=0.0)
W2V = dataclasses.replace(W2V_TINY, **NO_DROP)
FLASH = dataclasses.replace(W2V_DH8, attention_impl="flash", **NO_DROP)
CAAT = CAAT_TINY
K, STRIDE = 2, 3
S = 2400


@functools.lru_cache(maxsize=None)
def jax_model(kind, w2v=W2V, seed=1):
    """(flax model, seeded numpy params) of ``kind`` ("waitk" | "mma")."""
    model = (jax_waitk.WaitkModel(w2v, CAAT, K, STRIDE) if kind == "waitk"
             else jax_mma.MMAModel(w2v, CAAT))
    shapes = jax.eval_shape(lambda: model.init(
        {n: jax.random.PRNGKey(0) for n in ("params", "dropout",
                                            "layerdrop", "mono_noise")},
        jnp.zeros((1, S)), jnp.zeros((1, 5), jnp.int32),
        train=False))["params"]
    return model, _seeded(shapes, seed)


def port_model(kind, params, w2v=W2V):
    pw, pc = port_cfg(Wav2Vec2Config, w2v), port_cfg(CaatConfig, CAAT)
    if kind == "waitk":
        model = waitk.WaitkModel(pw, pc, K, STRIDE)
        sd = waitk_state_dict_from_jax(params)
    else:
        model = mma.MMAModel(pw, pc)
        sd = mma_state_dict_from_jax(params)
    model.load_state_dict(sd, strict=True)
    return model


def make_batch(seed=0):
    """3 rows of 2400 samples (row 2 padded from 1800), 6 targets ending in
    eos (row 1 three shorter)."""
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((3, S)) * 0.3).astype(np.float32)
    tgt = rng.integers(4, CAAT.vocab_size, (3, 6)).astype(np.int32)
    tgt[:, -1] = CAAT.eos
    tgt[1, 3:] = CAAT.pad
    tgt[1, 2] = CAAT.eos
    pad = np.zeros((3, S), bool)
    pad[2, 1800:] = True
    return {"source": src, "targets": tgt, "padding_mask": pad}


def _jax_batch(batch):
    return dict({k: jnp.asarray(v) for k, v in batch.items()},
                prev=jnp.asarray(_prev(batch["targets"])))


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _prev(tgt):
    prev = np.concatenate([np.full((tgt.shape[0], 1), CAAT.eos, np.int32),
                           tgt[:, :-1]], axis=1)
    return np.where(tgt == CAAT.pad, CAAT.pad, prev)


def _jax_loss(kind, model_j, train):
    """``sequence_loss`` of the JAX model (its MMA test's loss)."""

    def fn(params, b):
        tgt = b["targets"]
        out = model_j.apply(
            {"params": params}, b["source"], b["prev"], b["padding_mask"],
            train=train,
            rngs={n: jax.random.PRNGKey(0) for n in
                  ("dropout", "layerdrop", "mono_noise")})
        logits, alphas = out if kind == "mma" else (out, None)
        lp = jax.nn.log_softmax(logits, -1)
        nll = -jnp.take_along_axis(lp, tgt[..., None], -1)[..., 0]
        keep = tgt != CAAT.pad
        loss = jnp.sum(nll * keep) / keep.sum()
        if alphas is not None:
            src_lens = jnp.full((tgt.shape[0],), float(alphas.shape[-1]))
            loss = loss + 0.1 * jax_mma.latency_loss(alphas, src_lens, ~keep)
        return loss, out

    return fn


class Noise:
    """Records the port's MMA energy noise and plants it, in the same
    order, at the JAX draw site (``jax.random.normal`` of the mma
    module)."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.draws = []
        real = port_dropout.DropoutContext.normal

        def normal(ctx, shape):
            self.draws.append(real(ctx, shape))
            return self.draws[-1]

        monkeypatch.setattr(port_dropout.DropoutContext, "normal", normal)

    def plant(self):
        planted = [jnp.asarray(d.numpy()) for d in self.draws]
        calls = []

        class Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            def normal(self, key, shape):
                out = planted[len(calls) % len(planted)]
                calls.append(shape)
                assert tuple(shape) == out.shape, (shape, out.shape)
                return out

        class Jax:
            random = Random()

            def __getattr__(self, name):
                return getattr(jax, name)

        self.mp.setattr(jax_mma, "jax", Jax())
        return calls


def _grads_equal(model, sd_of, want_tree):
    want = sd_of(want_tree)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    named = dict(model.named_parameters())
    assert named.keys() == want.keys()
    for name, p in named.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(g, want[name].numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)


# -- wait-k ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 10, 2, 2), (6, 11, 3, 1)])
def test_waitk_cross_bias_matches_jax(shape):
    want = np.asarray(jax_waitk.waitk_cross_bias(*shape))
    np.testing.assert_array_equal(waitk.waitk_cross_bias(*shape).numpy(),
                                  want)


@pytest.mark.parametrize("w2v", [W2V, FLASH], ids=["dense", "flash"])
def test_waitk_logits_loss_and_gradients_match_jax(w2v):
    model_j, params = jax_model("waitk", w2v)
    b = make_batch()
    (want_loss, want_logits), grads = jax.jit(jax.value_and_grad(
        _jax_loss("waitk", model_j, True), has_aux=True))(
        params, _jax_batch(b))
    model = port_model("waitk", params, w2v)
    tb = _torch(b)
    with torch.no_grad():
        logits = model(tb["source"], torch.from_numpy(_prev(
            b["targets"])).long(), tb["padding_mask"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)
    loss = sequence_loss("waitk", model, tb, port_dropout.DropoutContext(
        torch.Generator().manual_seed(0)))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    _grads_equal(model, waitk_state_dict_from_jax, jax.device_get(grads))


# -- MMA ------------------------------------------------------------------


@pytest.mark.parametrize("w2v, noise", [(W2V, True), (FLASH, True),
                                        (W2V, False)],
                         ids=["dense", "flash", "dense-no-noise"])
def test_mma_logits_alphas_loss_and_gradients_match_jax(w2v, noise,
                                                        monkeypatch):
    """Training (``noise``: the energies' noise planted) or the inference
    forward (no noise): logits, the alphas of every layer, the loss with
    its latency term and every gradient."""
    model_j, params = jax_model("mma", w2v)
    b = make_batch()
    model = port_model("mma", params, w2v)
    tb = _torch(b)
    ctx = None
    if noise:
        draws = Noise(monkeypatch)
        ctx = port_dropout.DropoutContext(torch.Generator().manual_seed(0))
    loss = sequence_loss("mma", model, tb, ctx)
    loss.backward()
    if noise:
        assert len(draws.draws) == CAAT.decoder_layers
        calls = draws.plant()
    (want_loss, (want_logits, want_alphas)), grads = jax.jit(
        jax.value_and_grad(_jax_loss("mma", model_j, noise), has_aux=True))(
        params, _jax_batch(b))
    if noise:
        assert len(calls) == CAAT.decoder_layers
    with torch.no_grad():
        for layer in model.decoder.layers:
            layer.encoder_attn.noise_std = float(noise)
        logits, alphas = model(tb["source"], torch.from_numpy(_prev(
            b["targets"])).long(), tb["padding_mask"], ctx=(
            port_dropout.DropoutContext(torch.Generator().manual_seed(0))
            if noise else None))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(want_alphas),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _grads_equal(model, mma_state_dict_from_jax, jax.device_get(grads))
    g = model.decoder.layers[0].encoder_attn.mono_q_proj.weight.grad
    assert g.abs().max() > 0


@pytest.mark.parametrize("lo, hi", [(1e-7, 1e-3), (0.1, 0.9),
                                    (1 - 1e-3, 1.0)],
                         ids=["near0", "mid", "near1"])
def test_expected_alignment_and_its_gradient_match_jax(lo, hi):
    rng = np.random.default_rng(int(hi * 10))
    B, H, U, Sf = 2, 3, 5, 12
    p = rng.uniform(lo, hi, (B, H, U, Sf)).astype(np.float32)
    pad = np.zeros((B, Sf), bool)
    pad[1, 9:] = True
    r = rng.standard_normal(p.shape).astype(np.float32)

    def fn(p):
        a = jax_mma.expected_alignment(p, jnp.asarray(pad))
        return jnp.sum(a * r), a

    (_, want), want_g = jax.value_and_grad(fn, has_aux=True)(jnp.asarray(p))
    pt = torch.tensor(p, requires_grad=True)
    got = mma.expected_alignment(pt, torch.from_numpy(pad))
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(pt.grad.numpy(), want_g, rtol=1e-4,
                               atol=1e-6 * np.abs(want_g).max())
    assert np.isfinite(want_g).all()


def test_hard_pointers_match_jax():
    """The JAX test's walk (a stop before the pointer skipped, a head that
    never stops, one that stops at once), then random selection
    probabilities at several visible counts, open and ended."""
    p = np.zeros((1, 2, 3, 8), np.float32)
    p[0, 0, 0, 2] = p[0, 0, 1, 1] = p[0, 0, 1, 5] = 0.9
    p[0, 1, :, 0] = 0.9
    rng = np.random.default_rng(3)
    cases = [(p, [6], [False]), (p, [6], [True]),
             (rng.uniform(0, 1, (3, 4, 6, 10)).astype(np.float32) ** 3,
              [10, 4, 0], [False, False, True])]
    for probs, vis, end in cases:
        want = jax_mma.hard_pointers(jnp.asarray(probs), jnp.asarray(vis),
                                     jnp.asarray(end))
        got = mma.hard_pointers(torch.from_numpy(probs), torch.tensor(vis),
                                torch.tensor(end))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ptrs, stuck = mma.hard_pointers(torch.from_numpy(p), torch.tensor([6]),
                                    torch.tensor([False]))
    assert ptrs[0, 0].tolist() == [2, 5, 5] and stuck[0, 0].tolist() == [
        False, False, True]


def test_hard_decode_step_matches_jax():
    model_j, params = jax_model("mma")
    model = port_model("mma", params).eval()
    b = make_batch(1)
    src, pad = jnp.asarray(b["source"]), jnp.asarray(b["padding_mask"])
    enc, enc_pad = jax.jit(lambda p, s, m: model_j.apply(
        {"params": p}, s, m, method=model_j.encode))(params, src, pad)
    prev = np.full((3, 8), CAAT.pad, np.int32)
    prev[:, 0] = CAAT.eos
    prev[0, 1:3] = [5, 6]
    prev[1, 1:6] = [7, 8, 9, 10, 11]
    lens = np.asarray([3, 6, 1], np.int32)
    visible = np.asarray([40, 119, 3], np.int32)
    is_end = np.asarray([False, True, False])
    want = jax.jit(lambda p, *a: model_j.apply(
        {"params": p}, *a, method=model_j.hard_decode_step))(
        params, jnp.asarray(prev), jnp.asarray(lens), enc, enc_pad,
        jnp.asarray(visible), jnp.asarray(is_end))
    with torch.no_grad():
        enc_t, pad_t = model.encode(torch.from_numpy(b["source"]),
                                    torch.from_numpy(b["padding_mask"]))
        got = model.hard_decode_step(
            torch.from_numpy(prev).long(), torch.from_numpy(lens).long(),
            enc_t, pad_t, torch.from_numpy(visible).long(),
            torch.from_numpy(is_end))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_latency_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(4)
    alphas = rng.uniform(0, 0.3, (2, 3, 4, 5, 9)).astype(np.float32)
    src_lens = np.asarray([9.0, 6.0, 7.0], np.float32)
    tgt_pad = np.zeros((3, 5), bool)
    tgt_pad[1, 3:] = True
    want, want_g = jax.value_and_grad(jax_mma.latency_loss)(
        jnp.asarray(alphas), jnp.asarray(src_lens), jnp.asarray(tgt_pad))
    a = torch.tensor(alphas, requires_grad=True)
    got = mma.latency_loss(a, torch.from_numpy(src_lens),
                           torch.from_numpy(tgt_pad))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-7)
    assert float(want) > 0


def test_mma_noise_statistics():
    """The training noise: standard normal draws of the energies' shape
    from the step generator, one per layer, a function of its seed; none
    without a context."""
    _, params = jax_model("mma")
    model = port_model("mma", params)
    tb = _torch(make_batch())
    energies = []
    real = port_dropout.DropoutContext.normal

    def normal(ctx, shape):
        energies.append(real(ctx, shape))
        return energies[-1]

    port_dropout.DropoutContext.normal = normal
    try:
        for seed in (0, 0, 1):
            sequence_loss("mma", model, tb, port_dropout.DropoutContext(
                torch.Generator().manual_seed(seed)))
        sequence_loss("mma", model, tb, None)
    finally:
        port_dropout.DropoutContext.normal = real
    L = CAAT.decoder_layers
    assert len(energies) == 3 * L
    B, U = tb["targets"].shape
    assert energies[0].shape == (B, CAAT.decoder_attention_heads, U, 119)
    for a, b in zip(energies[:L], energies[L:2 * L]):
        assert torch.equal(a, b)
    assert not torch.equal(energies[0], energies[2 * L])
    x = torch.cat([e.flatten() for e in energies[:L]])
    assert abs(x.mean().item()) < 0.03 and abs(x.std().item() - 1) < 0.03


# -- the agents -----------------------------------------------------------


def _vocabs():
    out = []
    for cls in (JaxDictionary, Dictionary):
        v = cls()
        for i in range(CAAT.vocab_size - v.nspecial):
            v.add_symbol(f"w{i}")
        out.append(v)
    return out


def _quiet_eos(kind, params, scale=0.1):
    """A copy of ``params`` whose eos embedding row (tied to the output)
    is scaled down, so that the random model writes words before eos."""
    params = jax.tree_util.tree_map(np.array, params)
    tree = params["decoder"] if kind == "waitk" else params
    tree["embed_tokens"][CAAT.eos] *= scale
    return params


def _run(evaluator_cls, factory, wavs):
    ev = evaluator_cls(factory, segment_size_ms=25)
    return [(r.hypo, list(r.delays_ms)) for r in
            (ev.run_instance(w, "w1 w2") for w in wavs)]


def _wavs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.3).astype(np.float32)
            for n in lengths]


def test_waitk_agent_words_and_delays_equal_jax():
    model_j, params = jax_model("waitk")
    params = _quiet_eos("waitk", params)
    model = port_model("waitk", params).eval()
    jv, pv = _vocabs()
    wavs = _wavs([2000])
    kw = dict(waitk=K, stride=STRIDE * 7, frames_per_sample=1 / 20.0,
              max_len=5)
    want = _run(JaxSimulEvaluator, lambda: jax_waitk.WaitkAgent(
        model_j, params, jv, **kw), wavs)
    got = _run(SimulEvaluator, lambda: waitk.WaitkAgent(model, pv, **kw),
               wavs)
    assert got == want
    assert any(h for h, _ in got)


MMA_KW = dict(main_context=4, right_context=2, eager=True, max_len=8,
              audio_buckets=[1600, 3200], token_buckets=[8, 16])


@pytest.mark.parametrize("stuck", [False, True], ids=["emits", "stuck"])
def test_mma_agent_words_and_delays_equal_jax(stuck):
    """``stuck``: JAX's test of heads that never stop (energy bias -50):
    both agents READ to the end of the stream, then emit."""
    model_j, params = jax_model("mma")
    params = _quiet_eos("mma", params)
    if stuck:
        for i in range(CAAT.decoder_layers):
            params[f"layer_{i}"]["encoder_attn"]["energy_bias"] = np.asarray(
                -50.0, np.float32)
    model = port_model("mma", params).eval()
    jv, pv = _vocabs()
    wavs = _wavs([2400, 3200], seed=1)
    want = _run(JaxSimulEvaluator, lambda: JaxMMAStreamingAgent(
        model_j, params, jv, **MMA_KW), wavs)
    got = _run(SimulEvaluator, lambda: MMAStreamingAgent(model, pv, **MMA_KW),
               wavs)
    assert got == want
    assert any(h for h, _ in got)
    if stuck:
        # every word comes at the end of its stream
        for (_, delays), w in zip(got, wavs):
            assert set(delays) <= {len(w) / 16.0}
