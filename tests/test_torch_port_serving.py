"""Continuous-batching serving in the torch port, against the JAX package.

- ``IncrementalBlockwiseEncoder.make_serving_step`` equals the JAX serving
  step over two steps from a cache already holding rows, with a mixed
  visibility plane and nonzero per-slot frame counts (caches and outputs
  to 1e-5, float32), for the post-LN encoder and for the pre-LN one with
  conv bias (the Large layout);
- ``caat_step.jointer_step`` with a ``[N, T_cap]`` visibility plane equals
  the JAX one (1e-5), and equals its own ``[N]``-count path bit for bit
  where the plane is the count's prefix;
- ``ServingSession``: texts and delays EQUAL the JAX ``ServingSession``'s
  and those of the port's ``CachedFusedGreedyDecoder`` run alone on each
  stream, over staggered joins with a mid-stream stall and slot recycling
  (3 streams on 2 slots), cache compaction, and all streams in lockstep
  (the four cases of tests/test_serving.py, small enough for tier 1); a
  stream longer than ``t_cap`` raises in both; without a compaction the
  session's device state keeps its tensors from step to step.

Weights: the seeded tree of ``test_torch_port_import.jax_caat`` with the
rows of the tied embedding scaled to unit norm and the blank row to 0.75,
so that on these clips one stream stays blank and the others switch tokens
at points that depend on the audio they see.  The tiny conv stack hops 20
samples: 900 / 700 / 500 samples are 10 / 8 / 5 chunks of (mc 4, rc 2).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_greedy import _vocab
from tests.test_torch_port_import import jax_caat, port_caat, port_cfg
from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
from wav2vec_s_tpu.stream import caat_step as jax_caat_step
from wav2vec_s_tpu.stream import incremental as jax_incremental
from wav2vec_s_tpu.stream.serving import ServingSession as JaxSession
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.stream import caat_step
from wav2vec_s_tpu_torch.stream.batched import CachedFusedGreedyDecoder
from wav2vec_s_tpu_torch.stream.incremental import (
    IncrementalBlockwiseEncoder, IncrementalEncoderState)
from wav2vec_s_tpu_torch.stream.serving import ServingSession

ATOL = 1e-5
W2V = port_cfg(Wav2Vec2Config, W2V_TINY)
SESSION_KW = dict(blocks_per_step=1, max_len=24, max_emit_per_chunk=4)


@functools.lru_cache(maxsize=None)
def models():
    jax_model, params = jax_caat()
    params = dict(params)
    e = params["embed_tokens"].copy()
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e[CAAT_TINY.bos] *= 0.75
    params["embed_tokens"] = e
    return jax_model, params, port_caat(params)


def clips():
    rng = np.random.default_rng(7)
    return {sid: rng.standard_normal(n).astype(np.float32) * 0.3
            for sid, n in (("s0", 900), ("s1", 700), ("s2", 500))}


@functools.lru_cache(maxsize=None)
def oracle():
    """Each stream decoded alone by the port's cached decoder."""
    dec = CachedFusedGreedyDecoder(models()[2], _vocab(Dictionary), W2V,
                                   t_cap=128, **SESSION_KW)
    out = {}
    for sid, wav in clips().items():
        texts, delays = dec.decode_corpus([wav])
        out[sid] = (texts[0], delays[0])
    return out


def test_oracle_streams_differ():
    """The weights make the comparison sensitive: one stream blank, the
    others emitting different texts from different chunks on."""
    want = oracle()
    assert want["s0"] == ("", [])
    assert want["s1"][0] and want["s2"][0] and want["s1"] != want["s2"]
    assert want["s1"][1][0] != want["s2"][1][0]


# -- the step functions ------------------------------------------------------

def _serving_encoders(blocks, N, t_cap, w2v):
    _, params = jax_caat(w2v)
    model = port_caat(params, w2v)
    ref = jax_incremental.IncrementalBlockwiseEncoder(
        w2v, params["encoder"], N, t_cap=t_cap, blocks_per_step=blocks)
    port = IncrementalBlockwiseEncoder(
        port_cfg(Wav2Vec2Config, w2v), model.encoder.w2v2_model, N,
        t_cap=t_cap, blocks_per_step=blocks)
    return params, ref, port


@pytest.mark.parametrize("blocks,pre_ln", [(1, False), (2, False),
                                           (2, True)],
                         ids=["1", "2", "2-layer_norm_first"])
def test_serving_step_matches_jax(blocks, pre_ln):
    """``pre_ln``: the Large layout's encoder (a norm before attention and
    before the FFN, the post-stack norm, conv bias)."""
    N, t_cap, t_main = 3, 64, 20
    w2v = (dataclasses.replace(W2V_TINY, layer_norm_first=True,
                               conv_bias=True) if pre_ln else W2V_TINY)
    params, ref, port = _serving_encoders(blocks, N, t_cap, w2v)
    rng = np.random.default_rng(blocks)
    D = w2v.encoder_embed_dim
    L = w2v.encoder_layers

    def cache():
        c = np.zeros((t_cap, N, D), np.float32)
        c[:t_main] = rng.standard_normal((t_main, N, D))
        return c

    k = [cache() for _ in range(L)]
    v = [cache() for _ in range(L)]
    out = cache()
    j_state = jax_incremental.IncrementalEncoderState(
        k_cache=tuple(map(jnp.asarray, k)), v_cache=tuple(map(jnp.asarray, v)),
        out_cache=jnp.asarray(out), t_main=jnp.asarray(t_main, jnp.int32))
    t_state = IncrementalEncoderState(
        k_cache=[torch.tensor(x) for x in k],
        v_cache=[torch.tensor(x) for x in v],
        out_cache=torch.tensor(out), t_main=t_main)
    # a mixed plane: each slot sees its own scattered rows
    vis = np.zeros((N, t_cap), bool)
    vis[:, :t_main] = rng.random((N, t_main)) < 0.5
    vis[0, :t_main] = False                         # a fresh slot
    frames = np.array([0, 12, 40])
    j_step = ref.make_serving_step()
    t_step = port.make_serving_step()
    n_new = port.n_main + port.rc
    for s in range(2):
        window = (rng.standard_normal((N, port.window)) * 0.3).astype(
            np.float32)
        t0 = t_state.t_main
        j_state = j_step(params["encoder"], j_state, jnp.asarray(window),
                         jnp.asarray(frames), jnp.asarray(vis))
        t_state = t_step(t_state, torch.tensor(window), torch.tensor(frames),
                         torch.tensor(vis))
        assert int(j_state.t_main) == t_state.t_main == t0 + n_new
        vis[1:, t0:t0 + n_new] = True               # slots 1, 2 read on
        frames = frames + port.n_main
    np.testing.assert_allclose(t_state.out_cache.numpy(),
                               np.asarray(j_state.out_cache), atol=ATOL)
    for i in range(L):
        np.testing.assert_allclose(t_state.k_cache[i].numpy(),
                                   np.asarray(j_state.k_cache[i]), atol=ATOL)
        np.testing.assert_allclose(t_state.v_cache[i].numpy(),
                                   np.asarray(j_state.v_cache[i]), atol=ATOL)


def test_jointer_step_plane_matches_jax_and_count_path():
    jax_model, params, model = models()
    caat = CAAT_TINY
    N, T, D = 4, 24, caat.jointer_embed_dim
    rng = np.random.default_rng(3)
    h = rng.standard_normal((N, caat.decoder_embed_dim)).astype(np.float32)
    jk = [rng.standard_normal((T, N, D)).astype(np.float32)
          for _ in range(caat.jointer_layers)]
    jv = [rng.standard_normal((T, N, D)).astype(np.float32)
          for _ in range(caat.jointer_layers)]
    vis = rng.random((N, T)) < 0.4
    vis[:, 0] = True
    want = jax_caat_step.jointer_step(
        params, caat, jnp.asarray(h), tuple(map(jnp.asarray, jk)),
        tuple(map(jnp.asarray, jv)), jnp.asarray(vis))
    # the plane with every slot's extent the whole cache
    whole = (torch.zeros(N, dtype=torch.long), torch.tensor(T))
    got = caat_step.jointer_step(
        model, model.cfg, torch.tensor(h), [torch.tensor(x) for x in jk],
        [torch.tensor(x) for x in jv],
        caat_step.SlotPlane(torch.tensor(vis), *whole))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the plane of a count prefix gives the count path's values exactly
    counts = torch.tensor([1, 5, 17, 24])
    plane = torch.arange(T)[None] < counts[:, None]
    args = (model, model.cfg, torch.tensor(h), [torch.tensor(x) for x in jk],
            [torch.tensor(x) for x in jv])
    assert torch.equal(
        caat_step.jointer_step(*args, caat_step.SlotPlane(plane, *whole)),
        caat_step.jointer_step(*args, counts))


# -- the session -------------------------------------------------------------

def _stagger_stall_recycle(sess, wavs):
    """s0 joins with all its audio; s1 joins with its first chunk only and
    stalls for several steps; s2 waits for a free slot (3 streams, 2
    slots)."""
    assert sess.add_stream("s0")
    sess.push("s0", wavs["s0"], is_end=True)
    assert sess.add_stream("s1")
    sess.push("s1", wavs["s1"][:200])        # chunk 0 only: stalls after
    assert not sess.add_stream("s2")         # both slots busy
    added, resumed = False, False
    for it in range(100):
        sess.step()
        if not resumed and it >= 3:
            sess.push("s1", wavs["s1"][200:], is_end=True)
            resumed = True
        if not added and "s0" in sess._results:
            assert sess.add_stream("s2")     # the recycled slot
            sess.push("s2", wavs["s2"], is_end=True)
            added = True
        if len(sess._results) == 3:
            break


def _compaction(sess, wavs):
    """Streams one after another on one slot of too small a cache."""
    for sid in ("s0", "s1", "s2"):
        assert sess.add_stream(sid)
        sess.push(sid, wavs[sid], is_end=True)
        sess.drain()


def _lockstep(sess, wavs):
    for sid, wav in wavs.items():
        assert sess.add_stream(sid)
        sess.push(sid, wav, is_end=True)
    sess.drain()


SCENARIOS = {
    "stagger_stall_recycle": (_stagger_stall_recycle, 2, 256),
    "compaction": (_compaction, 1, 96),
    "lockstep": (_lockstep, 3, 256),
}


def _sessions(n_slots, t_cap):
    jax_model, params, model = models()
    ref = JaxSession(jax_model, params, _vocab(JaxDictionary), W2V_TINY,
                     n_slots=n_slots, t_cap=t_cap, **SESSION_KW)
    port = ServingSession(model, _vocab(Dictionary), W2V, n_slots=n_slots,
                          t_cap=t_cap, **SESSION_KW)
    return ref, port


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_session_equals_jax_and_solo_decodes(scenario):
    drive, n_slots, t_cap = SCENARIOS[scenario]
    ref, port = _sessions(n_slots, t_cap)
    for sess in (ref, port):
        drive(sess, clips())
    want = oracle()
    for sid in want:
        assert port.result(sid) == ref.result(sid) == want[sid], sid
    assert (port.compactions > 0) == (scenario == "compaction")


@pytest.mark.parametrize("scenario", ["stagger_stall_recycle", "lockstep"])
def test_serving_state_stays_in_place(scenario):
    """Without a compaction, every step (resets included) writes the
    prefixes, lengths, frame counts and LM state into the tensors the
    session started with, as the decoders' graphed loop does."""
    drive, n_slots, t_cap = SCENARIOS[scenario]
    sess = ServingSession(models()[2], _vocab(Dictionary), W2V,
                          n_slots=n_slots, t_cap=t_cap, **SESSION_KW)

    def ptrs():
        lm = sess._lm
        return [x.data_ptr() for x in [sess._prefixes, sess._lens,
                                       sess._frames, lm.h_last] + lm.k
                + lm.v]

    first, seen, device_step = ptrs(), [], sess._device_step

    def step(*args):
        device_step(*args)
        seen.append(ptrs())

    sess._device_step = step
    drive(sess, clips())
    assert sess.compactions == 0 and len(seen) == sess.steps > 5
    assert all(p == first for p in seen)
    for sid, want in oracle().items():
        assert sess.result(sid) == want, sid


def test_session_raises_when_t_cap_runs_out():
    """A stream longer than the cache cannot be compacted (its own rows are
    live): both sessions raise rather than overwrite."""
    for sess in _sessions(1, 24):
        assert sess.add_stream("long")
        sess.push("long", clips()["s0"], is_end=True)
        with pytest.raises(RuntimeError, match="t_cap"):
            sess.drain()


def test_session_raises_when_the_end_comes_after_the_last_chunk():
    """The end must come with the last chunk's audio: marked after the
    stream's last chunk ran (without the look-ahead flush), it raises,
    where the JAX session waits for that flush forever."""
    sess = ServingSession(models()[2], _vocab(Dictionary), W2V, n_slots=1,
                          t_cap=128, **SESSION_KW)
    assert sess.add_stream("s")
    sess.push("s", clips()["s2"])            # 5 chunks, all computable
    for _ in range(6):
        sess.step()
    assert sess.slots[0].chunk_idx == 5
    with pytest.raises(RuntimeError, match="after its last chunk ran"):
        sess.push("s", np.zeros(0, np.float32), is_end=True)
