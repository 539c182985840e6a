"""The beam block of ``stream/beam_batched.py`` and its pieces, the port
against the JAX package and against plain references.

- tie order: ``torch.argmax`` takes the first maximum, the stable sorts
  the lowest index among equals, on all-``-inf`` and all-equal rows (the
  beam block relies on both; ``torch.topk`` is not used);
- ``_merge_identical_batched`` (max and add) equals the JAX function and,
  row by row, the host searcher's ``_merge_identical``; no NaN on classes
  of ``-inf`` rows;
- the hierarchical top-B equals a flat stable descending sort, with
  planted ties: equal logits inside one bucket, across buckets, rows that
  are all ``-inf``;
- one whole beam block equals the JAX ``_beam_block`` on seeded prefixes
  (inter_beam 1 and 2, max and add merging, an inactive stream, open and
  ended streams): pool tokens equal, pool scores within 1e-4;
- running the fixed ``max_steps`` iterations gives what the early-stop
  loop gives: the pool of a block, and texts and delays of all four
  decoders.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_caat import CAAT_TINY, W2V_TINY
from tests.test_torch_port_beam_engine import chunked_audio
from tests.test_torch_port_greedy import _vocab
from tests.test_torch_port_import import jax_caat, port_caat, port_cfg
from wav2vec_s_tpu.data.dictionary import Dictionary as JaxDictionary
from wav2vec_s_tpu.stream import beam_batched as jax_beam
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.models import Wav2Vec2Config
from wav2vec_s_tpu_torch.stream import beam_batched
from wav2vec_s_tpu_torch.stream.searcher import StreamingTransducerSearcher

NINF = float("-inf")
DECODERS = ("BatchedBeamStreamingDecoder", "OneShotBeamDecoder",
            "FusedBeamStreamingDecoder", "FusedOneShotBeamDecoder")


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                            else a)


# -- tie order -------------------------------------------------------------

@pytest.mark.parametrize("value", [NINF, 0.0, 1.5])
def test_argmax_takes_the_first_of_equals(value):
    x = torch.full((3, 4, 7), value)
    assert torch.equal(x.argmax(-1), torch.zeros((3, 4), dtype=torch.long))
    x[:, :, 2] = value + 1 if np.isfinite(value) else 0.0
    x[:, :, 5] = x[:, :, 2]
    assert torch.equal(x.argmax(-1), torch.full((3, 4), 2))


@pytest.mark.parametrize("value", [NINF, 0.0])
def test_stable_sorts_keep_index_order_among_equals(value):
    x = torch.full((2, 9), value)
    x[0, 4] = x[0, 7] = 3.0
    want = torch.tensor([[4, 7, 0, 1, 2, 3, 5, 6, 8], list(range(9))])
    _, idx = torch.sort(x, dim=1, descending=True, stable=True)
    assert torch.equal(idx, want)
    assert torch.equal(torch.argsort(-x, dim=1, stable=True), want)


# -- identical-path merge --------------------------------------------------

def _pool(seed, N=3, P=6, U=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, 7, (N, P, U))
    toks[:, 3] = toks[:, 0]                      # identical paths
    toks[:, 4] = toks[:, 1]
    toks[0, 5] = toks[0, 0]
    scores = rng.standard_normal((N, P)).astype(np.float32)
    scores[1, 1] = scores[1, 4] = NINF           # a class of -inf rows
    scores[2] = NINF                             # an empty pool
    scores[0, 3] = NINF                          # -inf joins a finite row
    return toks, scores


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_identical_matches_jax_and_host(add, seed):
    toks, scores = _pool(seed)
    got = beam_batched._merge_identical_batched(_t(toks), _t(scores), add)
    want = jax_beam._merge_identical_batched(
        jnp.asarray(toks), jnp.asarray(scores), add)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for n in range(toks.shape[0]):
        host = StreamingTransducerSearcher._merge_identical(
            toks[n], scores[n].astype(np.float64), add)
        np.testing.assert_allclose(got[n].numpy(), host, atol=1e-6)


# -- hierarchical top-B ----------------------------------------------------

def _flat_top(masked, B):
    v, i = torch.sort(masked, dim=-1, descending=True, stable=True)
    return v[..., :B], i[..., :B]


def _planted(case, V):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, V)).astype(np.float32)
    if case == "in_one_bucket":
        x[:, :, [3, 9, 20, 21]] = 7.0
    elif case == "across_buckets":
        x[:, :, [130, 5, 257, 131]] = 7.0
        x[0, 0, V - 1] = 7.0
    elif case == "all_ninf_rows":
        x[0, 1] = NINF
        x[1] = NINF
    elif case == "all_equal":
        x[:] = 0.25
    elif case == "few_finite":
        x[:] = NINF
        x[:, :, [200, 7]] = 1.0                  # fewer finite than B
    return torch.from_numpy(x)


@pytest.mark.parametrize("V", [30, 300])
@pytest.mark.parametrize("case", ["seeded", "in_one_bucket",
                                  "across_buckets", "all_ninf_rows",
                                  "all_equal", "few_finite"])
def test_top_b_equals_flat_stable_sort(case, V):
    if V == 30 and case in ("across_buckets", "few_finite"):
        case = "in_one_bucket"                   # one bucket holds V 30
    masked = _planted(case, V)
    for B in (1, 3, 5):
        got_v, got_i = beam_batched._top_b_per_row(masked, B)
        want_v, want_i = _flat_top(masked, B)
        assert torch.equal(got_v, want_v), (case, B)
        # a row with fewer than B finite values fills up with -inf picks,
        # whose indices carry no meaning (such candidates never score; the
        # masking of earlier picks cannot tell them apart, here as in the
        # JAX block); the first pick is the flat argmax in every row
        live = torch.isfinite(want_v)
        assert torch.equal(got_i[live], want_i[live]), (case, B)
        assert torch.equal(got_i[..., 0], want_i[..., 0]), (case, B)


# -- one whole beam block --------------------------------------------------

KW = dict(beam_size=3, gen_beam=2.0, max_steps=5, max_len=64, eager=True,
          t_cap=64)


# the blank row of the tied embedding scaled so that blank wins early in
# some streams: the early-stop test of the block then fires
BLANK_SCALE = 1.6


@functools.lru_cache(maxsize=None)
def scaled_params(scale):
    """(flax model, seeded numpy params with the blank row scaled)."""
    jax_model, params = jax_caat()
    params = dict(params)
    params["embed_tokens"] = params["embed_tokens"].copy()
    params["embed_tokens"][CAAT_TINY.bos] *= scale
    return jax_model, params


@functools.lru_cache(maxsize=None)
def _decoders(inter_beam, merge_add):
    jax_model, params = scaled_params(BLANK_SCALE)
    kw = dict(KW, inter_beam=inter_beam, merge_add=merge_add)
    ref = jax_beam.BatchedBeamStreamingDecoder(
        jax_model, params, _vocab(JaxDictionary), W2V_TINY, **kw)
    port = beam_batched.BatchedBeamStreamingDecoder(
        port_caat(params), _vocab(Dictionary),
        port_cfg(Wav2Vec2Config, W2V_TINY), **kw)
    return params, ref, port


def _block_inputs(inter_beam, seed=11):
    rng = np.random.default_rng(seed)
    N, B, U, T, D = 4, KW["beam_size"], 16, 24, CAAT_TINY.jointer_embed_dim
    prefixes = np.full((N, B, U), CAAT_TINY.pad, np.int32)
    nlens = np.ones((N, B), np.int32)
    scores = np.full((N, B), NINF, np.float32)
    for n in range(N):
        for b in range(inter_beam):
            ln = int(rng.integers(1, 6))
            prefixes[n, b, 0] = CAAT_TINY.bos
            prefixes[n, b, 1:ln] = rng.integers(4, CAAT_TINY.vocab_size,
                                                ln - 1)
            nlens[n, b] = ln
            scores[n, b] = -rng.random() * 3
    jk = [rng.standard_normal((T, N, D)).astype(np.float32)
          for _ in range(CAAT_TINY.jointer_layers)]
    jv = [rng.standard_normal((T, N, D)).astype(np.float32)
          for _ in range(CAAT_TINY.jointer_layers)]
    visible = np.array([5, 24, 11, 16], np.int32)
    is_end = np.array([False, True, False, True])
    active = np.array([True, True, True, False])
    return prefixes, nlens, scores, jk, jv, visible, is_end, active


def _port_block(port, inputs, cap=16):
    prefixes, nlens, scores, jk, jv, visible, is_end, active = inputs
    return port._beam_block(
        _t(prefixes), _t(nlens), _t(scores), list(map(_t, jk)),
        list(map(_t, jv)), _t(visible), _t(is_end), _t(active), cap=cap)


@pytest.mark.parametrize("merge_add", [False, True])
@pytest.mark.parametrize("inter_beam", [1, 2])
def test_beam_block_matches_jax(inter_beam, merge_add):
    params, ref, port = _decoders(inter_beam, merge_add)
    inputs = _block_inputs(inter_beam)
    prefixes, nlens, scores, jk, jv, visible, is_end, active = inputs
    # visible <= cap for the streams whose frames the block may read
    cap = 24
    want_t, want_s = ref._beam_block(
        params, jnp.asarray(prefixes), jnp.asarray(nlens),
        jnp.asarray(scores), tuple(map(jnp.asarray, jk)),
        tuple(map(jnp.asarray, jv)), jnp.asarray(visible),
        jnp.asarray(is_end), jnp.asarray(active), cap=cap)
    got_t, got_s = _port_block(port, inputs, cap=cap)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    want_s = np.asarray(want_s)
    assert np.isfinite(want_s[:3, 0]).all()
    assert not np.isfinite(want_s[3]).any()      # the inactive stream
    np.testing.assert_array_equal(np.isfinite(got_s.numpy()),
                                  np.isfinite(want_s))
    fin = np.isfinite(want_s)
    np.testing.assert_allclose(got_s.numpy()[fin], want_s[fin], atol=1e-4,
                               rtol=0)
    assert not torch.isnan(got_s).any()


# -- fixed count == early stop ---------------------------------------------

@pytest.mark.parametrize("inter_beam", [1, 2])
def test_fixed_count_block_equals_early_stop_block(inter_beam):
    """Open streams under a blank bias: every stream's best finished path
    soon leads its best open one by ``gen_beam``, and the reading loop
    stops before ``max_steps``."""
    _, params = scaled_params(BLANK_SCALE)
    port = beam_batched.BatchedBeamStreamingDecoder(
        port_caat(params), _vocab(Dictionary),
        port_cfg(Wav2Vec2Config, W2V_TINY), inter_beam=inter_beam,
        bos_bias=12.0, **KW)
    inputs = list(_block_inputs(inter_beam))
    inputs[6] = np.zeros(4, bool)                # is_end
    pools, iterations = {}, {}
    for every in (0, 1, 2):
        port.stop_check_every = every
        before = port.iterations_run
        pools[every] = _port_block(port, inputs)
        iterations[every] = port.iterations_run - before
    assert iterations[0] == KW["max_steps"]
    assert iterations[1] < KW["max_steps"]       # the loop did stop early
    assert iterations[1] <= iterations[2] <= iterations[0]
    assert torch.isfinite(pools[0][1][:3, 0]).all()
    for every in (1, 2):
        assert torch.equal(pools[every][0], pools[0][0])
        assert torch.equal(pools[every][1], pools[0][1])


@pytest.mark.parametrize("name", DECODERS)
def test_fixed_count_decode_equals_early_stop_decode(name):
    _, params = scaled_params(BLANK_SCALE)
    wavs = [chunked_audio(4, 0), chunked_audio(3, 7), chunked_audio(4, 5),
            chunked_audio(2, 9)]
    out, iterations = {}, {}
    for every in (0, 1):
        dec = getattr(beam_batched, name)(
            port_caat(params), _vocab(Dictionary),
            port_cfg(Wav2Vec2Config, W2V_TINY), inter_beam=1, **KW)
        dec.stop_check_every = every
        out[every] = dec.decode_corpus(wavs)
        iterations[every] = dec.iterations_run
    assert out[1] == out[0]
    assert sum(len(d) for d in out[0][1]) >= 16
    assert iterations[1] < iterations[0]         # the loop did stop early
