"""Span masking and the pre-training batcher of the torch port against the
JAX package.

- ``num_mask_spans``, ``expected_mask_count`` and ``compute_span_mask_np``
  (copies): the same counts, and masks bit-equal to the JAX masker's for
  the same ``np.random.Generator`` (padding, ``require_same_masks``,
  ``exact_count`` trimming and topping up);
- ``sample_span_mask`` (torch, explicit generator): a static number of
  spans per row, every span in bounds, padded frames never masked,
  determined by the generator's seed;
- ``read_audio_manifest`` / ``read_audio_batch`` (copies): the JAX
  readers' values;
- ``PretrainBatcher``: crops and masks equal the JAX batcher's when the
  JAX one draws from the generator the port keys on (seed, epoch, batch
  offset); the same key gives the same batch again, another key another.
"""

import numpy as np
import pytest
import torch

from wav2vec_s_tpu.data import audio as jax_audio
from wav2vec_s_tpu.data import dataset as jax_dataset
from wav2vec_s_tpu.data import manifests as jax_manifests
from wav2vec_s_tpu.utils import masking as jax_masking
from wav2vec_s_tpu_torch.data import audio, dataset, manifests
from wav2vec_s_tpu_torch.data.batching import length_buckets
from wav2vec_s_tpu_torch.utils import masking


@pytest.mark.parametrize("T", [5, 10, 11, 119, 627, 781])
def test_mask_counts_match_jax(T):
    for rand in (0.0, 0.4, 0.99):
        assert (masking.num_mask_spans(T, 0.65, 10, 2, rand)
                == jax_masking.num_mask_spans(T, 0.65, 10, 2, rand))
    assert (masking.expected_mask_count(T)
            == jax_masking.expected_mask_count(T))


MASK_CASES = {
    "plain": dict(shape=(4, 120), pad=None, exact=None, same=False),
    "same": dict(shape=(4, 120), pad=None, exact=None, same=True),
    "exact_trim": dict(shape=(3, 627), pad=None, exact=320, same=True),
    "exact_top_up": dict(shape=(3, 60), pad=None, exact=50, same=True),
    "padded": dict(shape=(3, 90), pad=(0, 30, 70), exact=None, same=True),
    "padded_exact": dict(shape=(3, 90), pad=(0, 30, 70), exact=20,
                         same=True),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_span_masks_are_bit_equal_to_jax(case):
    c = MASK_CASES[case]
    pad = None
    if c["pad"] is not None:
        pad = np.zeros(c["shape"], bool)
        for r, n in enumerate(c["pad"]):
            if n:
                pad[r, -n:] = True
    for seed in range(5):
        kw = dict(min_masks=2, require_same_masks=c["same"],
                  exact_count=c["exact"])
        want = jax_masking.compute_span_mask_np(
            c["shape"], pad, 0.65, 10, np.random.default_rng(seed), **kw)
        got = masking.compute_span_mask_np(
            c["shape"], pad, 0.65, 10, np.random.default_rng(seed), **kw)
        np.testing.assert_array_equal(got, want)
        if pad is not None:
            assert not (got & pad).any()
        if c["exact"] is not None:
            sz = c["shape"][1] - (pad.sum(1) if pad is not None else 0)
            assert (got.sum(1) == np.minimum(c["exact"], sz - 1)).all()


@pytest.mark.parametrize("T,L", [(119, 10), (627, 10), (8, 10), (40, 3)])
def test_sample_span_mask_static_counts_in_bounds(T, L):
    B = 6
    pad = torch.zeros((B, T), dtype=torch.bool)
    pad[1, T // 2:] = True
    gen = torch.Generator().manual_seed(0)
    mask = masking.sample_span_mask(gen, (B, T), pad, 0.65, L)
    assert mask.shape == (B, T) and mask.dtype == torch.bool
    assert not (mask & pad).any()
    n_spans = masking.num_mask_spans(T, 0.65, L)
    # spans overlap: between one span and all of them, padding apart
    counts = mask.sum(1)
    assert (counts[[0, 2, 3, 4, 5]] >= min(L, T)).all()
    assert (counts <= min(T, n_spans * L)).all()
    # starts in [0, T - L): the last L - 1 frames only ever as span tails
    again = masking.sample_span_mask(torch.Generator().manual_seed(0),
                                     (B, T), pad, 0.65, L)
    assert torch.equal(mask, again)
    other = masking.sample_span_mask(torch.Generator().manual_seed(1),
                                     (B, T), pad, 0.65, L)
    assert T <= L or not torch.equal(mask, other)


@pytest.fixture
def audio_corpus(tmp_path):
    rng = np.random.default_rng(0)
    rows = [f"{tmp_path}"]
    for i, n in enumerate((9000, 4000, 12000, 700, 6400)):
        audio.write_wav(tmp_path / f"a{i}.wav",
                        rng.standard_normal(n).astype(np.float32) * 0.1)
        rows.append(f"a{i}.wav\t{n}")
    path = tmp_path / "train.tsv"
    path.write_text("\n".join(rows) + "\n")
    return path


@pytest.mark.parametrize("lo,hi", [(0, None), (1000, 8000)])
def test_audio_manifest_and_batch_reader_match_jax(audio_corpus, lo, hi):
    got = manifests.read_audio_manifest(audio_corpus, lo, hi)
    want = jax_manifests.read_audio_manifest(audio_corpus, lo, hi)
    assert (got.root, got.paths, got.sizes) == (want.root, want.paths,
                                                want.sizes)
    paths = [got.full_path(i) for i in range(len(got))]
    for a, b in zip(audio.read_audio_batch(paths, 12000),
                    jax_audio.read_audio_batch(paths, 12000)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("normalize", [False, True])
def test_pretrain_batcher_matches_jax_under_one_generator(audio_corpus,
                                                          normalize):
    man = manifests.read_audio_manifest(audio_corpus, 1000)
    jman = jax_manifests.read_audio_manifest(audio_corpus, 1000)
    buckets = length_buckets(12000, min_len=1000, multiple=640)
    port = dataset.PretrainBatcher(man, buckets, normalize=normalize,
                                   seed=3)
    jb = jax_dataset.PretrainBatcher(jman, buckets, normalize=normalize,
                                     seed=3)
    for key, idx, hint in (((0, 0), [0, 2], None), ((1, 4), [0, 1, 3], 6400),
                           ((2, 1), [2, 3], 9000)):
        idx = np.asarray(idx)
        got = port.collate(idx, size_hint=hint, key=key)
        jb._rng = np.random.default_rng((3, *key))
        want = jb.collate(idx, size_hint=hint)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["mask_positions"].dtype == np.int32
        again = port.collate(idx, size_hint=hint, key=key)
        assert all(np.array_equal(again[k], got[k]) for k in got)
    a = port.collate(np.asarray([0, 2]), key=(0, 0))
    b = port.collate(np.asarray([0, 2]), key=(0, 1))
    assert not np.array_equal(a["mask_positions"], b["mask_positions"])
