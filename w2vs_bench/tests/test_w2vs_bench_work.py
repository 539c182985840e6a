"""The yardstick's arithmetic on hand-made shapes and intervals, and the
per-layer readers on a hand-made slice."""

import pytest

from w2vs_bench import harness, work
from w2vs_bench.trace import Slice, breakdown


def test_busy_union_and_gaps():
    iv = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert work.busy_us(iv) == 12 + 10 + 1
    assert work.gaps(iv) == [(12, 20), (30, 40)]
    assert work.busy_us([]) == 0.0


def test_bound_takes_the_larger_side():
    assert work.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert work.bound_s(1.0, 989e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


@pytest.mark.parametrize("T", [16, 37, 100, 488, 729])
def test_block_pairs_equal_the_programs_mask_after_padding(T):
    """The program's block layout, its key padding applied, allows exactly
    the pairs ``block_pairs`` counts."""
    import torch

    from wav2vec_s_tpu_torch.ops.block_mask import (
        block_layout, extend_padding_mask)

    lay = block_layout(T, 16, 8)
    pad = extend_padding_mask(torch.zeros(1, T, dtype=torch.bool), lay)[0]
    allowed = lay.allowed & ~pad.numpy()[None, :]
    assert allowed.sum() == work.block_pairs(T, 16, 8)
    assert lay.rc_len == work.copy_rows(T, 16, 8)


@pytest.mark.parametrize("blocks", [1, 2, 10])
def test_chunk_pairs_equal_the_programs_intra_chunk_bias(blocks):
    from wav2vec_s_tpu_torch.stream.incremental import chunk_layout

    _, bias = chunk_layout(16, 8, blocks)
    assert (bias == 0).sum() == work.chunk_pairs(0, 16, 8, blocks)
    R = blocks * 24
    assert work.chunk_pairs(96, 16, 8, blocks) == R * 96 + (bias == 0).sum()


def test_k1_and_k2_work_by_hand():
    b, f = work.k1_call(B=2, R=3, t0=5, D=4, intra_pairs=7)
    assert b == 2 * 2 * 4 * (4 * 3 + 2 * 5) + 4 * 9
    assert f == 4 * 4 * 2 * (3 * 5 + 7)
    b, f = work.k2_call(B=2, S=6, D=4, pairs=11)
    assert (b, f) == (2 * 4 * 2 * 6 * 4 + 12, 4 * 2 * 4 * 11)


def test_conv_flops_and_receptive_field():
    convs = [[512, 10, 5], [512, 3, 2], [512, 3, 2], [512, 3, 2],
             [512, 3, 2], [512, 2, 2], [512, 2, 2]]
    assert work.receptive(convs) == (400, 320)
    n = 400 + 320 * 9                      # ten frames
    t1 = (n - 10) // 5 + 1
    assert work.conv_flops(n, convs[:1]) == 2 * t1 * 512 * 10
    t = n
    for _, k, s in convs:
        t = (t - k) // s + 1
    assert t == 10


def _slice(kernels, wall, **work_):
    return Slice(kernels, [("decode_corpus", 0.0, 1e6)], [], wall, work_)


def test_readers_on_a_hand_made_slice():
    k1 = work.k1_call(128, 48, 256, 768, work.chunk_pairs(0, 16, 8, 2))
    bound = work.bound_s(*k1)
    sl = _slice([("void chunk_attention_mma_kernel<4>", 0.0, 2 * bound * 1e6),
                 ("gemm", 2 * bound * 1e6, 4 * bound * 1e6)],
                wall=10 * bound, audio_s=2.0, k1_calls=[k1],
                model_flops=989e12 * bound)
    read = {m: harness.metric_reader(m) for m in (
        "k1_roofline.decode", "k2_roofline.decode", "mfu.decode",
        "device_idle.decode", "kernels_per_audio_s.decode")}
    assert read["k1_roofline.decode"](sl) == pytest.approx(50.0)
    assert read["k2_roofline.decode"](sl) is None          # no K2 ran
    assert read["mfu.decode"](sl) == pytest.approx(10.0)
    assert read["device_idle.decode"](sl) == pytest.approx(60.0)
    assert read["kernels_per_audio_s.decode"](sl) == 1.0
    empty = _slice([], wall=1.0, audio_s=2.0)
    assert all(r(empty) is None for r in read.values())


def test_breakdown_names_ops_and_idle_by_span():
    sl = Slice([("a", 0, 10), ("b", 20, 21), ("a", 30, 40)],
               [("step", 0, 25), ("push", 25, 35)],
               [("aten::item", 12, 19)], 50e-6, {})
    bd = breakdown(sl)
    assert bd["device_ops"][0] == ["a", pytest.approx(20e-6)]
    assert dict((k, v) for k, v in bd["idle_gaps"]) == {
        "step / aten::item": pytest.approx(10e-6),
        "push / python": pytest.approx(9e-6)}


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_loaded(["wav2vec_s_tpu_torch.ops",
                                     "jaxtyping", "flaxen.x"]) == []
    assert harness.forbidden_loaded(["wav2vec_s_tpu.models", "jax.numpy",
                                     "optax"]) == ["jax", "optax",
                                                    "wav2vec_s_tpu"]


TINY_SIZES = {
    "w2v": {"main_context": 2, "right_context": 1,
            "conv_feature_layers": [[4, 2, 2]], "encoder_embed_dim": 4,
            "encoder_ffn_embed_dim": 8, "encoder_layers": 1},
    "caat": {"jointer_embed_dim": 4, "jointer_ffn_embed_dim": 8,
             "jointer_layers": 1, "vocab_size": 10, "decoder_embed_dim": 4,
             "decoder_ffn_embed_dim": 8, "decoder_layers": 1}}
TINY_MIX = {"blocks_per_step": 1, "max_emit_per_chunk": 2, "max_len": 5}


def test_a_chunks_model_flops_by_hand():
    """Chunk 1 of a stream, one token after one: conv 32, encoder rows
    3 x 256 and 15 allowed pairs x 16, jointer K/V 128, two decisions over
    4 visible frames 2 x 336, one LM step 304."""
    from w2vs_bench import served as sv

    f = sv.chunk_flops(TINY_SIZES, TINY_MIX, c=1, last=False, k=1, before=1)
    assert f == 32 + (3 * 256 + 16 * 15) + 128 + 2 * 336 + 304


def test_one_flop_count_feeds_both_mfu_readers():
    """A decoded stream's model FLOPs (``mfu.decode``) are the sum of the
    per-chunk count the serving driver takes for each chunk it steps
    (``mfu.serve``), with each chunk's tokens and the tokens before."""
    from w2vs_bench import served as sv

    s = sv.Served("s", 0, 3, [5, 6, 7, 8], [0, 1, 1, 2])
    per = [sv.chunk_flops(TINY_SIZES, TINY_MIX, c, c == 2, k, before)
           for c, k, before in ((0, 1, 0), (1, 2, 1), (2, 1, 3))]
    assert sv.decode_flops(s, TINY_SIZES, TINY_MIX) == sum(per)
