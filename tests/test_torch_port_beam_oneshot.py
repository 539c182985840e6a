"""``OneShotBeamDecoder`` (one-shot encode in sub-batches + interleaved
halves): the port's texts and delays EQUAL the JAX decoder's, dense and
flash attention in the encoder (the 32-wide, dh-8 encoder so that the JAX
side runs its Pallas kernel in interpret mode), one and two blocks per
step, on a mixed-length corpus; plus one case on the int16 wire setting,
which the unfused decoders ignore as in the JAX package.
"""

import pytest

from tests.test_torch_port_beam_decoders import assert_equal_to_jax


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_texts_and_delays_equal_jax(impl, blocks):
    assert_equal_to_jax("OneShotBeamDecoder", impl, blocks, "float32")


def test_texts_and_delays_equal_jax_int16_setting():
    assert_equal_to_jax("OneShotBeamDecoder", "flash", 2, "int16")
