"""``FusedOneShotBeamDecoder`` on the int16 wire (16-bit PCM staged,
converted on the device): the port's texts and delays EQUAL the JAX
decoder's, dense and flash attention, one and two blocks per step.
"""

import pytest

from tests.test_torch_port_beam_decoders import assert_equal_to_jax


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_texts_and_delays_equal_jax_int16(impl, blocks):
    assert_equal_to_jax("FusedOneShotBeamDecoder", impl, blocks, "int16")
