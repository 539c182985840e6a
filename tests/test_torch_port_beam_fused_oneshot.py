"""``FusedOneShotBeamDecoder`` (one-shot encode, device-side re-seed, one
read at the end): the port's texts and delays EQUAL the JAX decoder's,
float32 wire, dense and flash attention in the encoder, one and two blocks
per step, on a mixed-length corpus (int16 wire in
test_torch_port_beam_fused_oneshot_int16.py).
"""

import pytest

from tests.test_torch_port_beam_decoders import assert_equal_to_jax


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_texts_and_delays_equal_jax(impl, blocks):
    assert_equal_to_jax("FusedOneShotBeamDecoder", impl, blocks, "float32")
