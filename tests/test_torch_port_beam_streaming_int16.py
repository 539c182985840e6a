"""The streaming beam decoders on the int16 wire: the port's texts and
delays EQUAL the JAX decoders'.  The fused decoder stages 16-bit PCM and
converts on the device; the unfused one takes host float32 whatever the
wire setting (as in the JAX package), which one case pins.
"""

import pytest

from tests.test_torch_port_beam_decoders import assert_equal_to_jax


@pytest.mark.parametrize("name,blocks", [
    ("FusedBeamStreamingDecoder", 1), ("FusedBeamStreamingDecoder", 2),
    ("BatchedBeamStreamingDecoder", 2)])
def test_texts_and_delays_equal_jax_int16(name, blocks):
    assert_equal_to_jax(name, "dense", blocks, "int16")
