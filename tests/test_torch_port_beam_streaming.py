"""The streaming beam decoders (incremental encoder): the port's texts and
delays EQUAL the JAX decoders', float32 wire, one and two blocks per step,
on a mixed-length corpus (int16 wire in
test_torch_port_beam_streaming_int16.py).  ``BatchedBeamStreamingDecoder``
reads the pool back every chunk, ``FusedBeamStreamingDecoder`` re-seeds on
the device and carries the LM prefix cache.  Each case also holds that
every kept hypothesis led the next one by more than 1e-4 (see
``test_torch_port_beam_decoders.assert_equal_to_jax``).
"""

import pytest

from tests.test_torch_port_beam_decoders import assert_equal_to_jax


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("name", ["BatchedBeamStreamingDecoder",
                                  "FusedBeamStreamingDecoder"])
def test_texts_and_delays_equal_jax(name, blocks):
    assert_equal_to_jax(name, "dense", blocks, "float32")
