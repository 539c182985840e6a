"""CachedFusedGreedyDecoder over the int16 wire format (16-bit PCM clipped
on the host, /32768 on the device): the port's texts and delays EQUAL the
JAX decoder's.  Setup in test_torch_port_greedy.py."""

import pytest

from tests.test_torch_port_greedy import decode_both


@pytest.mark.parametrize("blocks", [1, 2])
def test_int16_texts_and_delays_equal_jax(blocks):
    (want_t, want_d), (got_t, got_d) = decode_both(blocks, "int16")
    assert got_t == want_t
    assert got_d == want_d
    assert any(got_t)
