"""The port's plain banded solve against JAX's at half-bandwidths past
64 (on the card the dynamic-width kernel's, which the general-width
kernel also takes when forced): ``test_torch_wide_band.py``'s
``plain_matches_jax`` at bw 65 and 100, in a file of its own so that the
two JAX compiles (~15 and ~35 s on a desktop-class CPU) run beside that
file's rather than after them.
"""

import pytest

from .test_torch_wide_band import plain_matches_jax


@pytest.mark.parametrize("bw", [65, 100])
def test_plain_general_band_matches_jax(bw):
    plain_matches_jax(bw)
