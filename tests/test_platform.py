"""Guard: the test session must run on the 8-virtual-device CPU backend
(never on an accelerator) — see conftest.py."""

import jax


def test_platform():
    devs = jax.devices()
    assert devs[0].platform == "cpu", devs
    assert len(devs) == 8, devs
