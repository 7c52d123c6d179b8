"""The relight forward against the JAX package in the ``mis`` render mode
(emitter and BRDF samples combined with MIS weights); set-up and comparison
in ``relight_setup.py``, the other modes in ``test_torch_relight.py`` and
``test_torch_relight_sampled.py``."""

import pytest
import torch

import relight_setup as RS


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return RS.make_setup()


@pytest.mark.parametrize("mode", ["mis"])
def test_relight_forward_matches_jax(setup, mode):
    RS.check_mode(setup, mode)
