"""The port's relight forward with the seed grid against the JAX package's
(set-up in ``relight_setup.py``): step 25,000 in ``uniform_light``, both
given one JAX-baked seed grid (carried across by
``weights.seed_grid_from_jax``).  With ``baked_secondary_coarse`` the
secondary coarse pass is one compacted gather of the grid and the fine pass
polishes the raw grid roots for ``seed_grid_polish_iters``; without it the
coarse pass is queried, seeded from the grid."""

import types

import jax
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


GRID_RES = 16        # seed-grid resolution (96 in serving)


@pytest.fixture(scope="module")
def setup():
    s = RS.make_setup()
    s["jgrid"] = s["jm"].bake_seed_grid(
        s["jp"], s["system"].statics, s["jframe"], s["jcond"], RS.STEP,
        resolution=GRID_RES, chunk=GRID_RES ** 3)
    return s


@pytest.mark.parametrize("baked", [True, False])
def test_relight_forward_with_grid_matches_jax(setup, baked):
    s = setup
    s["jm"].config["baked_secondary_coarse"] = baked
    s["model"].config["baked_secondary_coarse"] = baked
    system = types.SimpleNamespace(model=s["jm"], statics=s["system"].statics)
    to = RS.check_mode(s, "uniform_light", jgrid=s["jgrid"], system=system)
    # the grid path: no search runs in the forward
    assert "ovf_candidates" not in to["counters"]
    assert "sec_seed_polish_fail" in to["counters"]
