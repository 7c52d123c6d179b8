"""Every key and shape of the JAX parameter tree lands in the port
(``intrinsicavatar_tpu_torch.weights.from_jax_params``), the port's own
``init`` gives the same parameter set, and ``weights.jax_init`` draws the
JAX package's init from the same seed."""

import jax
import numpy as np
import pytest
import torch

from intrinsicavatar_tpu.render.renderer import IntrinsicAvatar as JModel
from intrinsicavatar_tpu.utils.config import merge as jmerge
from intrinsicavatar_tpu.utils.default_config import tiny_config as jtiny
from intrinsicavatar_tpu_torch.render.renderer import IntrinsicAvatar
from intrinsicavatar_tpu_torch.utils.config import merge
from intrinsicavatar_tpu_torch.utils.default_config import tiny_config
from intrinsicavatar_tpu_torch.weights import flatten_tree, from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs six test workers on one host: keep each worker's torch
    pool small so it does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


OVERRIDES = {"model": {"primary_dtype": "float32", "eval_seed_grid": False}}


@pytest.fixture(scope="module")
def trees():
    jm = JModel(jmerge(jtiny(), OVERRIDES).model)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jp, merge(tiny_config(), OVERRIDES)


def test_every_leaf_lands(trees):
    jp, cfg = trees
    model = IntrinsicAvatar(cfg.model)
    landed = from_jax_params(model, jp)
    flat = flatten_tree(jp)
    assert set(landed) == set(flat)
    state = model.state_dict()
    for key, arr in flat.items():
        np.testing.assert_array_equal(state[landed[key]].numpy(), arr, key)
    # every parameter of the port came from the tree
    assert set(state) <= set(landed.values())
    assert {"geometry", "radiance", "density", "deformer", "pose_encoder",
            "pose_correction", "material", "emitter"} <= set(jp)


def test_own_init_has_the_same_parameters(trees):
    jp, cfg = trees
    model = IntrinsicAvatar(cfg.model).init(torch.Generator().manual_seed(0))
    state = model.state_dict()
    flat = {k: v for k, v in flatten_tree(jp).items()
            if k.split(".")[0] in ("geometry", "radiance", "density",
                                   "material", "emitter")}
    for key, arr in flat.items():
        t = state[key.replace(".mlp.", ".mlp.layers.")]
        assert tuple(t.shape) == arr.shape, key
    table = state["geometry.table"].numpy()
    assert np.abs(table).max() <= 1e-4 and table.std() > 1e-5
    assert float(state["density.beta"]) == float(jp["density"]["beta"])
    # the SG emitter's Fibonacci axes and sharpness are not random
    np.testing.assert_allclose(state["emitter.axes"].numpy(),
                               jp["emitter"]["axes"], atol=1e-6)
    np.testing.assert_allclose(state["emitter.sharpness"].numpy(),
                               jp["emitter"]["sharpness"], rtol=1e-6)
    # the Lipschitz bound is twice the largest absolute column sum
    w = state["material.mlp.layers.0.w"]
    assert float(state["material.mlp.layers.0.c"]) == pytest.approx(
        2.0 * float(torch.abs(w).sum(0).max()))


def test_jax_init_draws_the_jax_packages_init(trees):
    """``jax_init(model, 0)`` is the JAX package's ``init(PRNGKey(0))``:
    every uniform draw (hash tables, the radiance and material layers, the
    emitter) bit for bit, the sphere-initialized SDF layers (normal draws
    through XLA's erf_inv) and the sums over them (weight norms, Lipschitz
    bounds) within 2e-7 of each leaf's largest entry."""
    from intrinsicavatar_tpu_torch.weights import jax_init
    jp, cfg = trees
    model = IntrinsicAvatar(cfg.model)
    got = flatten_tree(jax_init(model, 0))
    ref = flatten_tree(jp)
    assert set(got) == set(ref)
    state = model.state_dict()
    for key, arr in ref.items():
        np.testing.assert_array_equal(
            state[key.replace(".mlp.", ".mlp.layers.")].numpy(), got[key])
        if key.startswith("geometry.mlp.") or key.endswith(".c"):
            np.testing.assert_allclose(got[key], arr, rtol=0,
                                       atol=2e-7 * np.abs(arr).max(),
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], arr, err_msg=key)


def test_missing_leaf_is_refused(trees):
    jp, cfg = trees
    model = IntrinsicAvatar(cfg.model)
    bad = {**jp, "geometry": {"table": jp["geometry"]["table"]}}
    with pytest.raises(KeyError):
        from_jax_params(model, bad)


def test_launcher_params_npz_round_trip(trees, tmp_path):
    """``launch --params`` reads the tree flattened to dotted keys."""
    from intrinsicavatar_tpu_torch.weights import unflatten
    jp, cfg = trees
    path = tmp_path / "params.npz"
    np.savez(path, **flatten_tree(jp))
    tree = unflatten(dict(np.load(path)))
    assert isinstance(tree["geometry"]["mlp"], list)
    model = IntrinsicAvatar(cfg.model)
    assert set(from_jax_params(model, tree)) == set(flatten_tree(jp))


def test_launcher_names_the_later_slice(capsys, monkeypatch):
    """``--mode test`` renders the relight maps on the card, so without one
    it stops at the device, before it reads a frame.  (The name is kept:
    the launcher said here that the mesh export and the env-map dump came
    with a later slice; they are ported, ``test_torch_eval_outputs.py``
    holds them to JAX and ``test_torch_real_data.py`` runs them through
    the launcher, and the notice is gone.)"""
    from intrinsicavatar_tpu_torch.launch import main
    from intrinsicavatar_tpu_torch.train import evaluate as TE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda|CUDA|card"):
        main(["--mode", "test"])
    assert "later slice" not in capsys.readouterr().err
    assert callable(TE.export_canonical_mesh) and callable(TE.dump_envmap)
