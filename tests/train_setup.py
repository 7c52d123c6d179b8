"""Shared set-up of the pose-correction and phys-regime training parity
tests (``test_torch_train_pose.py``, ``test_torch_train_phys.py``): the JAX
and port systems from one tiny config and parameter tree, the draws of the
JAX key path for the port, one JAX train step's losses, gradients and
updated parameters from one jitted function (the step is traced, so steps
that share their flags share a compile), and leaf-by-leaf comparisons."""

import jax
import jax.numpy as jnp
import numpy as np

from intrinsicavatar_tpu.ops.math import linear_to_srgb as j_srgb
from intrinsicavatar_tpu.train.system import IntrinsicAvatarSystem as JSystem
from intrinsicavatar_tpu.utils.config import merge as jmerge
from intrinsicavatar_tpu.utils.default_config import tiny_config as jtiny
from intrinsicavatar_tpu_torch.data.synthetic import SyntheticDataset
from intrinsicavatar_tpu_torch.train.system import IntrinsicAvatarSystem
from intrinsicavatar_tpu_torch.utils.config import merge
from intrinsicavatar_tpu_torch.utils.default_config import tiny_config
from intrinsicavatar_tpu_torch.weights import flatten_tree

RES = 16             # the tiny config's occupancy grid
BASE = {"model": {"primary_dtype": "float32",
                  "secondary_coarse_dtype": "float32",
                  "eval_seed_grid": False,
                  "pose_correction": {"enable_pose_correction": True}},
        "dataset": {"name": "synthetic", "n_rays": 64, "n_frames": 2}}


def deep_merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = deep_merge(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


def port_config(overrides):
    """The port's tiny config with ``BASE`` and ``overrides``."""
    return merge(tiny_config(), deep_merge(BASE, overrides))


def make_systems(overrides, step, seed=0, frame=0):
    """``(jax system, its state at ``step``, numpy tree, port config,
    batch of the synthetic training frame ``frame``, t_idx)``.  The tree
    carries noise on the SDF MLP's rows of the hash features and on the
    geometry table (as ``test_torch_train.py``): the geometry table then
    has a gradient from the first step."""
    jcfg = jmerge(jtiny(), deep_merge(BASE, overrides))
    cfg = port_config(overrides)
    jsys = JSystem(jcfg)
    state = jsys.setup(np.zeros(10), jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.array, state.params)
    rng = np.random.default_rng(seed)
    v = tree["geometry"]["mlp"][0]["v"]
    v[3:] += rng.normal(scale=0.05, size=v[3:].shape).astype(np.float32)
    tree["geometry"]["table"] += rng.uniform(
        -0.02, 0.02, tree["geometry"]["table"].shape).astype(np.float32)
    state = state._replace(params=jax.tree.map(jnp.asarray, tree),
                           step=jnp.asarray(step, jnp.int32))
    batch = SyntheticDataset(cfg.dataset)[frame]
    t_idx = batch.pop("t_idx")
    return jsys, state, tree, cfg, batch, t_idx


def port_system(cfg, tree, step):
    sys_ = IntrinsicAvatarSystem(cfg, "cpu")
    sys_.setup(np.zeros(10), tree)
    sys_.step = step
    return sys_


class JaxDraws:
    """The draws of the JAX system's key path from ``state.rng``: the
    occupancy update splits first (`train/system.py:555`), then each step
    ``rng, k_bg, k_fwd = split(rng, 3)`` (`:324`), ``k_strat, k_lap, k_jit,
    k_pbr = split(k_fwd, 4)`` (`render/renderer.py:508`), ``k_sub, k_lap =
    split(k_lap)`` (`:639`), ``k_jsub, k_jit = split(k_jit)`` on the
    compacted path (`:700`), and ``k_dirs, k_scatter, _ = split(k_pbr, 3)``
    (`render/pbr.py:437`) with the sphere's ``k1, k2 = split(k_dirs)``.
    ``nq_of(step)`` gives the step's shading lanes and whether they are
    compacted; ``phys(step)`` whether the PBR stage runs."""

    def __init__(self, rng, n_rays, nq_of, phys, spp):
        self.rng, self.R = rng, n_rays
        self.nq_of, self.phys, self.spp = nq_of, phys, spp

    def __call__(self, step, occ=None):
        """The draws of ``step`` (an occupancy update's first where ``occ``,
        by default where ``step`` is a multiple of 20)."""
        d = {}
        if (step % 20 == 0) if occ is None else occ:
            self.rng, k_occ = jax.random.split(self.rng)
            d["occ_u"] = np.asarray(jax.random.uniform(k_occ,
                                                       (RES ** 3, 1, 3)))
        self.rng, k_bg, k_fwd = jax.random.split(self.rng, 3)
        d.update(forward_draws(k_fwd, self.R, *self.nq_of(step),
                               self.phys(step), self.spp))
        d["bg"] = np.asarray(jax.random.uniform(k_bg, (3,)))
        return d


def forward_draws(k_fwd, R, nq, compact, phys, spp):
    """The draws of the forward of ``R`` rays from its key ``k_fwd``, with
    ``nq`` shading lanes (``compact``: on the compacted path) and, with
    ``phys``, the PBR stage's at ``spp`` scattering points; ``k_fwd`` kept
    under its name."""
    k_strat, k_lap, k_jit, k_pbr = jax.random.split(k_fwd, 4)
    k_sub, k_lap = jax.random.split(k_lap)
    nsub = min(max(int(np.ceil(nq * 0.25 / 128.0)) * 128, 128), nq)
    d = dict(strat_u=jax.random.uniform(k_strat, (R,)),
             lap_sub=jax.random.randint(k_sub, (nsub,), 0, nq),
             lap_u=jax.random.uniform(k_lap, (nsub, 3)))
    if phys:
        if compact:
            k_jsub, k_jit = jax.random.split(k_jit)
            d["jit_sub"] = jax.random.randint(k_jsub, (nsub,), 0, nq)
            d["jit_noise"] = jax.random.normal(k_jit, (nsub, 3))
        else:
            d["jit_noise"] = jax.random.normal(k_jit, (nq, 3))
        k_dirs, k_scatter, _ = jax.random.split(k_pbr, 3)
        n1 = max(spp // 32, 1)
        k1, k2 = jax.random.split(k_dirs)
        d["sphere_u"] = np.stack([
            np.asarray(jax.random.uniform(k1, (n1, spp // n1))),
            np.asarray(jax.random.uniform(k2, (n1, spp // n1)))])
        d["strata_u"] = jax.random.uniform(k_scatter, (R, spp))
    d = {k: np.asarray(v) for k, v in d.items()}
    d["k_fwd"] = k_fwd
    return d


def shading_lanes(cfg, flags, n_rays):
    """``(lanes, compacted)`` of the shading pass of a step with ``flags``
    (the renderer's budget rule, no budget boost)."""
    m = cfg.model
    S = int(m.num_samples_per_ray) + (
        int(m.get("n_importance_rounds", 2)) * int(m.n_importance_samples)
        if flags.importance_sample else 0)
    full = n_rays * S
    if flags.full_budget or full < 4096:
        return full, False
    frac = float(m.get("query_compaction", 0.5)) + 0.0625
    return min(max(int(np.ceil(full * frac / 128.0)) * 128, 128), full), True


def make_grad_fn(jsys, flags):
    """The body of the JAX ``train_step_impl`` (`train/system.py:324-355`)
    as one jitted function of ``(params, occ, batch, t_idx, step, k_fwd,
    bg, intervals[, seed_grid])``: ``(losses, grads)``."""

    @jax.jit
    def fn(params, occ, jb, t_idx, step, k_fwd, bg, intervals,
           seed_grid=None):
        fg = jb["alpha"][..., None]
        jb = {**jb, "rgb_wo_mask": jb["rgb"],
              "rgb": jb["rgb"] * fg + j_srgb(bg)[None, :] * (1.0 - fg)}

        def loss_fn(p):
            frame, cond = jsys.model.prepare(p, jsys.statics, jb, step)
            out = jsys.model.forward(
                p, jsys.statics, frame, cond, occ, jb["rays"], k_fwd, step,
                flags, t_idx=t_idx, background_color=bg,
                intervals=intervals, seed_grid=seed_grid)
            return jsys.compute_losses(p, out, jb, step, flags)

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        return losses, grads

    return fn


def jax_step(jsys, grad_fn, state, jb, t_idx, draws, flags, sampled=None):
    """One JAX train step from ``state``: ``(losses, grads, new state)``,
    the sampling stage's counters folded into the losses.  ``sampled``
    is the sampling stage's output (``jsys.sample_step``'s: intervals,
    counters and the step's seed grid), run here when None."""
    if sampled is None:
        sampled = jsys.sample_step(state, jb, t_idx, flags)
    intervals, s_counters, seed_grid = sampled
    losses, grads = grad_fn(state.params, state.occ, jb, t_idx, state.step,
                            draws["k_fwd"], jnp.asarray(draws["bg"]),
                            intervals, seed_grid)
    losses = dict(losses)
    for k, v in s_counters.items():
        losses[k] = losses[k] + v if k in losses else v
    # under jit: op by op, the first update compiles each leaf's ops
    updates, opt_state = jax.jit(jsys.tx.update)(grads, state.opt_state,
                                                 state.params)
    params = jax.tree.map(lambda p, u: p + u, state.params, updates)
    rng = jax.random.split(state.rng, 3)[0]
    return losses, grads, state._replace(params=params, opt_state=opt_state,
                                         step=state.step + 1, rng=rng)


def leaf_errors(port_tree, jax_tree):
    """``{leaf: (|port - jax|, |jax|)}`` over every leaf of the JAX tree."""
    a, b = flatten_tree(port_tree), flatten_tree(jax.tree.map(np.asarray,
                                                              jax_tree))
    assert set(a) == set(b)
    return {k: (float(np.linalg.norm(a[k] - b[k])),
                float(np.linalg.norm(b[k]))) for k in b}


def assert_tree_close(port_tree, jax_tree, rtol, atol=0.0, what="",
                      rtols=None):
    """Each leaf within ``rtol`` (or ``rtols[leaf]``) of its norm plus
    ``atol`` per entry."""
    b = flatten_tree(jax.tree.map(np.asarray, jax_tree))
    for k, (err, ref) in leaf_errors(port_tree, jax_tree).items():
        tol = (rtols or {}).get(k, rtol)
        assert err <= tol * ref + atol * np.sqrt(b[k].size) + 1e-30, (
            what, k, err, ref)
