"""SMPL body model (counterpart of the JAX package's ``anim/smpl.py``):
an official model file's loader, the synthetic SMPL-topology body, the
kinematic chain and the SMPL forward.

The body model is host numpy; :func:`smpl_forward` takes torch tensors and
runs on their device.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import NamedTuple

import numpy as np
import torch

from intrinsicavatar_tpu_torch.ops.math import rodrigues, transform_mat

NUM_JOINTS = 24
# SMPL kinematic tree (parent of each joint).
PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21], dtype=np.int32,
)


@dataclasses.dataclass(frozen=True)
class BodyModel:
    """Static SMPL model arrays (host numpy)."""

    v_template: np.ndarray    # [V, 3]
    shapedirs: np.ndarray     # [V, 3, n_betas]
    posedirs: np.ndarray      # [(J-1)*9, V*3] or [0, V*3]
    j_regressor: np.ndarray   # [24, V]
    lbs_weights: np.ndarray   # [V, 24]
    parents: np.ndarray       # [24]
    faces: np.ndarray         # [F, 3] int


class SmplOutput(NamedTuple):
    vertices: torch.Tensor    # [1, V, 3]
    joints: torch.Tensor      # [1, 24, 3]
    A: torch.Tensor           # [1, 24, 4, 4] rest->posed per-joint transforms


def load_body_model(path: str, gender: str = "neutral") -> BodyModel:
    """An official SMPL model file (``.pkl``, read as latin-1 pickle, or
    ``.npz``): sparse arrays densified, the first 10 shape directions,
    ``posedirs [V, 3, 207]`` as ``[207, V * 3]`` (the JAX package's
    ``load_body_model``; ``gender`` names the file's body, which the path
    already selects)."""
    if path.endswith(".npz"):
        d = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="latin1")

    def arr(x):
        if hasattr(x, "todense"):
            x = np.asarray(x.todense())
        return np.asarray(x, np.float32)

    posedirs = arr(d["posedirs"])
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T \
        if posedirs.ndim == 3 else posedirs
    return BodyModel(
        v_template=arr(d["v_template"]),
        shapedirs=arr(d["shapedirs"])[..., :10],
        posedirs=np.ascontiguousarray(posedirs, np.float32),
        j_regressor=arr(d["J_regressor"]),
        lbs_weights=arr(d["weights"]),
        parents=PARENTS,
        faces=np.asarray(d["f"], np.int64) if "f" in d
        else np.zeros((0, 3), np.int64),
    )


def make_synthetic_body_model(n_surface_verts: int = 2000,
                              seed: int = 0) -> BodyModel:
    """A stand-in articulated body with SMPL topology (same numpy draws as
    the JAX package's, so both packages build the same body)."""
    rng = np.random.default_rng(seed)
    J = np.zeros((24, 3), np.float32)
    J[0] = [0.0, 0.0, 0.0]          # pelvis
    J[1] = [0.08, -0.08, 0.0]       # L hip
    J[2] = [-0.08, -0.08, 0.0]      # R hip
    J[3] = [0.0, 0.12, 0.0]         # spine1
    J[4] = [0.09, -0.48, 0.0]       # L knee
    J[5] = [-0.09, -0.48, 0.0]      # R knee
    J[6] = [0.0, 0.25, 0.0]         # spine2
    J[7] = [0.09, -0.88, 0.0]       # L ankle
    J[8] = [-0.09, -0.88, 0.0]      # R ankle
    J[9] = [0.0, 0.38, 0.0]         # spine3
    J[10] = [0.11, -0.95, 0.10]     # L foot
    J[11] = [-0.11, -0.95, 0.10]    # R foot
    J[12] = [0.0, 0.52, 0.0]        # neck
    J[13] = [0.08, 0.45, 0.0]       # L collar
    J[14] = [-0.08, 0.45, 0.0]      # R collar
    J[15] = [0.0, 0.62, 0.02]       # head
    J[16] = [0.18, 0.45, 0.0]       # L shoulder
    J[17] = [-0.18, 0.45, 0.0]      # R shoulder
    J[18] = [0.44, 0.44, 0.0]       # L elbow
    J[19] = [-0.44, 0.44, 0.0]      # R elbow
    J[20] = [0.68, 0.43, 0.0]       # L wrist
    J[21] = [-0.68, 0.43, 0.0]      # R wrist
    J[22] = [0.76, 0.43, 0.0]       # L hand
    J[23] = [-0.76, 0.43, 0.0]      # R hand

    radii = np.full(24, 0.06, np.float32)
    radii[[0, 3, 6, 9]] = 0.12      # torso
    radii[15] = 0.09                # head
    radii[[22, 23]] = 0.035

    verts, weights = [], []
    bones = [(j, PARENTS[j]) for j in range(1, 24)]
    per_bone = n_surface_verts // len(bones)
    for j, p in bones:
        t = rng.uniform(0, 1, (per_bone, 1)).astype(np.float32)
        axis = J[j] - J[p]
        center = J[p] + t * axis
        r = radii[j]
        d = rng.normal(size=(per_bone, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        verts.append(center + d * r)
        w = np.zeros((per_bone, 24), np.float32)
        w[:, j] = t[:, 0]
        w[:, p] = 1.0 - t[:, 0]
        weights.append(w)
    verts = np.concatenate(verts)
    weights = np.concatenate(weights)

    # joint markers (exact regressor targets) with delta weights
    verts = np.concatenate([verts, J])
    weights = np.concatenate([weights, np.eye(24, dtype=np.float32)])
    V = verts.shape[0]
    j_reg = np.zeros((24, V), np.float32)
    j_reg[:, -24:] = np.eye(24, dtype=np.float32)
    shapedirs = rng.normal(scale=0.002, size=(V, 3, 10)).astype(np.float32)
    return BodyModel(
        v_template=verts.astype(np.float32),
        shapedirs=shapedirs,
        posedirs=np.zeros((23 * 9, V * 3), np.float32),
        j_regressor=j_reg,
        lbs_weights=weights,
        parents=PARENTS,
        faces=np.zeros((0, 3), np.int64),
    )


def batch_rigid_transform(rot_mats, joints, parents: np.ndarray):
    """Kinematic-chain global transforms: posed joints and the per-joint
    rest->posed transforms ``A_j = G_j - pad(G_j @ [J_rest_j; 0])``."""
    par = torch.as_tensor(np.maximum(parents, 0), device=joints.device)
    has_parent = torch.as_tensor(parents >= 0, device=joints.device)
    rel_joints = joints - torch.where(has_parent[:, None], joints[par], 0.0)
    local = transform_mat(rot_mats, rel_joints)
    chains = [local[0]]
    for j in range(1, NUM_JOINTS):
        chains.append(chains[int(parents[j])] @ local[j])
    G = torch.stack(chains)
    posed_joints = G[:, :3, 3]
    corr = torch.einsum("jab,jb->ja", G[:, :3, :3], joints)
    A = G.clone()
    A[:, :3, 3] = A[:, :3, 3] - corr
    return posed_joints, A


def smpl_forward(model: BodyModel, betas, body_pose, global_orient=None,
                 transl=None) -> SmplOutput:
    """Single-frame SMPL forward; pose inputs are axis-angle
    (``betas [10]``, ``body_pose [69]``, ``global_orient [3]``,
    ``transl [3]``)."""
    dev, dt = betas.device, betas.dtype
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    if global_orient is None:
        global_orient = torch.zeros(3, dtype=dt, device=dev)
    if transl is None:
        transl = torch.zeros(3, dtype=dt, device=dev)
    v_shaped = as_t(model.v_template) + torch.einsum(
        "vdb,b->vd", as_t(model.shapedirs), betas)
    joints_rest = as_t(model.j_regressor) @ v_shaped
    full_pose = torch.cat([global_orient, body_pose]).reshape(24, 3)
    rot_mats = rodrigues(full_pose)
    posedirs = as_t(model.posedirs)
    if posedirs.shape[0] > 0:
        eye = torch.eye(3, dtype=dt, device=dev)
        pose_feature = (rot_mats[1:] - eye).reshape(-1)
        v_posed = v_shaped + (pose_feature @ posedirs).reshape(-1, 3)
    else:
        v_posed = v_shaped
    posed_joints, A = batch_rigid_transform(rot_mats, joints_rest,
                                            model.parents)
    T = torch.einsum("vj,jab->vab", as_t(model.lbs_weights), A)
    verts = torch.einsum("vab,vb->va", T[:, :3, :3], v_posed) + T[:, :3, 3]
    verts = verts + transl
    posed_joints = posed_joints + transl
    A = A.clone()
    A[:, :3, 3] = A[:, :3, 3] + transl
    return SmplOutput(vertices=verts[None], joints=posed_joints[None],
                      A=A[None])


def get_predefined_rest_pose(cano_pose: str) -> np.ndarray:
    """Canonical rest poses (reference `snarf_deformer.py:9-21`)."""
    body_pose = np.zeros(69, np.float32)
    cano_pose = cano_pose.lower()
    if cano_pose == "da_pose":
        body_pose[2] = np.pi / 6
        body_pose[5] = -np.pi / 6
    elif cano_pose == "a_pose":
        body_pose[2] = 0.2
        body_pose[5] = -0.2
        body_pose[47] = -0.8
        body_pose[50] = 0.8
    else:
        raise ValueError(f"Unknown cano_pose: {cano_pose}")
    return body_pose


def get_bbox_from_verts(verts: np.ndarray, factor: float = 1.2) -> np.ndarray:
    """Cube bbox around vertices (reference `snarf_deformer.py:24-35`)."""
    v = np.asarray(verts).reshape(-1, 3)
    mn, mx = v.min(0), v.max(0)
    c = (mn + mx) / 2
    s = (mx - mn).max() / 2 * factor
    return np.stack([c - s, c + s]).astype(np.float32)
