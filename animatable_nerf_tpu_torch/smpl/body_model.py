"""SMPL body model math (numpy on the host; the LBS chain of core/).

JAX counterpart: animatable_nerf_tpu/smpl/body_model.py:1-526, kept as
its numpy with float64 accumulation. Where JAX calls its
core.skeleton `batch_rodrigues` and `rigid_transforms` (float32, on the
host here too), this module calls the port's core/skeleton.py
`batch_rodrigues` (on CPU tensors) and `rigid_transforms_host`, the
same float32 formulas.

The reference reads raw SMPL pickles and re-derives everything per tool
run (prepare_lbs_meta.py:107-134: shape blend shapes, J_regressor
joints, kinematic-chain transforms). This module packages that as a
model class. Pose blend shapes (posedirs) are supported but off by
default: the reference's prep path never applies them (vertices come
precomputed from EasyMocap), and `get_transform_params` ignores them.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from ..core import skeleton
from ..core.skeleton import rigid_transforms_host as rigid_transforms

N_BONES = 24


def batch_rodrigues(aa) -> np.ndarray:
    """Axis-angle (N, 3) -> (N, 3, 3) rotations in float32, the formula
    of core/skeleton.py `batch_rodrigues` (JAX's, with its `+ 1e-8`)."""
    aa = torch.as_tensor(np.asarray(aa, np.float32))
    return skeleton.batch_rodrigues(aa).numpy()


def _to_np(x):
    """Convert chumpy arrays / scipy sparse / lists to plain numpy."""
    if hasattr(x, "toarray"):  # scipy sparse (J_regressor)
        return np.asarray(x.toarray())
    if hasattr(x, "r"):  # chumpy
        return np.asarray(x.r)
    return np.asarray(x)


def load_smpl(path: str) -> dict:
    """Read a raw SMPL pickle (or .npz) into plain numpy arrays.

    Returns keys: v_template (V,3), shapedirs (V,3,S), posedirs
    (V,3,207) if present, J_regressor (24,V), weights (V,24),
    kintree_table (2,24+), f (faces).
    (prepare_lbs_meta.py:17-38 `read_pickle`/`read_smpl_file`.)
    """
    if path.endswith(".npz") or path.endswith(".npy"):
        raw = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            u = pickle._Unpickler(f)
            u.encoding = "latin1"
            raw = u.load()
    out = {}
    for k in ("v_template", "shapedirs", "posedirs", "J_regressor",
              "weights", "kintree_table", "f"):
        if k in raw:
            out[k] = _to_np(raw[k])
    return out


def big_pose_vector(n_joints: int = N_BONES, angle_deg: float = 30.0):
    """The canonical 'big pose': legs spread 30 degrees
    (prepare_lbs_meta.py:211-216, tpose_dataset.py:80-90). Valid for any
    joint count >= 3 (the spread rotations sit on joints 1 and 2 — SMPL-H
    pickles carry 52 joints, SMPL-X 55)."""
    big = np.zeros((n_joints, 3), np.float32)
    big[1, 2] = np.deg2rad(angle_deg)
    big[2, 2] = np.deg2rad(-angle_deg)
    return big


def barycentric_interpolation(val: np.ndarray, coords: np.ndarray):
    """val (N, 3, C) per-corner values, coords (N, 3) barycentric ->
    (N, C) (prepare_lbs_meta.py:41-49)."""
    t = val * coords[..., np.newaxis]
    return t.sum(axis=1)


class SMPLModel:
    """Host-side SMPL: shapes -> joints -> rigid transforms -> LBS.

    All arrays numpy; the rigid-transform chain is core/skeleton.py
    `rigid_transforms_host`, the data pipeline's.
    """

    def __init__(self, smpl: dict, n_bones: int | None = None):
        """n_bones: None derives the bone count from the pickle's
        kinematic tree — 24 for SMPL, 52 for SMPL-H, 55 for SMPL-X raw
        pickles (the reference vendors the full smplx package for
        offline prep, lib/utils/smplx/body_models.py; every runtime path
        here is joint-count-generic so the larger models load
        unchanged). Passing 24 keeps the first 24 kinematic-tree joints,
        which only APPROXIMATES the SMPL body skeleton for SMPL-H/X
        (their columns 22/23 are finger joints, not SMPL's hand joints);
        weights of dropped bones are renormalized away, with the sum
        clamped so hand-dominated vertices don't divide by ~0."""
        if n_bones is None:
            n_bones = min(
                np.asarray(smpl["kintree_table"]).shape[-1],
                np.asarray(smpl["weights"]).shape[-1],
            )
        self.v_template = np.asarray(smpl["v_template"], np.float64)
        self.shapedirs = np.asarray(smpl["shapedirs"], np.float64)
        self.J_regressor = np.asarray(smpl["J_regressor"], np.float64)
        w = np.asarray(smpl["weights"], np.float64)[:, :n_bones]
        self.weights = w / np.maximum(w.sum(axis=-1, keepdims=True), 1e-8)
        self.parents = np.asarray(smpl["kintree_table"])[0][:n_bones]
        self.parents = self.parents.copy()
        self.parents[0] = 0
        self.faces = np.asarray(smpl.get("f")) if "f" in smpl else None
        self.posedirs = (
            np.asarray(smpl["posedirs"], np.float64)
            if "posedirs" in smpl else None
        )
        self.n_bones = n_bones

    def shaped_vertices(self, betas: np.ndarray) -> np.ndarray:
        """v_template + shape blend shapes (prepare_lbs_meta.py:110-116)."""
        betas = np.asarray(betas, np.float64).reshape(-1)
        S = min(betas.shape[0], self.shapedirs.shape[-1])
        return self.v_template + np.einsum(
            "vcs,s->vc", self.shapedirs[..., :S], betas[:S]
        )

    def joints(self, v_shaped: np.ndarray) -> np.ndarray:
        """(24, 3) rest joints from the regressor
        (prepare_lbs_meta.py:121-122)."""
        return self.J_regressor.dot(v_shaped)[: self.n_bones]

    def transforms(self, poses: np.ndarray, joints: np.ndarray):
        """(24, 4, 4) bone transforms for axis-angle poses (24, 3)."""
        A = rigid_transforms(
            np.asarray(poses, np.float32).reshape(self.n_bones, 3),
            np.asarray(joints, np.float32),
            self.parents,
        )
        return np.asarray(A)

    def transform_params(self, params: dict):
        """EasyMocap-style params dict {poses (72,), shapes, Rh, Th} ->
        (A, R, Th, joints, parents, v_shaped)
        (prepare_lbs_meta.py:107-134)."""
        v_shaped = self.shaped_vertices(params["shapes"])
        joints = self.joints(v_shaped)
        poses = np.asarray(params["poses"], np.float64).reshape(-1, 3)
        A = self.transforms(poses[: self.n_bones], joints)
        Rh = np.asarray(params["Rh"]).reshape(-1)[:3]
        R = np.asarray(batch_rodrigues(Rh[None].astype(np.float32)))[0]
        Th = np.asarray(params["Th"]).reshape(1, 3)
        return A, R, Th, joints, self.parents, v_shaped

    def lbs(self, poses, betas=None, pose_blend: bool = False):
        """Forward LBS: posed vertices in SMPL coordinates.

        poses: (24, 3) axis-angle (root row included but global Rh/Th are
        applied separately, matching ZJU-MoCap conventions).
        """
        v = (
            self.shaped_vertices(betas)
            if betas is not None else self.v_template.copy()
        )
        joints = self.joints(v)
        if pose_blend and self.posedirs is not None:
            rot = np.asarray(
                batch_rodrigues(
                    np.asarray(poses, np.float32).reshape(-1, 3)[1:]
                )
            )
            feat = (rot - np.eye(3)).reshape(-1)
            v = v + np.einsum(
                "vcp,p->vc", self.posedirs[..., : feat.shape[0]], feat
            )
        A = self.transforms(poses, joints)
        blended = np.einsum("vb,bij->vij", self.weights, A)
        posed = (
            np.einsum("vij,vj->vi", blended[:, :3, :3], v)
            + blended[:, :3, 3]
        )
        return posed.astype(np.float32), joints, A

    def inverse_lbs(self, pverts: np.ndarray, A: np.ndarray):
        """Posed SMPL-space vertices -> canonical (T-pose), the tool's
        R_inv form (prepare_lbs_meta.py:165-169)."""
        blended = np.einsum("vb,bij->vij", self.weights, np.asarray(A, np.float64))
        can = pverts - blended[:, :3, 3]
        R_inv = np.linalg.inv(blended[:, :3, :3])
        return np.einsum("vij,vj->vi", R_inv, can).astype(np.float32)


# --------------------------------------------------------------- SMPL-X
# Full SMPL-X parameter surface: hand-PCA pose
# assembly + expression blend shapes + the 55-joint LBS, mirroring the
# reference's vendored smplx package (offline-only there — never
# imported by runtime code, SURVEY 2.7):
#   pose assembly   lib/utils/smplx/body_models.py:1295-1312 (SMPLX.forward)
#   lbs             lib/utils/smplx/lbs.py:152-248
#   rigid chain     lib/utils/smplx/lbs.py:345-401 (batch_rigid_transform)
# All numpy, f64 accumulation like the rest of this module.

SMPLX_NUM_BODY_JOINTS = 21
SMPLX_NUM_HAND_JOINTS = 15
SMPLX_SHAPE_SPACE_DIM = 300  # body_models.py:126 (expr dirs start here)
SMPLX_EXPRESSION_SPACE_DIM = 100  # body_models.py:990


def smplx_full_pose(
    global_orient,
    body_pose,
    jaw_pose=None,
    leye_pose=None,
    reye_pose=None,
    left_hand_pose=None,
    right_hand_pose=None,
    hands_componentsl=None,
    hands_componentsr=None,
    hands_meanl=None,
    hands_meanr=None,
    use_pca: bool = True,
    num_pca_comps: int = 6,
    flat_hand_mean: bool = False,
):
    """Assemble the (165,) SMPL-X axis-angle pose vector.

    Reproduces SMPLX.forward (body_models.py:1295-1312): hand PCA
    coefficients project through the first `num_pca_comps` rows of
    hands_components* (:695-696), the segments concatenate in SMPL-X
    joint order (global, 21 body, jaw, leye, reye, 15+15 hand joints),
    and the model's pose mean is added — which is zero everywhere
    except the hands when flat_hand_mean is False (:707-716)."""
    z3 = np.zeros(3, np.float64)

    def seg(x, n):
        return (np.zeros(n, np.float64) if x is None
                else np.asarray(x, np.float64).reshape(-1)[:n])

    if use_pca:
        lh = seg(left_hand_pose, num_pca_comps) @ np.asarray(
            hands_componentsl, np.float64)[:num_pca_comps]
        rh = seg(right_hand_pose, num_pca_comps) @ np.asarray(
            hands_componentsr, np.float64)[:num_pca_comps]
    else:
        lh = seg(left_hand_pose, 3 * SMPLX_NUM_HAND_JOINTS)
        rh = seg(right_hand_pose, 3 * SMPLX_NUM_HAND_JOINTS)

    full = np.concatenate([
        seg(global_orient, 3),
        seg(body_pose, 3 * SMPLX_NUM_BODY_JOINTS),
        seg(jaw_pose, 3), seg(leye_pose, 3), seg(reye_pose, 3),
        lh, rh,
    ])
    if not flat_hand_mean:
        mean = np.zeros_like(full)
        if hands_meanl is not None:
            mean[75:120] = np.asarray(hands_meanl, np.float64).reshape(-1)
        if hands_meanr is not None:
            mean[120:165] = np.asarray(hands_meanr, np.float64).reshape(-1)
        full = full + mean
    return full


# SMPL-X vertex indices of the OpenPose/MSCOCO extra keypoints (the
# standard public mapping shipped with every SMPL-X distribution;
# reference lib/utils/smplx/vertex_ids.py 'smplx' entry). Order below
# follows VertexJointSelector (vertex_joint_selector.py:38-68): 5 face
# keypoints, 6 feet keypoints, 10 finger tips (l then r hand).
SMPLX_VERTEX_IDS = {
    "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
    "LBigToe": 5770, "LSmallToe": 5780, "LHeel": 8846,
    "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
    "lthumb": 5361, "lindex": 4933, "lmiddle": 5058, "lring": 5169,
    "lpinky": 5286,
    "rthumb": 8079, "rindex": 7669, "rmiddle": 7794, "rring": 7905,
    "rpinky": 8022,
}


def extra_joint_ids(vertex_ids: dict, use_hands: bool = True,
                    use_feet_keypoints: bool = True) -> np.ndarray:
    """VertexJointSelector's extra-joint vertex index list
    (vertex_joint_selector.py:29-68): face keypoints, optional feet
    keypoints, optional finger tips (l-hand then r-hand)."""
    idxs = [vertex_ids[k] for k in ("nose", "reye", "leye", "rear", "lear")]
    if use_feet_keypoints:
        idxs += [vertex_ids[k] for k in (
            "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
        )]
    if use_hands:
        for hand in ("l", "r"):
            idxs += [
                vertex_ids[hand + tip]
                for tip in ("thumb", "index", "middle", "ring", "pinky")
            ]
    return np.asarray(idxs, np.int64)


def vertices2landmarks(vertices, faces, lmk_faces_idx, lmk_bary_coords):
    """Barycentric face landmarks (lbs.py:108-160): landmark l =
    sum_k bary[l,k] * vertices[faces[lmk_faces_idx[l], k]]."""
    faces = np.asarray(faces, np.int64)
    tri = np.asarray(vertices, np.float64)[
        faces[np.asarray(lmk_faces_idx, np.int64)]
    ]  # (L, 3, 3)
    return np.einsum(
        "lkc,lk->lc", tri, np.asarray(lmk_bary_coords, np.float64)
    )


def find_joint_kin_chain(joint_id: int, parents) -> list:
    """Root-ward kinematic chain from a joint (utils.py:90-96; the
    reference walks until parent == -1, so parents[0] must be -1
    here)."""
    chain = []
    cur = int(joint_id)
    while cur != -1:
        chain.append(cur)
        cur = int(parents[cur])
    return chain


def dynamic_lmk_idx_and_bcoords(full_pose, dynamic_lmk_faces_idx,
                                dynamic_lmk_bary_coords, neck_kin_chain):
    """Contour-landmark LUT row from the neck's accumulated y-rotation
    (lbs.py:30-105): compose the chain's rotations, take
    atan2(-R[2,0], hypot(R[0,0], R[1,0])) in degrees, round, clamp to
    the 79-row table ([0..39] right, [40..78] left)."""
    aa = np.asarray(full_pose, np.float64).reshape(-1, 3)[
        np.asarray(neck_kin_chain, np.int64)
    ]
    rel = np.eye(3)
    for i in range(len(neck_kin_chain)):
        rot = np.asarray(batch_rodrigues(
            np.asarray(aa[i: i + 1], np.float32)
        ), np.float64)[0]
        rel = rot @ rel
    sy = np.sqrt(rel[0, 0] ** 2 + rel[1, 0] ** 2)
    euler = np.arctan2(-rel[2, 0], sy)
    y_rot_angle = int(np.round(np.clip(-euler * 180.0 / np.pi, None, 39)))
    if y_rot_angle < 0:
        y_rot_angle = 78 if y_rot_angle < -39 else 39 - y_rot_angle
    return (
        np.asarray(dynamic_lmk_faces_idx, np.int64)[y_rot_angle],
        np.asarray(dynamic_lmk_bary_coords, np.float64)[y_rot_angle],
    )


def smplx_forward(
    model: dict,
    betas=None,
    expression=None,
    global_orient=None,
    body_pose=None,
    jaw_pose=None,
    leye_pose=None,
    reye_pose=None,
    left_hand_pose=None,
    right_hand_pose=None,
    transl=None,
    use_pca: bool = True,
    num_pca_comps: int = 6,
    flat_hand_mean: bool = False,
    use_face_contour: bool = False,
    vertex_ids: dict | None = None,
    num_betas: int = 10,
    num_expression: int = 10,
) -> dict:
    """SMPLX.forward equivalent (body_models.py:1295-1382): returns the reference's output struct
    as a dict {vertices (V,3), joints (55+21[+51/68] ,3), full_pose
    (165,), v_shaped (V,3), betas, expression} — pose assembly
    (smplx_full_pose), LBS (smplx_lbs), extra vertex joints
    (vertex_joint_selector), static face landmarks, optional dynamic
    contour landmarks, and the translation applied to vertices AND
    joints (:1363-1365).

    `model`: load_smpl output of an SMPL-X pickle — needs v_template /
    shapedirs / posedirs / J_regressor / weights / kintree_table plus
    f (faces), lmk_faces_idx, lmk_bary_coords (and the dynamic_* LUTs
    with use_face_contour). Unbatched by design (the runtime never
    batches body models; batch by looping callers)."""
    full_pose = smplx_full_pose(
        global_orient, body_pose, jaw_pose, leye_pose, reye_pose,
        left_hand_pose, right_hand_pose,
        hands_componentsl=model.get("hands_componentsl"),
        hands_componentsr=model.get("hands_componentsr"),
        hands_meanl=model.get("hands_meanl"),
        hands_meanr=model.get("hands_meanr"),
        use_pca=use_pca, num_pca_comps=num_pca_comps,
        flat_hand_mean=flat_hand_mean,
    )
    betas = (np.zeros(num_betas, np.float64) if betas is None
             else np.asarray(betas, np.float64).reshape(-1))
    expression = (np.zeros(num_expression, np.float64) if expression is None
                  else np.asarray(expression, np.float64).reshape(-1))
    verts, joints = smplx_lbs(
        model, betas, expression, full_pose,
        num_betas=num_betas, num_expression=num_expression,
    )
    verts = np.asarray(verts, np.float64)
    joints = np.asarray(joints, np.float64)

    # extra vertex joints (vertex_joint_selector forward, :73-77)
    vids = SMPLX_VERTEX_IDS if vertex_ids is None else vertex_ids
    joints = np.concatenate([joints, verts[extra_joint_ids(vids)]])

    # face landmarks (static 51, + 2x17 contour with use_face_contour)
    if "lmk_faces_idx" in model:
        lmk_faces = np.asarray(model["lmk_faces_idx"], np.int64)
        lmk_bary = np.asarray(model["lmk_bary_coords"], np.float64)
        if use_face_contour:
            parents = np.asarray(model["kintree_table"])[0].astype(np.int64)
            parents = parents.copy()
            parents[0] = -1
            chain = find_joint_kin_chain(12, parents)  # NECK_IDX = 12
            dyn_faces, dyn_bary = dynamic_lmk_idx_and_bcoords(
                full_pose, model["dynamic_lmk_faces_idx"],
                model["dynamic_lmk_bary_coords"], chain,
            )
            lmk_faces = np.concatenate([lmk_faces, dyn_faces])
            lmk_bary = np.concatenate([lmk_bary, dyn_bary])
        landmarks = vertices2landmarks(verts, model["f"], lmk_faces,
                                       lmk_bary)
        joints = np.concatenate([joints, landmarks])

    if transl is not None:
        t = np.asarray(transl, np.float64).reshape(3)
        verts = verts + t
        joints = joints + t

    v_shaped = np.asarray(model["v_template"], np.float64) + np.einsum(
        "vcs,s->vc",
        np.asarray(model["shapedirs"], np.float64)[..., :num_betas], betas,
    )
    return {
        "vertices": verts.astype(np.float32),
        "joints": joints.astype(np.float32),
        "full_pose": full_pose.astype(np.float32),
        "v_shaped": v_shaped.astype(np.float32),
        "betas": betas.astype(np.float32),
        "expression": expression.astype(np.float32),
    }


def smplx_lbs(model: dict, betas, expression, full_pose,
              num_betas: int = 10, num_expression: int = 10):
    """SMPL-X LBS: (verts (V, 3), posed joints (55, 3)).

    Mirrors lbs(shape_components, full_pose, ...) as SMPLX.forward
    calls it (body_models.py:1317-1328): shapedirs columns [:num_betas]
    are the shape space and [300:300+num_expression] the expression
    space (:1143-1154); posedirs may be the raw (V, 3, P) pickle layout
    or the reshaped (P, V*3) (:  the class transposes at load).

    `model`: dict with v_template, shapedirs, posedirs, J_regressor,
    kintree_table (or parents), weights — load_smpl output of an SMPL-X
    pickle/npz."""
    v_template = np.asarray(model["v_template"], np.float64)
    V = v_template.shape[0]
    shapedirs = np.asarray(model["shapedirs"], np.float64)
    sd = shapedirs[..., :num_betas]
    comps = [np.asarray(betas, np.float64).reshape(-1)[:num_betas]]
    dirs = [sd]
    if shapedirs.shape[-1] > num_betas:
        # expression-dirs column range, exactly as SMPLX.__init__ picks
        # it (body_models.py:1143-1158): full 300+100 layout -> columns
        # [300:300+n]; anything smaller is treated as the reduced
        # 10-shape+10-expression layout -> columns [10:10+n]
        if shapedirs.shape[-1] >= (
            SMPLX_SHAPE_SPACE_DIM + SMPLX_EXPRESSION_SPACE_DIM
        ):
            e0 = SMPLX_SHAPE_SPACE_DIM
        else:
            e0 = 10
            num_expression = min(num_expression, 10)
        expr_dirs = shapedirs[..., e0:e0 + num_expression]
        dirs.append(expr_dirs)
        comps.append(
            np.asarray(expression, np.float64).reshape(-1)[:num_expression]
        )
    shape_components = np.concatenate(comps)
    blend_dirs = np.concatenate(dirs, axis=-1)
    v_shaped = v_template + np.einsum(
        "vcs,s->vc", blend_dirs, shape_components
    )

    J_regressor = np.asarray(model["J_regressor"], np.float64)
    joints = J_regressor @ v_shaped  # (J, 3)
    n_joints = joints.shape[0]

    rot = np.asarray(batch_rodrigues(
        np.asarray(full_pose, np.float32).reshape(-1, 3)
    ), np.float64)[:n_joints]
    # pose blend shapes from the non-root rotations (lbs.py:216-222)
    feat = (rot[1:] - np.eye(3)).reshape(-1)
    posedirs = np.asarray(model["posedirs"], np.float64)
    if posedirs.ndim == 3:  # raw (V, 3, P) pickle layout
        pose_offsets = np.einsum(
            "vcp,p->vc", posedirs[..., :feat.shape[0]], feat
        )
    else:  # (P, V*3) smplx-class layout
        pose_offsets = (feat[:posedirs.shape[0]] @ posedirs).reshape(V, 3)
    v_posed = v_shaped + pose_offsets

    parents = (
        np.asarray(model["parents"]) if "parents" in model
        else np.asarray(model["kintree_table"])[0][:n_joints].copy()
    )
    parents = parents.copy()
    parents[0] = 0

    # batch_rigid_transform (lbs.py:345-401)
    rel = joints.copy()
    rel[1:] -= joints[parents[1:]]
    local = np.tile(np.eye(4), (n_joints, 1, 1))
    local[:, :3, :3] = rot
    local[:, :3, 3] = rel
    chain = [local[0]]
    for i in range(1, n_joints):
        chain.append(chain[parents[i]] @ local[i])
    transforms = np.stack(chain)  # (J, 4, 4)
    posed_joints = transforms[:, :3, 3].copy()
    # subtract the rest-pose joint transform
    A = transforms.copy()
    A[:, :3, 3] -= np.einsum("jab,jb->ja", transforms[:, :3, :3], joints)

    weights = np.asarray(model["weights"], np.float64)[:, :n_joints]
    T = np.einsum("vj,jab->vab", weights, A)
    verts = (
        np.einsum("vab,vb->va", T[:, :3, :3], v_posed) + T[:, :3, 3]
    )
    return verts.astype(np.float32), posed_joints.astype(np.float32)
