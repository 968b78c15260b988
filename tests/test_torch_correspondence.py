"""The correspondence head (``nn/correspondence.py``) against the JAX
package's, on the CPU, with the trained ``weights/corr_rel3d.npz`` (a
VN-DGCNN giving per-point invariant descriptors, ``return_points``, and a
``CorrespondencePairs``) on its pretraining corpus (256 points, 2–4 parts,
canonical 0.6, wall detail 0.06, boost 2), and ``weighted_kabsch`` on a known
pose.

f32 on both sides. Tolerances:
- the head on the JAX package's descriptors: 1e-5 of each output's largest
  entry (sums of 64-wide products and a softmax over 128 points);
- the relative poses of ``solve_rel_poses``: 1e-4 on the pairs whose match
  weight is above a tenth of the largest (a weighted 3×3 SVD: where the
  weights nearly vanish the solve is ill-posed in both packages);
- the descriptors of the port's own VN-DGCNN: its VNNorms amplify rounding,
  so one ulp of input noise moves them by a median 2.4e-2 and at most
  8.3e-2 of the largest entry (``tests/torch_assets.py:ulp_spread`` on this
  encoder and corpus); held to 1e-3 at the median point (measured 4.3e-5)
  and 0.15 at the worst (measured 1.7e-2);
- the losses 1e-5 relative, their gradients 1e-4 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffassemble_tpu.data.breaking_bad import SyntheticFractures, collate_fragments
from diffassemble_tpu.nn import correspondence as jc
from diffassemble_tpu.nn.vn import VN_DGCNN as JVN
from diffassemble_tpu.utils.params import load_params as jload
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.models.losses_3d import contact_matrix
from diffassemble_tpu_torch.nn import correspondence as tc
from diffassemble_tpu_torch.nn.vn import VN_DGCNN

WEIGHTS = "weights/corr_rel3d.npz"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))


def _corpus():
    ds = SyntheticFractures(2, 256, 2, 4, seed=3, canonical=0.6, wall_detail=0.06, wall_boost=2)
    return collate_fragments([ds[i] for i in range(2)], 4, rng=np.random.default_rng(0))


def _models():
    tree = jload(WEIGHTS)
    state = convert.convert_params({"encoder": tree["encoder"], "corr": tree["corr"]})
    enc = VN_DGCNN(feat_dim=128, return_points=True)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")}, strict=True)
    corr = tc.CorrespondencePairs(tree["corr"]["q"]["kernel"].shape[0])
    corr.load_state_dict({k[len("corr."):]: v for k, v in state.items() if k.startswith("corr.")}, strict=True)
    return tree, enc, corr


def _jax_descriptors(tree, nb):
    b, p, n = nb.pcds.shape[:3]
    _, desc = JVN(feat_dim=128, return_points=True).apply({"params": tree["encoder"]},
                                                          jnp.asarray(nb.pcds.reshape(b * p, n, 3)))
    return desc.reshape(b, p, n, -1)


def test_correspondence_pairs_and_relative_poses_match_on_the_trained_head():
    tree, _, corr = _models()
    nb = _corpus()
    desc = _jax_descriptors(tree, nb)
    want = jc.CorrespondencePairs().apply({"params": tree["corr"]}, jnp.asarray(nb.pcds), desc)
    with torch.no_grad():
        got = corr(torch.tensor(nb.pcds), torch.tensor(np.asarray(desc)))
    for key in ("y", "p", "w", "conf", "att"):
        assert _rel(got[key].numpy(), want[key]) <= 1e-5, key
    r, o = tc.solve_rel_poses(got)
    jr_, jo = jc.solve_rel_poses(want)
    mass = got["w"].sum(-1).numpy()
    sure = mass > 0.1 * mass.max()
    assert sure.sum() >= 4
    assert _rel(r.numpy()[sure], np.asarray(jr_)[sure]) <= 1e-4
    assert _rel(o.numpy()[sure], np.asarray(jo)[sure]) <= 1e-4
    assert np.allclose(np.linalg.det(r.numpy()), 1.0, atol=1e-4)


def test_point_descriptors_of_the_trained_encoder_match():
    tree, enc, _ = _models()
    nb = _corpus()
    want = np.asarray(_jax_descriptors(tree, nb))
    b, p, n = nb.pcds.shape[:3]
    with torch.no_grad():
        pooled, desc = enc(torch.tensor(nb.pcds.reshape(b * p, n, 3)))
    assert pooled.shape == (b * p, 768) and desc.shape == (b * p, n, 63 + 128)
    err = np.abs(desc.reshape(want.shape).numpy() - want).max(-1) / np.abs(want).max()
    assert np.median(err) <= 1e-3 and err.max() <= 0.15


def test_weighted_kabsch_recovers_a_pose_and_matches():
    rng = np.random.default_rng(1)
    src = rng.standard_normal((3, 40, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    rot = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    off = np.array([0.3, -0.2, 0.5], np.float32)
    dst = src @ rot.T + off
    w = rng.random((3, 40)).astype(np.float32)
    dst[:, :5] += 5.0  # outliers, weighted out
    w[:, :5] = 0.0
    r, o = tc.weighted_kabsch(torch.tensor(src), torch.tensor(dst), torch.tensor(w))
    assert np.allclose(r.numpy(), rot, atol=1e-5) and np.allclose(o.numpy(), off, atol=1e-5)
    jr_, jo = jc.weighted_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    assert _rel(r.numpy(), jr_) <= 1e-5 and _rel(o.numpy(), jo) <= 1e-5


def test_correspondence_losses_and_gradients_match():
    tree, _, corr = _models()
    nb = _corpus()
    desc = np.asarray(_jax_descriptors(tree, nb))
    gt_q, gt_t, v = (torch.tensor(a) for a in (nb.x0[..., :4], nb.x0[..., 4:7], nb.node_mask))
    contact = contact_matrix(torch.tensor(nb.pcds), gt_q, gt_t, v, thresh=0.1)
    assert contact.any()
    jargs = [jnp.asarray(a) for a in (nb.x0[..., :4], nb.x0[..., 4:7], contact.numpy(), nb.node_mask)]

    def jtotal(params, desc):
        out = jc.CorrespondencePairs().apply({"params": params}, jnp.asarray(nb.pcds), desc)
        losses = jc.correspondence_rel_loss(out, *jargs)
        losses["corr_att_loss"] = jc.correspondence_attention_loss(out, *jargs)
        return sum(losses.values()), losses

    (_, jlosses), jgrad = jax.jit(jax.value_and_grad(jtotal, argnums=1, has_aux=True))(tree["corr"], jnp.asarray(desc))
    td = torch.tensor(desc, requires_grad=True)
    out = corr(torch.tensor(nb.pcds), td)
    losses = tc.correspondence_rel_loss(out, gt_q, gt_t, contact, v)
    losses["corr_att_loss"] = tc.correspondence_attention_loss(out, gt_q, gt_t, contact, v)
    for key, val in losses.items():
        assert abs(float(val.detach()) - float(jlosses[key])) <= 1e-5 * abs(float(jlosses[key])) + 1e-7, key
    sum(losses.values()).backward()
    assert torch.isfinite(td.grad).all() and _rel(td.grad.numpy(), jgrad) <= 1e-4
