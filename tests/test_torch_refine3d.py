"""The held-out protocol's geometry in the port against the JAX package's, on
the CPU: the multiview ICP refinement (``models/refine3d.py``: the PCA
normals, the correspondences and ``refine_poses`` with and without
fracture-wall weights), the gauge-aligned diagnostic and the metric
calibration of ``train/heldout3d.py`` (``scripts/tpu_eval_3d.py``'s).

The corpus is the wall-surface one the refinement was built for, three
objects of 256 points; the poses are the true ones perturbed from a numpy
seed; f32 on both sides. Tolerances: the normals 1e-5 up to sign (each
eigenvector's sign is the solver's choice: the port's differs from the JAX
package's on about a tenth of the points, and nothing downstream sees it);
the correspondences' targets and weights 1e-5; the refined poses 1e-4
(measured at most 6.6e-7 after 20 iterations: nearest neighbours and the
trimming order agree exactly, so only rounding separates them), their mean
nearest distances 1e-2; the gauge-aligned poses 1e-5; metrics 1e-5
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.data.breaking_bad import SyntheticFractures, collate_fragments
from diffassemble_tpu.models import losses_3d as jl3
from diffassemble_tpu.models import refine3d as jr
from diffassemble_tpu.ops import so3 as jso3
from diffassemble_tpu.ops.knn import chamfer_distance as jchamfer
from diffassemble_tpu_torch.data import breaking_bad as tbb
from diffassemble_tpu_torch.models import Diffusion3D, Diffusion3DConfig
from diffassemble_tpu_torch.models import refine3d as tr
from diffassemble_tpu_torch.train import heldout3d


def _corpus(n=3, num_points=256, max_p=5):
    ds = SyntheticFractures(n, num_points, 3, max_p, seed=11, canonical=0.9, wall_detail=0.08, wall_boost=3,
                            wall_surface=True, wall_freq=5.0)
    samples = [ds[i] for i in range(n)]
    nb = collate_fragments(samples, max_p, rng=np.random.default_rng(0))
    wall = np.zeros(nb.pcds.shape[:3], np.float32)
    for i, smp in enumerate(samples):
        wall[i, : smp["n_parts"]] = smp["wall"][:max_p]
    return nb, wall


def _perturbed(nb, seed=1, rot=0.08, trans=0.03):
    rng = np.random.default_rng(seed)
    q = nb.x0[..., :4] + rot * rng.standard_normal(nb.x0[..., :4].shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = nb.x0[..., 4:7] + trans * rng.standard_normal(nb.x0[..., 4:7].shape).astype(np.float32)
    return q, t


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))


def test_pca_normals_match_up_to_sign():
    nb, _ = _corpus()
    pts = nb.pcds[:, :, :128]
    want = np.asarray(jr._pca_normals(jnp.asarray(pts), 10))
    got = tr._pca_normals(torch.tensor(pts), 10).numpy()
    dots = np.sum(want * got, -1)
    assert np.abs(np.abs(dots) - 1).max() <= 1e-5
    assert np.allclose(np.linalg.norm(got, axis=-1), 1, atol=1e-5)


@pytest.mark.parametrize("walls", [False, True], ids=["all_points", "wall_points"])
def test_correspondences_match(walls):
    nb, wall = _corpus()
    pts, node_mask = nb.pcds[:, :, :128], nb.node_mask
    n = np.asarray(jr._pca_normals(jnp.asarray(pts), 10))
    pw = wall[:, :, :128] if walls else None
    want = jr._correspond(jnp.asarray(pts), jnp.asarray(n), jnp.asarray(node_mask), 0.1, 0.25,
                          None if pw is None else jnp.asarray(pw))
    got = tr._correspond(torch.tensor(pts), torch.tensor(n), torch.tensor(node_mask), 0.1, 0.25,
                         None if pw is None else torch.tensor(pw))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-5


@pytest.mark.parametrize("walls", [False, True], ids=["all_points", "wall_points"])
def test_refine_poses_matches_from_the_same_perturbed_poses(walls):
    nb, wall = _corpus()
    q, t = _perturbed(nb)
    kw = dict(steps=20, n_sub=128, anchor=0.01)
    want = jr.refine_poses(jnp.asarray(nb.pcds), jnp.asarray(nb.node_mask), jnp.asarray(q), jnp.asarray(t),
                           point_w=jnp.asarray(wall) if walls else None, **kw)
    got = tr.refine_poses(torch.tensor(nb.pcds), torch.tensor(nb.node_mask), torch.tensor(q), torch.tensor(t),
                          point_w=torch.tensor(wall) if walls else None, **kw)
    v = nb.node_mask
    assert _rel(got.quat.numpy()[v], np.asarray(want.quat)[v]) <= 1e-4
    assert _rel(got.trans.numpy()[v], np.asarray(want.trans)[v]) <= 1e-4
    # the mean nearest distance takes the square root of |u|² − 2u·v + |v|², whose rounding (~1e-7 near
    # coincident points) its root turns into ~3e-4: 1e-2 of it (measured 1.0e-4)
    assert _rel(got.resid0.numpy(), want.resid0) <= 1e-2 and _rel(got.resid1.numpy(), want.resid1) <= 1e-2
    assert np.abs(got.trans.numpy()[v] - t[v]).max() > 1e-2  # it moved the parts
    assert np.array_equal(got.trans.numpy()[~v], t[~v])  # and left the padding where it was


def _script_gauge(pred_q, pred_t, gt_q, gt_t, v):
    """The gauge alignment as ``scripts/tpu_eval_3d.py`` computes it."""
    pred_r, gt_r = jso3.quaternion_to_matrix(pred_q), jso3.quaternion_to_matrix(gt_q)
    w = v.astype(pred_r.dtype)
    m = jnp.einsum("bp,bpij,bpkj->bik", w, gt_r, pred_r)
    u, _, vt = jnp.linalg.svd(m)
    det = jnp.linalg.det(jnp.einsum("bij,bjk->bik", u, vt))
    d = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], -1)
    r0 = jnp.einsum("bij,bj,bjk->bik", u, d, vt)
    nv = jnp.sum(w, axis=1, keepdims=True) + 1e-9
    t0 = jnp.sum(gt_t * w[..., None], axis=1) / nv - jnp.einsum(
        "bij,bj->bi", r0, jnp.sum(pred_t * w[..., None], axis=1) / nv)
    return jnp.einsum("bij,bpjk->bpik", r0, pred_r), jnp.einsum("bij,bpj->bpi", r0, pred_t) + t0[:, None]


def test_gauge_aligned_diagnostic_matches_the_scripts():
    """A global rotation and shift of an object's poses is removed exactly;
    on noisy poses the aligned poses are the script's."""
    nb, _ = _corpus()
    q, t = _perturbed(nb, 2, rot=0.3, trans=0.1)
    args = [jnp.asarray(a) for a in (q, t, nb.x0[..., :4], nb.x0[..., 4:7], nb.node_mask)]
    want_r, want_t = _script_gauge(*args)
    got_r, got_t = heldout3d.gauge_align(*[torch.tensor(np.asarray(a)) for a in args])
    v = nb.node_mask
    assert _rel(got_r.numpy()[v], np.asarray(want_r)[v]) <= 1e-5
    assert _rel(got_t.numpy()[v], np.asarray(want_t)[v]) <= 1e-5
    # a pure global SE(3) move of the true poses is undone (the determinant fix keeps it proper)
    gt_q, gt_t = torch.tensor(nb.x0[..., :4]), torch.tensor(nb.x0[..., 4:7])
    g = torch.tensor(np.linalg.qr(np.random.default_rng(3).standard_normal((3, 3)))[0], dtype=torch.float32)
    g = g * torch.sign(torch.linalg.det(g))
    from diffassemble_tpu_torch.ops import so3 as tso3

    moved_q = tso3.matrix_to_quaternion(g @ tso3.quaternion_to_matrix(gt_q))
    a_r, a_t = heldout3d.gauge_align(moved_q, gt_t @ g.T + 0.5, gt_q, gt_t, torch.tensor(v))
    assert torch.allclose(a_r[torch.tensor(v)], tso3.quaternion_to_matrix(gt_q)[torch.tensor(v)], atol=1e-5)
    assert torch.allclose(a_t[torch.tensor(v)], gt_t[torch.tensor(v)], atol=1e-5)


def test_heldout_row_with_refinement_and_gauge_is_the_scripts(monkeypatch):
    """Given the same sampled poses, a protocol row's ``gauge_aligned`` and
    ``refined`` blocks are what the script's formulas give on the JAX
    package's refinement, with the fracture-wall weights of the corpus."""
    protocol = dict(test_n=3, batch=2, num_points=96, max_num_part=4, min_num_part=3, wall_detail=0.08,
                    wall_boost=3, wall_surface=1, wall_freq=5.0, canonical=0.9, seed=11, ratios=[10],
                    refine_steps=8, refine_anchor=0.01, refine_sigma0=0.2, refine_trim=0.25)
    model = Diffusion3D(Diffusion3DConfig(backbone="pointnet", n_layers=1, hidden_dim=16, heads=2, max_num_part=4),
                        device="cpu")
    rng = np.random.default_rng(4)
    finals = []

    def fake_sample(batch, generator=None, inference_ratio=None):
        q, t = _perturbed(type("B", (), {"x0": batch.x0.numpy()}), int(rng.integers(1 << 30)), 0.1, 0.03)
        finals.append(np.concatenate([q, t], -1))
        return type("R", (), {"final": torch.tensor(finals[-1])})

    monkeypatch.setattr(model, "sample", fake_sample)
    row = heldout3d.run_protocol(model, protocol)
    assert row["ratio"] == 10 and row["reverse_steps"] == 30 and row["refined"]["steps"] == 8

    test_ds = heldout3d.protocol_corpus(protocol)
    refine = jax.jit(lambda *a: jr.refine_poses(*a[:4], steps=8, anchor=0.01, sigma0=0.2, trim=0.25, point_w=a[4]))
    cd_a, gd_a, ref_cd, ref_rt = [], [], [], []
    for (nb, pw), final in zip(heldout3d.batches(test_ds, 2, 4, 11, "cpu"), finals):
        jb = [jnp.asarray(a) for a in (nb.pcds.numpy(), nb.x0.numpy(), nb.node_mask.numpy())]
        pts, x0, v = jb
        pred_q, pred_t = jnp.asarray(final[..., :4]), jnp.asarray(final[..., 4:7])
        gt_q, gt_t = x0[..., :4], x0[..., 4:7]

        def cd(tq, tt):
            d1, d2 = jchamfer(jl3.transform_pc(tt, tq, pts), jl3.transform_pc(gt_t, gt_q, pts))
            return np.asarray(jnp.mean(d1, -1) + jnp.mean(d2, -1))[nb.node_mask.numpy()]

        a_r, a_t = _script_gauge(pred_q, pred_t, gt_q, gt_t, v)
        cd_a.append(cd(jso3.matrix_to_quaternion(a_r), a_t))
        gd_a.append(np.asarray(jso3.geodesic_distance_rmat(a_r, jso3.quaternion_to_matrix(gt_q)))[nb.node_mask.numpy()])
        res = refine(pts, v.astype(bool), pred_q, pred_t, None if pw is None else jnp.asarray(pw.numpy()))
        ref_cd.append(cd(res.quat, res.trans))
        ref_rt.append(np.asarray(jl3.trans_rmse(res.trans, gt_t, v)))
    cd_a, gd_a, ref_cd = (np.concatenate(x) for x in (cd_a, gd_a, ref_cd))
    assert abs(row["gauge_aligned"]["gd_r"] - gd_a.mean()) <= 1e-5 * max(gd_a.mean(), 1)
    assert abs(row["gauge_aligned"]["cd_median"] - np.median(cd_a)) <= 1e-5 * np.abs(cd_a).max()
    assert row["gauge_aligned"]["part_acc"] == {str(t): float((cd_a < t).mean()) for t in heldout3d.THRESHOLDS}
    assert abs(row["refined"]["rmse_t"] - np.concatenate(ref_rt).mean()) <= 1e-4 * np.concatenate(ref_rt).max()
    assert abs(row["refined"]["cd_median"] - np.median(ref_cd)) <= 1e-4 * np.abs(ref_cd).max()
    assert row["n_parts"] == ref_cd.size


def test_calibration_scores_the_true_poses_at_one():
    """The zero-noise row gates the metric: part_acc 1.0 at every
    threshold; noise lowers it and raises the median CD."""
    _, test_ds, _ = tbb.get_dataset_3d("synthetic", train_n=2, test_n=4, num_points=64, max_num_part=4, seed=2)
    rows = heldout3d.calibration(test_ds, batch=2, max_num_part=4, seed=0)
    assert [(r["rot_deg"], r["trans_sigma"]) for r in rows] == list(heldout3d.CALIBRATION_NOISE)
    assert set(rows[0]["part_acc"].values()) == {1.0} and rows[0]["cd_median"] < 1e-6  # rounding alone
    assert rows[4]["cd_median"] > rows[1]["cd_median"] > rows[0]["cd_median"]
    assert rows[4]["part_acc"]["0.01"] < 1.0
