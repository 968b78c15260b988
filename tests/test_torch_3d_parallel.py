"""3D data-parallel training and the trajectory export on the CPU.

``parallel/dryrun.py``'s 3D case: 2 gloo ranks under DDP against one
process on the whole batch, on objects whose ground-truth contact counts
differ between the ranks.

Tolerances (``parallel/dryrun.py``): the loss and its terms within 1e-5
relative, the gradient norms within 2e-4; each gradient within 2e-3 of its
parameter's largest entry plus 1e-6 of the model's largest; the parameters
after the step within 2e-3 of each parameter's largest step plus 1e-6
relative. The case can catch the fault it exists for: with each rank's own
contact and pair counts the relative-pose losses would miss the whole
batch's by far more than their tolerance.

``Diffusion3D.sample(keep_trajectory=True)`` of a small model with
converted seeded weights, from the JAX sampler's own initial translation
draw (noise_weight 0.5) and with the JAX encoder's features in both
packages (seeded VN weights amplify rounding: ``test_torch_3d_model.py``):
every step within 1e-4 of the JAX trajectory, the last step the final
state bit for bit; each package's ``export_fragment_trajectory`` of its own
trajectory writes the same files, the ``.ply`` coordinates within 1e-4 and
the colours and headers equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffassemble_tpu.data.batch import FragmentBatch as JFragmentBatch
from diffassemble_tpu.utils import viz as jviz
from diffassemble_tpu_torch.parallel import dryrun
from diffassemble_tpu_torch.utils import viz as tviz
from test_torch_3d_model import _batch, _small_models


def test_3d_dryrun_two_gloo_ranks_with_unequal_contacts_match_one_process():
    threads = torch.get_num_threads()
    try:
        out = dryrun.dryrun_multichip_3d(2)
    finally:
        torch.set_num_threads(threads)
    a, b = out["contacts"]
    assert a != b and min(a, b) > 0, out["contacts"]
    case = out["unequal_contacts"]
    assert all(case[k] <= 1.0 for k in ("loss", "grads", "params")), case
    # the per-rank counts would miss the loss tolerance (1e-5 relative) on each relative-pose term
    assert all(v > 10.0 for v in out["per_rank_denominators"].values()), out["per_rank_denominators"]


def test_sample_trajectory_and_its_export_match(tmp_path, monkeypatch):
    jm, params, tm = _small_models(noise_weight=0.5)
    nb = _batch()
    jb = JFragmentBatch(*[jnp.asarray(a) for a in nb])
    key = jax.random.PRNGKey(3)
    want, want_traj = jax.jit(lambda p, b: jm.sample(p, b, key, keep_trajectory=True))(params, jb)
    noise = torch.tensor(np.asarray(jax.random.normal(jax.random.split(key)[0], nb.x0.shape[:2] + (3,))))
    feats = torch.tensor(np.asarray(jm.pcd_features(params, jb.pcds)))
    monkeypatch.setattr(tm, "pcd_features", lambda pcds: feats)
    res = tm.sample(nb.to("cpu"), keep_trajectory=True, noise=noise)
    assert res.trajectory.shape == (3, 2, 4, 7) and torch.equal(res.trajectory[-1], res.final)
    v = nb.node_mask
    np.testing.assert_allclose(res.trajectory.numpy()[:, v], np.asarray(want_traj)[:, v], rtol=0, atol=1e-4)
    for pkg, traj, name in ((jviz, np.asarray(want_traj), "jax"), (tviz, res.trajectory.numpy(), "port")):
        pkg.export_fragment_trajectory(tmp_path / name, nb.pcds[0], traj[:, 0], nb.node_mask[0], name="obj0")
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(files) == 4
    for f in (f for f in files if f.endswith(".ply")):
        got, ref = ((tmp_path / d / f).read_text().splitlines() for d in ("port", "jax"))
        head = got.index("end_header") + 1
        assert got[:head] == ref[:head] and len(got) == len(ref)
        gv, rv = (np.array([[float(x) for x in line.split()] for line in lines[head:]]) for lines in (got, ref))
        np.testing.assert_array_equal(gv[:, 3:], rv[:, 3:])
        np.testing.assert_allclose(gv[:, :3], rv[:, :3], rtol=0, atol=1e-4)
    with np.load(tmp_path / "port" / "obj0_traj.npz") as a, np.load(tmp_path / "jax" / "obj0_traj.npz") as b:
        assert a.files == b.files
        assert np.array_equal(a["pcds"], b["pcds"]) and np.array_equal(a["valids"], b["valids"])
        np.testing.assert_allclose(a["trajectory"][:, v[0]], b["trajectory"][:, v[0]], rtol=0, atol=1e-4)
