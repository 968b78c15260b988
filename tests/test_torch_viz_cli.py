"""The port's visualisation, image-folder data, preprocessing and the
evaluate / missing-pieces CLIs against the JAX package's, on the CPU.

- ``save_reconstruction`` with PIL blocked (an import blocker like
  ``tests/test_torch_isolation.py``'s) writes the JAX package's ``.npy``
  fallback byte for byte, and no PNG; ``save_trajectory`` writes the JAX
  package's files byte for byte, with PIL and without.
- ``_resize`` in both branches (PIL's resize, and nearest-neighbour indexing
  with PIL blocked) equals the JAX package's exactly.
- ``ImageFolder`` and ``build_memmap`` on images the test writes: the shard,
  its index and ``MemmapImages`` equal the JAX package's byte for byte, and
  puzzles cut from an image folder (with a resize) are the JAX package's.
- ``Trainer._save_viz`` for puzzles (PNGs, or ``.npy`` without PIL) and for
  3D fragments (``.ply``) writes the JAX trainer's files byte for byte; a
  drawing that fails is printed and does not raise.
- ``export_fragment_trajectory``: the ``.ply`` text and the ``.npz`` arrays
  of a trajectory are the JAX package's.
- ``train_2d_missing`` trains a tiny run with 20% of the pieces gone, and
  ``evaluate`` on it reports the metrics of the model's own sample of each
  batch, writes one image per sampling step and puzzle, takes the sampler
  overrides and ``--checkpoint_path``, and with ``--calibrate_norm`` writes
  ``norm_stats.npz`` in the JAX package's layout; on a run with an EMA both
  the latest checkpoint and ``--checkpoint_path`` evaluate the EMA, and the
  test batch, the calibrated statistics and the sample equal the JAX
  package's ``cli/evaluate.py`` pieces on the same params.
- ``cli/train_device.py`` draws the first puzzles of each evaluation.
"""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from diffassemble_tpu.cli import preprocess as jpre
from diffassemble_tpu.data import datasets as jdatasets
from diffassemble_tpu.train import trainer as jtrainer
from diffassemble_tpu.utils import viz as jviz
from diffassemble_tpu_torch.cli import evaluate as tevaluate
from diffassemble_tpu_torch.cli import preprocess as tpre
from diffassemble_tpu_torch.cli import train_2d_missing
from diffassemble_tpu_torch.data import PuzzleBatch, collate_puzzles
from diffassemble_tpu_torch.data import breaking_bad as tbb
from diffassemble_tpu_torch.data import datasets as tdatasets
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
from diffassemble_tpu_torch.train import trainer as ttrainer
from diffassemble_tpu_torch.utils import viz as tviz


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _RefusePIL:
    """A meta-path finder that refuses PIL, as the isolation test's does."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "PIL":
            raise ImportError(f"the test refused {name}")
        return None


@pytest.fixture
def no_pil(monkeypatch):
    """PIL unimportable for the test (its loaded modules taken out, put back after)."""
    for name in [m for m in sys.modules if m.split(".")[0] == "PIL"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(sys, "meta_path", [_RefusePIL(), *sys.meta_path])
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _puzzle(seed=0, n=3):
    rng = np.random.default_rng(seed)
    patches = (rng.random((n * n, 32, 32, 3)) * 255).astype(np.uint8)
    pos = rng.uniform(-1, 1, (n * n, 2)).astype(np.float32)
    gt = rng.uniform(-1, 1, (n * n, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (n * n,))
    rot = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    return patches, pos, gt, rot


def test_save_reconstruction_without_pil_writes_the_jax_npy(no_pil, tmp_path):
    patches, pos, gt, rot = _puzzle()
    for pkg, name in ((jviz, "jax"), (tviz, "port")):
        pkg.save_reconstruction(tmp_path / name / "r.png", patches, pos, gt, (3, 3), pred_rot=rot, gt_rot=rot[::-1])
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert list(port) == ["r.png.npy"] and port == ref
    assert np.load(tmp_path / "port" / "r.png.npy").shape == (96, 2 * 96 + 8, 3)  # prediction | 8 | truth


@pytest.mark.parametrize("pil", [True, False])
def test_save_trajectory_writes_the_jax_files(pil, tmp_path, request):
    if not pil:
        request.getfixturevalue("no_pil")
    patches, _, gt, _ = _puzzle(1)
    traj = np.random.default_rng(2).uniform(-1, 1, (3, 9, 4)).astype(np.float32)
    jviz.save_trajectory(tmp_path / "jax", patches, traj, gt, (3, 3), name="b0_s1")
    tviz.save_trajectory(tmp_path / "port", patches, traj, gt, (3, 3), name="b0_s1")
    port = _files(tmp_path / "port")
    suffix = ".png" if pil else ".png.npy"
    assert list(port) == [f"b0_s1_step{s:03d}{suffix}" for s in range(3)]
    assert port == _files(tmp_path / "jax")


@pytest.mark.parametrize("pil", [True, False])
def test_resize_both_branches_match(pil, request):
    if not pil:
        request.getfixturevalue("no_pil")
    img = np.random.default_rng(3).random((40, 56, 3)).astype(np.float32)
    for size in ((64, 64), (20, 30)):
        got, want = tdatasets._resize(img, size), jdatasets._resize(img, size)
        assert got.shape == (*size, 3) and got.dtype == want.dtype and np.array_equal(got, want)
    if not pil:
        yi, xi = (np.arange(20) * 40 / 20).astype(int), (np.arange(30) * 56 / 30).astype(int)
        assert np.array_equal(tdatasets._resize(img, (20, 30)), img[yi][:, xi])


def _image_folder(root: Path, n=4, size=48) -> Path:
    from PIL import Image

    rng = np.random.default_rng(4)
    (root / "sub").mkdir(parents=True)
    for i in range(n):
        arr = (rng.random((size, size, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / ("sub" if i % 2 else ".") / f"img{i}.png")
    (root / "notes.txt").write_text("not an image")
    return root


def test_image_folder_and_memmap_match(tmp_path):
    src = _image_folder(tmp_path / "src")
    n_j = jpre.build_memmap(str(src), str(tmp_path / "jax.npy"), 48, limit=3)
    n_t = tpre.build_memmap(str(src), str(tmp_path / "port.npy"), 48, limit=3)
    assert n_j == n_t == 3
    assert (tmp_path / "port.npy").read_bytes() == (tmp_path / "jax.npy").read_bytes()
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    got, want = tpre.MemmapImages(str(tmp_path / "port.npy")), jpre.MemmapImages(str(tmp_path / "jax.npy"))
    assert len(got) == len(want) == 3 and all(np.array_equal(got[i], want[i]) for i in range(3))
    # a split file, and puzzles cut (with a resize from 48 to 64 pixels) from the folder
    split = tmp_path / "split.txt"
    split.write_text("img0.png\nsub/img1.png\n")
    a, b = jdatasets.ImageFolder(str(src), str(split)), tdatasets.ImageFolder(str(src), str(split))
    assert len(a) == len(b) == 2 and all(np.array_equal(a[i], b[i]) for i in range(2))
    kw = dict(puzzle_sizes=[2], rotation=True, train_n=4, test_n=4, seed=5)
    ja, ta = jdatasets.get_dataset(str(src), **kw), tdatasets.get_dataset(str(src), **kw)
    for ds_a, ds_b in zip(ja[:2], ta[:2]):
        assert len(ds_a) == len(ds_b) == 4
        for i in range(len(ds_a)):
            sa, sb = ds_a[i], ds_b[i]
            assert sa.keys() == sb.keys() and all(np.array_equal(sa[k], sb[k]) for k in sa)


def test_image_folder_needs_pil_and_says_so(no_pil, tmp_path):
    with pytest.raises(ImportError, match="PIL"):
        tdatasets.ImageFolder(str(tmp_path))


def _jax_viz_self(run_dir: Path, rotation: bool):
    return types.SimpleNamespace(run_dir=run_dir, viz_every_eval=2,
                                 model=types.SimpleNamespace(cfg=types.SimpleNamespace(rotation=rotation)))


@pytest.mark.parametrize("pil", [True, False])
def test_trainer_save_viz_2d_writes_the_jax_trainers_files(pil, tmp_path, request, capsys):
    if not pil:
        request.getfixturevalue("no_pil")
    cfg = Diffusion2DConfig(steps=20, rotation=True, backbone="tiny", n_layers=1, hidden_dim=32, heads=4)
    tr = ttrainer.Trainer(Diffusion2D(cfg, device="cpu"), run_dir=str(tmp_path / "port"), batch_size=2)
    assert tr.viz_every_eval == 2
    train, _, _ = tdatasets.get_dataset("synthetic", puzzle_sizes=[3, 2], rotation=True, missing_perc=20, train_n=3,
                                        seed=1)
    nb = collate_puzzles([train[i] for i in range(3)], train.max_nodes)
    assert not nb.node_mask.all()  # padded pieces: each drawing takes the valid ones
    final = np.random.default_rng(6).uniform(-1, 1, nb.x0.shape).astype(np.float32)
    tr._save_viz(nb, final, "val", 7)
    jtrainer.Trainer._save_viz(_jax_viz_self(tmp_path / "jax", True), nb, final, "val", 7)
    port = _files(tmp_path / "port" / "viz")
    suffix = ".png" if pil else ".png.npy"
    assert list(port) == [f"val_step7_p{i}{suffix}" for i in range(2)]
    assert port == _files(tmp_path / "jax" / "viz")
    tr._save_viz(nb, final[:, :, :1], "val", 8)  # positions of the wrong width: printed, not raised
    assert "viz skipped" in capsys.readouterr().out


def _fragments(n=3):
    _, test_ds, _ = tbb.get_dataset_3d("synthetic", num_points=16, min_num_part=2, max_num_part=3, train_n=1,
                                       test_n=n, seed=2)
    return tbb.collate_fragments([test_ds[i] for i in range(n)], 3)


def _poses(shape, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((*shape, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([q, rng.uniform(-0.5, 0.5, (*shape, 3)).astype(np.float32)], -1)


def test_trainer_save_viz_3d_writes_the_jax_trainers_files(tmp_path):
    from diffassemble_tpu_torch.models import Diffusion3D, Diffusion3DConfig

    model = Diffusion3D(Diffusion3DConfig(steps=20, n_layers=1, hidden_dim=16, heads=2, max_num_part=3), device="cpu")
    tr = ttrainer.Trainer(model, run_dir=str(tmp_path / "port"), batch_size=2,
                          adapter=ttrainer.fragment_adapter(3, ["synthetic"]))
    nb = _fragments()
    final = _poses(nb.x0.shape[:2], 7)
    tr._save_viz(nb, final, "val", 4)
    jtrainer.Trainer._save_viz(_jax_viz_self(tmp_path / "jax", False), nb, final, "val", 4)
    port = _files(tmp_path / "port" / "viz")
    assert list(port) == ["val_step4_p0.ply", "val_step4_p1.ply"]
    assert port == _files(tmp_path / "jax" / "viz")
    lines = port["val_step4_p0.ply"].decode().splitlines()
    assert f"element vertex {16 * int(nb.node_mask[0].sum())}" in lines


def test_export_fragment_trajectory_matches(tmp_path):
    nb = _fragments(1)
    traj = _poses((4, 3), 8)
    for pkg, name in ((jviz, "jax"), (tviz, "port")):
        pkg.export_fragment_trajectory(tmp_path / name, nb.pcds[0], traj, nb.node_mask[0], name="obj0")
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(["obj0_traj.npz"] + [f"obj0_step{s:03d}.ply" for s in range(4)])
    assert {k: v for k, v in port.items() if k.endswith(".ply")} == {k: v for k, v in ref.items() if k.endswith(".ply")}
    with np.load(tmp_path / "port" / "obj0_traj.npz") as a, np.load(tmp_path / "jax" / "obj0_traj.npz") as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)


# ---------------------------------------------------------------- the CLIs

TINY = ["-dataset", "synthetic", "-puzzle_sizes", "3", "-steps", "20", "-batch_size", "2", "--n_layers", "1",
        "--compute_dtype", "float32", "--device", "cpu"]


@pytest.fixture(scope="module")
def missing_run(tmp_path_factory):
    """A tiny run trained by ``train_2d_missing`` (tiny encoder, 2 steps)."""
    run = tmp_path_factory.mktemp("missing") / "run"
    argv = ["train_2d_missing", *TINY, "--backbone", "tiny", "-max_steps", "2", "--run_dir", str(run)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", argv)
        train_2d_missing.main()
    return run


def test_train_2d_missing_trains_without_a_fifth_of_the_pieces(missing_run):
    from diffassemble_tpu_torch.cli import common

    assert (missing_run / "checkpoints" / "2" / "state.pt").is_file()
    recs = [json.loads(line) for line in (missing_run / "metrics.jsonl").read_text().splitlines()]
    assert any("sanity/overall__piece_acc" in r for r in recs) and np.isfinite(recs[-1]["loss"])
    ap = common.argparse.ArgumentParser()
    common.add_2d_args(ap)
    ap.set_defaults(missing=20)
    train_ds, _, _ = common.build_2d_datasets(ap.parse_args(TINY))
    assert {len(train_ds[i]["x0"]) for i in range(4)} == {7}  # 9 − ⌈9 · 0.2⌉ pieces
    assert (missing_run / "viz").is_dir()  # the evaluations drew their first puzzles


def test_evaluate_reports_the_models_own_samples(missing_run, tmp_path):
    from diffassemble_tpu_torch.train.checkpoint import CheckpointManager
    from diffassemble_tpu_torch.train.train_state import create_train_state

    out = tmp_path / "preds"
    got = tevaluate.main(["--run_dir", str(missing_run), "--puzzle_sizes", "3", "--batch_size", "2", "--n_batches",
                          "2", "--inference_ratio", "10", "--out_dir", str(out), "--device", "cpu"])
    cfg = Diffusion2DConfig(**{**CheckpointManager(missing_run / "checkpoints").load_config(), "inference_ratio": 10})
    model = Diffusion2D(cfg, device="cpu")
    CheckpointManager(missing_run / "checkpoints").restore(
        create_train_state(model, model.make_optimizer(), torch.Generator()))
    _, test_ds, _ = tdatasets.get_dataset("synthetic", puzzle_sizes=[3], rotation=cfg.rotation, seed=0)
    gen = torch.Generator().manual_seed(0)
    for bi in range(2):
        batch = PuzzleBatch(*collate_puzzles([test_ds[i] for i in (2 * bi, 2 * bi + 1)], test_ds.max_nodes)).to("cpu")
        m = model.metrics_from_final(model.sample(batch, gen).final, batch)
        assert got[bi] == {"piece_acc": float(m["piece_acc"].mean()), "puzzle_acc": float(m["puzzle_correct"].mean())}
    # 20 steps at ratio 10: 2 images per puzzle
    assert sorted(_files(out)) == sorted(f"b{b}_s{j}_step{s:03d}.png" for b in range(2) for j in range(2)
                                         for s in range(2))
    explicit = tevaluate.main(["--run_dir", str(missing_run), "--checkpoint_path", str(missing_run / "checkpoints" / "2"),
                               "--puzzle_sizes", "3", "--batch_size", "2", "--n_batches", "2", "--inference_ratio",
                               "10", "--save_images", "false", "--device", "cpu"])
    assert explicit == got  # no EMA: the live params are the latest checkpoint's


def test_evaluate_calibrates_orientation_norms(tmp_path):
    """``--calibrate_norm`` on a run of an equivariant encoder writes the
    JAX package's ``norm_stats.npz`` layout, which the model then runs with."""
    from diffassemble_tpu.nn import visual as jvisual

    from diffassemble_tpu_torch.cli import train_2d_rot

    run = tmp_path / "run"
    argv = ["train_2d_rot", *TINY, "-puzzle_sizes", "2", "--backbone", "resnet18equiv", "-max_steps", "1",
            "--run_dir", str(run)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", argv)
        train_2d_rot.main()
    tevaluate.main(["--run_dir", str(run), "--puzzle_sizes", "2", "--batch_size", "2", "--n_batches", "1",
                    "--calibrate_norm", "2", "--save_images", "false", "--device", "cpu"])
    stats = jvisual.load_norm_stats(run / "norm_stats.npz")  # the JAX package reads it
    model = Diffusion2D(Diffusion2DConfig(**json.loads((run / "checkpoints" / "config.json").read_text())),
                        device="cpu")
    from diffassemble_tpu_torch.nn.visual import norm_layers

    assert set(stats) == {p.split("/")[0] for p, _ in norm_layers(model.encoder)}
    with np.load(run / "norm_stats.npz") as z:
        assert len(z.files) == 2 * len(norm_layers(model.encoder))
        assert all(z[k].shape[:4] == (1, 1, 1, 1) and np.isfinite(z[k]).all() for k in z.files)


@pytest.fixture(scope="module")
def ema_run(tmp_path_factory):
    """A run of a small resnet18equiv model written by the port's checkpoint
    manager at step 3 from JAX ``init`` params: the live params from one key,
    an EMA from another, so that the two differ everywhere. Returns (run dir,
    the JAX model, the JAX EMA params)."""
    import jax

    from diffassemble_tpu.data import collate_puzzles as jcollate
    from diffassemble_tpu.models.diffusion_2d import Diffusion2D as JD
    from diffassemble_tpu.models.diffusion_2d import Diffusion2DConfig as JC

    from diffassemble_tpu_torch import convert
    from diffassemble_tpu_torch.train.checkpoint import CheckpointManager
    from diffassemble_tpu_torch.train.train_state import TrainState

    cfg = dict(backbone="resnet18equiv", n_layers=1, hidden_dim=32, heads=4, virt_nodes=2, steps=20,
               inference_ratio=10, rotation=True, compute_dtype="float32")
    jm = JD(JC(**cfg))
    _, test_ds, _ = jdatasets.get_dataset("synthetic", puzzle_sizes=[2], rotation=True, seed=0)
    first = jcollate([test_ds[0]], test_ds.max_nodes)
    init = jax.jit(lambda k: jm.init(k, first))
    live, ema = (jax.tree.map(np.asarray, init(jax.random.PRNGKey(k))) for k in (1, 2))
    model = Diffusion2D(Diffusion2DConfig(**cfg), device="cpu")
    trees = []
    for tree in (live, ema):
        model.load_state_dict(convert.convert_params(tree))
        trees.append({k: p.detach().clone() for k, p in model.named_parameters()})
    run = tmp_path_factory.mktemp("ema") / "run"
    ckpt = CheckpointManager(run / "checkpoints")
    ckpt.save_config(model.cfg)
    ckpt.save(3, TrainState(trees[0], {}, 3, torch.Generator().manual_seed(0), trees[1]))
    return run, jm, ema


@pytest.mark.parametrize("explicit", [False, True])
def test_evaluate_matches_the_jax_package(ema_run, explicit, tmp_path):
    """``evaluate --calibrate_norm 2`` against the pieces of the JAX package's
    ``cli/evaluate.py`` on the same run, from its latest checkpoint and from
    ``--checkpoint_path``: both evaluate the EMA, as ``eval_params`` does.
    The test batch equals the JAX ``get_dataset``'s exactly; the calibrated
    OrientationNorm statistics in ``norm_stats.npz`` equal JAX
    ``calibrate_norm_stats``' within 1e-5 of each array's largest entry
    (f32); the sample equals
    the JAX sample within 1e-4, and its metrics exactly. With noise_weight 0
    and DDIM (the trained checkpoints' sampler) neither sampler draws
    anything, so the two run on the same draws."""
    import jax
    import jax.numpy as jnp

    from diffassemble_tpu.data import PuzzleBatch as JBatch
    from diffassemble_tpu.data import collate_puzzles as jcollate
    from diffassemble_tpu.nn import visual as jvisual

    run, jm, ema = ema_run
    seen = []
    sample = Diffusion2D.sample

    def spy(self, batch, *args, **kwargs):
        res = sample(self, batch, *args, **kwargs)
        seen.append((batch, res.final))
        return res

    flags = ["--puzzle_sizes", "2", "--batch_size", "2", "--n_batches", "1", "--calibrate_norm", "2",
             "--save_images", "false", "--device", "cpu"]
    if explicit:
        flags += ["--checkpoint_path", str(run / "checkpoints" / "3")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Diffusion2D, "sample", spy)
        got = tevaluate.main(["--run_dir", str(run), *flags])
    (batch, final), = seen

    train_ds, test_ds, _ = jdatasets.get_dataset("synthetic", puzzle_sizes=[2], rotation=True, seed=0)
    nb = jcollate([test_ds[i] for i in range(2)], test_ds.max_nodes)
    for k, want in nb._asdict().items():
        assert np.array_equal(getattr(batch, k).numpy(), want), k
    calib = []
    for bi in range(2):
        cb = jcollate([train_ds[i % len(train_ds)] for i in range(2 * bi, 2 * bi + 2)], train_ds.max_nodes)
        p = cb.patches.astype(np.float32) / 255.0
        calib.append(jnp.asarray(p.reshape(-1, *p.shape[2:])))
    jvisual.save_norm_stats(tmp_path / "jax.npz", jm.calibrate_norm_stats({"encoder": ema["encoder"]}, calib))
    with np.load(run / "norm_stats.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) and a.files
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5 * np.abs(b[k]).max(), err_msg=k)
    jb = JBatch(*[jnp.asarray(a) for a in nb])
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    want = jax.jit(lambda p, b, k: jm.sample(p, b, k).final)(ema, jb, sub)
    jm.norm_stats = None
    np.testing.assert_allclose(final.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    m = jm.metrics_from_final(want, jb)
    assert got == [{"piece_acc": float(np.asarray(m["piece_acc"]).mean()),
                    "puzzle_acc": float(np.asarray(m["puzzle_correct"]).mean())}]


@pytest.mark.parametrize("pil", [True, False])
def test_train_device_draws_the_first_puzzles_of_each_evaluation(pil, tmp_path, monkeypatch, request):
    """The recipe CLI (``cli/train_device.py``) with ``--viz_every_eval 2``
    draws the first two held-out puzzles of each evaluation through
    ``save_reconstructions``, as ``Trainer._save_viz`` does: PNGs, or
    ``.npy`` pixels without PIL."""
    import time

    from diffassemble_tpu_torch.cli import train_device

    if not pil:
        request.getfixturevalue("no_pil")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DIFFASSEMBLE_DEADLINE_EPOCH", str(time.time() + 86400))
    train_device.main(["--run_dir", "run", "--hw", "3", "--backbone", "tiny", "--degree", "60%", "--n_layers", "1",
                       "--steps", "20", "--batch_size", "2", "--train_n", "4", "--eval_n", "2", "--eval_every", "2",
                       "--compute_dtype", "float32", "--viz_every_eval", "2", "--max_steps", "2", "--device", "cpu"])
    ext = ".png" if pil else ".png.npy"
    assert sorted(_files(tmp_path / "run" / "viz")) == sorted(f"{tag}_step2_p{i}{ext}" for tag in ("final", "val")
                                                             for i in range(2))
