"""The port's device-resident training path against the JAX package's, on the
CPU: the mixed-size corpus and its gather (``train/device_data.py``), one
``make_device_train_step`` step, the round deadline (``utils/deadline.py``),
the profiling hooks, reconstruction images, and the recipe CLI
``cli/train_device.py`` with a resume.

Tolerances: the corpus and gathered batches bit-equal (the port is given the
JAX package's rotation draw; ARPACK's start vector is fixed in both packages,
``torch_assets.fixed_eigsh``); the train step's loss and gradient norms
within 2e-4 relative, as ``test_torch_train.py::test_train_step_matches_jax``
holds them, and the parameters and EMA within 5e-4 of each parameter's
largest update plus 1e-6 relative (``torch_parity.assert_same_step``). The
step's batch is 64 patches of which 30 are zero padding, and "batch"-mode
BatchNorm over so many equal patches is ill-conditioned in float32: the JAX
encoder's features on these patches change by 8e-4 of their largest entry
(10.6) when the same patches come in another order, and the port's differ
from the JAX package's by 1.2e-3. The fusion MLP's and the aux head's
weights read those features, and their step lands 2.0e-4 of the largest
update from the JAX package's (every other parameter's within 1.3e-5). The
deadline is exactly equal.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.models.diffusion_2d import Diffusion2D as JDiffusion2D
from diffassemble_tpu.models.diffusion_2d import Diffusion2DConfig as JConfig
from diffassemble_tpu.train import device_data as jdd
from diffassemble_tpu.train import train_state as jts
from diffassemble_tpu.utils import deadline as jdeadline
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.cli import train_device
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
from diffassemble_tpu_torch.train import device_data as tdd
from diffassemble_tpu_torch.train import train_state
from diffassemble_tpu_torch.utils import deadline as tdeadline
from diffassemble_tpu_torch.utils import profiling, viz
from torch_assets import fixed_eigsh
from torch_parity import CFG, assert_same_step, jax_draws, seeded_params, torch_draws

SIZES = [(3, 3), (2, 2), (4, 4)]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(n):
    rng = np.random.default_rng(3)
    return [rng.random((128, 128, 3)).astype(np.float32) for _ in range(n)]


def _mixed(n=6, degree="60%"):
    images = _images(n)

    def factory(size_hw, i):
        return images[i][:size_hw[0], :size_hw[1]]

    with fixed_eigsh():
        jd = jdd.build_device_data_mixed(factory, SIZES, n, degree=degree, seed=2)
        td = tdd.build_device_data_mixed(factory, SIZES, n, degree=degree, seed=2, device="cpu")
    return jd, td


def _bit_equal(want, got, name):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape and np.array_equal(want, got), name


@pytest.mark.parametrize("degree", ["60%", -1])
def test_build_device_data_mixed_matches(degree):
    jd, td = _mixed(degree=degree)
    assert td.n_samples == 6 and td.n_nodes == 16
    for name in jdd.DeviceMixedPuzzleData._fields:
        _bit_equal(getattr(jd, name), getattr(td, name), name)
    assert not td.node_mask[1, 4:].any() and not td.adj[1, 4:].any() and not td.patches[1, 4:].any()


@pytest.mark.parametrize("rotation", [True, False])
def test_gather_batch_mixed_matches_given_the_jax_draw(rotation):
    jd, td = _mixed()
    idx = np.array([1, 5, 0, 4], dtype=np.int32)
    key = jax.random.PRNGKey(11)
    want = jdd.gather_batch_mixed(jd, jnp.asarray(idx), key if rotation else None)
    rot_k = torch.from_numpy(np.array(jax.random.randint(key, (4, 16), 0, 4))) if rotation else None
    got = tdd.gather_batch_mixed(td, torch.from_numpy(idx).long(), rot_k)
    for name in want._fields:
        _bit_equal(getattr(want, name), getattr(got, name), name)
    if rotation:  # padding nodes: rotation 0 and a zero target, whatever was drawn
        assert not got.x0[0, 4:].any() and int(rot_k[0, 4:].max()) > 0


def test_one_topology_shared_by_two_corpora():
    """The recipe CLI draws the topologies once and hands them to both
    corpora; with them given, a corpus function draws none of its own."""
    topo = tdd.size_topologies(SIZES, "60%", seed=2)
    images = _images(3)
    a = tdd.build_device_data_mixed(lambda hw, i: images[i][:hw[0], :hw[1]], SIZES, 3, degree="60%",
                                    device="cpu", topologies=topo)
    b = tdd.build_device_data(images, (4, 4), 2, patch_size=32, degree="60%", seed=5, device="cpu",
                              topology=topo[(4, 4)])
    assert torch.equal(a.adj[2], b.adj) and torch.equal(a.adj[0, :9, :9], torch.from_numpy(topo[(3, 3)]))


def test_device_train_step_matches_jax():
    """One step on the mixed corpus given the JAX step's own draws (its key
    split into index, rotation, loss and next keys), with the clip at 1 so
    that it bites, Adafactor with the HF schedule and the debiased EMA."""
    jd, td = _mixed()
    jm = JDiffusion2D(JConfig(**CFG))
    n = jd.n_nodes
    enc = seeded_params(jm.encoder, 8, jnp.zeros((1, 32, 32, 3)))
    den = seeded_params(jm.denoiser, 9, jnp.zeros((1, n, 4)), jnp.zeros((1, n), jnp.int32),
                        jnp.zeros((1, n, 1088)), jnp.ones((1, n, n), bool), jnp.ones((1, n), bool))
    params = {"encoder": enc, "denoiser": den}
    model = Diffusion2D(Diffusion2DConfig(**CFG), device="cpu")
    model.load_state_dict(convert.convert_params(jax.tree_util.tree_map(np.asarray, params)))

    b = 4
    jopt = jm.make_optimizer()
    jstate = jts.create_train_state(params, jopt, jax.random.PRNGKey(1), ema=True)
    k_idx, k_rot, k_loss, _ = jax.random.split(jstate.rng, 4)
    draws = {"idx": torch.from_numpy(np.array(jax.random.randint(k_idx, (b,), 0, jd.n_samples))),
             "rot_k": torch.from_numpy(np.array(jax.random.randint(k_rot, (b, n), 0, 4))),
             **torch_draws(jax_draws(k_loss, b, (b, n, 4), CFG["steps"], CFG["classifier_free_prob"]))}
    assert draws["cf_keep"].any() and not draws["cf_keep"].all()  # the encoder gets a gradient
    assert len(set(td.hw[draws["idx"]][:, 0].tolist())) > 1  # puzzles of several sizes in the batch
    jstep = jdd.make_device_train_step(jm.loss, jopt, rotation=True, max_grad_norm=1.0, ema_decay=0.999)
    jnew, jaux = jstep(jstate, jd, b)

    opt = model.make_optimizer()
    state = train_state.create_train_state(model, opt, torch.Generator().manual_seed(0), ema=True)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = tdd.make_device_train_step(model.loss, opt, rotation=True, max_grad_norm=1.0, ema_decay=0.999)
    state, aux = step(state, td, b, draws)
    assert state.step == 1 and "grad_nonfinite" not in aux
    for key in ("loss", "total_loss", "aux_loss", "grad_norm", "grad_norm/encoder", "grad_norm/denoiser"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=2e-4, err_msg=key)
    assert abs(float(aux["grad_norm"]) - 1.0) < 1e-5  # clipped to the norm
    ref = convert.convert_params(jax.tree_util.tree_map(np.asarray, jnew.params))
    ref_ema = convert.convert_params(jax.tree_util.tree_map(np.asarray, jnew.ema_params))
    gmax = max(float(p.grad.abs().max()) for p in model.parameters())
    for name, p in model.named_parameters():
        g_tol = 2e-4 * float(p.grad.abs().max()) + 1e-6 * gmax
        unfactored = name in state.opt_state["v"]
        assert_same_step(p.detach(), ref[name], before[name], p.grad, unfactored, g_tol, 5e-4, name)
        assert_same_step(state.ema_params[name], ref_ema[name], before[name], p.grad, unfactored, g_tol,
                         5e-4, name)


def test_device_train_step_draws_from_the_state_generator():
    """Without draws the step draws indices, rotations and the loss's draws
    from the state's generator: the same seed gives the same step."""
    _, td = _mixed(degree=-1)
    cfg = {**CFG, "n_layers": 1}
    out = []
    for seed in (4, 4, 5):
        model = Diffusion2D(Diffusion2DConfig(**cfg), device="cpu", seed=1)
        opt = model.make_optimizer()
        state = train_state.create_train_state(model, opt, torch.Generator().manual_seed(seed))
        step = tdd.make_device_train_step(model.loss, opt, rotation=True)
        state, aux = step(state, td, 2)
        out.append(float(aux["total_loss"]))
    assert out[0] == out[1] != out[2]


def _progress(tmp_path, wall_s=50000.0):
    p = tmp_path / "PROGRESS.jsonl"
    p.write_text("\n".join(json.dumps({"ts": 1.7e9 + i, "wall_s": wall_s + i}) for i in range(3)) + "\n\n")
    return str(p)


@pytest.mark.parametrize("case", ["progress", "env", "fresh_file", "stale_file", "unreadable"])
def test_round_deadline_matches_jax(case, tmp_path, monkeypatch):
    """The same PROGRESS file, overrides and clock in both modules (the JAX
    module imports no JAX)."""
    now = 1.7e9 + 1000.0
    monkeypatch.setattr(time, "time", lambda: now)
    monkeypatch.delenv("DIFFASSEMBLE_DEADLINE_EPOCH", raising=False)
    progress = _progress(tmp_path) if case != "unreadable" else str(tmp_path / "missing.jsonl")
    for mod in (jdeadline, tdeadline):
        monkeypatch.setattr(mod, "_PROGRESS", progress)
    if case == "env":
        monkeypatch.setenv("DIFFASSEMBLE_DEADLINE_EPOCH", "1700005000.5")
    if case.endswith("_file"):
        (tmp_path / ".deadline_epoch").write_text(str(now + 300 if case == "fresh_file" else now - 700))
    want = {"progress": 1.7e9 + 2 - 50002.0 + 2 * 43200.0, "env": 1700005000.5, "fresh_file": now + 300,
            "stale_file": 1.7e9 + 2 - 50002.0 + 2 * 43200.0, "unreadable": now + 3600.0}[case]
    assert tdeadline.round_deadline() == jdeadline.round_deadline() == want
    assert tdeadline.time_left(600.0) == jdeadline.time_left(600.0) == want - 600.0 - now
    # an explicit path bypasses both overrides
    assert tdeadline.round_deadline(_progress(tmp_path, 100.0)) == jdeadline.round_deadline(
        _progress(tmp_path, 100.0)) == 1.7e9 + 2 - 102.0 + 43200.0


def test_profiling_hooks(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        with profiling.annotate("square"):
            return {"y": [x * x]}

    best, result = profiling.timed(fn, torch.ones(3), iters=2, warmup=1)
    assert len(calls) == 3 and best >= 0.0 and torch.equal(result["y"][0], torch.ones(3))
    with profiling.trace(str(tmp_path / "trace")) as d:
        fn(torch.ones(4))
    assert "square" in (tmp_path / "trace" / "trace.json").read_text() and d == str(tmp_path / "trace")


def test_save_reconstruction_needs_pil_and_says_so(tmp_path, monkeypatch):
    """A PNG through PIL; where PIL is missing (as on the card) no PNG and
    no error, but the same pixels as ``<path>.npy``, as the JAX package
    falls back (``tests/test_torch_viz_cli.py`` holds the bytes to its)."""
    rng = np.random.default_rng(0)
    patches = rng.integers(0, 255, (4, 8, 8, 3), dtype=np.uint8)
    grid = np.array([[-1, -1], [1, -1], [-1, 1], [1, 1]], np.float32)
    viz.save_reconstruction(tmp_path / "a.png", patches, grid, grid, (2, 2))
    assert (tmp_path / "a.png").read_bytes()[:4] == b"\x89PNG"
    from PIL import Image

    png = np.asarray(Image.open(tmp_path / "a.png"))
    monkeypatch.setitem(sys.modules, "PIL", None)  # PIL missing
    viz.save_reconstruction(tmp_path / "b.png", patches, grid, grid, (2, 2))
    assert not (tmp_path / "b.png").exists()
    assert np.array_equal(np.load(tmp_path / "b.png.npy"), png)


def test_recipe_cli_trains_evaluates_and_resumes(tmp_path, monkeypatch):
    """The recipe CLI at 3×3, one layer, f32: the corpus cache, data.json,
    evaluations at the real step, top-k checkpoints, then a resume."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DIFFASSEMBLE_DEADLINE_EPOCH", str(time.time() + 86400))
    flags = ["--run_dir", "run", "--hw", "3", "--backbone", "efficientnet_b0", "--degree", "60%",
             "--n_layers", "1", "--steps", "20", "--batch_size", "2", "--train_n", "4", "--eval_n", "2",
             "--eval_every", "2", "--log_every", "1", "--compute_dtype", "float32", "--ema_decay", "0.999",
             "--aux_loss_weight", "0.1", "--viz_every_eval", "0", "--device", "cpu"]
    m = train_device.main(flags + ["--max_steps", "2"])
    assert m["overall_nImages"] == 2
    assert sorted(p.name for p in (tmp_path / "runs" / "_corpus").iterdir()) == [
        "eval-hw3-n2-s1000-d60pct-g2.npz", "train-hw3-n4-s0-d60pct-g2.npz"]
    assert json.loads((tmp_path / "run" / "checkpoints" / "data.json").read_text()) == {
        "dataset": "synthetic", "hw": [3], "degree": "60%", "canonical": 0.5, "hf_detail": 0.0,
        "style": "default", "train_n": 4, "seed": 0}
    train_device.main(flags + ["--max_steps", "3"])  # resumes at 2, the cached corpus
    recs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3]
    assert [(r["step"], k.split("/")[0]) for r in recs for k in r if k.endswith("overall_nImages")] == [
        (2, "val"), (2, "final"), (3, "val"), (3, "final")]
    assert sorted(int(p.name) for p in (tmp_path / "run" / "checkpoints").iterdir() if p.name.isdigit()) == [2, 3]
    with np.load(tmp_path / "runs" / "_corpus" / "eval-hw3-n2-s1000-d60pct-g2.npz") as z, \
            np.load(tmp_path / "runs" / "_corpus" / "train-hw3-n4-s0-d60pct-g2.npz") as t:
        assert np.array_equal(z["adj"], t["adj"])  # one expander for both corpora
