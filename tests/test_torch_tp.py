"""Tensor parallelism of the port against the JAX package's, on the CPU.

The JAX side runs on the 8-virtual-device CPU mesh (as ``test_sharding.py``
does); the port on gloo ranks spawned by ``parallel/dryrun.py:run_on_ranks``
(what each rank runs is in ``torch_tp_ranks.py``).

- ``param_sharding_rules`` equals the JAX package's per parameter, through
  ``convert.py``'s name map, for the 2D and 3D denoisers at tp = 2: the JAX
  kernel's ``P(None, 'tp')`` is dim 0 of the port's (out, in) weight,
  ``P('tp', None)`` dim 1, a bias's ``P('tp')`` dim 0, ``P()`` None.
- The port's tp = 2 denoiser forward and loss gradients, on weights
  converted from JAX, match JAX's unsharded ``denoise`` and ``jax.grad`` of
  its ``loss`` (the values ``test_tp_sharded_forward_matches`` and
  ``test_tp_sharded_gradients_match`` compute), under those tests'
  tolerances: atol 1e-5 for the forward, atol 2e-4 and rtol 1e-3 for the
  gradients. The tp collectives are exact: a bf16 all-gather bit for bit,
  ``unshard_params`` back to the loaded weights; replicated gradients that
  differ between the ranks take their mean (``sync_replicated``).
- ``dryrun_multichip(4)``: dp 2 × tp 2 against one process, for the 2D step
  with equal and unequal valid nodes, the 2D DDIM sampler, the 3D step with
  the relative-pose losses and the 3D sampler (``parallel/dryrun.py``'s
  tolerances).
- A ``Trainer`` on dp 1 × tp 2: its step against one process under the
  dryrun's efficientnet_b0 tolerances, its evaluation (both ranks of the tp
  group run the sampler; piece accuracy within one piece of the 18), a
  checkpoint of the whole parameters that loads in one process, and a
  restore that slices them again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.data import collate_puzzles as jcollate_puzzles
from diffassemble_tpu.data import get_dataset as jget_dataset
from diffassemble_tpu.data.batch import FragmentBatch as JFragmentBatch
from diffassemble_tpu.data.batch import PuzzleBatch as JPuzzleBatch
from diffassemble_tpu.models.diffusion_2d import Diffusion2D as JDiffusion2D
from diffassemble_tpu.models.diffusion_2d import Diffusion2DConfig as JConfig
from diffassemble_tpu.models.diffusion_3d import Diffusion3D as JDiffusion3D
from diffassemble_tpu.models.diffusion_3d import Diffusion3DConfig as JConfig3D
from diffassemble_tpu.parallel import mesh as jmesh
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.data import PuzzleBatch
from diffassemble_tpu_torch.data.breaking_bad import collate_fragments, get_dataset_3d
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig, Diffusion3D, Diffusion3DConfig
from diffassemble_tpu_torch.parallel import dryrun, mesh
from torch_parity import CFG, jax_draws
import torch_tp_ranks

# test_sharding.py's model: tiny backbone, 2 transformer layers of 4 heads, hidden 32
SHARDING_CFG = dict(steps=10, inference_ratio=5, mean_type="xstart", backbone="tiny", n_layers=2, hidden_dim=32,
                    heads=4)
CFG_3D = dict(steps=20, backbone="vn_dgcnn_rich", n_layers=2, hidden_dim=32, heads=4, max_num_part=3,
              rel_condition=True, rel_pose_weight=0.5, aux_pose_weight=0.5, compute_dtype="float32")
DATA_3D = dict(num_points=32, min_num_part=2, max_num_part=3, train_n=2, test_n=1, seed=1)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_batch_2d(b: int):
    """test_sharding.py's ``_model_and_batch`` batch: b synthetic 2×2 puzzles padded to 4 nodes."""
    train, _, _ = jget_dataset("synthetic", puzzle_sizes=[2], train_n=b)
    return jcollate_puzzles([train[i] for i in range(b)], n_max=4)


def _jax_dims(specs, shapes) -> dict:
    """The JAX package's rules as the port's dims, by the port's parameter
    names: each leaf becomes an array filled with 1 + the JAX axis on 'tp'
    (0 where replicated), which ``convert.convert_params`` renames and
    transposes as it does the weights."""

    def code(s, leaf):
        spec = tuple(s.spec)
        return np.full(leaf.shape, 1 + spec.index("tp") if "tp" in spec else 0, dtype=np.float32)

    return jax.tree.map(code, specs, shapes)


def _port_dims(converted: dict) -> dict:
    out = {}
    for name, codes in converted.items():
        c = int(codes.flatten()[0]) if codes.numel() else 0
        assert bool((codes == c).all()), name
        # a Dense kernel (in, out) is the port's (out, in) weight: JAX axis a is port dim 1 − a
        out[name] = None if c == 0 else (1 - (c - 1) if codes.dim() == 2 else c - 1)
    return out


def _cases():
    return {
        "2d_tiny_transformer": ("2d", SHARDING_CFG),
        "2d_exophormer_aux": ("2d", CFG),
        "3d_relpose": ("3d", CFG_3D),
        "3d_dual_stream": ("3d", {**CFG_3D, "backbone": "vn_dgcnn", "equiv_inv_mp": True, "rel_condition": False,
                                  "rel_pose_weight": 0.0, "aux_pose_weight": 0.0}),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_rules_equal_the_jax_rules_per_parameter(case):
    family, cfg = _cases()[case]
    if family == "2d":
        jm = JDiffusion2D(JConfig(**cfg))
        jb = JPuzzleBatch(*[jnp.asarray(a) for a in _jax_batch_2d(2)])
        port = Diffusion2D(Diffusion2DConfig(**cfg), device="cpu")
        heads = None
    else:
        jm = JDiffusion3D(JConfig3D(**cfg))
        train, _, _ = get_dataset_3d("synthetic", **DATA_3D)
        nb = collate_fragments([train[i] for i in range(2)], cfg["max_num_part"])
        jb = JFragmentBatch(*[jnp.asarray(np.asarray(a)) for a in nb])
        port = Diffusion3D(Diffusion3DConfig(**cfg), device="cpu")
        heads = convert.HEADS_3D
    shapes = jax.eval_shape(lambda k: jm.init(k, jb), jax.random.PRNGKey(0))
    jax_specs = jmesh.param_sharding_rules(jmesh.make_mesh(8, dp=4, tp=2), shapes)
    want = _port_dims(convert.convert_params(_jax_dims(jax_specs, shapes), heads))
    got = mesh.param_sharding_rules(mesh.Mesh(dp=4, tp=2), port)
    assert got.keys() == want.keys()
    assert got == want
    sharded = {k for k, d in got.items() if d is not None}
    assert any(".query.weight" in k for k in sharded) and "denoiser.fusion.fc2.weight" in sharded
    assert got["denoiser.fusion.fc2.weight"] == 1 and got["denoiser.fusion.fc2.bias"] is None
    assert mesh.param_sharding_rules(mesh.Mesh(), port) == dict.fromkeys(got)


@pytest.fixture(scope="module")
def tp_against_jax():
    """JAX's unsharded forward and gradients on test_sharding.py's model and
    batch (4 puzzles), and the port's on 2 gloo ranks at tp = 2."""
    jm = JDiffusion2D(JConfig(**SHARDING_CFG))
    nb = _jax_batch_2d(4)
    jb = JPuzzleBatch(*[jnp.asarray(a) for a in nb])
    params = jm.init(jax.random.PRNGKey(0), jb)
    feats = jm.visual_features(params, jb.patches)
    x = jnp.zeros_like(jb.x0)
    t = jnp.zeros(jb.x0.shape[:2], dtype=jnp.int32)
    ref = np.asarray(jm.denoise(params, x, t, feats, jb.adj, jb.node_mask))
    rng = jax.random.PRNGKey(1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb, rng)[0]))(params)
    draws = jax_draws(rng, 4, nb.x0.shape, SHARDING_CFG["steps"], 0.0)
    state = convert.convert_params(jax.tree.map(np.asarray, params))
    assert JPuzzleBatch._fields == PuzzleBatch._fields
    ranks = dryrun.run_on_ranks(torch_tp_ranks.denoise_and_grads, 2, 2, SHARDING_CFG, state, tuple(nb),
                                np.asarray(feats), draws)
    return {"ref": ref, "loss": float(loss_j), "grads": convert.convert_params(jax.tree.map(np.asarray, grads_j)),
            "state": state, "ranks": ranks}


def test_tp_forward_matches_the_jax_unsharded_forward(tp_against_jax):
    ref, ranks = tp_against_jax["ref"], tp_against_jax["ranks"]
    assert torch.equal(ranks[0]["denoise"], ranks[1]["denoise"])
    np.testing.assert_allclose(ranks[0]["denoise"].numpy(), ref, atol=1e-5, rtol=0)
    # each rank holds half of every projection's rows and half of fc2's columns
    state, shapes = tp_against_jax["state"], ranks[0]["shapes"]
    for k, d in ranks[0]["dims"].items():
        want = list(state[k].shape)
        if d is not None:
            want[d] //= 2
        assert shapes[k] == tuple(want), k
    assert sum(d is not None for d in ranks[0]["dims"].values()) == 2 * 8 + 3


def test_tp_gradients_match_jax_grad_of_the_unsharded_loss(tp_against_jax):
    grads, ranks = tp_against_jax["grads"], tp_against_jax["ranks"]
    np.testing.assert_allclose(ranks[0]["loss"], tp_against_jax["loss"], rtol=1e-5)
    assert grads.keys() == ranks[0]["grads"].keys()
    for k, g in grads.items():
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
        np.testing.assert_allclose(ranks[0]["grads"][k].numpy(), g.numpy(), atol=2e-4, rtol=1e-3, err_msg=k)


def test_tp_collectives_are_exact(tp_against_jax):
    ranks = tp_against_jax["ranks"]
    piece = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7
    want = torch.cat([piece.to(torch.bfloat16), (piece + 1).to(torch.bfloat16)], dim=1)
    for r in ranks:
        assert r["gathered"].dtype == torch.bfloat16 and torch.equal(r["gathered"], want)
        assert r["unsharded_equal"]
        assert torch.equal(r["synced"]["replicated"], torch.full((2, 3), 1.5))
    assert [float(r["synced"]["sharded"][0]) for r in ranks] == [5.0, 6.0]


def test_dryrun_dp2_tp2_matches_one_process():
    out = dryrun.dryrun_multichip(4)
    assert set(out) == {"equal", "unequal", "sampler", "unequal_contacts_3d", "sampler_3d"}
    assert all(v <= 1.0 for worst in out.values() for v in worst.values())


def test_trainer_on_tp2_steps_evaluates_saves_and_restores(tmp_path):
    ranks = dryrun.run_on_ranks(torch_tp_ranks.trainer_step_eval_save_restore, 2, 2, str(tmp_path / "tp"))
    ref = torch_tp_ranks.trainer_step_eval_save_restore(mesh.Mesh(), str(tmp_path / "one"))
    worst = dryrun.compare_steps(ranks, ref, *dryrun.GRAD_TOL["efficientnet_b0"])
    assert all(v <= 1.0 for v in worst.values())
    assert ranks[0]["local_shapes"]["denoiser.fusion.fc1.weight"] == (64, 1152)
    # the tp group evaluates together: the same metrics on both ranks, within a piece of one process's
    assert ranks[0]["metrics"] == ranks[1]["metrics"] and ranks[0]["metrics"].keys() == ref["metrics"].keys()
    for k, v in ref["metrics"].items():
        assert abs(ranks[0]["metrics"][k] - v) <= (1 / 18 if "acc" in k else 1e-5 * max(abs(v), 1.0)), k
    # the checkpoint holds the whole parameters, loads in one process and restores the slices
    saved = torch.load(ranks[0]["checkpoint"], weights_only=True)
    single = Diffusion2D(Diffusion2DConfig(**torch_tp_ranks.TRAINER_CFG), device="cpu")
    single.load_state_dict(saved["params"], strict=True)
    for r in ranks:
        assert r["restored_step"] == 1
        for k, v in ranks[0]["params"].items():
            assert torch.equal(saved["params"][k], v) and torch.equal(r["restored"][k], v), k
            assert torch.equal(saved["ema_params"][k], ranks[0]["ema"][k]) and torch.equal(r["restored_ema"][k],
                                                                                          ranks[0]["ema"][k]), k
