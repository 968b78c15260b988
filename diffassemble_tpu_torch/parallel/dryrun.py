"""The torch twin of ``__graft_entry__.dryrun_multichip``: data- and
tensor-parallel training checked on the CPU.

``dryrun_multichip(n)`` spawns ``n`` processes that form a gloo group on
localhost, on a mesh of dp = n / tp × tp, tp = 2 where n is even and at
least 4 (as the JAX dryrun chooses), else 1. Each runs one full train step
(``train_state.make_train_step`` over ``parallel.mesh.data_parallel_loss``,
the Trainer's step) under DDP on its dp slice of a tiny batch, with tp > 1
on a model sharded over its tp group (``parallel.mesh.shard_params``); the
parent runs the same step in one process on the whole batch and checks that
every rank ends with the same whole parameters and that they, the loss and
the gradients equal the single-process step's. It does so twice: with as
many valid nodes on every dp place, and with puzzles of different sizes on
the dp places (different numbers of valid nodes), which only a global
BatchNorm and a global masked mean get right. With tp > 1 it also runs the
2D DDIM sampler and the 3D sampler on the whole batch on every rank of the
sharded model (the ranks' poses bit-equal, within ``SAMPLE_TOL`` of one
process) and the 3D step with the relative-pose losses below. ``backbone`` swaps
the tiny model's efficientnet_b0 for another encoder (resnet18equiv: its
OrientationNorm statistics are global too). ``dryrun_multichip_3d(n)`` does
the same for a small 3D model with the relative-pose losses, on objects
whose ground-truth contact counts differ between the ranks, which only the
losses' global contact and pair counts get right. Run it as
``python -m diffassemble_tpu_torch.parallel.dryrun [n] [backbone or 3d]``.

Tolerances (``GRAD_TOL[backbone]`` = (rel, abs, norm_rel)): the loss and
its parts within 1e-5 relative, the gradient norms within norm_rel (1e-5 for
the 2D models); each parameter's gradient within rel of its largest
entry plus abs of the model's largest (sums over the ranks in another
order); parameters after the step within rel of the parameter's largest
step plus 1e-6 relative, except where an unfactored parameter's gradient is
within the gradient tolerance of 0: the first Adafactor step of such an
entry is the sign of its gradient, and there the step is only held to the
largest step. (1e-4, 1e-6) for efficientnet_b0; (3e-2, 1e-5) for
resnet18equiv, whose gradients are ill-conditioned in one process already:
with every parameter moved by one ulp (four draws), a conv kernel's gradient
moves by up to 5.5e-3 of its largest entry and gradients that nearly cancel
by more than their own size, and 17 layers of batch statistics' backward sit
between the loss and the stem; (2e-3, 1e-6) for the 3D model (its
VN-DGCNN encoder, from the 3D recipe's pretrained weights, standardizes
vector norms six times: the same rounding moves its gradients by up to
1.3e-3 of the largest entry, ``tests/test_torch_3d_train.py``), its
gradient norms within 2e-4 relative.
"""

from __future__ import annotations

import socket
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

CFG = dict(steps=20, inference_ratio=10, mean_type="xstart", rotation=True, backbone="efficientnet_b0",
           architecture="exophormer", n_layers=1, virt_nodes=2, hidden_dim=32, heads=4, aux_loss_weight=0.1,
           classifier_free_prob=0.5, compute_dtype="float32", warmup_steps=0)
# the 3D case: the 3D recipe's losses (relative pose, aux pose, rot_pt_l2) on a small model
ROOT = Path(__file__).resolve().parents[2]
CFG_3D = dict(steps=20, backbone="vn_dgcnn_rich", n_layers=1, hidden_dim=32, heads=2, max_num_part=3,
              rel_condition=True, rel_pose_weight=0.5, aux_pose_weight=0.5, rot_pt_l2_weight=1.0,
              compute_dtype="float32", encoder_init=str(ROOT / "weights" / "vn_dgcnn_rich_rel3d_512.npz"))
DATA_3D = dict(num_points=32, min_num_part=2, max_num_part=3, train_n=16, test_n=1, seed=1, canonical=0.9,
               wall_detail=0.08, wall_boost=3)
FAMILY_3D = "3d"


def _batch(world: int, unequal: bool):
    """2 puzzles per dp place; with ``unequal`` place r's are of size 3×3 for
    even r and 2×2 for odd r (9 or 4 valid nodes of 9), else all 3×3."""
    from ..train.device_data import build_device_data_mixed, gather_batch_mixed

    sizes = [(3, 3), (2, 2)] if unequal else [(3, 3)]
    k, n = len(sizes), 2 * world * len(sizes)
    rng = np.random.default_rng(0)
    images = [rng.random((96, 96, 3)).astype(np.float32) for _ in range(n)]
    data = build_device_data_mixed(lambda hw, i: images[i][:hw[0], :hw[1]], sizes, n, device="cpu")
    pools = [[i for i in range(n) if i % k == s] for s in range(k)]  # sample i has size sizes[i % k]
    idx = [pools[r % k].pop() for r in range(world) for _ in range(2)]
    rot_k = torch.from_numpy(rng.integers(0, 4, (2 * world, data.n_nodes)))
    return gather_batch_mixed(data, torch.tensor(idx), rot_k)


def contact_counts(batch, world: int) -> list[int]:
    """The ground-truth contact pairs (``losses_3d.contact_matrix`` at
    ``CFG_3D``'s threshold) in each of ``world`` dp slices of a fragment batch."""
    from ..models.losses_3d import contact_matrix
    from ..models.diffusion_3d import Diffusion3DConfig

    contact = contact_matrix(batch.pcds, batch.x0[..., :4], batch.x0[..., 4:7], batch.node_mask,
                             thresh=Diffusion3DConfig(**CFG_3D).contact_thresh)
    return [int(c) for c in contact.reshape(world, -1).sum(-1)]


def _batch_3d(world: int):
    """2 objects per dp place, the first 2·world of the small training split
    (on 2 places their ground-truth contact counts are 4 and 2)."""
    from ..data.breaking_bad import collate_fragments, get_dataset_3d

    train, _, _ = get_dataset_3d("synthetic", **DATA_3D)
    samples = [train[i] for i in range(2 * world)]
    return collate_fragments(samples, CFG_3D["max_num_part"], rng=np.random.default_rng(0)).to("cpu")


def _model(family: str):
    """The tiny 2D model with backbone ``family``, or with ``FAMILY_3D`` the
    small 3D model (seeded, then its ``encoder_init``)."""
    if family == FAMILY_3D:
        from ..models.diffusion_3d import Diffusion3D, Diffusion3DConfig

        model = Diffusion3D(Diffusion3DConfig(**CFG_3D), device="cpu", seed=0)
        model.init(0)
        return model
    from ..models.diffusion_2d import Diffusion2D, Diffusion2DConfig

    return Diffusion2D(Diffusion2DConfig(**{**CFG, "backbone": family}), device="cpu", seed=0)


def tp_for(n_devices: int) -> int:
    """The JAX dryrun's tp for ``n_devices``: 2 where it is even and at least 4."""
    return 2 if n_devices % 2 == 0 and n_devices >= 4 else 1


def _cases(family: str, dp: int, tp: int = 1) -> dict:
    """Each case's (family, kind, whole batch), kind "step" or "sample": for
    the 3D model one step, with unequal contact counts; for a 2D one a step
    of each of ``CASES``, and with tp > 1 the 2D sampler, the 3D step and
    the 3D sampler too."""
    if family == FAMILY_3D:
        return {"unequal_contacts": (FAMILY_3D, "step", _batch_3d(dp))}
    cases = {case: (family, "step", _batch(dp, unequal)) for case, unequal in CASES.items()}
    if tp > 1:
        cases["sampler"] = (family, "sample", _batch(dp, True))
        cases["unequal_contacts_3d"] = (FAMILY_3D, "step", _batch_3d(dp))
        cases["sampler_3d"] = (FAMILY_3D, "sample", _batch_3d(dp))
    return cases


def _step(batch, mesh=None, family: str = CFG["backbone"]) -> dict:
    """One train step of ``_model(family)`` on ``batch`` (sharded over the
    mesh's tp group where tp > 1): its aux, the whole parameters before and
    after, the whole gradients and the unfactored parameters' names."""
    from ..train.train_state import create_train_state, make_train_step
    from .mesh import Mesh, data_parallel_loss, gather_params, shard_batch, shard_params

    mesh = mesh or Mesh()
    model = _model(family)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    layout = shard_params(mesh, model)
    opt = model.make_optimizer()
    state = create_train_state(model, opt, torch.Generator().manual_seed(1))
    step = make_train_step(data_parallel_loss(model, mesh), opt, max_grad_norm=1.0, layout=layout)
    state, aux = step(state, shard_batch(mesh, batch))
    return {"aux": {k: float(v) for k, v in aux.items()}, "before": before,
            "params": {k: p.clone() for k, p in gather_params(model).items()},
            "grads": {k: g.clone() for k, g in gather_params(model, {k: p.grad for k, p in state.params.items()}).items()},
            "unfactored": sorted(state.opt_state["v"])}


def _sample(batch, mesh=None, family: str = CFG["backbone"]) -> dict:
    """The sampler of the seeded ``_model(family)`` (sharded where tp > 1)
    on the whole ``batch``, its noise from a generator seeded alike on every
    rank: the final poses."""
    from .mesh import Mesh, shard_params

    model = _model(family)
    shard_params(mesh or Mesh(), model)
    return {"final": model.sample(batch, torch.Generator().manual_seed(2)).final}


GRAD_TOL = {"efficientnet_b0": (1e-4, 1e-6, 1e-5), "resnet18equiv": (3e-2, 1e-5, 1e-5),
            FAMILY_3D: (2e-3, 1e-6, 2e-4)}
SAMPLE_TOL = 1e-5  # the samplers' final poses, absolute (tests/test_sharding.py's forward tolerance)
CASES = {"equal": False, "unequal": True}  # case → dp places hold puzzles of different sizes
_RUN = {"step": _step, "sample": _sample}


def _rank_cases(mesh, family: str) -> dict:
    """Every case of ``_cases`` on this rank of ``mesh``, by case."""
    return {case: _RUN[kind](batch, mesh, fam) for case, (fam, kind, batch) in _cases(family, mesh.dp, mesh.tp).items()}


def _run_rank(rank: int, world: int, port: int, out_dir: str, tp: int, fn, args: tuple) -> None:
    import torch.distributed as dist

    from .mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        torch.save(fn(make_mesh(world, dp=world // tp, tp=tp), *args), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_on_ranks(fn, n_devices: int, tp: int, *args, timeout: float | None = None) -> list:
    """``fn(mesh, *args)`` on each of ``n_devices`` spawned gloo ranks on a
    mesh of dp = n_devices / tp × tp; their results (anything ``torch.save``
    takes), by rank. ``fn`` is a module-level function. A rank that raises
    raises here; ranks still running after ``timeout`` seconds are taken to
    hang: all are stopped and AssertionError is raised."""
    import time

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        start = time.perf_counter()
        ctx = mp.start_processes(_run_rank, args=(n_devices, _free_port(), tmp, tp, fn, args), nprocs=n_devices,
                                 start_method="spawn", join=False)
        try:
            while not ctx.join(timeout=5):
                if timeout is not None and time.perf_counter() - start > timeout:
                    raise AssertionError(f"{fn.__name__}: the ranks did not end within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(n_devices)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int = 2, backbone: str = CFG["backbone"]) -> dict[str, dict[str, float]]:
    """Run the check for each case; raises AssertionError on a mismatch and
    returns each case's worst error/tolerance ratios."""
    tp = tp_for(n_devices)
    dp = n_devices // tp
    ranks = run_on_ranks(_rank_cases, n_devices, tp, backbone)
    refs = {case: (fam, kind, batch, _RUN[kind](batch, family=fam))
            for case, (fam, kind, batch) in _cases(backbone, dp, tp).items()}
    out = {}
    for case, (fam, kind, batch, ref) in refs.items():
        results = [r[case] for r in ranks]
        if kind == "sample":
            out[case] = _compare_finals(results, ref)
            print(f"dryrun_multichip {case}: final poses of {batch.x0.shape[0]} "
                  f"{'objects' if fam == FAMILY_3D else 'puzzles'} on every rank, worst err/tol "
                  f"{out[case]['final']:.3f}", flush=True)
            continue
        out[case] = compare_steps(results, ref, *GRAD_TOL[fam])
        per_rank = (f"contact pairs per dp place {contact_counts(batch, dp)}" if fam == FAMILY_3D
                    else f"valid nodes per dp place {batch.node_mask.reshape(dp, -1).sum(-1).tolist()}")
        print(f"dryrun_multichip {case}: {per_rank}, worst err/tol: loss "
              f"{out[case]['loss']:.3f}, gradients {out[case]['grads']:.3f}, parameters "
              f"{out[case]['params']:.3f}", flush=True)
    print(f"dryrun_multichip ok: world={n_devices}, mesh={{'dp': {dp}, 'tp': {tp}}}, "
          f"{'the 3D model' if backbone == FAMILY_3D else 'backbone'} "
          f"{'' if backbone == FAMILY_3D else backbone}".rstrip(), flush=True)
    return out


def _compare_finals(ranks: list[dict], ref: dict) -> dict[str, float]:
    """Every rank's final positions bit-equal to rank 0's, and within
    ``SAMPLE_TOL`` of the single-process ``ref``."""
    got = ranks[0]["final"]
    if not all(torch.equal(r["final"], got) for r in ranks[1:]):
        raise AssertionError("ranks disagree on the sampler's positions")
    err = float((got - ref["final"]).abs().max())
    if not err <= SAMPLE_TOL:
        raise AssertionError(f"the sampler's positions differ from one process by {err:.3e}")
    return {"final": err / SAMPLE_TOL}


def dryrun_multichip_3d(n_devices: int = 2) -> dict:
    """``dryrun_multichip`` of the 3D model on objects whose contact counts
    differ between the ranks; besides its worst error/tolerance ratios,
    returns the contact counts per rank and ``per_rank_denominators``: how
    far, in loss tolerances (1e-5 relative), the ranks' mean of their own
    relative-pose losses, each divided by the rank's own counts, lies from
    the whole batch's. Above 1, the check tells the two apart."""
    out = dryrun_multichip(n_devices, FAMILY_3D)
    n_devices //= tp_for(n_devices)  # the dp places
    batch = _batch_3d(n_devices)
    model = _model(FAMILY_3D)
    b = batch.x0.shape[0] // n_devices
    with torch.no_grad():
        draws = model.loss_draws(batch.x0.shape[0], batch.x0.shape, torch.Generator().manual_seed(1), "cpu")
        whole = model.loss(batch, **draws)[1]
        halves = [model.loss(type(batch)(*[f[r * b:(r + 1) * b] for f in batch]),
                             **{k: v[r * b:(r + 1) * b] for k, v in draws.items()})[1] for r in range(n_devices)]
    keys = ("rel_rot_loss", "rel_off_loss", "rel_conf_loss")
    local = {k: sum(float(h[k]) for h in halves) / n_devices for k in keys}
    out["contacts"] = contact_counts(batch, n_devices)
    out["per_rank_denominators"] = {k: abs(local[k] - float(whole[k])) / (1e-5 * abs(float(whole[k]))) for k in keys}
    print(f"dryrun_multichip_3d: contact pairs per rank {out['contacts']}; per-rank counts would miss the whole "
          f"batch's losses by {', '.join(f'{k} {v:.1f}' for k, v in out['per_rank_denominators'].items())} "
          "loss tolerances", flush=True)
    return out


def compare_steps(ranks: list[dict], ref: dict, rel: float = 1e-4, atol: float = 1e-6,
                  norm_rel: float = 1e-5, loss_rel: float = 1e-5, steps: bool = True) -> dict[str, float]:
    """Rank 0's step against the single-process ``ref`` (each as ``_step``
    returns it); every rank's parameters equal rank 0's. The aux's gradient
    norms within ``norm_rel`` relative, its other entries within
    ``loss_rel``; each gradient within ``rel`` of its largest entry plus
    ``atol`` of the model's largest; with ``steps``, the parameters after the
    step within ``rel`` of the parameter's largest step plus 1e-6 relative
    (see the module's docstring). Returns the worst error/tolerance ratios."""
    aux, before, params, grads = ref["aux"], ref["before"], ref["params"], ref["grads"]
    got = ranks[0]
    for r in ranks[1:]:
        if not all(torch.equal(r["params"][k], v) for k, v in got["params"].items()):
            raise AssertionError("ranks disagree")
    worst = {"loss": 0.0, "grads": 0.0, "params": 0.0}
    for key, want in aux.items():
        err = abs(got["aux"][key] - want) / ((norm_rel if key.startswith("grad_norm") else loss_rel) * abs(want) + 1e-30)
        worst["loss"] = max(worst["loss"], err)
        if not err <= 1.0:
            raise AssertionError(f"{key}: {got['aux'][key]} vs {want}")
    gmax = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        g_tol = rel * float(g.abs().max()) + atol * gmax
        g_err = float((got["grads"][k] - g).abs().max())
        worst["grads"] = max(worst["grads"], g_err / g_tol)
        if not g_err <= g_tol:
            raise AssertionError(f"{k}: gradient differs by {g_err:.3e} (tol {g_tol:.3e})")
        if not steps:
            continue
        d_want, d_got = params[k] - before[k], got["params"][k] - before[k]
        largest = float(d_want.abs().max())
        tol = rel * largest + 1e-6 * params[k].abs()
        sure = g.abs() > g_tol if k in ref["unfactored"] else torch.ones_like(g, dtype=torch.bool)
        err = (d_got - d_want).abs()
        if not bool((err <= tol)[sure].all()):
            raise AssertionError(f"{k}: the step differs by up to {float((err / tol)[sure].max()):.3g} times its "
                                 f"tolerance (largest step {largest:.3e})")
        if not bool((d_got.abs() <= largest + tol)[~sure].all()):
            raise AssertionError(f"{k}: the step exceeds the largest")
        worst["params"] = max(worst["params"], float((err / tol)[sure].max()) if sure.any() else 0.0)
    return worst


def one_rank_ddp_matches(make_model, batch, backend: str) -> int:
    """One Trainer step of ``make_model()`` on ``batch`` (on the model's
    device) without a process group, then the same under DDP in a world of
    one process over ``backend`` (this process, on localhost), then without
    again: the parameters and gradients must be bit-equal. Returns the number
    of parameters compared."""
    import torch.distributed as dist

    from ..train.trainer import Trainer

    def step(run_dir):
        tr = Trainer(make_model(), run_dir=run_dir, batch_size=batch.x0.shape[0])
        tr.train_step(tr.new_state(), batch)
        return {k: (p.detach().clone(), p.grad.clone()) for k, p in tr.model.named_parameters()}, tr.mesh

    with tempfile.TemporaryDirectory(prefix="ddp_") as tmp:
        plain, mesh = step(tmp)
        if mesh.distributed:
            raise AssertionError("the plain step ran under a process group")
        dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
        try:
            ddp, mesh = step(tmp)
            if not (mesh.distributed and mesh.dp == 1):
                raise AssertionError(f"the DDP step's mesh is {mesh}")
        finally:
            dist.destroy_process_group()
        again, _ = step(tmp)
    for k, (p, g) in plain.items():
        for other, label in ((ddp, "under DDP"), (again, "in a second plain run")):
            if not (torch.equal(other[k][0], p) and torch.equal(other[k][1], g)):
                raise AssertionError(f"{k}: the step {label} differs from the plain step")
    return len(plain)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    if sys.argv[2:3] == [FAMILY_3D]:
        dryrun_multichip_3d(n)
    else:
        dryrun_multichip(n, *sys.argv[2:3])
