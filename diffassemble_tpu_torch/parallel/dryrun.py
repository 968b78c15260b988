"""The torch twin of ``__graft_entry__.dryrun_multichip``: data-parallel
training checked on the CPU.

``dryrun_multichip(n)`` spawns ``n`` processes that form a gloo group on
localhost. Each runs one full train step (``train_state.make_train_step``
over ``parallel.mesh.data_parallel_loss``, the Trainer's step) under DDP on
its slice of a tiny batch; the parent runs the same step in one process on
the whole batch and checks that every rank ends with the same parameters and
that they, the loss and the gradients equal the single-process step's. It
does so twice: with as many valid nodes on every rank, and with puzzles of
different sizes on the ranks (different numbers of valid nodes), which only
a global BatchNorm and a global masked mean get right. ``backbone`` swaps
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
    """2 puzzles per rank; with ``unequal`` rank r's are of size 3×3 for even
    r and 2×2 for odd r (9 or 4 valid nodes of 9), else all 3×3."""
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
    ``CFG_3D``'s threshold) in each rank's slice of a fragment batch."""
    from ..models.losses_3d import contact_matrix
    from ..models.diffusion_3d import Diffusion3DConfig

    contact = contact_matrix(batch.pcds, batch.x0[..., :4], batch.x0[..., 4:7], batch.node_mask,
                             thresh=Diffusion3DConfig(**CFG_3D).contact_thresh)
    return [int(c) for c in contact.reshape(world, -1).sum(-1)]


def _batch_3d(world: int):
    """2 objects per rank, the first 2·world of the small training split (on
    2 ranks their ground-truth contact counts are 4 and 2)."""
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


def _cases(family: str, world: int) -> dict:
    """Each case's whole batch: for the 3D model one, with unequal contact
    counts; for a 2D one ``CASES``."""
    if family == FAMILY_3D:
        return {"unequal_contacts": _batch_3d(world)}
    return {case: _batch(world, unequal) for case, unequal in CASES.items()}


def _step(batch, mesh=None, family: str = CFG["backbone"]) -> dict:
    """One train step of ``_model(family)`` on ``batch``: its aux, the
    parameters before and after, the gradients and the unfactored
    parameters' names."""
    from ..train.train_state import create_train_state, make_train_step
    from .mesh import Mesh, data_parallel_loss, shard_batch

    mesh = mesh or Mesh()
    model = _model(family)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = model.make_optimizer()
    state = create_train_state(model, opt, torch.Generator().manual_seed(1))
    step = make_train_step(data_parallel_loss(model, mesh), opt, max_grad_norm=1.0)
    state, aux = step(state, shard_batch(mesh, batch))
    return {"aux": {k: float(v) for k, v in aux.items()}, "before": before,
            "params": {k: p.detach().clone() for k, p in state.params.items()},
            "grads": {k: p.grad.detach().clone() for k, p in state.params.items()},
            "unfactored": sorted(state.opt_state["v"])}


GRAD_TOL = {"efficientnet_b0": (1e-4, 1e-6, 1e-5), "resnet18equiv": (3e-2, 1e-5, 1e-5),
            FAMILY_3D: (2e-3, 1e-6, 2e-4)}
CASES = {"equal": False, "unequal": True}  # case → ranks hold puzzles of different sizes


def _worker(rank: int, world: int, port: int, out_dir: str, family: str) -> None:
    import torch.distributed as dist

    from .mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        for case, batch in _cases(family, world).items():
            torch.save(_step(batch, make_mesh(), family), Path(out_dir) / f"{case}{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int = 2, backbone: str = CFG["backbone"]) -> dict[str, dict[str, float]]:
    """Run the check for each case; raises AssertionError on a mismatch and
    returns each case's worst error/tolerance ratios."""
    import torch.multiprocessing as mp

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        workers = mp.start_processes(_worker, args=(n_devices, _free_port(), tmp, backbone), nprocs=n_devices,
                                     start_method="spawn", join=False)
        try:  # the single-process references while the ranks run
            refs = {case: (batch, _step(batch, family=backbone))
                    for case, batch in _cases(backbone, n_devices).items()}
        finally:
            torch.set_num_threads(threads)
            while not workers.join():
                pass
        out = {}
        for case, (batch, ref) in refs.items():
            ranks = [torch.load(Path(tmp) / f"{case}{r}.pt", weights_only=True) for r in range(n_devices)]
            out[case] = _compare(ranks, ref, *GRAD_TOL[backbone])
            per_rank = (f"contact pairs per rank {contact_counts(batch, n_devices)}" if backbone == FAMILY_3D
                        else f"valid nodes per rank {batch.node_mask.reshape(n_devices, -1).sum(-1).tolist()}")
            print(f"dryrun_multichip {case}: {per_rank}, worst err/tol: loss "
                  f"{out[case]['loss']:.3f}, gradients {out[case]['grads']:.3f}, parameters "
                  f"{out[case]['params']:.3f}", flush=True)
    print(f"dryrun_multichip ok: world={n_devices}, {'the 3D model' if backbone == FAMILY_3D else 'backbone'} "
          f"{'' if backbone == FAMILY_3D else backbone}".rstrip(), flush=True)
    return out


def dryrun_multichip_3d(n_devices: int = 2) -> dict:
    """``dryrun_multichip`` of the 3D model on objects whose contact counts
    differ between the ranks; besides its worst error/tolerance ratios,
    returns the contact counts per rank and ``per_rank_denominators``: how
    far, in loss tolerances (1e-5 relative), the ranks' mean of their own
    relative-pose losses, each divided by the rank's own counts, lies from
    the whole batch's. Above 1, the check tells the two apart."""
    out = dryrun_multichip(n_devices, FAMILY_3D)
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


def _compare(ranks: list[dict], ref: dict, rel: float = 1e-4, atol: float = 1e-6,
             norm_rel: float = 1e-5) -> dict[str, float]:
    """Rank 0's step against the single-process ``ref``; every rank's
    parameters equal rank 0's. The aux's gradient norms within ``norm_rel``
    relative, its other entries within 1e-5."""
    aux, before, params, grads = ref["aux"], ref["before"], ref["params"], ref["grads"]
    got = ranks[0]
    for r in ranks[1:]:
        if not all(torch.equal(r["params"][k], v) for k, v in got["params"].items()):
            raise AssertionError("ranks disagree")
    worst = {"loss": 0.0, "grads": 0.0, "params": 0.0}
    for key, want in aux.items():
        err = abs(got["aux"][key] - want) / ((norm_rel if key.startswith("grad_norm") else 1e-5) * abs(want) + 1e-30)
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
        d_want, d_got = params[k] - before[k], got["params"][k] - before[k]
        largest = float(d_want.abs().max())
        tol = rel * largest + 1e-6 * params[k].abs()
        sure = g.abs() > g_tol if k in ref["unfactored"] else torch.ones_like(g, dtype=torch.bool)
        err = (d_got - d_want).abs()
        if not bool((err <= tol)[sure].all()):
            raise AssertionError(f"{k}: the step differs")
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
