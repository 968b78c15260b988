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
OrientationNorm statistics are global too). Run it as
``python -m diffassemble_tpu_torch.parallel.dryrun [n] [backbone]``.

Tolerances (``GRAD_TOL[backbone]`` = (rel, abs)): the loss and its parts
within 1e-5 relative; each parameter's gradient within rel of its largest
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
between the loss and the stem.
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


def _step(batch, mesh=None, backbone: str = CFG["backbone"]) -> dict:
    """One train step of the tiny model (with ``backbone``) on ``batch``: its
    aux, the parameters before and after, the gradients and the unfactored
    parameters' names."""
    from ..models.diffusion_2d import Diffusion2D, Diffusion2DConfig
    from ..train.train_state import create_train_state, make_train_step
    from .mesh import Mesh, data_parallel_loss, shard_batch

    mesh = mesh or Mesh()
    model = Diffusion2D(Diffusion2DConfig(**{**CFG, "backbone": backbone}), device="cpu", seed=0)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = model.make_optimizer()
    state = create_train_state(model, opt, torch.Generator().manual_seed(1))
    step = make_train_step(data_parallel_loss(model, mesh), opt, max_grad_norm=1.0)
    state, aux = step(state, shard_batch(mesh, batch))
    return {"aux": {k: float(v) for k, v in aux.items()}, "before": before,
            "params": {k: p.detach().clone() for k, p in state.params.items()},
            "grads": {k: p.grad.detach().clone() for k, p in state.params.items()},
            "unfactored": sorted(state.opt_state["v"])}


GRAD_TOL = {"efficientnet_b0": (1e-4, 1e-6), "resnet18equiv": (3e-2, 1e-5)}
CASES = {"equal": False, "unequal": True}  # case → ranks hold puzzles of different sizes


def _worker(rank: int, world: int, port: int, out_dir: str, backbone: str) -> None:
    import torch.distributed as dist

    from .mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        for case, unequal in CASES.items():
            torch.save(_step(_batch(world, unequal), make_mesh(), backbone), Path(out_dir) / f"{case}{rank}.pt")
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
            batches = {case: _batch(n_devices, unequal) for case, unequal in CASES.items()}
            refs = {case: (batch, _step(batch, backbone=backbone)) for case, batch in batches.items()}
        finally:
            torch.set_num_threads(threads)
            while not workers.join():
                pass
        out = {}
        for case, (batch, ref) in refs.items():
            ranks = [torch.load(Path(tmp) / f"{case}{r}.pt", weights_only=True) for r in range(n_devices)]
            out[case] = _compare(ranks, ref, *GRAD_TOL[backbone])
            valid = batch.node_mask.reshape(n_devices, -1).sum(-1).tolist()
            print(f"dryrun_multichip {case}: valid nodes per rank {valid}, worst err/tol: loss "
                  f"{out[case]['loss']:.3f}, gradients {out[case]['grads']:.3f}, parameters "
                  f"{out[case]['params']:.3f}", flush=True)
    print(f"dryrun_multichip ok: world={n_devices}, backbone {backbone}", flush=True)
    return out


def _compare(ranks: list[dict], ref: dict, rel: float = 1e-4, atol: float = 1e-6) -> dict[str, float]:
    """Rank 0's step against the single-process ``ref``; every rank's
    parameters equal rank 0's."""
    aux, before, params, grads = ref["aux"], ref["before"], ref["params"], ref["grads"]
    got = ranks[0]
    for r in ranks[1:]:
        if not all(torch.equal(r["params"][k], v) for k, v in got["params"].items()):
            raise AssertionError("ranks disagree")
    worst = {"loss": 0.0, "grads": 0.0, "params": 0.0}
    for key, want in aux.items():
        err = abs(got["aux"][key] - want) / (1e-5 * abs(want) + 1e-30)
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
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2, *sys.argv[2:3])
