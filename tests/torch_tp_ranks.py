"""What each gloo rank of ``tests/test_torch_tp.py`` runs (through
``parallel/dryrun.py:run_on_ranks``): the port on a mesh with tp > 1. This
module imports no JAX, so that the spawned ranks start quickly; each
function takes the rank's mesh first and returns what the test compares.
"""

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from diffassemble_tpu_torch.data import PuzzleBatch, collate_puzzles, make_puzzle
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
from diffassemble_tpu_torch.parallel.mesh import gather_params, shard_batch, shard_params, unshard_params
from diffassemble_tpu_torch.parallel.tensor import TPLayout, all_gather
from diffassemble_tpu_torch.train import checkpoint
from diffassemble_tpu_torch.train.train_state import eval_params
from diffassemble_tpu_torch.train.trainer import Trainer

# the trainer case: the flagship's architecture at tiny widths
TRAINER_CFG = dict(steps=300, inference_ratio=150, mean_type="xstart", rotation=True, backbone="efficientnet_b0",
                   architecture="exophormer", n_layers=2, virt_nodes=2, hidden_dim=32, heads=4,
                   compute_dtype="float32")


def denoise_and_grads(mesh, cfg_kw: dict, state_dict: dict, batch: tuple, feats: np.ndarray, draws: dict) -> dict:
    """The sharded denoiser's forward at x_t = 0, t = 0 on ``feats`` (as the
    JAX package's ``test_tp_sharded_forward_matches``), the loss and its
    whole gradients on ``draws``, this rank's parameter shapes, and checks
    of the collectives: a bf16 all-gather and ``unshard_params`` exact, and
    ``sync_replicated`` on gradients that differ between the ranks."""
    model = Diffusion2D(Diffusion2DConfig(**cfg_kw), device="cpu")
    model.load_state_dict(state_dict, strict=True)
    layout = shard_params(mesh, model)
    batch = PuzzleBatch(*[torch.as_tensor(np.asarray(a)) for a in batch])
    x = torch.zeros_like(batch.x0)
    t = torch.zeros(batch.x0.shape[:2], dtype=torch.long)
    with torch.no_grad():
        out = model.denoise(x, t, torch.as_tensor(feats), batch.adj, batch.node_mask)
    loss, _ = model.loss(batch, **{k: torch.as_tensor(v) for k, v in draws.items()})
    loss.backward()
    grads = gather_params(model, {k: p.grad for k, p in model.named_parameters()})
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    piece = (torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7 + mesh.tp_rank).to(torch.bfloat16)
    gathered = all_gather(piece, 1, mesh.tensor_parallel)
    unshard_params(model)
    whole = all(torch.equal(p, state_dict[k]) for k, p in model.named_parameters())
    # gradients that differ between the ranks: the replicated one takes the group's mean, the sharded stays
    synced = {"replicated": torch.full((2, 3), 1.0 + mesh.tp_rank), "sharded": torch.full((4,), 5.0 + mesh.tp_rank)}
    TPLayout(mesh.tensor_parallel, {"replicated": None, "sharded": 0}).sync_replicated(synced)
    return {"denoise": out, "loss": float(loss), "grads": grads, "dims": layout.dims, "shapes": shapes,
            "gathered": gathered, "unsharded_equal": whole and model.tp_layout is None, "synced": synced}


class ListDataset:
    """``n`` seeded 3×3 puzzles with rotation, as the trainer takes them."""

    max_nodes = 9

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.items = [make_puzzle(rng.random((96, 96, 3)).astype(np.float32), 3, 3, 32, rotation=True, rng=rng)
                      for _ in range(n)]
        for s in self.items:
            s["patches_dim"] = np.array([3, 3], dtype=np.int32)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def trainer_step_eval_save_restore(mesh, run_dir: str) -> dict:
    """A ``Trainer`` on ``mesh`` (sharded in ``new_state``): one train step on
    4 puzzles, an evaluation of 2, a checkpoint, then a fresh trainer's
    restore of it. Returns the step as ``dryrun.compare_steps`` reads it (whole
    parameters and gradients), the metrics, the whole EMA and the restored
    whole parameters and EMA."""
    tr = Trainer(Diffusion2D(Diffusion2DConfig(**TRAINER_CFG), device="cpu"), run_dir=run_dir, batch_size=4,
                 ema_decay=0.9, mesh=mesh, viz_every_eval=0)
    state = tr.new_state()
    before = {k: v.clone() for k, v in gather_params(tr.model).items()}
    batch = PuzzleBatch(*collate_puzzles([ListDataset(4, seed=1)[i] for i in range(4)], 9)).to("cpu")
    state, aux = tr.train_step(state, shard_batch(mesh, batch))
    out = {"aux": {k: float(v) for k, v in aux.items()}, "before": before,
           "params": {k: v.clone() for k, v in gather_params(tr.model).items()},
           "grads": {k: v.clone() for k, v in
                     gather_params(tr.model, {k: p.grad for k, p in state.params.items()}).items()},
           "unfactored": sorted(state.opt_state["v"]),
           "ema": {k: v.clone() for k, v in gather_params(tr.model, state.ema_params).items()},
           "local_shapes": {k: tuple(p.shape) for k, p in state.params.items()}}
    out["metrics"] = tr.evaluate(eval_params(state), ListDataset(2, seed=3), step=1)
    tr._save(1, state, out["metrics"])
    if mesh.distributed:
        dist.barrier()
    again = Trainer(Diffusion2D(Diffusion2DConfig(**TRAINER_CFG), device="cpu", seed=5), run_dir=run_dir,
                    batch_size=4, ema_decay=0.9, mesh=mesh, viz_every_eval=0)
    restored = again._restore(again.new_state())
    out["restored"] = {k: v.clone() for k, v in gather_params(again.model).items()}
    out["restored_ema"] = {k: v.clone() for k, v in gather_params(again.model, restored.ema_params).items()}
    out["restored_step"] = restored.step
    out["checkpoint"] = str(Path(run_dir) / "checkpoints" / "1" / checkpoint.STATE_FILE)
    return out
