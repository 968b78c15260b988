"""Quality training over a device-resident corpus — the port's counterpart of
the JAX package's ``scripts/tpu_train_device.py``, flag for flag, plus
``--device``.

The whole corpus lives on the device (``train/device_data.py``); every step
draws its indices and a fresh k·90° rotation per piece there, gathers the
batch there and steps (``make_device_train_step``), so steady training does
not touch the host. Every ``eval_every`` steps the held-out corpus is
evaluated through ``train/heldout.py:heldout_eval`` with one rotation draw
fixed for the whole run, and checkpoints are kept top-k by ``--monitor``.
Every 50 steps the round-deadline guard (``utils/deadline.py``) may stop the
run; the final evaluation follows either way.

One deliberate difference from the JAX script: it draws the expander of the
train and the eval corpus apart from the same seed, and ARPACK's random start
vector lets the seed keep any of five graphs, so the two can differ. Here the
topologies are drawn once (``size_topologies``) and handed to both corpora,
also when they come from the corpus cache.

The flagship 30×30 recipe (``weights/diffusion2d_rot30``):

    python -m diffassemble_tpu_torch.cli.train_device --run_dir runs/rot30 --hw 30 \\
        --rotation 1 --backbone efficientnet_b0 --architecture exophormer --degree 10% \\
        --canonical 0.8 --hf_detail 0.25 --aux_loss_weight 0.1 --batch_size 8 \\
        --train_n 1536 --encoder_init weights/efficientnet_b0_pose30hf.npz \\
        --ema_decay 0.999 --viz_every_eval 0

The mixed-size recipe of ``weights/diffusion2d_rot_ms`` (its config.json and data.json):

    python -m diffassemble_tpu_torch.cli.train_device --run_dir runs/rot_ms --hw 6 8 10 12 \
        --degree -1 --batch_size 16 --eval_batch 16 --aux_loss_weight 0.1

``--evaluate_npz`` evaluates the parameters of an npz instead of training
(``convert.load_jax_npz``: a committed asset of ``train/heldout.py``, with
``heldout_rot_k``, the JAX package's rotation draw): the held-out corpus of
these flags under ``train/heldout.py:evaluate_protocol``, in calls of
``--eval_batch``; nothing is written.

The guard reads the cutoff from ``PROGRESS.jsonl``; set
``DIFFASSEMBLE_DEADLINE_EPOCH`` to run past it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..data.datasets import SyntheticImages
from ..models.diffusion_2d import Diffusion2D, Diffusion2DConfig
from ..train.checkpoint import CheckpointManager
from ..train.device_data import (
    DeviceMixedPuzzleData,
    DevicePuzzleData,
    build_device_data,
    build_device_data_mixed,
    make_device_train_step,
    size_topologies,
)
from ..train.heldout import evaluate_protocol, heldout_eval
from ..train.train_state import create_train_state, eval_params
from ..train.trainer import JsonlLogger, swapped_params
from ..utils.deadline import round_deadline
from ..utils.deadline import time_left as _deadline_time_left
from .common import check_backbone

EVAL_ROT_SEED = 99  # the held-out rotation draw's generator seed


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--hw", type=int, nargs="+", default=[6],
                    help="one value = single-size corpus; several = mixed-size (the reference's random-size "
                         "6/8/10/12 training)")
    ap.add_argument("--rotation", type=int, default=1)
    ap.add_argument("--backbone", default="resnet18equiv")
    ap.add_argument("--architecture", default="exophormer")
    ap.add_argument("--degree", default="60%")
    ap.add_argument("--virt_nodes", type=int, default=8)
    ap.add_argument("--n_layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--inference_ratio", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--train_n", type=int, default=4000)
    ap.add_argument("--eval_n", type=int, default=64)
    ap.add_argument("--eval_batch", type=int, default=0, help="0 = batch_size")
    ap.add_argument("--max_steps", type=int, default=12000)
    ap.add_argument("--eval_every", type=int, default=1000)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--warmup_steps", type=int, default=500)
    ap.add_argument("--aux_loss_weight", type=float, default=0.0)
    ap.add_argument("--encoder_init", default="")
    ap.add_argument("--freeze_backbone", type=int, default=0)
    ap.add_argument("--attention_impl", default="auto")
    ap.add_argument("--hf_detail", type=float, default=0.0,
                    help="fixed high-frequency canonical texture weight (data/datasets.py)")
    ap.add_argument("--canonical", type=float, default=0.5,
                    help="weight of the generator's fixed aligned field (data/datasets.py)")
    ap.add_argument("--style", default="default", choices=["default", "art"],
                    help="generator style: 'art' = WikiArt-hardness corpus")
    ap.add_argument("--monitor", default="overall__piece_acc",
                    help="checkpoint top-k metric (overall_acc is 0 until a puzzle is fully solved)")
    ap.add_argument("--viz_every_eval", type=int, default=1,
                    help="save N reconstruction PNGs per eval (0 = off; needs PIL)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ema_decay", type=float, default=0.0, help="EMA of params for eval (0 = off)")
    ap.add_argument("--deadline_margin", type=float, default=3600.0,
                    help="stop training this many seconds before the round's cutoff (utils/deadline.py)")
    ap.add_argument("--evaluate_npz", default="",
                    help="evaluate these parameters (a JAX-tree npz, e.g. a committed asset) instead of training")
    ap.add_argument("--device", default="cuda", help="torch device; the CPU runs only when asked for")
    return ap


def corpus_path(args, tag: str, n: int, img_seed: int) -> Path:
    """The corpus cache file, named as the JAX script names it."""
    deg = str(args.degree).replace("%", "pct")
    hwtag = "x".join(str(s) for s in args.hw)
    ctag = "" if args.canonical == 0.5 else f"-c{args.canonical}"
    ctag += "" if args.hf_detail == 0.0 else f"-hf{args.hf_detail}"
    ctag += "" if args.style == "default" else f"-{args.style}"
    return Path(f"runs/_corpus/{tag}-hw{hwtag}-n{n}-s{img_seed}-d{deg}-g2{ctag}.npz")


def _with_topologies(data, topologies: dict, device: torch.device):
    """``data`` with the run's shared topologies (a cached corpus may hold
    another expander)."""
    if isinstance(data, DevicePuzzleData):
        hw = tuple(int(v) for v in data.hw.tolist())
        return data._replace(adj=torch.from_numpy(topologies[hw]).to(device))
    adj = torch.zeros_like(data.adj)
    for (h, w), topo in topologies.items():
        sel = (data.hw[:, 0] == h) & (data.hw[:, 1] == w)
        adj[sel, :h * w, :h * w] = torch.from_numpy(topo).to(device)
    return data._replace(adj=adj)


def load_corpus(args, tag: str, n: int, img_seed: int, topologies: dict, device: torch.device):
    """The corpus from its cache file, else generated, patchified and cached;
    on ``device``, over the shared ``topologies``."""
    sizes = [(s, s) for s in args.hw]
    mixed = len(sizes) > 1
    kind = DeviceMixedPuzzleData if mixed else DevicePuzzleData
    f = corpus_path(args, tag, n, img_seed)
    image_kw = dict(n=n, seed=img_seed, cache=False, canonical=args.canonical, hf_detail=args.hf_detail,
                    style=args.style)
    if f.exists():
        with np.load(f) as z:
            data = kind(*(torch.from_numpy(z[k]).to(device) for k in kind._fields))
    else:
        if mixed:
            sources = {}

            def factory(size_hw, i):
                if size_hw not in sources:
                    sources[size_hw] = SyntheticImages(size_hw, **image_kw)
                return sources[size_hw][i]

            data = build_device_data_mixed(factory, sizes, n, device=device, topologies=topologies)
        else:
            hw = sizes[0]
            images = SyntheticImages((hw[0] * 32, hw[1] * 32), **image_kw)
            data = build_device_data(images, hw, n, device=device, topology=topologies[hw])
        f.parent.mkdir(parents=True, exist_ok=True)
        np.savez(f, **{k: v.cpu().numpy() for k, v in data._asdict().items()})
    return _with_topologies(data, topologies, device)


def corpus_bytes(*corpora) -> int:
    return sum(t.numel() * t.element_size() for data in corpora for t in data)


def evaluate_npz(args, model: Diffusion2D) -> dict[str, float]:
    """``--evaluate_npz``: the npz's parameters in ``model`` under these
    flags' held-out protocol (their eval corpus, the npz's rotation draw)."""
    from .. import convert

    params, extras = convert.load_jax_npz(args.evaluate_npz)
    model.load_state_dict(params, strict=True)
    if model.cfg.rotation and "heldout_rot_k" not in extras:
        raise ValueError(f"{args.evaluate_npz} holds no heldout_rot_k, the rotation draw of its protocol")
    protocol = {"hw": args.hw, "degree": args.degree, "seed": args.seed, "eval_n": args.eval_n,
                "eval_batch": args.eval_batch or args.batch_size, "canonical": args.canonical,
                "hf_detail": args.hf_detail, "style": args.style}
    return evaluate_protocol(model, protocol, extras["heldout_rot_k"] if model.cfg.rotation else None, model.device)


def main(argv: list[str] | None = None) -> dict[str, float]:
    """Train (or resume) and evaluate; returns the final evaluation's metrics."""
    t0 = time.time()

    def tick(msg):
        print(f"[{time.time() - t0:7.1f}s] {msg}", flush=True)

    args = build_parser().parse_args(argv)
    tick(f"round deadline {round_deadline():.0f} ({_deadline_time_left(args.deadline_margin) / 60:.0f} min usable)")
    check_backbone(args.backbone)
    sizes = [(s, s) for s in args.hw]
    rotation = bool(args.rotation)
    cfg = Diffusion2DConfig(
        steps=args.steps, inference_ratio=args.inference_ratio, sampling="ddim", mean_type="xstart",
        rotation=rotation, backbone=args.backbone, architecture=args.architecture, virt_nodes=args.virt_nodes,
        n_layers=args.n_layers, compute_dtype=args.compute_dtype, warmup_steps=args.warmup_steps,
        aux_loss_weight=args.aux_loss_weight, encoder_init=args.encoder_init,
        freeze_backbone=bool(args.freeze_backbone), attention_impl=args.attention_impl,
    )
    model = Diffusion2D(cfg, device=args.device, seed=args.seed)
    dev = model.device
    tick(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})")
    if args.evaluate_npz:
        m = evaluate_npz(args, model)
        tick(f"evaluated {args.evaluate_npz}: overall_acc={m.get('overall_acc', float('nan')):.4f} "
             f"piece_acc={m.get('overall__piece_acc', float('nan')):.4f}")
        return m

    topologies = size_topologies(sizes, args.degree, args.seed)
    data = load_corpus(args, "train", args.train_n, args.seed, topologies, dev)
    eval_data = load_corpus(args, "eval", args.eval_n, args.seed + 1000, topologies, dev)
    tick(f"corpus resident: {tuple(data.patches.shape)} ({data.patches.numel() / 1e9:.2f} GB uint8); "
         f"both corpora {corpus_bytes(data, eval_data)} bytes on the device")

    model.init(args.seed)
    opt = model.make_optimizer()
    ema_on = args.ema_decay > 0
    state = create_train_state(model, opt, torch.Generator(device=dev).manual_seed(args.seed + 1), ema=ema_on)
    ckpt = CheckpointManager(f"{args.run_dir}/checkpoints", args.monitor, "max")
    # a checkpoint saved without an EMA seeds the average from its params (checkpoint._restore_into)
    restored = ckpt.restore(state)
    if restored is not None:
        state = restored
        tick(f"resumed from step {state.step}")
    ckpt.save_config(cfg)
    # the data distribution next to the weights, so that later evaluations
    # rebuild a matching held-out set
    (Path(args.run_dir) / "checkpoints" / "data.json").write_text(json.dumps({
        "dataset": "synthetic", "hw": args.hw, "degree": args.degree, "canonical": args.canonical,
        "hf_detail": args.hf_detail, "style": args.style, "train_n": args.train_n, "seed": args.seed,
    }))
    logger = JsonlLogger(args.run_dir)
    train_step = make_device_train_step(model.loss, opt, rotation=rotation,
                                        ema_decay=args.ema_decay if ema_on else None)

    # one rotation draw for the whole held-out set, the same at every evaluation
    eval_rot_k = (torch.randint(0, 4, (eval_data.n_samples, eval_data.n_nodes), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(EVAL_ROT_SEED))
                  if rotation else None)
    eval_bs = args.eval_batch or args.batch_size

    def run_eval(tag: str, step: int) -> dict[str, float]:
        def draw(lo, batch, final):
            from ..utils.viz import save_reconstruction

            if lo != 0:
                return
            fin, b = final.cpu().numpy(), [t.cpu().numpy() for t in batch]
            patches, x0, _, _, node_mask, dims, _ = b
            for i in range(min(args.viz_every_eval, fin.shape[0])):
                vm = node_mask[i]
                save_reconstruction(
                    f"{args.run_dir}/viz/{tag}_step{step}_p{i}.png", patches[i][vm], fin[i][vm, :2],
                    x0[i][vm, :2], tuple(dims[i]), pred_rot=fin[i][vm, 2:4] if rotation else None,
                    gt_rot=x0[i][vm, 2:4] if rotation else None)

        with swapped_params(model, eval_params(state)):
            m = heldout_eval(model, eval_data, eval_rot_k, eval_n=eval_bs,
                             on_slice=draw if args.viz_every_eval else None)
        logger.log(step, {f"{tag}/{k}": v for k, v in m.items()})
        return m

    step = state.step
    t_last = time.time()
    while step < args.max_steps:
        if step % 50 == 0 and _deadline_time_left(args.deadline_margin) <= 0:
            tick(f"deadline guard: stopping at step {step} ({args.deadline_margin / 60:.0f} min margin)")
            break
        state, aux = train_step(state, data, args.batch_size)
        step = state.step
        if step % args.log_every == 0 or step == 1:
            dt = time.time() - t_last
            t_last = time.time()
            logger.log(step, {**aux, "steps_per_s": args.log_every / max(dt, 1e-9)})
        if step % args.eval_every == 0 or step == args.max_steps:
            ckpt.save(step, state, run_eval("val", step))
            t_last = time.time()
    m = run_eval("final", step)
    if ckpt.latest_step() != step:  # the deadline guard stopped between eval points
        ckpt.save(step, state, m)
    tick(f"final: overall_acc={m.get('overall_acc', float('nan')):.4f} "
         f"piece_acc={m.get('overall__piece_acc', float('nan')):.4f}")
    return m


if __name__ == "__main__":
    main()
