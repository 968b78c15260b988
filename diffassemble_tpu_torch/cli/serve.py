"""Serving — port of the JAX package's ``cli/serve.py``: puzzlize an image
(patchify → full graph), run the sampler, return the reassembled image.

``PuzzleSolver.predict_array`` is the programmatic API on numpy arrays; the
PIL ``predict`` and the stdlib HTTP server in ``main`` (POST an image to
/solve, get the reassembled PNG back) import PIL only when called.

Weights come in two ways. ``PuzzleSolver.from_run`` serves a run of the
port's trainer as the JAX ``cli/serve.py`` serves one of its own: the run's
config, and ``eval_params`` of its latest checkpoint (the EMA where the run
kept one), or with ``checkpoint_path`` that checkpoint's live params. The
constructor takes a config and a state_dict (e.g. JAX weights converted with
``convert.convert_params``, or read by ``convert.load_jax_npz`` from an npz
such as the committed ``assets/diffusion2d_rot30_ema32000.npz``, which
``tests/torch_assets.py`` exports from the JAX package's own checkpoint),
or builds seeded random weights.

    python -m diffassemble_tpu_torch.cli.serve --run_dir runs/synthetic-30 --puzzle_size 30
    python -m diffassemble_tpu_torch.cli.serve --config weights/diffusion2d_rot30/config.json --puzzle_size 30
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import torch

from ..data.batch import collate_puzzles
from ..data.patchify import make_puzzle
from ..models.diffusion_2d import Diffusion2D, Diffusion2DConfig
from ..train.checkpoint import CheckpointManager, restore_explicit
from ..train.train_state import create_train_state, eval_params
from ..utils.device import resolve_device
from ..utils.viz import compose_from_positions


class PuzzleSolver:
    """predict_array(image) → reassembled image."""

    def __init__(
        self,
        config: Diffusion2DConfig,
        state_dict: dict[str, torch.Tensor] | None = None,
        seed: int = 0,
        device: torch.device | str = "cuda",
        puzzle_size: int = 6,
        shuffle: bool = True,
    ):
        self.device = resolve_device(device)
        self.puzzle_size = puzzle_size
        self.shuffle = shuffle
        self.seed = seed
        # serving samples from unit noise, as the reference app does
        cfg = dataclasses.replace(config, noise_weight=1.0)
        self.model = Diffusion2D(cfg, device=self.device, seed=seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.eval()

    @classmethod
    def from_run(cls, run_dir: str | Path, puzzle_size: int = 6, shuffle: bool = True, seed: int = 0,
                 checkpoint_path: str = "", device: torch.device | str = "cuda") -> "PuzzleSolver":
        """A solver for a run of the port's trainer (the JAX package's
        ``PuzzleSolver(run_dir, ...)``): the config of ``<run_dir>/checkpoints``;
        with ``checkpoint_path`` the live params of that checkpoint
        (``restore_explicit``), else ``eval_params`` of the run's latest
        checkpoint, else the seeded weights."""
        ckpt = CheckpointManager(Path(run_dir) / "checkpoints")
        solver = cls(Diffusion2DConfig(**ckpt.load_config()), seed=seed, device=device,
                     puzzle_size=puzzle_size, shuffle=shuffle)
        model = solver.model
        # a template without EMA, as the reference builds it; restoring fills the
        # model's own parameters with the live params
        state = create_train_state(model, model.make_optimizer(), torch.Generator(device=model.device))
        if checkpoint_path:
            params = restore_explicit(checkpoint_path, state).params
        else:
            restored = ckpt.restore(state)
            params = eval_params(restored) if restored is not None else state.params
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(params[k])
        return solver

    def predict_positions(self, img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(n·32, n·32, 3) float image in [0, 1] → its pieces as served (shuffled
        when ``shuffle``), (n², 32, 32, 3), and the sampler's final prediction
        per piece, (n², C): the position, then the rotation's cos and sin where
        the model rotates."""
        n = self.puzzle_size
        if img.shape != (n * 32, n * 32, 3):
            raise ValueError(f"image {img.shape} is not ({n * 32}, {n * 32}, 3)")
        rng = np.random.default_rng(self.seed)
        s = make_puzzle(np.asarray(img, np.float32), n, n, 32,
                        rotation=self.model.cfg.rotation, rng=rng)
        if self.shuffle:  # scramble piece order so the demo is honest
            perm = rng.permutation(n * n)
            s["patches"] = s["patches"][perm]
        s["patches_dim"] = np.array([n, n], dtype=np.int32)
        host = collate_puzzles([s], n * n)
        batch = host.to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        return host.patches[0], self.model.sample(batch, gen).final[0].cpu().numpy()

    def predict_array(self, img: np.ndarray) -> np.ndarray:
        """(n·32, n·32, 3) float image in [0, 1] → the reassembled (n·32, n·32, 3) image."""
        patches, final = self.predict_positions(img)
        rot = final[:, 2:4] if final.shape[-1] >= 4 else None
        return compose_from_positions(patches, final[:, :2], (self.puzzle_size,) * 2, rot)

    def predict(self, image):
        """PIL image in → PIL reassembled image out."""
        from PIL import Image

        n = self.puzzle_size
        arr = np.asarray(image.convert("RGB").resize((n * 32, n * 32)), dtype=np.float32) / 255.0
        out = self.predict_array(arr)
        return Image.fromarray((np.clip(out, 0, 1) * 255).astype(np.uint8))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run_dir", default="", help="a run of the port's trainer (holding checkpoints/)")
    ap.add_argument("--checkpoint_path", default="",
                    help="with --run_dir: serve this checkpoint's live params (a run dir, its checkpoints/ "
                    "or one step dir) instead of the latest checkpoint's eval params")
    ap.add_argument("--config", default="", help="instead of --run_dir: a config.json")
    ap.add_argument("--state_dict", default="", help="with --config: converted weights (torch.save of a state_dict)")
    ap.add_argument("--puzzle_size", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", type=int, default=7860)
    args = ap.parse_args()

    if args.run_dir:
        solver = PuzzleSolver.from_run(args.run_dir, args.puzzle_size, seed=args.seed,
                                       checkpoint_path=args.checkpoint_path, device=args.device)
    elif args.config:
        with open(args.config) as f:
            cfg = Diffusion2DConfig(**json.load(f))
        sd = torch.load(args.state_dict, map_location="cpu") if args.state_dict else None
        solver = PuzzleSolver(cfg, sd, args.seed, args.device, args.puzzle_size)
    else:
        ap.error("give --run_dir (a run of the trainer) or --config")

    from http.server import BaseHTTPRequestHandler, HTTPServer

    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != "/solve":
                self.send_response(404)
                self.end_headers()
                return
            length = int(self.headers.get("Content-Length", 0))
            out = solver.predict(Image.open(io.BytesIO(self.rfile.read(length))))
            buf = io.BytesIO()
            out.save(buf, format="PNG")
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.end_headers()
            self.wfile.write(buf.getvalue())

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.end_headers()
            self.wfile.write(b"POST an image to /solve to reassemble it.\n")

    print(f"serving on :{args.port} — POST an image to /solve")
    HTTPServer(("0.0.0.0", args.port), Handler).serve_forever()


if __name__ == "__main__":
    main()
