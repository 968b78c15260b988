"""Angle-parameterised 2D rotation diffusion — port of the JAX package's
``models/diffusion_2d_angle.py``.

The rotation is diffused as one scalar angle (radians or degrees) beside the
position: the state is (B, N, 3) [x, y, angle], while the batch's target and
the sampled result keep the (B, N, 4) [x, y, cos θ, sin θ] layout of the
other 2D models, and the denoiser is conditioned on [x, y, cos, sin] of the
noisy state.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..data.batch import PuzzleBatch
from ..ops.gaussian import SampleLoopResult, q_sample, sample_loop
from .diffusion_2d import Diffusion2D, Diffusion2DConfig, _huber


@dataclasses.dataclass(frozen=True)
class AngleDiffusion2DConfig(Diffusion2DConfig):
    rotation: bool = True
    angle_type: str = "radian"  # radian | degree


class AngleDiffusion2D(Diffusion2D):
    """Diffuses [pos (2), angle (1)]; conditions the denoiser on [pos, cos, sin]."""

    cfg: AngleDiffusion2DConfig

    @property
    def _angle_scale(self) -> float:
        return 1.0 if self.cfg.angle_type == "radian" else 180.0 / math.pi

    def _to_state(self, x: torch.Tensor) -> torch.Tensor:
        ang = torch.atan2(x[..., 3:4], x[..., 2:3]) * self._angle_scale
        return torch.cat([x[..., :2], ang], dim=-1)

    def _to_public(self, state: torch.Tensor) -> torch.Tensor:
        a = state[..., 2] / self._angle_scale
        return torch.cat([state[..., :2], torch.stack([torch.cos(a), torch.sin(a)], dim=-1)], dim=-1)

    def loss_draws(self, b: int, x_shape: tuple[int, ...], generator: torch.Generator | None,
                   device: torch.device) -> dict[str, torch.Tensor]:
        """t (b,) and the noise of the 3-channel state (b, N, 3)."""
        return {"t_graph": torch.randint(0, self.cfg.steps, (b,), generator=generator, device=device),
                "noise": torch.randn((b, x_shape[1], 3), generator=generator, device=device)}

    def loss(self, batch: PuzzleBatch, generator: torch.Generator | None = None, t_graph=None,
             noise=None) -> tuple[torch.Tensor, dict]:
        """Huber on the state (x₀ prediction folded back to [pos, angle]) or
        on the first three output channels (ε), masked mean over valid nodes."""
        cfg = self.cfg
        b, n = batch.x0.shape[:2]
        if t_graph is None:
            draws = self.loss_draws(b, batch.x0.shape, generator, batch.x0.device)
            t_graph, noise = draws["t_graph"], draws["noise"]
        t = t_graph[:, None].expand(b, n)
        x0_state = self._to_state(batch.x0)
        x_noisy = q_sample(self.sched, x0_state, t, noise)
        feats = self.visual_features(batch.patches)
        pred = self.denoise(self._to_public(x_noisy), t, feats, batch.adj, batch.node_mask)
        if cfg.mean_type == "xstart":
            err = _huber(self._to_state(pred), x0_state)
        else:
            err = _huber(pred[..., :3], noise)
        m = batch.node_mask[..., None].float()
        loss = (err * m).sum() / (self.valid_count(m) * err.shape[-1]).clamp_min(1.0)
        return loss, {"loss": loss}

    @torch.no_grad()
    def sample(self, batch: PuzzleBatch, generator: torch.Generator | None = None, keep_trajectory: bool = False,
               inference_ratio: int | None = None) -> SampleLoopResult:
        """The reverse process over the state; ``final`` (B, N, 4) [pos, cos, sin]."""
        cfg = self.cfg
        b, n = batch.x0.shape[:2]
        init = torch.randn((b, n, 3), generator=generator, device=self.device) * cfg.noise_weight
        feats = self.visual_features(batch.patches)

        def denoise_fn(x_state, t):
            pred = self.denoise(self._to_public(x_state), t, feats, batch.adj, batch.node_mask)
            return self._to_state(pred) if cfg.mean_type == "xstart" else pred[..., :3]

        res = sample_loop(self.sched, denoise_fn, init, generator,
                          inference_ratio=inference_ratio or cfg.inference_ratio, sampling=cfg.sampling,
                          mean_type=cfg.mean_type, keep_trajectory=keep_trajectory)
        traj = self._to_public(res.trajectory) if res.trajectory is not None else None
        return SampleLoopResult(final=self._to_public(res.final), trajectory=traj)
