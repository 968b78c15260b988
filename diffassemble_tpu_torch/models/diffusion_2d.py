"""Continuous 2D puzzle diffusion, sampling path — port of
the JAX package's ``models/diffusion_2d.py``.

Gaussian DDIM/DDPM over node states x ∈ R² (position) or R⁴ (position +
rotation unit vector), conditioned on per-piece visual features through the
graph-attention denoiser, with classifier-free guidance and greedy-assignment
metrics. The visual features are computed once per batch and reused at every
step. Loss and optimizer come with the training slice.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..data.batch import PuzzleBatch
from ..nn.denoiser import GraphDenoiser2D
from ..nn.efficientnet import EfficientNetB0Features
from ..nn.layers import init_weights
from ..ops.assignment import greedy_assignment_batch
from ..ops.gaussian import SampleLoopResult, sample_loop
from ..ops.schedules import DiffusionSchedule
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Diffusion2DConfig:
    """The JAX package's config, field for field, so that a run's
    ``config.json`` loads unchanged. Fields of training (loss, optimizer,
    pretrained weights) are carried but not read by this slice;
    ``attention_impl`` is carried but the port dispatches attention by device."""

    steps: int = 300
    sampling: str = "ddim"
    inference_ratio: int = 10
    mean_type: str = "epsilon"
    scheduler: str = "linear"
    rotation: bool = False
    noise_weight: float = 0.0
    classifier_free_prob: float = 0.0
    classifier_free_w: float = 0.0
    loss_type: str = "huber"
    backbone: str = "efficientnet_b0"
    architecture: str = "transformer"
    n_layers: int = 4
    virt_nodes: int = 4
    hidden_dim: int = 256
    heads: int = 8
    freeze_backbone: bool = False
    visual_pretrained: bool = False
    visual_weights: str = "weights/efficientnet_b0_features.npz"
    encoder_init: str = ""
    all_equivariant: bool = False
    two_heads: bool = False
    learning_rate: float = 1e-4
    warmup_steps: int = 0
    aux_loss_weight: float = 0.0
    compute_dtype: str = "float32"
    attention_impl: str = "auto"
    remat: bool = False

    @property
    def input_channels(self) -> int:
        return 4 if self.rotation else 2

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


class Diffusion2D(nn.Module):
    """Encoder + denoiser + sampler.

    Built with seeded random weights (``seed``) on ``device``; load converted
    JAX weights with ``load_state_dict(convert.convert_params(params))``.
    """

    def __init__(self, config: Diffusion2DConfig, device: torch.device | str = "cuda", seed: int = 0):
        super().__init__()
        if config.backbone != "efficientnet_b0":
            raise NotImplementedError(f"backbone {config.backbone!r} is not ported yet")
        if config.all_equivariant:
            raise NotImplementedError("all_equivariant is not ported yet")
        device = resolve_device(device)
        self.cfg = config
        self.sched = DiffusionSchedule.create(config.steps, config.scheduler, device)
        self.encoder = EfficientNetB0Features(
            bn_mode="affine" if config.visual_pretrained else "batch", dtype=config.dtype
        )
        self.denoiser = GraphDenoiser2D(
            steps=config.steps,
            input_channels=config.input_channels,
            output_channels=config.input_channels,
            feature_dim=EfficientNetB0Features.feature_dim,
            n_layers=config.n_layers,
            architecture=config.architecture,
            virt_nodes=config.virt_nodes,
            hidden_dim=config.hidden_dim,
            heads=config.heads,
            two_heads=config.two_heads and config.rotation,
            aux_head=config.aux_loss_weight > 0,
            dtype=config.dtype,
        )
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.sched.betas.device

    def visual_features(self, patches: torch.Tensor) -> torch.Tensor:
        """(B, N, ps, ps, 3) uint8 or float in [0, 1] → (B, N, 1088).

        "batch"-mode BatchNorm takes its statistics over all B·N patches."""
        b, n = patches.shape[:2]
        if not patches.is_floating_point():
            patches = patches.float() / 255.0
        feats = self.encoder(patches.reshape(b * n, *patches.shape[2:]))
        return feats.reshape(b, n, -1)

    def denoise(self, x_t, t, feats, adj, node_mask) -> torch.Tensor:
        return self.denoiser(x_t, t, feats, adj, node_mask).float()

    @torch.no_grad()
    def sample(
        self,
        batch: PuzzleBatch,
        generator: torch.Generator | None = None,
        keep_trajectory: bool = False,
        inference_ratio: int | None = None,
    ) -> SampleLoopResult:
        """Full reverse process; ``batch`` holds tensors on the model's device.
        Returns SampleLoopResult with final (B, N, C) f32."""
        cfg = self.cfg
        b, n = batch.x0.shape[:2]
        ratio = inference_ratio or cfg.inference_ratio
        init = torch.randn(
            (b, n, cfg.input_channels), generator=generator, device=self.device
        ) * cfg.noise_weight
        feats = self.visual_features(batch.patches)
        zero_feats = torch.zeros_like(feats)

        def denoise_fn(x, t):
            out = self.denoise(x, t, feats, batch.adj, batch.node_mask)
            if cfg.classifier_free_prob > 0 and cfg.classifier_free_w != 0:
                uncond = self.denoise(x, t, zero_feats, batch.adj, batch.node_mask)
                out = (1 + cfg.classifier_free_w) * out - cfg.classifier_free_w * uncond
            return out

        return sample_loop(
            self.sched,
            denoise_fn,
            init,
            generator,
            inference_ratio=ratio,
            sampling=cfg.sampling,
            mean_type=cfg.mean_type,
            keep_trajectory=keep_trajectory,
        )

    @torch.no_grad()
    def metrics_from_final(self, final: torch.Tensor, batch: PuzzleBatch) -> dict:
        """Greedy-assign predictions and ground truth to the anchor grid; a
        piece is correct when both land on the same anchor (and, with rotation,
        within 45°); a puzzle when all its pieces are."""
        valid = batch.node_mask
        pred_ass = greedy_assignment_batch(final[..., :2], batch.grid, valid)
        gt_ass = greedy_assignment_batch(batch.x0[..., :2], batch.grid, valid)
        piece_correct = (pred_ass == gt_ass) & valid
        if self.cfg.rotation:
            pred_rot = final[..., 2:4]
            gt_rot = batch.x0[..., 2:4]
            cos = (pred_rot * gt_rot).sum(-1) / torch.clamp(
                torch.linalg.norm(pred_rot, dim=-1) * torch.linalg.norm(gt_rot, dim=-1), min=1e-8
            )
            piece_correct = piece_correct & (cos > math.cos(math.pi / 4))
        n_valid = torch.clamp(valid.sum(-1), min=1)
        return {
            "piece_acc": piece_correct.sum(-1) / n_valid,
            "puzzle_correct": (piece_correct | ~valid).all(-1).float(),
            "n_valid": n_valid,
        }
