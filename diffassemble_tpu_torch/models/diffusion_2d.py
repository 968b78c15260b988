"""Continuous 2D puzzle diffusion — port of the JAX package's
``models/diffusion_2d.py``.

Gaussian DDIM/DDPM over node states x ∈ R² (position) or R⁴ (position +
rotation unit vector), conditioned on per-piece visual features through the
graph-attention denoiser, with classifier-free guidance and greedy-assignment
metrics. The visual features are computed once per batch and reused at every
step; the encoder is any of ``nn/visual.py:make_visual_encoder``
(efficientnet_b0 or an equivariant ResNet), with ``all_equivariant`` the
mean of the features of the four rot90 copies of every patch, and frozen
OrientationNorm statistics while ``norm_stats`` holds them
(``calibrate_norm_stats``). Training: ``loss`` (per-graph t, huber/l1/l2 on
ε or x₀, the aux head), ``init`` (seeded weights, the ``visual_pretrained``
features, the ``encoder_init`` npz) and ``make_optimizer`` (Adafactor with the HF relative schedule).
Evaluation: ``evaluate``, ``metrics_from_final`` and ``piece_table``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .. import convert
from ..data.batch import PuzzleBatch
from ..nn.denoiser import GraphDenoiser2D
from ..nn.efficientnet import load_pretrained_features
from ..nn.layers import init_weights
from ..nn.visual import FEATURE_DIM, calibrate_norm_stats, make_visual_encoder, norm_layers, set_norm_stats
from ..ops.assignment import greedy_assignment_batch
from ..ops.gaussian import SampleLoopResult, q_sample, sample_loop
from ..ops.schedules import DiffusionSchedule
from ..train.adafactor import Adafactor, hf_relative_schedule, reference_layouts
from ..utils.device import resolve_device
from ..utils.params import load_params


@dataclasses.dataclass(frozen=True)
class Diffusion2DConfig:
    """The JAX package's config, field for field, so that a run's
    ``config.json`` loads unchanged. ``attention_impl`` and ``remat`` are
    carried but not read: the port dispatches attention by device."""

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
    JAX weights with ``load_state_dict(convert.convert_params(params))``. The
    constructor reads no file: ``init`` (the training path) loads the
    ``encoder_init`` npz.
    """

    def __init__(self, config: Diffusion2DConfig, device: torch.device | str = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = config
        self.sched = DiffusionSchedule.create(config.steps, config.scheduler, device)
        self.encoder = make_visual_encoder(config.backbone, config.dtype, config.visual_pretrained)
        self.denoiser = self.make_denoiser(config)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device)
        self.stats_group = None  # a process group: the loss's masked means span it (loss)
        self._norm_stats = None

    def make_denoiser(self, config) -> GraphDenoiser2D:
        return GraphDenoiser2D(
            steps=config.steps,
            input_channels=config.input_channels,
            output_channels=config.input_channels,
            feature_dim=FEATURE_DIM,
            n_layers=config.n_layers,
            architecture=config.architecture,
            virt_nodes=config.virt_nodes,
            hidden_dim=config.hidden_dim,
            heads=config.heads,
            two_heads=config.two_heads and config.rotation,
            aux_head=config.aux_loss_weight > 0,
            dtype=config.dtype,
        )

    @property
    def device(self) -> torch.device:
        return self.sched.betas.device

    @property
    def norm_stats(self) -> dict | None:
        """The frozen OrientationNorm statistics the encoder runs with (the
        nested ``norm_stats`` layout), or None for batch statistics; setting
        it attaches or detaches them."""
        return self._norm_stats

    @norm_stats.setter
    def norm_stats(self, stats: dict | None) -> None:
        set_norm_stats(self.encoder, stats)
        self._norm_stats = stats or None

    @property
    def has_norm_layers(self) -> bool:
        """Whether the encoder has OrientationNorm layers to calibrate."""
        return bool(norm_layers(self.encoder))

    def calibrate_norm_stats(self, patch_batches) -> dict:
        """Pool OrientationNorm statistics over calibration batches (each
        (B, ps, ps, 3) in [0, 1]) with the model's current parameters and
        attach them (``norm_stats``); {} and None attached for an encoder
        without OrientationNorm layers."""
        stats = calibrate_norm_stats(self.encoder, patch_batches)
        self.norm_stats = stats
        return stats

    def visual_features(self, patches: torch.Tensor) -> torch.Tensor:
        """(B, N, ps, ps, 3) uint8 or float in [0, 1] → (B, N, 1088).

        "batch"-mode BatchNorm and OrientationNorm without frozen statistics
        take theirs over all B·N patches. With ``all_equivariant`` the
        features are the mean over the four rot90 copies of every patch."""
        b, n = patches.shape[:2]
        if not patches.is_floating_point():
            patches = patches.float() / 255.0
        flat = patches.reshape(b * n, *patches.shape[2:])
        if self.cfg.all_equivariant:
            feats = torch.stack([self.encoder(torch.rot90(flat, k, dims=(1, 2))) for k in range(4)]).mean(0)
        else:
            feats = self.encoder(flat)
        if self.cfg.freeze_backbone:
            feats = feats.detach()
        return feats.reshape(b, n, -1)

    def denoise(self, x_t, t, feats, adj, node_mask) -> torch.Tensor:
        return self.denoiser(x_t, t, feats, adj, node_mask).float()

    # ------------------------------------------------------------ training

    @torch.no_grad()
    def init(self, seed: int = 0) -> None:
        """Fresh seeded weights, then with ``visual_pretrained`` the converted
        ``visual_weights`` (``load_pretrained_features``), then the
        ``encoder_init`` npz if the config names one, in the JAX ``init``'s
        order. The npz is the JAX package's flattened parameter tree
        (``utils/params.py``)."""
        init_weights(self, torch.Generator().manual_seed(seed))
        if self.cfg.visual_pretrained:
            load_pretrained_features(self.encoder, self.cfg.visual_weights)
        if self.cfg.encoder_init:
            loaded = convert.convert_params({"encoder": load_params(self.cfg.encoder_init)["encoder"]})
            own = {f"encoder.{k}": v for k, v in self.encoder.state_dict().items()}
            if loaded.keys() != own.keys() or any(loaded[k].shape != own[k].shape for k in own):
                raise ValueError(
                    f"encoder_init {self.cfg.encoder_init!r} does not match the "
                    f"{self.cfg.backbone} encoder's parameter structure"
                )
            self.encoder.load_state_dict({k[len("encoder."):]: v for k, v in loaded.items()})

    def loss_draws(self, b: int, x_shape: tuple[int, ...], generator: torch.Generator | None,
                   device: torch.device) -> dict[str, torch.Tensor]:
        """The loss's random draws for ``b`` puzzles, in the loss's order: t
        (b,), the noise ``x_shape`` and, with classifier-free training, the
        keep mask (b, 1, 1)."""
        out = {"t_graph": torch.randint(0, self.cfg.steps, (b,), generator=generator, device=device),
               "noise": torch.randn(x_shape, generator=generator, device=device)}
        if self.cfg.classifier_free_prob > 0:
            out["cf_keep"] = torch.rand((b, 1, 1), generator=generator, device=device) >= self.cfg.classifier_free_prob
        return out

    def loss(
        self,
        batch: PuzzleBatch,
        generator: torch.Generator | None = None,
        t_graph: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
        cf_keep: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """Training loss (the JAX ``loss``): per-graph t ~ U[0, T) spread to
        the nodes, huber (δ = 1) / l1 / l2 on ε or x₀, masked mean over valid
        nodes, plus ``aux_loss_weight`` × the aux head's x₀ loss.

        t (B,), the noise (B, N, C) and the classifier-free keep mask (B, 1, 1)
        are drawn from ``generator`` (``loss_draws``) unless all are given
        (the tests feed the JAX package's draws). While ``stats_group`` holds
        a process group, each masked mean divides by the valid entries of the
        whole batch across the group over the group's size, so that the
        ranks' mean, which data-parallel training takes, is the whole
        batch's. Returns (loss, aux) with 0-dim tensors."""
        cfg = self.cfg
        b, n = batch.x0.shape[:2]
        dev = batch.x0.device
        if t_graph is None:
            draws = self.loss_draws(b, batch.x0.shape, generator, dev)
            t_graph, noise, cf_keep = draws["t_graph"], draws["noise"], draws.get("cf_keep")
        t = t_graph[:, None].expand(b, n)
        x_noisy = q_sample(self.sched, batch.x0, t, noise)

        feats = self.visual_features(batch.patches)
        if cfg.classifier_free_prob > 0:
            feats = feats * cf_keep.to(feats.dtype)

        target = batch.x0 if cfg.mean_type == "xstart" else noise
        err_fn = {"huber": _huber, "l1": lambda p, y: (p - y).abs(), "l2": lambda p, y: (p - y) ** 2}[cfg.loss_type]
        mask = batch.node_mask[..., None].float()
        n_valid = self.valid_count(mask)

        def masked_mean(per_elem):
            n_valid_elems = n_valid * per_elem.shape[-1]
            return (per_elem * mask).sum() / n_valid_elems.clamp_min(1.0)

        aux = {}
        if cfg.aux_loss_weight > 0:
            pred, aux_pred = self.denoiser(x_noisy, t, feats, batch.adj, batch.node_mask, return_aux=True)
            pred = pred.float()
            # deep supervision: the fusion-level head predicts x0 from the features alone
            aux_loss = masked_mean(err_fn(aux_pred.float(), batch.x0))
            aux["aux_loss"] = aux_loss
        else:
            pred = self.denoise(x_noisy, t, feats, batch.adj, batch.node_mask)
            aux_loss = 0.0
        per_elem = err_fn(pred, target)
        main = masked_mean(per_elem)
        if cfg.rotation:
            aux["loss/pos"] = masked_mean(per_elem[..., :2])
            aux["loss/rot"] = masked_mean(per_elem[..., 2:])
        loss = main + cfg.aux_loss_weight * aux_loss
        return loss, {"loss": main, "total_loss": loss, "t_mean": t_graph.float().mean(), **aux}

    def valid_count(self, mask: torch.Tensor) -> torch.Tensor:
        """The entries of ``mask`` that a masked mean divides by: its sum, or
        while ``stats_group`` holds a process group, the whole batch's sum
        across the group over the group's size (the ranks' mean of their
        means, which data-parallel training takes, is then the whole batch's)."""
        n_valid = mask.sum()
        if self.stats_group is not None:
            import torch.distributed as dist

            n_valid = n_valid.clone()
            dist.all_reduce(n_valid, group=self.stats_group)
            n_valid = n_valid / dist.get_world_size(self.stats_group)
        return n_valid

    def make_optimizer(self) -> Adafactor:
        """Adafactor with HF-style relative step sizes (the JAX
        ``make_optimizer``): lr_t = min(1e-2, 1/√t) × min(1, t/warmup), scaled
        by each parameter's RMS, factored over the same two dimensions as
        optax factors the JAX package's layout of each parameter."""
        return Adafactor(hf_relative_schedule(self.cfg.warmup_steps), reference_layouts(self))

    @torch.no_grad()
    def sample(
        self,
        batch: PuzzleBatch,
        generator: torch.Generator | None = None,
        keep_trajectory: bool = False,
        inference_ratio: int | None = None,
    ) -> SampleLoopResult:
        """Full reverse process; ``batch`` holds tensors on the model's device.
        Returns SampleLoopResult with final (B, N, C) f32. On a model sharded
        over a tp group (``parallel/mesh.py:shard_params``) every rank of the
        group calls it on the same batch with a generator seeded alike: the
        positions stay replicated."""
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
    def evaluate(self, batch: PuzzleBatch, generator: torch.Generator | None = None) -> dict:
        """Sample, then score (``metrics_from_final``)."""
        return self.metrics_from_final(self.sample(batch, generator).final, batch)

    @torch.no_grad()
    def piece_table(self, final: torch.Tensor, batch: PuzzleBatch) -> dict:
        """Per-piece (B, N) arrays for error analysis: whether each piece's
        assignment is right, both assignments, the mask, the raw position
        error and the true position; with rotation also whether the rotation
        is within 45°, its cosine and the true rotation."""
        valid = batch.node_mask
        pred_pos = final[..., :2]
        pred_ass = greedy_assignment_batch(pred_pos, batch.grid, valid)
        gt_ass = greedy_assignment_batch(batch.x0[..., :2], batch.grid, valid)
        out = {"pos_correct": (pred_ass == gt_ass) & valid, "pred_ass": pred_ass, "gt_ass": gt_ass,
               "valid": valid, "pos_err": torch.linalg.norm(pred_pos - batch.x0[..., :2], dim=-1),
               "gt_pos": batch.x0[..., :2]}
        if self.cfg.rotation:
            cos = _rotation_cosine(final[..., 2:4], batch.x0[..., 2:4])
            out.update(rot_correct=cos > math.cos(math.pi / 4), rot_cos=cos, gt_rot=batch.x0[..., 2:4])
        return out

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
            piece_correct = piece_correct & (_rotation_cosine(final[..., 2:4], batch.x0[..., 2:4])
                                             > math.cos(math.pi / 4))
        n_valid = torch.clamp(valid.sum(-1), min=1)
        return {
            "piece_acc": piece_correct.sum(-1) / n_valid,
            "puzzle_correct": (piece_correct | ~valid).all(-1).float(),
            "n_valid": n_valid,
        }


def _rotation_cosine(pred_rot: torch.Tensor, gt_rot: torch.Tensor) -> torch.Tensor:
    return (pred_rot * gt_rot).sum(-1) / torch.clamp(
        torch.linalg.norm(pred_rot, dim=-1) * torch.linalg.norm(gt_rot, dim=-1), min=1e-8)


def _huber(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """``optax.huber_loss``: 0.5·min(|e|, δ)² + δ·(|e| − min(|e|, δ))."""
    abs_err = (pred - target).abs()
    quadratic = torch.clamp(abs_err, max=delta)
    return 0.5 * quadratic**2 + delta * (abs_err - quadratic)
