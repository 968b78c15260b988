"""Discrete (D3PM) 2D puzzle diffusion and its rotation/cold-diffusion variant
— port of the JAX package's ``models/diffusion_2d_discrete.py``.

Uniform transitions Q_t = (1 − β_t)I + β_t/K·J over K = H·W grid cells, in
closed form: Q̄_t = ᾱ_t I + (1 − ᾱ_t)/K·J, so the marginals and the posterior
are axpys on one-hots and softmaxes. Categorical draws are Gumbel-max:
argmax(logits + g) with g = −log(−log U). Every draw can be handed in (the
``gumbel_*`` arguments, ``loss_draws``, ``sample``'s ``draws``), which is how
the tests feed the JAX package's.

- ``DiscreteDiffusion2D``: positions only; cross-entropy / variational-bound
  / hybrid loss with the feats-only aux CE; a Gumbel ancestral sampler (a
  Python loop over the DDIM timesteps, classifier-free mix on the logits)
  decoded to grid positions.
- ``DiscreteDiffusion2DRot``: two chains, positions and 4 rotation classes;
  the sampler re-rotates every patch by −(accumulated rotation) and re-runs
  the encoder each step (from the four rot90 copies made once), taking the
  posterior-sampled rotation with ``cold_diffusion`` and the argmax-x₀ one
  otherwise; ``only_rotation`` feeds the true cells.

As in the JAX package, ``init`` of these models reads no ``encoder_init``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..data.batch import PuzzleBatch
from ..nn.denoiser import GraphDenoiser2D
from ..nn.layers import init_weights
from ..nn.visual import FEATURE_DIM
from ..ops.gaussian import SampleLoopResult
from .diffusion_2d import Diffusion2D, Diffusion2DConfig

_EPS = 1e-8
_LN2 = math.log(2.0)


# ---------------------------------------------------------------- D3PM math


def _one_hot(idx: torch.Tensor, k: int) -> torch.Tensor:
    return F.one_hot(idx.long(), k).float()


def d3pm_marginal_probs(x0_onehot: torch.Tensor, t: torch.Tensor, alphabar: torch.Tensor, k: int) -> torch.Tensor:
    """Row of Q̄_t for x0: ᾱ_t·onehot + (1 − ᾱ_t)/K."""
    a = alphabar[t][..., None]
    return a * x0_onehot + (1.0 - a) / k


def gumbel(shape, generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """Standard Gumbel draws, −log(−log U) with U uniform on [tiny, 1) in f32."""
    u = torch.rand(shape, generator=generator, device=device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def d3pm_q_sample(x0_idx: torch.Tensor, t: torch.Tensor, alphabar: torch.Tensor, k: int,
                  gumbel_noise: torch.Tensor) -> torch.Tensor:
    """Forward noising: a categorical draw from the marginal, Gumbel-max over
    its log-probabilities with the given (…, K) Gumbel draws."""
    probs = d3pm_marginal_probs(_one_hot(x0_idx, k), t, alphabar, k)
    return torch.argmax(torch.log(probs + 1e-9) + gumbel_noise, dim=-1)


def d3pm_posterior_logits(x_t_idx, x0_logits, t, t_prev, alphabar, k: int, x0_is_onehot: bool = False):
    """log q(x_{t_prev} | x_t, x0) for uniform transitions, Q̄_t Q̄_s⁻¹ in the
    ratio form ᾱ_t/ᾱ_s; at t = 0 the x0 logits themselves."""
    a_t = alphabar[t][..., None]
    a_s = alphabar[torch.clamp(t_prev, min=0)][..., None]
    a_ts = a_t / a_s
    fact1 = a_ts * _one_hot(x_t_idx, k) + (1.0 - a_ts) / k
    if x0_is_onehot:
        p0, tzero_logits = x0_logits, torch.log(x0_logits + _EPS)
    else:
        p0, tzero_logits = torch.softmax(x0_logits, dim=-1), x0_logits
    fact2 = a_s * p0 + (1.0 - a_s) / k
    out = torch.log(fact1 + _EPS) + torch.log(fact2 + _EPS)
    return torch.where((t == 0)[..., None], tzero_logits, out)


def categorical_kl_logits(logits1: torch.Tensor, logits2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """KL(C(logits1) ‖ C(logits2))."""
    p1 = torch.softmax(logits1 + eps, dim=-1)
    return (p1 * (torch.log_softmax(logits1 + eps, dim=-1) - torch.log_softmax(logits2 + eps, dim=-1))).sum(-1)


def vb_term(pred_x0_logits, x0_idx, x_t_idx, t, alphabar, k: int) -> torch.Tensor:
    """Per-node variational-bound term in bits: KL(true ‖ model) at t > 0,
    the decoder's NLL at t = 0."""
    model_logits = d3pm_posterior_logits(x_t_idx, pred_x0_logits, t, t - 1, alphabar, k)
    x0_onehot = _one_hot(x0_idx, k)
    true_logits = d3pm_posterior_logits(x_t_idx, x0_onehot, t, t - 1, alphabar, k, x0_is_onehot=True)
    true_logits = torch.where((t == 0)[..., None], torch.log(x0_onehot + _EPS), true_logits)
    kl = categorical_kl_logits(true_logits, model_logits) / _LN2
    nll = -torch.log_softmax(pred_x0_logits, dim=-1).gather(-1, x0_idx.long()[..., None])[..., 0] / _LN2
    return torch.where(t == 0, nll, kl)


def cross_entropy_smoothed(logits: torch.Tensor, labels: torch.Tensor, k: int, smoothing: float = 1e-2):
    """Cross-entropy with label smoothing ``smoothing``."""
    target = _one_hot(labels, k) * (1 - smoothing) + smoothing / k
    return -(target * torch.log_softmax(logits, dim=-1)).sum(-1)


def gumbel_argmax(logits: torch.Tensor, t: torch.Tensor, gumbel_noise: torch.Tensor) -> torch.Tensor:
    """Ancestral categorical step: argmax(logits + 1{t > 0}·g)."""
    mask = (t != 0)[..., None].to(logits.dtype)
    return torch.argmax(logits + mask * gumbel_noise, dim=-1)


def indices_from_positions(x0_pos: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Each node's grid cell: the nearest anchor to its position target."""
    d = ((x0_pos[:, :, None, :] - grid[:, None, :, :]) ** 2).sum(-1)
    return torch.argmin(d, dim=-1)


def rot_class_from_vec(rot_vec: torch.Tensor) -> torch.Tensor:
    """Unit vector [[1,0],[0,1],[-1,0],[0,-1]] → class 0..3."""
    ang = torch.atan2(rot_vec[..., 1], rot_vec[..., 0])
    return torch.remainder(torch.round(ang / (math.pi / 2)).to(torch.int64), 4)


# -------------------------------------------------------------------- models


@dataclasses.dataclass(frozen=True)
class DiscreteDiffusion2DConfig(Diffusion2DConfig):
    n_classes: int = 36  # K = H·W
    discrete_loss: str = "vb"  # cross_entropy | vb | hybrid
    lambda_loss: float = 0.01
    cold_diffusion: bool = False
    only_rotation: bool = False


class DiscreteDiffusion2D(Diffusion2D):
    """Position-only D3PM."""

    cfg: DiscreteDiffusion2DConfig

    def make_denoiser(self, config) -> GraphDenoiser2D:
        return GraphDenoiser2D(
            steps=config.steps, feature_dim=FEATURE_DIM, n_layers=config.n_layers,
            architecture=config.architecture, virt_nodes=config.virt_nodes, hidden_dim=config.hidden_dim,
            heads=config.heads, aux_head=config.aux_loss_weight > 0, discrete=True,
            n_classes=config.n_classes, rot_classes=4 if config.rotation else 0, dtype=config.dtype)

    @torch.no_grad()
    def init(self, seed: int = 0) -> None:
        """Fresh seeded weights; like the JAX package's discrete ``init``, no ``encoder_init``."""
        if self.cfg.visual_pretrained:
            raise NotImplementedError(
                "visual_pretrained (load_pretrained_features) is not ported yet: ROADMAP Queue 1 item 6")
        init_weights(self, torch.Generator().manual_seed(seed))

    def denoise_logits(self, x_idx, t, feats, adj, node_mask, rot_idx=None, return_aux: bool = False):
        """The denoiser's logits (a tensor, or {"pos", "rot"}) in f32; with
        ``return_aux`` also the aux head's ({"pos"[, "rot"]}), None when the
        model has no aux head."""

        def f32(o):
            return {k: v.float() for k, v in o.items()} if isinstance(o, dict) else o.float()

        kwargs = {"rot_t": rot_idx} if self.cfg.rotation else {}
        if return_aux and self.denoiser.aux_head:
            out, aux = self.denoiser(x_idx, t, feats, adj, node_mask, return_aux=True, **kwargs)
            return f32(out), f32(aux)
        out = f32(self.denoiser(x_idx, t, feats, adj, node_mask, **kwargs))
        return (out, None) if return_aux else out

    def _node_loss(self, logits, x0_idx, x_t_idx, t, k: int) -> torch.Tensor:
        cfg, ab = self.cfg, self.sched.alphas_cumprod
        if cfg.discrete_loss == "cross_entropy":
            return cross_entropy_smoothed(logits, x0_idx, k)
        vb = vb_term(logits, x0_idx, x_t_idx, t, ab, k)
        if cfg.discrete_loss == "vb":
            return vb
        return cfg.lambda_loss * cross_entropy_smoothed(logits, x0_idx, k) + vb

    def _masked_mean(self, per_node: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
        m = node_mask.float()
        return (per_node * m).sum() / self.valid_count(m).clamp_min(1.0)

    def loss_draws(self, b: int, x_shape: tuple[int, ...], generator: torch.Generator | None,
                   device: torch.device) -> dict[str, torch.Tensor]:
        """t (b,), the Gumbel draws of the position chain's noising (b, N, K)
        and, with classifier-free training, the keep mask (b, 1, 1)."""
        n = x_shape[1]
        out = {"t_graph": torch.randint(0, self.cfg.steps, (b,), generator=generator, device=device),
               "gumbel_x": gumbel((b, n, self.cfg.n_classes), generator, device)}
        if self.cfg.classifier_free_prob > 0:
            out["cf_keep"] = torch.rand((b, 1, 1), generator=generator, device=device) >= self.cfg.classifier_free_prob
        return out

    def loss(self, batch: PuzzleBatch, generator: torch.Generator | None = None, t_graph=None, gumbel_x=None,
             cf_keep=None) -> tuple[torch.Tensor, dict]:
        """The per-node D3PM loss (``discrete_loss``), masked mean over valid
        nodes, plus ``aux_loss_weight`` × the aux head's cross-entropy. The
        draws come from ``generator`` (``loss_draws``) unless given."""
        cfg = self.cfg
        b, n = batch.x0.shape[:2]
        if t_graph is None:
            draws = self.loss_draws(b, batch.x0.shape, generator, batch.x0.device)
            t_graph, gumbel_x, cf_keep = draws["t_graph"], draws["gumbel_x"], draws.get("cf_keep")
        t = t_graph[:, None].expand(b, n)
        x0_idx = indices_from_positions(batch.x0[..., :2], batch.grid)
        x_t = d3pm_q_sample(x0_idx, t, self.sched.alphas_cumprod, cfg.n_classes, gumbel_x)
        feats = self.visual_features(batch.patches)
        if cfg.classifier_free_prob > 0:
            feats = feats * cf_keep.to(feats.dtype)
        logits, aux_logits = self.denoise_logits(x_t, t, feats, batch.adj, batch.node_mask, return_aux=True)
        loss = self._masked_mean(self._node_loss(logits, x0_idx, x_t, t, cfg.n_classes), batch.node_mask)
        metrics = {"loss": loss}
        total = loss
        if aux_logits is not None:
            aux_loss = self._masked_mean(cross_entropy_smoothed(aux_logits["pos"], x0_idx, cfg.n_classes),
                                         batch.node_mask)
            total = loss + cfg.aux_loss_weight * aux_loss
            metrics.update(aux_loss=aux_loss, total_loss=total)
        return total, metrics

    def _init_and_steps(self, b: int, n: int, generator, draws: dict | None, ratio: int, chains: int):
        """The initial cells (and rotation classes) and the timesteps."""
        draws = draws or {}
        dev = self.device
        init = [draws["init_idx"]] if "init_idx" in draws else [
            torch.randint(0, self.cfg.n_classes, (b, n), generator=generator, device=dev)]
        if chains == 2:
            init.append(draws["init_rot"] if "init_rot" in draws
                        else torch.randint(0, 4, (b, n), generator=generator, device=dev))
        return [x.to(dev, torch.int64) for x in init], [int(t) for t in self.sched.timesteps(ratio)]

    def _draw(self, draws: dict | None, key: str, i: int, shape, generator) -> torch.Tensor:
        return draws[key][i].to(self.device) if draws and key in draws else gumbel(shape, generator, self.device)

    @torch.no_grad()
    def sample(self, batch: PuzzleBatch, generator: torch.Generator | None = None, keep_trajectory: bool = False,
               inference_ratio: int | None = None, draws: dict | None = None) -> SampleLoopResult:
        """Gumbel ancestral sampling over the DDIM timesteps; ``final`` the
        grid positions of the sampled cells (B, N, 2). ``draws`` may hold
        ``init_idx`` (B, N) and ``gumbel`` (S, B, N, K), else they come from
        ``generator``."""
        cfg = self.cfg
        b, n = batch.x0.shape[:2]
        ratio = inference_ratio or cfg.inference_ratio
        (x,), ts = self._init_and_steps(b, n, generator, draws, ratio, 1)
        feats = self.visual_features(batch.patches)
        zero_feats = torch.zeros_like(feats)
        ab = self.sched.alphas_cumprod
        traj = []
        for i, t_scalar in enumerate(ts):
            t = torch.full((b, n), t_scalar, dtype=torch.int64, device=self.device)
            logits = self.denoise_logits(x, t, feats, batch.adj, batch.node_mask)
            if cfg.classifier_free_prob > 0 and cfg.classifier_free_w != 0:
                uncond = self.denoise_logits(x, t, zero_feats, batch.adj, batch.node_mask)
                logits = (1 + cfg.classifier_free_w) * logits - cfg.classifier_free_w * uncond
            post = d3pm_posterior_logits(x, logits, t, t - ratio, ab, cfg.n_classes)
            x = gumbel_argmax(post, t, self._draw(draws, "gumbel", i, post.shape, generator))
            if keep_trajectory:
                traj.append(x)
        final_pos = torch.gather(batch.grid, 1, x[..., None].expand(b, n, 2))
        return SampleLoopResult(final=final_pos, trajectory=torch.stack(traj) if keep_trajectory else None)

    @torch.no_grad()
    def metrics_from_final(self, final: torch.Tensor, batch: PuzzleBatch) -> dict:
        """A piece is right when its cell is; a puzzle when all its pieces are."""
        return self._metrics(self._piece_correct(final, batch), batch.node_mask)

    def _piece_correct(self, final, batch) -> torch.Tensor:
        pred_idx = indices_from_positions(final[..., :2], batch.grid)
        gt_idx = indices_from_positions(batch.x0[..., :2], batch.grid)
        return (pred_idx == gt_idx) & batch.node_mask

    @staticmethod
    def _metrics(piece_correct: torch.Tensor, valid: torch.Tensor) -> dict:
        n_valid = torch.clamp(valid.sum(-1), min=1)
        return {"piece_acc": piece_correct.sum(-1) / n_valid,
                "puzzle_correct": (piece_correct | ~valid).all(-1).float(), "n_valid": n_valid}


class DiscreteDiffusion2DRot(DiscreteDiffusion2D):
    """Two-chain D3PM (positions + 4-fold rotations) with cold-diffusion patch re-rotation."""

    def loss_draws(self, b, x_shape, generator, device) -> dict[str, torch.Tensor]:
        """t (b,) and the Gumbel draws of both chains' noising, (b, N, K) and (b, N, 4)."""
        n = x_shape[1]
        return {"t_graph": torch.randint(0, self.cfg.steps, (b,), generator=generator, device=device),
                "gumbel_x": gumbel((b, n, self.cfg.n_classes), generator, device),
                "gumbel_r": gumbel((b, n, 4), generator, device)}

    def loss(self, batch: PuzzleBatch, generator: torch.Generator | None = None, t_graph=None, gumbel_x=None,
             gumbel_r=None) -> tuple[torch.Tensor, dict]:
        """rot_loss (+ x_loss unless ``only_rotation``) + aux CE of both heads."""
        cfg = self.cfg
        b, n = batch.x0.shape[:2]
        if t_graph is None:
            draws = self.loss_draws(b, batch.x0.shape, generator, batch.x0.device)
            t_graph, gumbel_x, gumbel_r = draws["t_graph"], draws["gumbel_x"], draws["gumbel_r"]
        t = t_graph[:, None].expand(b, n)
        x0_idx = indices_from_positions(batch.x0[..., :2], batch.grid)
        rot0_idx = rot_class_from_vec(batch.x0[..., 2:4])
        ab = self.sched.alphas_cumprod
        x_t = d3pm_q_sample(x0_idx, t, ab, cfg.n_classes, gumbel_x)
        rot_t = d3pm_q_sample(rot0_idx, t, ab, 4, gumbel_r)
        if cfg.only_rotation:
            x_t = x0_idx
        feats = self.visual_features(batch.patches)
        out, aux_logits = self.denoise_logits(x_t, t, feats, batch.adj, batch.node_mask, rot_idx=rot_t,
                                              return_aux=True)
        losses = {"rot_loss": self._masked_mean(self._node_loss(out["rot"], rot0_idx, rot_t, t, 4), batch.node_mask)}
        if not cfg.only_rotation:
            losses["x_loss"] = self._masked_mean(self._node_loss(out["pos"], x0_idx, x_t, t, cfg.n_classes),
                                                 batch.node_mask)
        total = sum(losses.values())
        metrics = {**losses, "loss": total}
        if aux_logits is not None:
            aux_ce = (cross_entropy_smoothed(aux_logits["pos"], x0_idx, cfg.n_classes)
                      + cross_entropy_smoothed(aux_logits["rot"], rot0_idx, 4))
            aux_loss = self._masked_mean(aux_ce, batch.node_mask)
            total = total + cfg.aux_loss_weight * aux_loss
            metrics.update(aux_loss=aux_loss, total_loss=total)
        return total, metrics

    @torch.no_grad()
    def sample(self, batch: PuzzleBatch, generator: torch.Generator | None = None, keep_trajectory: bool = False,
               inference_ratio: int | None = None, draws: dict | None = None) -> SampleLoopResult:
        """Both chains; each step the patches are turned by −(accumulated
        rotation) and the encoder re-runs. ``final`` (B, N, 4): the sampled
        cells' grid positions and the accumulated rotation's unit vector.
        ``draws`` may hold ``init_idx``, ``init_rot`` (B, N), ``gumbel`` (S,
        B, N, K) and ``gumbel_rot`` (S, B, N, 4)."""
        cfg = self.cfg
        b, n = batch.x0.shape[:2]
        dev = self.device
        ratio = inference_ratio or cfg.inference_ratio
        (x, r), ts = self._init_and_steps(b, n, generator, draws, ratio, 2)
        ab = self.sched.alphas_cumprod
        # the four rotated copies of every patch, made once; each step gathers from them
        patches4 = torch.stack([torch.rot90(batch.patches, k, dims=(2, 3)) for k in range(4)], dim=2)
        rows, cols = torch.arange(b, device=dev)[:, None], torch.arange(n, device=dev)[None, :]
        gt_idx = indices_from_positions(batch.x0[..., :2], batch.grid)
        rot_acc = torch.zeros((b, n), dtype=torch.int64, device=dev)
        traj = []
        for i, t_scalar in enumerate(ts):
            feats = self.visual_features(patches4[rows, cols, torch.remainder(-rot_acc, 4)])
            t = torch.full((b, n), t_scalar, dtype=torch.int64, device=dev)
            out = self.denoise_logits(gt_idx if cfg.only_rotation else x, t, feats, batch.adj, batch.node_mask,
                                      rot_idx=r)
            post_x = d3pm_posterior_logits(x, out["pos"], t, t - ratio, ab, cfg.n_classes)
            x = gumbel_argmax(post_x, t, self._draw(draws, "gumbel", i, post_x.shape, generator))
            post_r = d3pm_posterior_logits(r, out["rot"], t, t - ratio, ab, 4)
            rot_prev_t = gumbel_argmax(post_r, t, self._draw(draws, "gumbel_rot", i, post_r.shape, generator))
            r = rot_prev_t if cfg.cold_diffusion else torch.argmax(out["rot"], dim=-1)
            rot_acc = torch.remainder(rot_acc + r, 4)
            if keep_trajectory:
                traj.append(torch.stack([x, rot_acc], dim=-1))
        final_pos = torch.gather(batch.grid, 1, x[..., None].expand(b, n, 2))
        ang = rot_acc.float() * (math.pi / 2)
        final = torch.cat([final_pos, torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)], dim=-1)
        return SampleLoopResult(final=final, trajectory=torch.stack(traj) if keep_trajectory else None)

    def _piece_correct(self, final, batch) -> torch.Tensor:
        """Both the cell and the rotation class right."""
        rot_right = rot_class_from_vec(final[..., 2:4]) == rot_class_from_vec(batch.x0[..., 2:4])
        return super()._piece_correct(final, batch) & rot_right
