"""SE(3) double diffusion for 3D fragment reassembly — port of the JAX
package's ``models/diffusion_3d.py``.

An R³ Gaussian chain for translations and an SO(3) chain for rotations; the
reverse process is DDIM: the state splits into [quat (4) ‖ trans (3)], the
translation takes the Euclidean update and the rotation the Lie-group update
(geodesic scaling through ``so3_scale``). Sampling starts rotations at the
identity and translations at ``noise_weight``·N(0, 1), computes the point
features once per batch and, with ``rel_condition``, the pairwise head's
outputs once, then runs the steps as a Python loop. Metrics per object:
rmse_t, rmse_r (euler degrees), gd_r (radians) and part_acc (per-part
CD < 0.01).

Training: ``q_sample_tr`` (Gaussian) and ``q_sample_rot`` (the clean
rotation scaled by √ᾱ_t through ``so3_scale``, then right-multiplied by an
IGSO3(√(1 − ᾱ_t)) draw from the per-step inverse-CDF table of
``ops/igso3.py``); ``loss`` (the five-term dict or the ``split`` pair, the
aux-pose pass at t = 0, the relative-pose losses); ``make_optimizer``
(Adafactor with the HF relative schedule, as the 2D model's).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import convert
from ..data.batch import FragmentBatch
from ..nn.denoiser import GraphDenoiser3D
from ..nn.layers import init_weights
from ..nn.pointnet import make_point_encoder
from ..nn.relpose import RelPoseHead, rel_consensus, split_equiv_inv
from ..ops import so3
from ..ops.gaussian import SampleLoopResult
from ..ops.igso3 import build_igso3_inverse_cdf, igso3_draws, igso3_sample
from ..ops.schedules import DiffusionSchedule, extract
from ..train.adafactor import Adafactor, hf_relative_schedule, reference_layouts
from ..utils.device import resolve_device
from ..utils.params import load_params
from . import losses_3d


@dataclasses.dataclass(frozen=True)
class Diffusion3DConfig:
    """The JAX package's config, field for field, so that a run's
    ``config.json`` loads unchanged. ``attention_impl`` and ``remat`` are
    carried but not read: the port dispatches attention by device."""

    steps: int = 300
    sampling: str = "ddim"
    inference_ratio: int = 10
    mean_type: str = "xstart"
    scheduler: str = "linear"
    noise_weight: float = 0.0
    loss_type: str = "all"
    backbone: str = "vn_dgcnn"
    architecture: str = "transformer"
    n_layers: int = 4
    virt_nodes: int = 8
    hidden_dim: int = 256
    heads: int = 8
    max_num_part: int = 20
    use_6dof: bool = False
    equiv_inv_mp: bool = False
    freeze_backbone: bool = False
    diffuse_rotation: bool = True
    diffuse_translation: bool = True
    learning_rate: float = 1e-4
    aux_pose_weight: float = 0.0
    rot_pt_l2_weight: float = 0.0
    encoder_init: str = ""
    rel_pose_weight: float = 0.0
    rel_condition: bool = False
    contact_thresh: float = 0.1
    rel_k: int = 16
    compute_dtype: str = "float32"
    warmup_steps: int = 0
    attention_impl: str = "auto"
    remat: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


class Diffusion3D(nn.Module):
    """Point encoder + relative-pose head + denoiser + sampler.

    Built with seeded random weights (``seed``) on ``device``; load converted
    JAX weights with
    ``load_state_dict(convert.convert_params(params, convert.HEADS_3D))``.
    The constructor reads no file: ``init`` loads the ``encoder_init`` npz,
    so a model given its weights never reads it.
    """

    def __init__(self, config: Diffusion3DConfig, device: torch.device | str = "cuda", seed: int = 0):
        super().__init__()
        if config.sampling != "ddim":
            raise ValueError("Diffusion3D is DDIM-only, as the reference's 3D model is")
        device = resolve_device(device)
        self.cfg = config
        self.sched = DiffusionSchedule.create(config.steps, config.scheduler, device)
        backbone = config.backbone
        self.use_rel = config.rel_pose_weight > 0 or config.rel_condition
        if config.equiv_inv_mp or self.use_rel:
            if backbone not in ("vn_dgcnn", "vn_dgcnn_equiv_inv", "vn_dgcnn_rich"):
                raise ValueError("equiv_inv_mp / rel_pose pathways require backbone='vn_dgcnn' or "
                                 "'vn_dgcnn_rich' (the relative-rotation head is built on VN-equivariant features)")
            if backbone == "vn_dgcnn":
                backbone = "vn_dgcnn_equiv_inv"  # [equiv(768) ‖ inv(256)]
        # the [equiv ‖ inv] split point of the both=True layouts
        self.equiv_dim = 1536 if backbone == "vn_dgcnn_rich" else 768
        self.encoder, self.feat_dim = make_point_encoder(backbone, dtype=config.dtype)
        self.rel_head = (RelPoseHead(self.equiv_dim // 3, self.feat_dim - self.equiv_dim, k=config.rel_k)
                         if self.use_rel else None)
        self.denoiser = GraphDenoiser3D(
            steps=config.steps,
            input_channels=13 if config.use_6dof else 7,
            feature_dim=self.feat_dim,
            n_layers=config.n_layers,
            architecture=config.architecture,
            virt_nodes=config.virt_nodes,
            hidden_dim=config.hidden_dim,
            heads=config.heads,
            use_6dof=config.use_6dof,
            equiv_inv_mp=config.equiv_inv_mp,
            equiv_dim=self.equiv_dim,
            rel_channels=13 if config.rel_condition else 0,
            dtype=config.dtype,
        )
        # the IGSO3 inverse-CDF table for eps_t = √(1 − ᾱ_t), one row per step:
        # a buffer, so it follows ``.to()``, kept out of the state_dict
        self.register_buffer("igso3_table", torch.as_tensor(
            build_igso3_inverse_cdf(self.sched.sqrt_one_minus_alphas_cumprod.cpu().numpy()), device=device),
            persistent=False)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device)
        self.stats_group = None  # a process group: the relative-pose losses' counts span it (loss)

    @property
    def device(self) -> torch.device:
        return self.sched.betas.device

    @torch.no_grad()
    def init(self, seed: int = 0) -> None:
        """Fresh seeded weights, then the ``encoder_init`` npz if the config
        names one (its ``encoder`` subtree, and its ``relpose`` subtree when
        this model has the pairwise head), as the JAX ``init`` does."""
        init_weights(self, torch.Generator().manual_seed(seed))
        if not self.cfg.encoder_init:
            return
        pretrained = load_params(self.cfg.encoder_init)
        parts = [("encoder", "encoder", self.encoder)]
        if self.use_rel and "relpose" in pretrained:
            parts.append(("relpose", "rel_head", self.rel_head))
        for name, prefix, module in parts:
            loaded = convert.convert_params({name: pretrained[name]})
            own = {f"{prefix}.{k}": v for k, v in module.state_dict().items()}
            if loaded.keys() != own.keys() or any(loaded[k].shape != own[k].shape for k in own):
                raise ValueError(f"encoder_init {self.cfg.encoder_init!r}: its {name} does not match this model's")
            module.load_state_dict({k[len(prefix) + 1:]: v for k, v in loaded.items()})

    # ------------------------------------------------------------ features

    def pcd_features(self, pcds: torch.Tensor) -> torch.Tensor:
        """(B, P, N, 3) → (B, P, F), once per batch."""
        b, p = pcds.shape[:2]
        feats = self.encoder(pcds.reshape(b * p, *pcds.shape[2:]))
        if self.cfg.freeze_backbone:
            feats = feats.detach()
        return feats.reshape(b, p, -1)

    def denoise(self, x_t, t, feats, adj, node_mask, rel_ctx=None) -> torch.Tensor:
        return self.denoiser(x_t, t, feats, adj, node_mask, rel_ctx=rel_ctx).float()

    def rel_outputs(self, feats):
        """(rot_raw, offset, conf) of the pairwise head."""
        g, inv = split_equiv_inv(feats.float(), self.equiv_dim)
        return self.rel_head(g, inv)

    def _rel_ctx(self, rel, x, node_mask):
        """The consensus vector from the current pose estimate x (B, P, ≥7)."""
        rot_raw, offset, conf = rel
        return rel_consensus(rot_raw, offset, conf, x[..., :4], x[..., 4:7], node_mask)

    # ------------------------------------------------------- forward chain

    def q_sample_tr(self, x_tr, t, noise):
        s = self.sched
        return extract(s.sqrt_alphas_cumprod, t) * x_tr + extract(s.sqrt_one_minus_alphas_cumprod, t) * noise

    def q_sample_rot(self, rot_mat, t, generator: torch.Generator | None = None,
                     u: torch.Tensor | None = None, axes: torch.Tensor | None = None):
        """R_t = so3_scale(R₀, √ᾱ_t) · IGSO3(√(1 − ᾱ_t)); the IGSO3 draws u
        and axes come from ``generator`` unless given."""
        noise = igso3_sample(self.igso3_table, t, generator, u, axes)
        blended = so3.so3_scale(rot_mat, self.sched.sqrt_alphas_cumprod[t.long()])
        return so3._mm(blended, noise)

    # ------------------------------------------------------------ training

    def loss_draws(self, b: int, x_shape: tuple[int, ...], generator: torch.Generator | None,
                   device: torch.device) -> dict[str, torch.Tensor]:
        """The loss's random draws for ``b`` objects of ``x_shape[1]`` parts,
        in the loss's order: t (b,), the translation noise (b, P, 3), and the
        IGSO3 quantiles u (b, P) and axes (b, P, 3). All are drawn whatever
        the config diffuses."""
        p = x_shape[1]
        t_graph = torch.randint(0, self.cfg.steps, (b,), generator=generator, device=device)
        noise_tr = torch.randn((b, p, 3), generator=generator, device=device)
        rot_u, rot_axes = igso3_draws((b, p), generator, device)
        return {"t_graph": t_graph, "noise_tr": noise_tr, "rot_u": rot_u, "rot_axes": rot_axes}

    def loss(
        self,
        batch: FragmentBatch,
        generator: torch.Generator | None = None,
        t_graph: torch.Tensor | None = None,
        noise_tr: torch.Tensor | None = None,
        rot_u: torch.Tensor | None = None,
        rot_axes: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """Training loss (the JAX ``loss``, the reference's p_losses): one t
        per object, translations noised by ``q_sample_tr`` and rotations by
        ``q_sample_rot``, one denoiser pass, then the ``split`` pair (trans
        L2, rot L2) or the five-term dict weighted by
        ``DEFAULT_LOSS_WEIGHTS`` (``rot_pt_l2_weight`` overrides its weight;
        terms of weight 0 are computed and logged all the same). With
        ``aux_pose_weight`` a second pass denoises the identity pose at t = 0
        (its own consensus vector with ``rel_condition``) and adds its cosine,
        per-point L2 and translation losses; with ``rel_pose_weight`` the
        pairwise head's losses on the ground truth's contact pairs.

        The draws (``loss_draws``) come from ``generator`` unless all are
        given (the tests feed the JAX package's). While ``stats_group`` holds
        a process group, the relative-pose losses divide by the whole batch's
        contact and pair counts across the group over its size
        (``relative_pose_loss``); every other term is a mean over objects,
        which the ranks' mean gets right. Returns (total, the loss dict with
        ``loss`` the total), 0-dim tensors."""
        cfg = self.cfg
        b, p = batch.x0.shape[:2]
        dev = batch.x0.device
        if t_graph is None:
            draws = self.loss_draws(b, batch.x0.shape, generator, dev)
            t_graph, noise_tr, rot_u, rot_axes = (draws[k] for k in ("t_graph", "noise_tr", "rot_u", "rot_axes"))
        t = t_graph[:, None].expand(b, p)
        v = batch.node_mask

        gt_q, gt_t = batch.x0[..., :4], batch.x0[..., 4:7]
        gt_rot = so3.quaternion_to_matrix(gt_q)
        x_tr = self.q_sample_tr(gt_t, t, noise_tr) if cfg.diffuse_translation else gt_t
        if cfg.diffuse_rotation:
            x_rot = self.q_sample_rot(gt_rot, t, u=rot_u, axes=rot_axes)
        else:
            x_rot = torch.eye(3, device=dev).expand(gt_rot.shape)
        x_quat = so3.matrix_to_quaternion(x_rot)
        x_noisy = torch.cat([x_quat, x_tr], dim=-1)
        if cfg.use_6dof:
            x_noisy = torch.cat([x_noisy, so3.matrix_to_sixdof(so3.quaternion_to_matrix(x_quat))], dim=-1)

        feats = self.pcd_features(batch.pcds)
        rel = rel_ctx = None
        if self.use_rel:
            rel = self.rel_outputs(feats)
            if cfg.rel_condition:
                rel_ctx = self._rel_ctx(rel, x_noisy, v)
        pred = self.denoise(x_noisy, t, feats, batch.adj, v, rel_ctx=rel_ctx)
        pred_q, pred_t = self._pose(pred)

        if cfg.loss_type == "split":
            loss_dict = {"trans_loss": losses_3d.trans_l2_loss(pred_t, gt_t, v).mean(),
                         "rot_loss": losses_3d.rot_l2_loss(pred_q, gt_q, v).mean()}
            total = loss_dict["trans_loss"] + loss_dict["rot_loss"]
        else:
            loss_dict = losses_3d.reassembly_loss_dict(batch.pcds, pred_t, gt_t, pred_q, gt_q, v)
            w = dict(losses_3d.DEFAULT_LOSS_WEIGHTS)
            if cfg.rot_pt_l2_weight:
                w["rot_pt_l2_loss"] = cfg.rot_pt_l2_weight
            total = sum(loss_dict[k] * w[k] for k in loss_dict)
        if cfg.aux_pose_weight > 0:
            # feature-only deep supervision: the identity pose denoised at t = 0
            x_id = torch.cat([torch.tensor([1.0, 0, 0, 0], device=dev).expand(gt_q.shape),
                              torch.zeros_like(gt_t)], dim=-1)
            if cfg.use_6dof:
                x_id = torch.cat([x_id, torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=dev).expand(b, p, 6)], dim=-1)
            rel_ctx0 = self._rel_ctx(rel, x_id, v) if cfg.rel_condition else None
            pred0 = self.denoise(x_id, torch.zeros_like(t), feats, batch.adj, v, rel_ctx=rel_ctx0)
            p0_q, p0_t = self._pose(pred0)
            aux = (losses_3d.rot_cosine_loss(p0_q, gt_q, v).mean()
                   + losses_3d.rot_points_l2_loss(batch.pcds, p0_q, gt_q, v).mean()
                   + losses_3d.trans_l2_loss(p0_t, gt_t, v).mean())
            loss_dict["aux_pose_loss"] = aux
            total = total + cfg.aux_pose_weight * aux
        if self.use_rel and cfg.rel_pose_weight > 0:
            contact = losses_3d.contact_matrix(batch.pcds, gt_q, gt_t, v, thresh=cfg.contact_thresh)
            rel_losses = losses_3d.relative_pose_loss(*rel, gt_q, gt_t, contact, v, group=self.stats_group)
            loss_dict.update(rel_losses)
            total = total + cfg.rel_pose_weight * sum(rel_losses.values())
        loss_dict["loss"] = total
        return total, loss_dict

    def _pose(self, out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(quaternion, translation) of a denoiser output."""
        q = out[..., :4]
        if self.cfg.use_6dof:
            q = so3.matrix_to_quaternion(so3.sixdof_to_matrix(out[..., 7:13]))
        return q, out[..., 4:7]

    def make_optimizer(self) -> Adafactor:
        """Adafactor with HF-style relative step sizes (the JAX
        ``make_optimizer``, the 2D model's): lr_t = min(1e-2, 1/√t) ×
        min(1, t/warmup), scaled by each parameter's RMS, factored over the
        same two dimensions as optax factors the JAX package's layout of each
        parameter."""
        return Adafactor(hf_relative_schedule(self.cfg.warmup_steps), reference_layouts(self))

    # ------------------------------------------------------------ sampling

    def _predict_eps_rot(self, x_quat, t, x0_quat):
        """The Lie-group ε̂ (the reference's _predict_eps_from_xstart_rot)."""
        s_recip = self.sched.sqrt_recip_alphas_cumprod[t.long()]
        s_recipm1 = self.sched.sqrt_recipm1_alphas_cumprod[t.long()]
        x_term = so3.so3_scale(so3.quaternion_to_matrix(x_quat), s_recip / s_recipm1)
        x0_term = so3.so3_scale(so3.quaternion_to_matrix(x0_quat), 1.0 / s_recipm1)
        return so3._mm(x_term, x0_term.transpose(-1, -2))

    def ddim_step_se3(self, x, t, model_out, ratio: int):
        """One split DDIM update (the reference's p_sample_ddim)."""
        cfg, s = self.cfg, self.sched
        t_prev = t - ratio
        alpha_prod = extract(s.alphas_cumprod, t)
        alpha_prod_prev = torch.where(t_prev[..., None] >= 0, extract(s.alphas_cumprod, torch.clamp(t_prev, min=0)),
                                      torch.ones_like(alpha_prod))
        beta = 1 - alpha_prod
        x0 = model_out if cfg.mean_type == "xstart" else (x - torch.sqrt(beta) * model_out) / torch.sqrt(alpha_prod)

        x0_q, x0_t = x0[..., :4], x0[..., 4:7]
        if cfg.use_6dof:
            x0_q = so3.matrix_to_quaternion(so3.sixdof_to_matrix(model_out[..., 7:13]))
        x_q, x_tr = x[..., :4], x[..., 4:7]

        # translation: Euclidean DDIM
        eps_tr = (extract(s.sqrt_recip_alphas_cumprod, t) * x_tr - x0_t) / extract(s.sqrt_recipm1_alphas_cumprod, t)
        prev_tr = torch.sqrt(alpha_prod_prev) * x0_t + torch.sqrt(1 - alpha_prod_prev) * eps_tr

        # rotation: geodesic DDIM
        eps_rot = self._predict_eps_rot(x_q, t, x0_q)
        sqrt_prev = torch.sqrt(alpha_prod_prev)[..., 0]
        dir_rot = so3.so3_scale(eps_rot, torch.sqrt(torch.clamp(1 - alpha_prod_prev[..., 0], min=0.0)))
        prev_rot = so3._mm(so3.so3_scale(so3.quaternion_to_matrix(x0_q), sqrt_prev), dir_rot)
        out = torch.cat([so3.matrix_to_quaternion(prev_rot), prev_tr], dim=-1)
        if cfg.use_6dof:
            out = torch.cat([out, so3.matrix_to_sixdof(prev_rot)], dim=-1)
        return out

    @torch.no_grad()
    def sample(self, batch: FragmentBatch, generator: torch.Generator | None = None,
               keep_trajectory: bool = False, inference_ratio: int | None = None,
               noise: torch.Tensor | None = None) -> SampleLoopResult:
        """The reverse process at ``inference_ratio`` (default: the config's);
        ``batch`` holds tensors on the model's device. Rotations start at the
        identity, translations at ``noise_weight`` × a unit normal (B, P, 3)
        drawn from ``generator`` unless ``noise`` gives it. Returns
        SampleLoopResult with final (B, P, 7) f32 (13 with 6-DoF) and, with
        ``keep_trajectory``, every step's state (S, B, P, 7). A model sharded
        over a tp group runs as the 2D model's ``sample`` does: every rank
        on the same batch with a generator seeded alike."""
        cfg = self.cfg
        b, p = batch.x0.shape[:2]
        ratio = inference_ratio or cfg.inference_ratio
        dev = self.device
        if noise is None:
            noise = torch.randn((b, p, 3), generator=generator, device=dev)
        tr0 = noise * cfg.noise_weight
        q0 = torch.tensor([1.0, 0, 0, 0], device=dev).expand(b, p, 4)
        x = torch.cat([q0, tr0], dim=-1)
        if cfg.use_6dof:
            x = torch.cat([x, torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=dev).expand(b, p, 6)], dim=-1)

        feats = self.pcd_features(batch.pcds)
        # the pairwise head reads only the features: once per batch
        rel = self.rel_outputs(feats) if self.use_rel else None
        traj = []
        for t_scalar in self.sched.timesteps(ratio):
            t = torch.full((b, p), int(t_scalar), dtype=torch.long, device=dev)
            rel_ctx = self._rel_ctx(rel, x, batch.node_mask) if cfg.rel_condition else None
            out = self.denoise(x, t, feats, batch.adj, batch.node_mask, rel_ctx=rel_ctx)
            x = self.ddim_step_se3(x, t, out, ratio)
            if keep_trajectory:
                traj.append(x)
        return SampleLoopResult(x, torch.stack(traj) if keep_trajectory else None)

    # ---------------------------------------------------------- evaluation

    @torch.no_grad()
    def evaluate(self, batch: FragmentBatch, generator: torch.Generator | None = None) -> dict:
        return self.metrics_from_final(self.sample(batch, generator).final, batch)

    @torch.no_grad()
    def metrics_from_final(self, final: torch.Tensor, batch: FragmentBatch) -> dict:
        """Per-object rmse_t, rmse_r, gd_r and part_acc, each (B,)."""
        pred_q, pred_t = self._pose(final)
        gt_q, gt_t = batch.x0[..., :4], batch.x0[..., 4:7]
        v = batch.node_mask
        return {
            "rmse_t": losses_3d.trans_rmse(pred_t, gt_t, v),
            "rmse_r": losses_3d.rot_euler_rmse(pred_q, gt_q, v),
            "gd_r": losses_3d.rot_geodesic(pred_q, gt_q, v),
            "part_acc": losses_3d.part_accuracy(batch.pcds, pred_t, gt_t, pred_q, gt_q, v),
        }
