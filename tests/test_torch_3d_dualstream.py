"""Split equivariant/invariant message passing in the port against the JAX
package, on the CPU: ``TransformerConvLayer``'s ``kv`` and ``skip_only``,
``DualStreamGraphTransformer`` (``nn/gnn.py``) and ``GraphDenoiser3D`` with
``equiv_inv_mp`` (``nn/denoiser.py``), outputs and gradients, and
``Diffusion3D``'s upgrade of ``vn_dgcnn`` to the [equiv ‖ inv] encoder.

Seeded numpy inputs and parameters, f32 on both sides. Tolerances: outputs
1e-5 of their largest entry (measured at most 3.0e-7: sums of a few hundred
products in another order); gradients 1e-4 of each parameter's largest
entry plus 1e-6 of the largest over the model (through the softmax's
backward and both streams' shared weights)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.nn.denoiser import GraphDenoiser3D as JDenoiser3D
from diffassemble_tpu.nn.gnn import DualStreamGraphTransformer as JDual
from diffassemble_tpu.nn.gnn import TransformerConvLayer as JConv
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.models import Diffusion3D, Diffusion3DConfig
from diffassemble_tpu_torch.nn import gnn as tgnn
from diffassemble_tpu_torch.nn.denoiser import GraphDenoiser3D
from test_torch_3d import _init_shapes, _load, seeded_tree


def _close(got: torch.Tensor, want, rel: float) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6))


def _graph(seed, b=2, p=5, d=12):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, p), bool)
    mask[1, 3:] = False  # padding parts: empty rows and unattended keys
    adj = mask[:, :, None] & mask[:, None, :]
    return rng, adj, [rng.standard_normal((b, p, d)).astype(np.float32) for _ in range(2)]


def _grads_close(tm: torch.nn.Module, jgrads: dict, name: str) -> None:
    want = convert.convert_params({name: jax.tree.map(np.asarray, jgrads)}, convert.HEADS_3D)
    got = {f"{name}.{k}": p.grad for k, p in tm.named_parameters()}
    assert want.keys() == got.keys()
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k, w in want.items():
        g = got[k].numpy()
        tol = 1e-4 * float(np.abs(w.numpy()).max()) + 1e-6 * gmax
        assert np.abs(g - w.numpy()).max() <= tol, k


def test_transformer_conv_layer_takes_keys_and_values_from_a_second_stream():
    _, adj, (x, kv) = _graph(1)
    jm = JConv(8, heads=2)
    params = seeded_tree(_init_shapes(jm, jnp.asarray(x), jnp.asarray(adj)), 2)
    tm = tgnn.TransformerConvLayer(12, 8, heads=2)
    _load(tm, params, "layer")
    for kw in ({"kv": kv}, {"skip_only": True}):
        want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(adj),
                        **{k: jnp.asarray(v) if k == "kv" else v for k, v in kw.items()})
        with torch.no_grad():
            got = tm(torch.tensor(x), torch.tensor(adj), **{k: torch.tensor(v) if k == "kv" else v
                                                            for k, v in kw.items()})
        _close(got, want, 1e-5)


def test_dual_stream_graph_transformer_matches_with_gradients():
    rng, adj, (x_e, x_i) = _graph(3)
    jm = JDual(hidden_dim=16, heads=2, output_size=12, n_layers=3)
    jin = [jnp.asarray(a) for a in (x_e, x_i, adj, adj.any(-1))]
    params = seeded_tree(_init_shapes(jm, *jin), 4)
    cot = rng.standard_normal((2, 5, 12)).astype(np.float32)

    def jloss(params, x_e, x_i):
        return jnp.sum(jm.apply({"params": params}, x_e, x_i, *jin[2:])[0] * cot)

    want = jm.apply({"params": params}, *jin)[0]
    jg, jge, jgi = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(params, *jin[:2])
    tm = tgnn.DualStreamGraphTransformer(12, hidden_dim=16, heads=2, output_size=12, n_layers=3)
    _load(tm, params, "gnn")
    te, ti = (torch.tensor(a, requires_grad=True) for a in (x_e, x_i))
    got, weights = tm(te, ti, torch.tensor(adj), torch.tensor(adj.any(-1)))
    assert weights is None
    _close(got, want, 1e-5)
    (got * torch.tensor(cot)).sum().backward()
    _close(te.grad, jge, 1e-4)
    _close(ti.grad, jgi, 1e-4)
    _grads_close(tm, jg, "gnn")


def test_skip_only_layers_launch_no_attention(monkeypatch):
    """A pass of n layers runs n attentions: the invariant stream's skip
    projection attends to nothing."""
    _, adj, (x_e, x_i) = _graph(5)
    tm = tgnn.DualStreamGraphTransformer(12, hidden_dim=16, heads=2, output_size=12, n_layers=4)
    calls = []
    attend = tgnn.masked_attention
    monkeypatch.setattr(tgnn, "masked_attention", lambda *a, **k: calls.append(a[0].shape) or attend(*a, **k))
    with torch.no_grad():
        tm(torch.tensor(x_e), torch.tensor(x_i), torch.tensor(adj), None)
    assert len(calls) == 4 and calls[-1][-1] == 6 and all(c[-1] == 8 for c in calls[:-1])


@pytest.mark.parametrize("rel_channels", [0, 13])
def test_split_message_passing_denoiser_matches_with_gradients(rel_channels):
    b, p, f, equiv = 2, 5, 24, 18
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, p, 7)).astype(np.float32)
    t = rng.integers(0, 20, (b, p)).astype(np.int32)
    feats = rng.standard_normal((b, p, f)).astype(np.float32)
    mask = np.ones((b, p), bool)
    mask[1, 3:] = False
    adj = mask[:, :, None] & mask[:, None, :]
    rel = rng.standard_normal((b, p, 13)).astype(np.float32) if rel_channels else None
    kw = dict(steps=20, feature_dim=f, n_layers=3, hidden_dim=16, heads=2, equiv_inv_mp=True, equiv_dim=equiv,
              rel_channels=rel_channels)
    jm = JDenoiser3D(**kw)
    jin = [jnp.asarray(a) for a in (x, t, feats, adj, mask)]
    jrel = None if rel is None else jnp.asarray(rel)
    params = seeded_tree(_init_shapes(jm, *jin, jrel), 9)
    assert "DualStreamGraphTransformer_0" in params
    cot = rng.standard_normal((b, p, 7)).astype(np.float32)

    def jloss(params, feats):
        return jnp.sum(jm.apply({"params": params}, jin[0], jin[1], feats, *jin[3:], rel_ctx=jrel) * cot)

    want = jm.apply({"params": params}, *jin, rel_ctx=jrel)
    jg, jgf = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jin[2])
    tm = GraphDenoiser3D(**kw)
    _load(tm, params, "denoiser")
    tf = torch.tensor(feats, requires_grad=True)
    got = tm(torch.tensor(x), torch.tensor(t), tf, torch.tensor(adj), torch.tensor(mask),
             rel_ctx=None if rel is None else torch.tensor(rel))
    assert got.dtype == torch.float32 and got.shape == (b, p, 7)
    _close(got, want, 1e-5)
    (got * torch.tensor(cot)).sum().backward()
    _close(tf.grad, jgf, 1e-4)
    _grads_close(tm, jg, "denoiser")


def test_diffusion3d_upgrades_vn_dgcnn_for_split_message_passing():
    small = dict(backbone="vn_dgcnn", n_layers=2, hidden_dim=16, heads=2, max_num_part=3, equiv_inv_mp=True,
                 compute_dtype="float32")
    model = Diffusion3D(Diffusion3DConfig(**small), device="cpu")
    assert model.feat_dim == 1024 and model.equiv_dim == 768
    assert isinstance(model.denoiser.gnn, tgnn.DualStreamGraphTransformer)
    with pytest.raises(ValueError, match="vn_dgcnn"):
        Diffusion3D(Diffusion3DConfig(**{**small, "backbone": "pointnet"}), device="cpu")
    with pytest.raises(ValueError, match="transformer"):
        GraphDenoiser3D(steps=10, architecture="exophormer", equiv_inv_mp=True)
