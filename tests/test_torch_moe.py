"""The MMVTS mixture of experts on the port against the JAX package
(``models/multimodal.py`` ``MoELayer`` in both ``moe_impl`` modes, the
capacity dispatch, JAX's expert rule and the expert-sharded dry run). JAX is
imported inside the tests.

Sizes as JAX's tests/test_moe_dispatch.py: H=32, experts of width 64, 8
experts, top 2. In float32 the layer's output and balance loss agree with
JAX's within 1e-5, and one loss's gradients within 1e-4 of each largest
entry; the dispatch agrees with the dense combine at a generous capacity
and drops exactly the tokens GShard's k-major priority drops at a tight
one (JAX's limits: atol 1e-5, rtol 1e-4); the expert-sharded dry run over 2
gloo ranks reproduces the single-process layer within the same limits.
"""

import math

import numpy as np
import pytest
import torch

BASE = dict(hidden_size=32, intermediate_size=64, hidden_dropout=0.0, attention_dropout=0.0,
            moe_num_experts=8, moe_top_k=2, moe_residual=False)


def _layer_inputs(B, L, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, 32)).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    if B > 1:
        mask[1, L - 4:] = 0
    return x, mask


def _port_layer(**kw):
    from spokennlp_tpu_torch.models.multimodal import MoELayer, MultimodalConfig

    return MoELayer(MultimodalConfig(**{**BASE, **kw}), 32,
                    generator=torch.Generator().manual_seed(0))


def _run(layer, x, mask):
    y, aux = layer(torch.from_numpy(x), torch.from_numpy(mask))
    return y.detach().numpy(), float(aux.detach())


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_moe_layer_matches_jax(impl):
    """The layer (residual on) and the gradients of sum(y * probe) + aux
    with respect to x, the gate and both expert stacks."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.multimodal import MoELayer as JMoE
    from spokennlp_tpu.models.multimodal import MultimodalConfig as JCfg
    from spokennlp_tpu_torch.models.checkpoint_io import params_from_state_dict

    kw = dict(moe_impl=impl, moe_residual=True)
    layer = _port_layer(**kw)
    x, mask = _layer_inputs(2, 24, 0)
    probe = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jlayer = JMoE(JCfg(**{**BASE, **kw}))
    tree = params_from_state_dict(layer.state_dict())
    shapes = jax.eval_shape(jlayer.init, jax.random.PRNGKey(0), x, mask)["params"]
    assert jax.tree.map(lambda s: tuple(s.shape), shapes) == jax.tree.map(np.shape, tree)

    def jloss(p, x):
        y, aux = jlayer.apply({"params": p}, x, jnp.asarray(mask))
        return (y * probe).sum() + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                            has_aux=True))(tree, x)
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = layer(tx, torch.from_numpy(mask))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    assert aux.item() == pytest.approx(float(jaux), rel=1e-5)
    ((y * torch.from_numpy(probe)).sum() + aux).backward()
    grads = {"x": (tx.grad, jgx), "gate.kernel": (layer.gate.kernel.grad, jg["gate"]["kernel"]),
             "gate.bias": (layer.gate.bias.grad, jg["gate"]["bias"]),
             "w_in": (layer.w_in.grad, jg["w_in"]), "w_out": (layer.w_out.grad, jg["w_out"])}
    for name, (g, w) in grads.items():
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_dispatch_against_dense_and_capacity_drops():
    """At a generous capacity the dispatch equals the dense combine on valid
    tokens (pads zero); at the tightest capacity (8 slots an expert for 96
    assignments) a token keeping both choices equals the generous output, a
    token keeping none is a zero row, exactly as an independent walk of the
    k-major priority says, and the output equals JAX's dispatch."""
    import jax

    from spokennlp_tpu.models.multimodal import MoELayer as JMoE
    from spokennlp_tpu.models.multimodal import MultimodalConfig as JCfg
    from spokennlp_tpu_torch.models.checkpoint_io import params_from_state_dict

    x, mask = _layer_inputs(2, 24, 0)
    dense = _port_layer(moe_impl="dense")
    generous = _port_layer(moe_impl="dispatch", moe_capacity_factor=100.0)
    y_dense, aux_dense = _run(dense, x, mask)
    y_disp, aux_disp = _run(generous, x, mask)
    valid = mask.astype(bool)
    np.testing.assert_allclose(y_disp[valid], y_dense[valid], atol=1e-5, rtol=1e-4)
    assert aux_disp == pytest.approx(aux_dense, rel=1e-5)
    np.testing.assert_allclose(y_disp[~valid], 0.0, atol=1e-6)

    x, mask = _layer_inputs(1, 48, 1)
    y_big, _ = _run(generous, x, mask)
    tight = _port_layer(moe_impl="dispatch", moe_capacity_factor=0.01)
    y_tiny, _ = _run(tight, x, mask)
    gl = x.reshape(-1, 32) @ dense.gate.kernel.detach().numpy() + dense.gate.bias.detach().numpy()
    topi = np.argsort(-gl, axis=1, kind="stable")[:, :2]
    counters, survives = np.zeros(8, np.int64), np.zeros((48, 2), bool)
    for k in range(2):  # choice 0 of every token outranks any choice 1
        for n in range(48):
            if counters[topi[n, k]] < 8:
                survives[n, k] = True
                counters[topi[n, k]] += 1
    both, none = survives.all(axis=1), ~survives.any(axis=1)
    assert both.any() and none.any()
    np.testing.assert_allclose(y_tiny[0, both], y_big[0, both], atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(np.abs(y_tiny).sum(-1)[0] == 0, none)
    jlayer = JMoE(JCfg(**BASE, moe_impl="dispatch", moe_capacity_factor=0.01))
    jy, _ = jax.jit(lambda p: jlayer.apply({"params": p}, x, mask))(
        params_from_state_dict(tight.state_dict()))
    np.testing.assert_allclose(y_tiny, np.asarray(jy), atol=1e-5, rtol=1e-5)


def test_capacity_and_gate_ties_match_jax():
    """C = max(8, ceil(ceil(N K / E cf) / 8) 8) over a grid; tied gate
    logits route to the lower expert first, as jax.lax.top_k does."""
    import jax

    from spokennlp_tpu_torch.models.multimodal import MultimodalConfig, capacity, route

    for n, k, e, cf in [(48, 2, 8, 0.01), (32, 2, 8, 2.0), (1000, 2, 4, 1.25), (77, 1, 3, 1.1),
                        (4096, 4, 16, 1.0)]:
        c = int(np.ceil(n * k / e * cf))
        want = max(8, int(np.ceil(c / 8)) * 8)
        cfg = MultimodalConfig(moe_num_experts=e, moe_top_k=k, moe_capacity_factor=cf)
        assert capacity(n, cfg) == want
    logits = np.asarray([[0.5, 1.0, 1.0, 0.2], [2.0, 2.0, 2.0, 2.0], [0.0, -1.0, 0.0, 0.0]],
                        np.float32)
    topi, gates, dense = route(torch.from_numpy(logits), 2, 4)
    jv, ji = jax.lax.top_k(logits, 2)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jax.nn.softmax(jv, -1)), rtol=1e-6)
    assert math.isclose(float(dense.sum()), 3.0, rel_tol=1e-6)


def test_expert_rule_matches_jax():
    """is_expert_param names exactly the leaves JAX's param_partition_spec
    shards over "model" among a ma_moe / ca_moe model's w_in / w_out, and
    expert_range gives each rank the experts a NamedSharding of the leading
    axis puts on its device."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from spokennlp_tpu.parallel.mesh import param_partition_spec
    from spokennlp_tpu_torch.models.checkpoint_io import params_from_state_dict
    from spokennlp_tpu_torch.models.multimodal import MultiModalForTS, MultimodalConfig
    from spokennlp_tpu_torch.parallel.mesh import expert_range, is_expert_param

    for ce, share in (("ma_moe", False), ("ca_moe", True)):
        model = MultiModalForTS(MultimodalConfig(hidden_size=16, text_hidden_size=8,
                                                 vis_hidden_size=8, audio_hidden_size=8,
                                                 num_cross_encoder_heads=2,
                                                 cross_encoder_type=ce, moe_share_in_layers=share))
        tree = params_from_state_dict(model.state_dict())
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        experts = 0
        for path, leaf in leaves:
            name = ".".join(k.key for k in path)
            spec = param_partition_spec(path, leaf)
            sharded = len(spec) > 0 and spec[0] == "model" and path[-1].key in ("w_in", "w_out")
            assert is_expert_param(name) == sharded, name
            experts += sharded
        assert experts == (2 if share else 4)
    devices = jax.devices()
    for n in (1, 2, 4, 8):
        mesh = Mesh(np.asarray(devices[:n]), ("model",))
        where = NamedSharding(mesh, P("model", None, None)).devices_indices_map((8, 4, 4))
        for rank, dev in enumerate(devices[:n]):
            sl = where[dev][0]
            assert range(sl.start or 0, 8 if sl.stop is None else sl.stop) == expert_range(
                rank, n, 8)
    with pytest.raises(ValueError):
        expert_range(0, 3, 8)


def test_dryrun_moe_ep_over_two_gloo_ranks():
    """The expert-sharded layer over 2 gloo processes (4 experts a rank)
    reproduces the single-process layer's output, balance loss and
    gradients (dryrun.dryrun_moe_ep raises otherwise)."""
    from spokennlp_tpu_torch import dryrun

    res = dryrun.dryrun_moe_ep(2, timeout=240)
    assert np.asarray(res["sharded"]["dw_in"]).shape == (8, 32, 64)
    assert np.abs(np.asarray(res["single"]["y"])).sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_moe_layer_on_the_card(impl):
    """The layer on the card against the CPU: output and gradients within
    1e-4 of each largest entry (float32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, mask = _layer_inputs(2, 24, 0)
    out = {}
    for dev in ("cpu", "cuda"):
        layer = _port_layer(moe_impl=impl).to(dev)
        tx = torch.from_numpy(x).to(dev).requires_grad_()
        y, aux = layer(tx, torch.from_numpy(mask).to(dev))
        (y.sum() + aux).backward()
        out[dev] = [t.detach().cpu().numpy() for t in (y, aux, tx.grad, layer.w_in.grad,
                                                       layer.gate.kernel.grad)]
    for g, w in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-6))
