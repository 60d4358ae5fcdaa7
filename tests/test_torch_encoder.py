"""Port encoder and topic-segmentation model against the JAX modules.

Weights are made by the JAX init, cross into the port through
``models/convert.py``, and both sides get the same numpy inputs in float32.
JAX is imported inside the CPU tests only (see tests/test_torch_kernels.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from spokennlp_tpu.configs import EncoderConfig, TopicSegConfig
from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
from spokennlp_tpu_torch.models.encoder import Encoder, resolve_attention_impl
from spokennlp_tpu_torch.models.topic_seg import TopicSegModel
from spokennlp_tpu_torch.objectives.cssl import gather_sentence_features

# float32 einsum path against JAX's: the same math, summed in another order
EINSUM_TOL = dict(atol=1e-4, rtol=1e-4)
# fused path (the kernels' plain versions) against JAX's Pallas kernels in
# interpret mode, as tests/test_attention_block.py compares them
FUSED_TOL = dict(atol=5e-3, rtol=1e-2)

TINY = EncoderConfig(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    max_position_embeddings=64, attention_impl="einsum",
)
B, L = 3, 40


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 127, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 25:] = 0
    mask[2, 33:] = 0
    tt = rng.integers(0, 2, size=(B, L)).astype(np.int32)
    pack = np.where(mask > 0, 1 + (np.arange(L) >= 15), 0).astype(np.int32)
    return dict(ids=ids, mask=mask, tt=tt, pack=pack)


def _jax_encoder(cfg, x, **kw):
    """(params as numpy, JAX EncoderOutput) for cfg on the inputs x."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.encoder import Encoder as JaxEncoder

    enc = JaxEncoder(cfg)
    args = dict(attention_mask=jnp.asarray(x["mask"]), token_type_ids=jnp.asarray(x["tt"]))
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x["ids"]), **args)["params"]
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    out = enc.apply({"params": params}, jnp.asarray(x["ids"]), **args, **kw)
    return jax.tree.map(np.asarray, params), out


def _port_encoder(cfg, params, x, **kw):
    enc = Encoder(cfg).eval()
    enc.load_state_dict(jax_params_to_state_dict(params), strict=True)
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    with torch.inference_mode():
        return enc(
            torch.from_numpy(x["ids"]), attention_mask=torch.from_numpy(x["mask"]),
            token_type_ids=torch.from_numpy(x["tt"]), **kw,
        )


@pytest.mark.parametrize("embedding_size", [None, 32], ids=["bert", "electra"])
def test_state_dict_from_jax_loads_strict(embedding_size):
    cfg = dataclasses.replace(TINY, embedding_size=embedding_size)
    params, _ = _jax_encoder(cfg, _inputs())
    sd = jax_params_to_state_dict(params)
    port = Encoder(cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()
    }
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


@pytest.mark.parametrize("embedding_size", [None, 32], ids=["bert", "electra"])
def test_encoder_einsum_matches_jax(embedding_size):
    cfg = dataclasses.replace(TINY, embedding_size=embedding_size)
    x = _inputs(1)
    params, want = _jax_encoder(cfg, x, output_hidden_states=True)
    got = _port_encoder(cfg, params, x, output_hidden_states=True)
    valid = x["mask"] > 0
    np.testing.assert_allclose(
        got.last_hidden_state.numpy()[valid], np.asarray(want.last_hidden_state)[valid],
        **EINSUM_TOL,
    )
    assert len(got.hidden_states) == len(want.hidden_states) == cfg.num_layers + 1
    for g, w in zip(got.hidden_states, want.hidden_states):
        np.testing.assert_allclose(g.numpy()[valid], np.asarray(w)[valid], **EINSUM_TOL)
    np.testing.assert_allclose(got.pooled_output.numpy(), np.asarray(want.pooled_output), **EINSUM_TOL)


def test_encoder_einsum_attentions_match_jax():
    x = _inputs(2)
    params, want = _jax_encoder(TINY, x, output_attentions=True)
    got = _port_encoder(TINY, params, x, output_attentions=True)
    for g, w in zip(got.attentions, want.attentions):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EINSUM_TOL)


@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_encoder_packed_windows_match_jax(impl):
    cfg = dataclasses.replace(TINY, attention_impl=impl)
    x = _inputs(3)
    params, want = _jax_encoder(cfg, x, pack_segment_ids=x["pack"])
    got = _port_encoder(cfg, params, x, pack_segment_ids=x["pack"])
    valid = x["pack"] > 0
    tol = EINSUM_TOL if impl == "einsum" else FUSED_TOL
    np.testing.assert_allclose(
        got.last_hidden_state.numpy()[valid], np.asarray(want.last_hidden_state)[valid], **tol
    )


def test_encoder_fused_matches_jax_fused():
    """The port's fused path on the CPU runs the kernels' plain versions; the
    JAX fused path runs the Pallas kernels in interpret mode. Both use the
    tanh GELU inside the MLP block."""
    cfg = dataclasses.replace(TINY, attention_impl="fused")
    x = _inputs(4)
    params, want = _jax_encoder(cfg, x, output_hidden_states=True)
    got = _port_encoder(cfg, params, x, output_hidden_states=True)
    valid = x["mask"] > 0
    for g, w in zip(got.hidden_states, want.hidden_states):
        np.testing.assert_allclose(g.numpy()[valid], np.asarray(w)[valid], **FUSED_TOL)


def test_topic_seg_model_matches_jax():
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel

    task = TopicSegConfig()
    x = _inputs(5)
    pos = np.array([[1, 7, 20], [2, 9, 24], [1, 5, 30]], np.int32)
    jm = JaxTopicSegModel(TINY, task)
    args = dict(attention_mask=jnp.asarray(x["mask"]), sent_positions=jnp.asarray(pos))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x["ids"]), **args)["params"]
    want = jm.apply({"params": params}, jnp.asarray(x["ids"]), **args)

    port = TopicSegModel(TINY, task).eval()
    port.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    with torch.inference_mode():
        got = port(
            torch.from_numpy(x["ids"]), attention_mask=torch.from_numpy(x["mask"]),
            sent_positions=torch.from_numpy(pos),
        )
    valid = x["mask"] > 0
    np.testing.assert_allclose(
        got["token_logits"].numpy()[valid], np.asarray(want["token_logits"])[valid], **EINSUM_TOL
    )
    for key in ("sent_features", "tssp_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **EINSUM_TOL)


def test_gather_sentence_features_matches_jax():
    import jax.numpy as jnp

    from spokennlp_tpu.objectives.cssl import gather_sentence_features as jax_gather

    rng = np.random.default_rng(6)
    seq = rng.normal(size=(2, 12, 5)).astype(np.float32)
    pos = rng.integers(0, 12, size=(2, 4)).astype(np.int32)
    want = np.asarray(jax_gather(jnp.asarray(seq), jnp.asarray(pos)))
    got = gather_sentence_features(torch.from_numpy(seq), torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want)


def test_attention_impl_resolution():
    auto = dataclasses.replace(TINY, attention_impl="auto")
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_attention_impl(auto, cuda, output_attentions=False) == "fused"
    assert resolve_attention_impl(auto, cuda, output_attentions=True) == "einsum"
    assert resolve_attention_impl(auto, cpu, output_attentions=False) == "einsum"
    fused = dataclasses.replace(TINY, attention_impl="fused")
    assert resolve_attention_impl(fused, cpu, output_attentions=False) == "fused"
    for dev in (cpu, cuda):
        assert resolve_attention_impl(fused, dev, False, training=True) == "train_fused"
    assert resolve_attention_impl(auto, cuda, False, training=True) == "train_fused"
    assert resolve_attention_impl(auto, cpu, False, training=True) == "einsum"
    # auto on the card, as JAX resolves it on its accelerator, W8A8 or not
    for cfg in (auto, dataclasses.replace(auto, quantize="w8a8")):
        at = lambda **kw: resolve_attention_impl(cfg, cuda, **{"output_attentions": False, **kw})
        assert at(batch_size=32) == "stack"
        assert at(batch_size=33) == "fused"
        assert at(batch_size=8, output_hidden_states=True) == "fused"
        assert at(batch_size=8, output_attentions=True) == "einsum"
        assert at(batch_size=8, training=True) == "train_fused"
        assert resolve_attention_impl(cfg, cpu, False, batch_size=8) == "einsum"
    stack = dataclasses.replace(TINY, attention_impl="stack", quantize="w8a8")
    assert resolve_attention_impl(stack, cpu, False, batch_size=64) == "stack"
    assert resolve_attention_impl(stack, cuda, False, output_hidden_states=True) == "fused"
    assert resolve_attention_impl(stack, cuda, False, training=True) == "train_fused"
    pallas = dataclasses.replace(TINY, attention_impl="pallas", quantize="w8a8")
    assert resolve_attention_impl(pallas, cuda, False, batch_size=8) == "pallas"
    assert resolve_attention_impl(pallas, cuda, True, batch_size=8) == "einsum"
    with pytest.raises(NotImplementedError):
        resolve_attention_impl(pallas, cuda, False, training=True)
    # W8A8 on the Longformer path runs the W8A8 mode of its kernel, as JAX resolves it
    lf = dataclasses.replace(TINY, attention_type="sliding_window", attention_window=16,
                             quantize="w8a8", attention_impl="auto")
    kw = dict(seq_len=64, prefix_globals=1, has_global_mask=True, batch_size=8)
    assert resolve_attention_impl(lf, cuda, False, **kw) == "fused"
    assert resolve_attention_impl(dataclasses.replace(lf, attention_impl="stack"), cuda, False,
                                  **kw) == "fused"
    assert resolve_attention_impl(lf, cuda, False, training=True, **kw) == "train_fused"
    lf_einsum = dataclasses.replace(lf, attention_impl="einsum", sliding_window_impl="chunked")
    assert resolve_attention_impl(lf_einsum, cuda, False, **kw) == "chunked"
    # "flash" runs the port's own kernels on the card (kernel 6 at inference,
    # the training kernels in training) and the einsum path elsewhere
    flash = dataclasses.replace(TINY, attention_impl="flash")
    assert resolve_attention_impl(flash, cuda, False, seq_len=128) == "pallas"
    assert resolve_attention_impl(flash, cuda, False, training=True, seq_len=128) == "train_fused"
    assert resolve_attention_impl(flash, cpu, False, seq_len=128) == "einsum"
    with pytest.raises(ValueError, match="attention_impl='einsum'"):
        resolve_attention_impl(flash, cuda, output_attentions=False, seq_len=64)
    for bad in (dataclasses.replace(TINY, attention_type="ponet"),):
        with pytest.raises(NotImplementedError):
            resolve_attention_impl(bad, cuda, output_attentions=False)


W8A8_IMPLS = ["einsum", "fused", "stack", "pallas"]


def _jax_topic_seg(cfg, x, pos, **kw):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel

    jm = JaxTopicSegModel(cfg, TopicSegConfig())
    args = dict(attention_mask=jnp.asarray(x["mask"]), sent_positions=jnp.asarray(pos))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x["ids"]), **args)["params"]
    return jax.tree.map(np.asarray, params), jm.apply({"params": params}, jnp.asarray(x["ids"]),
                                                      **args, **kw)


def _port_topic_seg(cfg, params, x, pos):
    port = TopicSegModel(cfg, TopicSegConfig()).eval()
    port.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.inference_mode():
        return port(torch.from_numpy(x["ids"]), attention_mask=torch.from_numpy(x["mask"]),
                    sent_positions=torch.from_numpy(pos))


POS = np.array([[1, 7, 20], [2, 9, 24], [1, 5, 30]], np.int32)


@pytest.mark.parametrize("impl", W8A8_IMPLS)
def test_topic_seg_model_w8a8_matches_jax(impl):
    """One JAX state_dict drives every W8A8 path of the port. JAX runs its
    Pallas kernels in interpret mode on the CPU, the port the plain
    versions: the same integer arithmetic, so the logits agree to float32
    rounding but where a sum order moves an int8 step: one step moves a
    row's projection by up to 1/127 of its absmax, and attention spreads that
    over the row's sequence in the next layer, where it moves more steps (one
    flip in layer 0 of seed 8's stack path leaves 0.046 in its sequence's
    hidden states after layer 1). So the bound is on the largest logit error
    (5e-2), its mean (5e-3) and the argmax, not on a share of elements; the
    kernel tests hold each block tightly. The pallas path differs in its
    attention core besides: JAX's kernel takes the exponent in bfloat16, the
    port's CPU path JAX's float32 reference (tests/test_torch_kernels.py);
    test_pallas_w8a8_projections_stay_unquantised holds that path tightly."""
    cfg = dataclasses.replace(TINY, attention_impl=impl, quantize="w8a8")
    x = _inputs(8)
    params, want = _jax_topic_seg(cfg, x, POS)
    got = _port_topic_seg(cfg, params, x, POS)
    valid = x["mask"] > 0
    g, w = got["token_logits"].numpy()[valid], np.asarray(want["token_logits"])[valid]
    err = np.abs(g - w)
    # pallas: the exponent differs in every row, so flips are many (mean 1e-2)
    mean_tol = 1e-2 if impl == "pallas" else 5e-3
    assert err.max() <= 5e-2 and err.mean() <= mean_tol, (err.max(), err.mean())
    assert (g.argmax(-1) == w.argmax(-1)).mean() >= 0.99


def test_pallas_w8a8_projections_stay_unquantised(monkeypatch):
    """Under W8A8 JAX's pallas path quantises the MLP but not the attention
    projections (its bsnld / bnld layouts). With JAX's float32 reference in
    place of its kernel on both sides the two paths are the same arithmetic:
    a quantised projection on either side would show as an error far above
    1e-4."""
    from spokennlp_tpu.ops.pallas import blhd_attention

    monkeypatch.setattr(
        blhd_attention, "snld_self_attention",
        lambda qkv, seg, sm_scale, **_: blhd_attention.reference_snld_attention(qkv, seg,
                                                                                sm_scale))
    cfg = dataclasses.replace(TINY, attention_impl="pallas", quantize="w8a8")
    x = _inputs(9)
    params, want = _jax_topic_seg(cfg, x, POS)
    got = _port_topic_seg(cfg, params, x, POS)
    valid = x["mask"] > 0
    err = np.abs(got["token_logits"].numpy()[valid] - np.asarray(want["token_logits"])[valid])
    assert err.max() <= 2e-2 and err.mean() <= 2e-3, (err.max(), err.mean())
    quantised = _port_topic_seg(dataclasses.replace(cfg, attention_impl="einsum"), params, x, POS)
    assert not torch.allclose(quantised["token_logits"], got["token_logits"], atol=1e-3)


@pytest.mark.gpu
def test_encoder_fused_on_card_matches_plain_on_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(TINY, attention_impl="auto", num_heads=2)  # head_dim 32
    x = _inputs(7)
    enc = Encoder(cfg, generator=torch.Generator().manual_seed(0)).eval()
    args = lambda dev: (
        torch.from_numpy(x["ids"]).to(dev),
        torch.from_numpy(x["mask"]).to(dev),
        torch.from_numpy(x["tt"]).to(dev),
    )
    fused_cpu = Encoder(dataclasses.replace(cfg, attention_impl="fused")).eval()
    fused_cpu.load_state_dict(enc.state_dict())
    with torch.inference_mode():
        want = fused_cpu(*args("cpu")).last_hidden_state
        got = enc.cuda()(*args("cuda")).last_hidden_state.cpu()
    valid = torch.from_numpy(x["mask"] > 0)
    torch.testing.assert_close(got[valid], want[valid], atol=1e-3, rtol=1e-3)
