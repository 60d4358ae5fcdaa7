"""Port PoNet: ``models/ponet.py`` against the JAX package's XLA mixer path,
``ops/cuda/ponet_block.ponet_mixer_block_plain`` against the JAX fused mixer
block (Pallas, interpret mode) on the CPU, the port's initialisers against
Flax's, and the CUDA kernel (kernel 9) against the plain version on the card
(``-m gpu``). JAX is imported inside the CPU tests only.

Shapes: width 32, 2 heads, 2 layers, windows of L=64 as the MUG featuriser
makes them (CLS in segment 0, one id a sentence, the pad run n_sent + 1,
later windows with ids above L + 1), plus rows of singleton runs and tied
values and rows of non-contiguous ids. Tolerances: the pooling functions
select values, so they agree exactly; modules, logits and gradients in
float32 to 1e-4 (gradients relative to their largest magnitude); W8A8 by the
int8-step rule of tests/test_torch_kernels.py (``assert_close_w8a8``).
"""

import hashlib
import math
from unittest import mock

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.models import ponet as tp
from spokennlp_tpu_torch.ops.cuda import ponet_block as pb
from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
from test_torch_kernels import assert_close_w8a8

F32_TOL = 1e-4
# card: largest |kernel - plain| over the largest |plain| on real rows; float32
# sums in another order (chip_smoke.py's readings are near 1e-6), bfloat16 a
# projection or a GA sum rounded the other way now and then
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
           max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0,
           add_pooler=False)
L = 64


def _normalized(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def mug_rows(B, L, seed, run_len=(1, 8), kinds=("full", "padded", "ties", "noncontig")):
    """(mask, segment ids, tie rows) of B rows, as the MUG featuriser makes
    them: CLS in segment 0, runs of one id a sentence, pads in the run
    n_sent + 1. Kinds cycle: ``full``; ``padded`` (suffix, sentence ids
    from 500, above L + 1); ``ties`` (padded, singleton runs, and pairs of
    equal rows inside runs, listed in tie rows as (b, l)); ``noncontig``
    (two ids alternating in runs of 5, so equal ids are not adjacent)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    ties = []
    for b in range(B):
        kind = kinds[b % len(kinds)]
        n = L if kind in ("full", "noncontig") else int(rng.integers(L // 2, L - 2))
        if kind == "noncontig":
            seg[b] = np.where(np.arange(L) % 10 < 5, 3, 7)
            seg[b, 0] = 0
            mask[b] = 1
            continue
        sid = 500 if kind == "padded" else 1
        ids = [0]
        while len(ids) < n:
            run = 1 if kind == "ties" and rng.random() < 0.4 else int(rng.integers(*run_len))
            if kind == "ties" and run >= 3:
                ties.append((b, len(ids) + 1))
            ids.extend([sid] * run)
            sid += 1
        seg[b, :n] = ids[:n]
        seg[b, n:] = sid + 3
        mask[b, :n] = 1
    return mask, seg, ties


def block_inputs(B, L, H, seed, **kw):
    """The fused block's inputs (numpy): hidden with the tie rows copied from
    their predecessors, MUG masks and ids, float32 weights."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    mask, seg, ties = mug_rows(B, L, seed, **kw)
    hidden = f(B, L, H)
    for b, l in ties:
        hidden[b, l] = hidden[b, l - 1]
    return dict(hidden=hidden, attention_mask=mask, segment_ids=seg,
                proj_kernels=f(5, H, H, scale=H**-0.5), proj_biases=f(5, H, scale=0.1),
                out_kernel=f(H, H, scale=H**-0.5), out_bias=f(H, scale=0.1),
                ln_scale=1 + f(H, scale=0.1), ln_bias=f(H, scale=0.1))


BLOCK_ARGS = ("hidden", "attention_mask", "segment_ids", "proj_kernels", "proj_biases",
              "out_kernel", "out_bias")


def _block(fn, inp, convert, window=3, **kw):
    args = [convert(inp[k]) for k in BLOCK_ARGS]
    H = inp["hidden"].shape[-1]
    return fn(*args, local_window=window, sm_scale=H**-0.5, ln_scale=convert(inp["ln_scale"]),
              ln_bias=convert(inp["ln_bias"]), **kw)


def mug_windows(n_sents=(100, 6), seed=0, L=L):
    """Featurised windows of synthetic meetings of ``n_sents`` sentences
    (port featuriser), stacked: the long meeting's later windows carry
    sentence ids above L + 1, the short one's window is padded."""
    from spokennlp_tpu_torch.configs import WindowingConfig
    from spokennlp_tpu_torch.projects.mug.topic_segmentation import (
        stack_eos_windows, window_document_eos,
    )

    rng = np.random.default_rng(seed)
    wcfg = WindowingConfig(max_seq_length=L, cls_token_id=2, pad_token_id=0, bos_token_id=1)
    windows = []
    for eid, n in enumerate(n_sents):
        sents = [rng.integers(5, 120, size=int(rng.integers(1, 6))).tolist() for _ in range(n)]
        labels = [int(rng.random() < 0.2) for _ in range(n)]
        windows += window_document_eos(sents, labels, wcfg, eos_token_id=3, example_id=eid)
    return stack_eos_windows(windows)


# ------------------------------------------------------------ the pooling functions


def test_pooling_functions_match_jax():
    """segment_max_with_second, smp_second_max and local_max_pool select
    values, so they equal JAX's exactly: ties on the max, singleton and
    empty segments, pads forced into segment 0, ids at and past L + 1."""
    import jax.numpy as jnp

    from spokennlp_tpu.models import ponet as jp

    B, D = 3, 8
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    x[0, 5] = x[0, 6]  # a tie on the max inside a segment
    mask, seg, _ = mug_rows(B, L, 1, kinds=("ties", "padded", "full"))
    seg[2, 40:] = L + 1 + np.arange(L - 40) % 3  # ids at and past num_segments
    forced = np.where(mask > 0, seg, 0)
    S = L + 1
    T = torch.from_numpy
    m1, m2 = tp.segment_max_with_second(T(x), T(forced), S)
    got_smp = tp.smp_second_max(T(x), T(forced), S)
    for b in range(B):
        j1, j2 = jp.segment_max_with_second(jnp.asarray(x[b]), jnp.asarray(forced[b]), S)
        np.testing.assert_array_equal(m1[b].numpy(), np.asarray(j1))
        np.testing.assert_array_equal(m2[b].numpy(), np.asarray(j2))
        want = jp.smp_second_max(jnp.asarray(x[b]), jnp.asarray(forced[b]), S)
        np.testing.assert_array_equal(got_smp[b].numpy(), np.asarray(want))
    assert (m1.numpy() == jp.NEG_INF).any()  # empty segments read -1e9
    for window in (1, 2, 3, 4, 5):
        want = jp.local_max_pool(jnp.asarray(x), window, jnp.asarray(mask))
        got = tp.local_max_pool(T(x), window, T(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_ids_past_the_end_read_neg_inf_as_in_jax():
    """The XLA mixer's num_segments = L + 1: ids past it fall out of the max
    and the gather clamps them, so every token reads -1e9 (JAX does the
    same); ids 1-4 give the true maxima."""
    import jax.numpy as jnp

    from spokennlp_tpu.models import ponet as jp

    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    for offset, hit in ((40, True), (0, False)):
        ids = (offset + 1 + np.arange(16) // 4).astype(np.int32)
        want = np.asarray(jp.smp_second_max(jnp.asarray(x), jnp.asarray(ids), 17))
        got = tp.smp_second_max(torch.from_numpy(x)[None], torch.from_numpy(ids)[None], 17)[0]
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == jp.NEG_INF).all() == hit
    m1, _ = tp.segment_max_with_second(torch.from_numpy(x)[None], torch.from_numpy(ids)[None], 17)
    np.testing.assert_array_equal(m1[0, 1:5].numpy(), x.reshape(4, 4, 4).max(1))


# ------------------------------------------------------------ the fused block


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "w8a8"])
@pytest.mark.parametrize("window", [3, 4])
def test_plain_block_matches_jax_kernel(quantized, window):
    """ponet_mixer_block_plain against the JAX fused block (interpret mode)
    on MUG rows: full, suffix-padded with ids above L + 1, singleton runs
    and ties, non-contiguous ids."""
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.ponet_block import fused_ponet_mixer_block

    inp = block_inputs(4, L, 32, seed=window)
    want = np.asarray(_block(fused_ponet_mixer_block, inp, jnp.asarray, window,
                             quantized=quantized, interpret=True))
    got = _block(pb.ponet_mixer_block_plain, inp, torch.from_numpy, window,
                 quantized=quantized).numpy()
    valid = inp["attention_mask"] > 0
    if quantized:
        assert_close_w8a8(got[valid], want[valid])
    else:
        assert _normalized(got[valid], want[valid]) < F32_TOL
    # the wrapper takes the plain version for CPU tensors
    again = _block(pb.fused_ponet_mixer_block, inp, torch.from_numpy, window,
                   quantized=quantized).numpy()
    np.testing.assert_array_equal(again, got)


def test_plain_block_without_layer_norm_and_in_bf16():
    """No ln_* returns the projection alone; bf16 rounds where the kernel
    does (the same function on bf16 inputs, within bf16 rounding of the
    float32 run)."""
    inp = block_inputs(2, L, 32, seed=5)
    T = torch.from_numpy
    args = [T(inp[k]) for k in BLOCK_ARGS]
    kw = dict(local_window=3, sm_scale=32**-0.5)
    raw = pb.ponet_mixer_block_plain(*args, **kw)
    normed = pb.ponet_mixer_block_plain(*args, **kw, ln_scale=T(inp["ln_scale"]),
                                        ln_bias=T(inp["ln_bias"]))
    valid = T(inp["attention_mask"]) > 0
    want = pb._layer_norm(raw + args[0], T(inp["ln_scale"]), T(inp["ln_bias"]), 1e-12)
    torch.testing.assert_close(normed[valid], want[valid], atol=1e-5, rtol=1e-5)
    bf = pb.ponet_mixer_block_plain(args[0].bfloat16(), *args[1:], **kw)
    assert bf.dtype == torch.bfloat16
    assert _normalized(bf[valid].float(), raw[valid]) < 3e-2


def test_fused_block_raises_off_cpu_and_cuda():
    inp = block_inputs(1, 8, 8, seed=0)
    args = [torch.from_numpy(inp[k]).to("meta") for k in BLOCK_ARGS]
    with pytest.raises(ValueError, match="unsupported device"):
        pb.fused_ponet_mixer_block(*args, local_window=3, sm_scale=1.0)


# ------------------------------------------------------------ planted faults


def ga_mean_over_all_rows(q, k, v, mrow, sm_scale):
    """A planted fault: GA's mean query over all L rows, pads included."""
    dt = q.dtype
    g = q.float().mean(dim=1, keepdim=True).to(dt)
    att = (k.float() * g.float()).sum(dim=2, keepdim=True) * sm_scale
    att = att + torch.where(mrow, 0.0, pb.NEG_INF)
    w = torch.softmax(att, dim=1).to(dt)
    return (v.float() * w.float()).sum(dim=1, keepdim=True).to(dt) * q


def smp_xla_semantics(s, mrow, segment_ids):
    """A planted fault: the XLA mixer's SMP, pads merged into segment 0 with
    their s projections unmasked."""
    seg = torch.where(mrow[..., 0], segment_ids, 0)
    return tp.smp_second_max(s, seg, s.shape[1] + 1)


def smp_without_second_max(s, mrow, segment_ids):
    """A planted fault: every row gets its run's max."""
    m1, _ = pb.run_top2(torch.where(mrow, s.float(), pb.NEG_INF), segment_ids)
    return m1.to(s.dtype)


PLANTED = {
    "pads_in_segment_zero": ("smp_plain", smp_xla_semantics),
    "no_second_max": ("smp_plain", smp_without_second_max),
    "lmp_window_shifted": ("lmp_offsets", lambda w: range(-(w // 2) + 1, w - w // 2 + 1)),
    "ga_mean_over_all_rows": ("ga_plain", ga_mean_over_all_rows),
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "w8a8"])
def test_planted_faults_fail_the_check(fault, quantized):
    """Each planted fault moves the block's output on real rows beyond the
    check it is held to (float32: 1e-4 of the largest output; W8A8: the
    int8-step rule)."""
    inp = block_inputs(4, L, 32, seed=11)
    want = _block(pb.ponet_mixer_block_plain, inp, torch.from_numpy, quantized=quantized)
    name, fn = PLANTED[fault]
    with mock.patch.object(pb, name, fn):
        bad = _block(pb.ponet_mixer_block_plain, inp, torch.from_numpy, quantized=quantized)
    valid = inp["attention_mask"] > 0
    if quantized:
        with pytest.raises(AssertionError):
            assert_close_w8a8(bad[valid], want[valid])
    else:
        assert _normalized(bad[valid], want[valid]) > F32_TOL


def test_tf32x3_product_model_and_its_plain_tf32_fault():
    """The model of kernel 9's float32 product tile (int8_matmul.
    tf32x3_product) at the block's depth K = 768, unit inputs and weights of
    std 0.02: its split alone (float64 sums) within 2e-7 of a float64
    product's largest value, the model itself (float32 sums, as the tile)
    within 1e-6; its big x big-only variant (plain TF32) beyond kernel 9's
    float32 card limit. TF32 rounds to nearest with ties away from zero."""
    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im

    tie = torch.tensor([1 + 2**-11, -(1 + 3 * 2**-11), 1 + 2**-12, 3.0])
    assert im.tf32_round(tie).tolist() == [1 + 2**-10, -(1 + 2**-9), 1.0, 3.0]
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((256, 768)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((768, 256)) * 0.02).astype(np.float32))
    ref = x.double() @ w.double()
    rel = lambda got: ((got.double() - ref).abs().max() / ref.abs().max()).item()
    big = lambda t: im.tf32_round(t).double()
    small = lambda t: im.tf32_round(t - im.tf32_round(t)).double()
    assert rel(small(x) @ big(w) + big(x) @ small(w) + big(x) @ big(w)) < 2e-7
    assert rel(im.tf32x3_product(x, w)) < 1e-6
    assert rel(im.tf32x3_product(x, w, terms=1)) > F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_block_on_given_projections(dtype):
    """ponet_mixer_block_plain fed its own five projections side by side
    (as kernel 9's buffer holds them, the card check's second part) gives
    its output bit for bit; fed other projections, it follows them."""
    import chip_smoke

    inp = block_inputs(3, L, 32, seed=17)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    hidden = t["hidden"].to(dtype)
    params = {k: t[k] for k in BLOCK_ARGS[3:]}
    call = lambda **kw: pb.ponet_mixer_block_plain(
        hidden, t["attention_mask"], t["segment_ids"], *params.values(), local_window=3,
        sm_scale=32**-0.5, ln_scale=t["ln_scale"], ln_bias=t["ln_bias"], **kw)
    proj = chip_smoke.ponet_projections(pb, hidden, params)
    assert torch.equal(call(proj=proj), call())
    assert not torch.equal(call(proj=proj * 1.5), call())


def test_plain_tf32_products_fail_the_float32_check():
    """The block's float32 check (1e-4 of the largest output on real rows)
    rejects the plain version with its six products in plain TF32 (the
    planted fault of the card check at H = 768) and passes it with the
    3xTF32 model of the kernel's tile."""
    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im

    inp = block_inputs(2, 128, 768, seed=13)
    want = _block(pb.ponet_mixer_block_plain, inp, torch.from_numpy)
    valid = inp["attention_mask"] > 0
    for terms, fails in ((1, True), (3, False)):
        with mock.patch.object(pb, "float_product",
                               lambda a, b, terms=terms: im.tf32x3_product(a, b, terms)):
            got = _block(pb.ponet_mixer_block_plain, inp, torch.from_numpy)
        assert (_normalized(got[valid], want[valid]) > F32_TOL) == fails


# ------------------------------------------------------------ the model


def _jax_model(impl, quantize, **over):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig as JC
    from spokennlp_tpu.models.ponet import PoNetForTokenClassification

    cfg = JC(**{**CFG, **over}, ponet_mixer_impl=impl, quantize=quantize)
    model = PoNetForTokenClassification(cfg)
    ones = jnp.ones((1, L), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ones, attention_mask=ones,
                        segment_ids=jnp.zeros((1, L), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, impl, quantize, **over):
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    model = tp.PoNetForTokenClassification(
        EncoderConfig(**{**CFG, **over}, ponet_mixer_impl=impl, quantize=quantize))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model


@pytest.mark.parametrize("quantize", ["none", "w8a8"])
@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_model_matches_jax(impl, quantize):
    """PoNetForTokenClassification's logits and PoNetEncoder's hidden states
    at inference on featurised MUG windows, from one JAX tree (the same tree
    on both mixer paths), against JAX's: xla reproduces both hazards of the
    XLA mixer (pads in segment 0, ids past L + 1)."""
    import jax.numpy as jnp

    batch = mug_windows()
    assert (batch["segment_ids"] > L + 1).any() and (batch["attention_mask"] == 0).any()
    jmodel, params = _jax_model(impl, quantize)
    ids, am, sg = (batch[k] for k in ("input_ids", "attention_mask", "segment_ids"))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   attention_mask=jnp.asarray(am),
                                   segment_ids=jnp.asarray(sg))["token_logits"])
    model = _port_model(params, impl, quantize).eval()
    T = torch.from_numpy
    with torch.no_grad():
        got = model(T(ids), attention_mask=T(am), segment_ids=T(sg))["token_logits"].numpy()
        hidden = model.ponet(T(ids), attention_mask=T(am), segment_ids=T(sg),
                             output_hidden_states=True).hidden_states
    assert len(hidden) == CFG["num_layers"] + 1
    valid = am > 0
    err = np.abs(got - want)[valid]
    if quantize == "w8a8":
        assert err.max() < 2e-2 and err.mean() < F32_TOL, (err.max(), err.mean())
    else:
        assert err.max() < F32_TOL, err.max()


def test_gradients_match_jax():
    """One training forward (the XLA mixer whatever the config says, as in
    JAX) at dropout 0: the masked cross-entropy and every parameter's
    gradient within 1e-4 of its largest magnitude."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.losses import cross_entropy_with_ignore as jce
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.ops.losses import cross_entropy_with_ignore

    batch = {k: v[:4] for k, v in mug_windows(seed=3).items()}
    jmodel, params = _jax_model("fused", "none")

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(batch["input_ids"]),
                           attention_mask=jnp.asarray(batch["attention_mask"]),
                           segment_ids=jnp.asarray(batch["segment_ids"]), deterministic=False)
        return jce(out["token_logits"], jnp.asarray(batch["labels"]))

    want_loss, want = jax.value_and_grad(loss_fn)(params)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want))
    model = _port_model(params, "fused", "none").train()
    T = torch.from_numpy
    out = model(T(batch["input_ids"]), attention_mask=T(batch["attention_mask"]),
                segment_ids=T(batch["segment_ids"]))
    loss = cross_entropy_with_ignore(out["token_logits"], T(batch["labels"]).long())
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= F32_TOL * abs(float(want_loss))
    # k's bias moves every score of a sequence alike, which the softmax
    # ignores: its gradient is rounding noise, held against 1e-3 of the
    # model's largest gradient instead of its own
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    for name, p in model.named_parameters():
        err = (p.grad - want[name]).abs().max().item()
        assert err < F32_TOL * max(want[name].abs().max().item(), floor), name


def test_xla_and_fused_paths_differ_at_cls_on_padded_windows():
    """Hazard 1: on a padded MUG window the XLA mixer pools CLS with the
    pads' s projections (segment 0) where the fused block masks them; each
    port path equals its JAX twin, and the two paths differ at CLS by more
    than 0.1."""
    import jax.numpy as jnp

    batch = mug_windows()
    padded = batch["attention_mask"].min(1) == 0
    ids, am, sg = (batch[k][padded] for k in ("input_ids", "attention_mask", "segment_ids"))
    T = torch.from_numpy
    out = {}
    for impl in ("xla", "fused"):
        jmodel, params = _jax_model(impl, "none")
        want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                       attention_mask=jnp.asarray(am),
                                       segment_ids=jnp.asarray(sg))["seq_output"])
        with torch.no_grad():
            got = _port_model(params, impl, "none").eval()(
                T(ids), attention_mask=T(am), segment_ids=T(sg))["seq_output"].numpy()
        assert np.abs(got - want)[am > 0].max() < F32_TOL
        out[impl] = got
    assert np.abs(out["xla"][:, 0] - out["fused"][:, 0]).max() > 0.1


def test_mixer_resolution():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = lambda **kw: EncoderConfig(**CFG, **kw)
    assert tp.mixer_path(cfg(), cpu, False) == "xla"
    assert tp.mixer_path(cfg(ponet_mixer_impl="xla"), cuda, False) == "xla"
    assert tp.mixer_path(cfg(ponet_mixer_impl="fused"), cuda, False) == "fused"
    assert tp.mixer_path(cfg(ponet_mixer_impl="fused"), cuda, True) == "xla"
    per_head = cfg(ponet_mixer_impl="fused", ponet_ga_per_head=True)
    assert tp.mixer_path(per_head, cpu, False) == "xla"
    with pytest.raises(ValueError, match="ponet_mixer_impl='xla'"):
        tp.mixer_path(per_head, cuda, False)
    with pytest.raises(ValueError):
        tp.mixer_path(cfg(ponet_mixer_impl="pallas"), cpu, False)


# ------------------------------------------------------------ initialisers


def _jax_dense_model():
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig as JC
    from spokennlp_tpu.configs import TopicSegConfig
    from spokennlp_tpu.models.topic_seg import TopicSegModel

    cfg = JC(**INIT_CFG)
    ones = jnp.ones((1, 16), jnp.int32)
    params = TopicSegModel(cfg, TopicSegConfig()).init(
        jax.random.PRNGKey(0), ones, attention_mask=ones, deterministic=True)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_ponet_model():
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig as JC
    from spokennlp_tpu.models.ponet import PoNetForTokenClassification

    ones = jnp.ones((1, 16), jnp.int32)
    params = PoNetForTokenClassification(JC(**INIT_CFG)).init(
        jax.random.PRNGKey(0), ones, attention_mask=ones,
        segment_ids=jnp.zeros((1, 16), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


INIT_CFG = dict(vocab_size=2048, hidden_size=256, num_layers=1, num_heads=4,
                intermediate_size=512, max_position_embeddings=512, add_pooler=False)


@pytest.mark.parametrize("trunk", ["dense", "ponet"])
def test_initialiser_stds_match_flax(trunk):
    """Every parameter's standard deviation within 5 % of a Flax init of
    the same config (the truncated normal's variance correction, the
    embeddings' 1/sqrt(features)), and the same truncation of the kernels:
    no draw beyond two of the uncorrected standard deviations."""
    from spokennlp_tpu_torch.configs import TopicSegConfig
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

    gen = torch.Generator().manual_seed(0)
    if trunk == "dense":
        want = jax_params_to_state_dict(_jax_dense_model())
        model = TopicSegModel(EncoderConfig(**INIT_CFG), TopicSegConfig(), generator=gen)
    else:
        want = jax_params_to_state_dict(_jax_ponet_model())
        model = tp.PoNetForTokenClassification(EncoderConfig(**INIT_CFG), generator=gen)
    got = dict(model.named_parameters())
    assert set(want) <= set(got)  # the port also builds heads JAX makes only when used
    for name, w in want.items():
        g = got[name].detach()
        assert g.shape == w.shape, name
        if w.std() == 0:
            torch.testing.assert_close(g, w, msg=name)  # zeros and ones
            continue
        # 5 %, and the sampling noise of the smaller tables
        tol = 0.05 + 3 / math.sqrt(w.numel())
        assert abs(g.std().item() / w.std().item() - 1) < tol, (name, g.std(), w.std())
        if name.endswith("kernel"):  # truncated at 2 / sqrt(fan_in) / 0.8796
            fan_in = w.shape[0] * (w.shape[1] if w.dim() == 3 else 1)
            bound = 2 / math.sqrt(fan_in) / 0.87962566103423978 * (1 + 1e-6)
            assert max(g.abs().max().item(), w.abs().max().item()) <= bound, name


# ------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on_card(inp, device, dtype):
    """Inputs on the card, hidden in ``dtype``, the rest as made."""
    out = {k: torch.from_numpy(v).to(device) for k, v in inp.items()}
    out["hidden"] = out["hidden"].to(dtype)
    return out


# (B, L, H, window, run lengths): the slice's shape at batch 2; a tile edge
# that no run start falls on (runs of 5-60 over 64-row tiles), L not a
# multiple of the 64-row SMP tile or the 128-row GA chunk, H below and not a
# multiple of the 256 columns of a block, even windows
CARD_SHAPES = [(2, 4096, 768, 3, (5, 61)), (3, 130, 96, 4, (1, 8)), (4, 200, 256, 5, (60, 140)),
               (4, 64, 32, 3, (1, 8)), (2, 1000, 768, 2, (5, 61))]


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "w8a8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,H,window,run_len", CARD_SHAPES)
def test_ponet_kernel_matches_plain_on_card(cuda, dtype, quantized, B, L, H, window, run_len):
    inp = _on_card(block_inputs(B, L, H, seed=L + H, run_len=run_len), cuda, dtype)
    kw = dict(local_window=window, sm_scale=H**-0.5, quantized=quantized)
    args = [inp[k] for k in BLOCK_ARGS]
    for ln in (True, False):
        if ln:
            kw.update(ln_scale=inp["ln_scale"], ln_bias=inp["ln_bias"])
        n = pb.fused_ponet_mixer_block.launches
        got = pb.fused_ponet_mixer_block(*args, **kw)
        torch.cuda.synchronize()
        assert pb.fused_ponet_mixer_block.launches == n + 1
        want = pb.ponet_mixer_block_plain(*args, **kw)
        valid = inp["attention_mask"] > 0
        g, w = got[valid].float(), want[valid].float()
        assert torch.isfinite(g).all()
        if quantized:
            assert_close_w8a8(g, w, bf16=dtype == torch.bfloat16)
        else:
            err = ((g - w).abs().max() / w.abs().max()).item()
            assert err < CARD_TOL[dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_ponet_kernel_rejects_planted_faults_on_card(cuda, fault):
    """The check that passes the kernel rejects each planted fault at the
    slice's widths."""
    inp = _on_card(block_inputs(2, 1024, 768, seed=7, run_len=(5, 61)), cuda, torch.float32)
    args = [inp[k] for k in BLOCK_ARGS]
    kw = dict(local_window=3, sm_scale=768**-0.5, ln_scale=inp["ln_scale"],
              ln_bias=inp["ln_bias"])
    got = pb.fused_ponet_mixer_block(*args, **kw)
    name, fn = PLANTED[fault]
    with mock.patch.object(pb, name, fn):
        bad = pb.ponet_mixer_block_plain(*args, **kw)
    valid = inp["attention_mask"] > 0
    err = ((got[valid] - bad[valid]).abs().max() / bad[valid].abs().max()).item()
    assert err > CARD_TOL[torch.float32], err


@pytest.mark.gpu
def test_ponet_fused_per_head_raises_on_card(cuda):
    model = tp.PoNetForTokenClassification(
        EncoderConfig(**CFG, ponet_mixer_impl="fused", ponet_ga_per_head=True)).to(cuda).eval()
    ids = torch.ones((1, L), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="ponet_mixer_impl='xla'"):
        model(ids, attention_mask=ids, segment_ids=ids)


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", ["none", "w8a8"])
def test_ponet_model_runs_kernel_9_on_card(cuda, quantize):
    """At inference the fused config runs kernel 9 once a layer (and the
    W8A8 MLP block under W8A8); its logits agree with the plain fused path's
    on the card."""
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block

    batch = mug_windows()
    cfg = EncoderConfig(**CFG, ponet_mixer_impl="fused", quantize=quantize)
    model = tp.PoNetForTokenClassification(cfg, generator=torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    T = lambda k: torch.from_numpy(batch[k]).to(cuda)
    n, m = pb.fused_ponet_mixer_block.launches, fused_mlp_block.launches
    with torch.no_grad():
        got = model(T("input_ids"), attention_mask=T("attention_mask"),
                    segment_ids=T("segment_ids"))["token_logits"]
        assert pb.fused_ponet_mixer_block.launches == n + cfg.num_layers
        assert fused_mlp_block.launches == m + (cfg.num_layers if quantize == "w8a8" else 0)
        for layer in model.ponet.layers():
            layer.mixer_block = pb.ponet_mixer_block_plain
        want = model(T("input_ids"), attention_mask=T("attention_mask"),
                     segment_ids=T("segment_ids"))["token_logits"]
    valid = T("attention_mask") > 0
    err = (got - want).abs()[valid]
    assert err.max().item() < (2e-2 if quantize == "w8a8" else F32_TOL), err.max()


# (M, N, K): none a multiple of the 128 x 128 tile or the 32-deep stage;
# odd widths (4-byte copies), the projections' and out projection's shapes
TILE_SHAPES = [(130, 200, 72), (257, 129, 130), (33, 17, 9), (300, 3840, 768), (1000, 768, 768)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", TILE_SHAPES)
def test_f32tc_tile_matches_plain_product_on_card(cuda, M, N, K):
    """Kernel 9's float32 product tile alone (the shared float32 GEMM tile
    that kernel 9 launches, through train_blocks.forward_tile) against the
    float64 product plus bias: within 1e-5 of the largest output (3xTF32
    keeps about float32's accuracy); plain TF32 products of the same
    operands land beyond it from K = 64 on."""
    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im

    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = torch.randn(M, K, generator=g, device=cuda)
    w = torch.randn(K, N, generator=g, device=cuda) * K**-0.5
    bias = torch.randn(N, generator=g, device=cuda)
    n = tb.forward_tile.launches
    got = tb.forward_tile(a, w, bias)
    torch.cuda.synchronize()
    assert tb.forward_tile.launches == n + 1
    want = a.double() @ w.double() + bias.double()
    rel = lambda t: ((t.double() - want).abs().max() / want.abs().max()).item()
    assert rel(got) < 1e-5, rel(got)
    assert torch.equal(tb.forward_tile(a, w) + bias, got)  # the bias added last, in float32
    if K >= 64:
        assert rel(im.tf32x3_product(a, w, terms=1) + bias) > 1e-5


# sha256 (its first 16 hex digits) of kernel 9's float32 output, with and
# without its LayerNorm, on kernel9_f32_digest's inputs, read on the card
# from the build whose own float32 launchers (gemm_bias_act_f32tc_kernel,
# residual_ln_f32tc_kernel in ponet_block.cu) bf16_gemm.cuh's shared
# launch_gemm<float> and launch_residual_ln<float> replaced: the same tiles,
# epilogues and grids, so the same bits
KERNEL9_F32_DIGEST = "85c401c9c6e6cf2a"


def kernel9_f32_digest(device) -> str:
    """The digest of KERNEL9_F32_DIGEST from this checkout's build."""
    inp = _on_card(block_inputs(2, 1000, 768, seed=17, run_len=(5, 61)), device, torch.float32)
    args = [inp[k] for k in BLOCK_ARGS]
    h = hashlib.sha256()
    for ln in ({"ln_scale": inp["ln_scale"], "ln_bias": inp["ln_bias"]}, {}):
        out = pb.fused_ponet_mixer_block(*args, local_window=3, sm_scale=768**-0.5, **ln)
        h.update(out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.gpu
def test_kernel9_float32_keeps_its_bits_after_the_fold_on_card(cuda):
    """Kernel 9's float32 products run bf16_gemm.cuh's shared float32
    launchers, not copies of their own: its output keeps the bits it had
    on its own launchers."""
    assert kernel9_f32_digest(cuda) == KERNEL9_F32_DIGEST


@pytest.mark.gpu
def test_ponet_kernel_rejects_plain_tf32_products_on_card(cuda):
    """The float32 check that passes kernel 9 rejects its plain version with
    the six products in plain TF32 (the big x big term of the tile alone)."""
    from spokennlp_tpu_torch.ops.cuda import int8_matmul as im

    inp = _on_card(block_inputs(2, 1024, 768, seed=7, run_len=(5, 61)), cuda, torch.float32)
    args = [inp[k] for k in BLOCK_ARGS]
    kw = dict(local_window=3, sm_scale=768**-0.5, ln_scale=inp["ln_scale"],
              ln_bias=inp["ln_bias"])
    got = pb.fused_ponet_mixer_block(*args, **kw)
    valid = inp["attention_mask"] > 0
    want = pb.ponet_mixer_block_plain(*args, **kw)
    err = ((got[valid] - want[valid]).abs().max() / want[valid].abs().max()).item()
    assert err < CARD_TOL[torch.float32], err
    with mock.patch.object(pb, "float_product", lambda a, b: im.tf32x3_product(a, b, terms=1)):
        bad = pb.ponet_mixer_block_plain(*args, **kw)
    err = ((got[valid] - bad[valid]).abs().max() / bad[valid].abs().max()).item()
    assert err > CARD_TOL[torch.float32], err
