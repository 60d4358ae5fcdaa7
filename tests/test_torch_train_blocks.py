"""Port training blocks: the plain versions against the JAX training kernels
on the CPU, the dropout mask against a numpy reference of the kernels'
formula, and the CUDA kernels against the plain versions on the card
(``-m gpu``). JAX is imported inside the CPU tests only, so the card tests
do not depend on it.
"""

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

# CPU, float32: the plain versions against the JAX kernels in interpret mode
# at rate 0 compute the same math summed in another order; outputs to 1e-4,
# gradients to 1e-3 of their largest magnitude.
OUT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_RTOL = 1e-3
# Card: largest |kernel - plain| over the largest |plain| of each output.
# float32 differs only by summation order; bf16 kernels round q, k, v, the
# probabilities, ctx, dS and dq/dk/dv (or the MLP intermediate and dpre) to
# bf16 (unit roundoff 2^-9) where the plain version stays in float32.
# float32 limits per kernel from the H100 readings of chip_smoke.py (PERF.md:
# 1.2e-7 to 6e-6, the attention block's dqkv_bias up to 3.9e-5), about ten
# times the largest.
CARD_TOL = {"attention": {torch.float32: 2e-4, torch.bfloat16: 3e-2},
            "mlp": {torch.float32: 1e-4, torch.bfloat16: 3e-2}}

# the sizes of tests/test_train_blocks.py
B, L, H, NH = 2, 128, 64, 4
HD = H // NH


def _segments(B, L, seed):
    """A padded tail on row 0, two packed windows on row 1 (odd rows)."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, L), np.int32)
    for b in range(B):
        n = L if b == B - 1 else int(rng.integers(L // 2, L))
        seg[b, :n] = 1
        if b % 2:
            seg[b, n // 2 : n] = 2
    return seg


def _attention_inputs(B, L, H, nh, seed, w_scale=0.3):
    """``w_scale`` scales the projection weights; the card tests use
    H^-0.5, which keeps the scores O(1) as in a trained model (at 0.3 and
    H=256 the scores reach |s| ~ 20, where one bf16 step of q moves the
    softmax by several percent)."""
    hd = H // nh
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(
        hidden=f(B, L, H), segment_ids=_segments(B, L, seed),
        qkv_kernel=f(H, 3, nh, hd, scale=w_scale), qkv_bias=f(3, nh, hd, scale=0.1),
        out_kernel=f(nh, hd, H, scale=w_scale), out_bias=f(H, scale=0.1),
        cotangent=f(B, L, H),
    )


def _mlp_inputs(M, H, I, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(x=f(M, H), w1=f(H, I, scale=H**-0.5), b1=f(I, scale=0.1),
                w2=f(I, H, scale=I**-0.5), b2=f(H, scale=0.1), cotangent=f(M, H))


ATT_ARGS = ("hidden", "qkv_kernel", "qkv_bias", "out_kernel", "out_bias")
MLP_ARGS = ("x", "w1", "b1", "w2", "b2")


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(w).max())


def _torch_value_and_grads(fn, inp, names):
    ts = {k: torch.from_numpy(v) for k, v in inp.items()}
    for k in names:
        ts[k].requires_grad_(True)
    out = fn(ts)
    (out * ts["cotangent"]).sum().backward()
    return out.detach().numpy(), [ts[k].grad.numpy() for k in names]


def test_attention_plain_matches_jax_train_kernel():
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_blocks import attention_block_train as jax_attention

    inp = _attention_inputs(B, L, H, NH, seed=0)
    seg, cot = jnp.asarray(inp["segment_ids"]), jnp.asarray(inp["cotangent"])
    seed = jnp.zeros((1,), jnp.int32)

    def f(*args):
        o = jax_attention(*args[:1], seg, *args[1:], seed, HD**-0.5, dropout_rate=0.0,
                          interpret=True)
        return jnp.sum(o * cot), o

    (_, want), want_grads = jax.value_and_grad(f, argnums=tuple(range(5)), has_aux=True)(
        *(jnp.asarray(inp[k]) for k in ATT_ARGS)
    )
    got, got_grads = _torch_value_and_grads(
        lambda t: tb.attention_block_train(
            t["hidden"], t["segment_ids"], t["qkv_kernel"], t["qkv_bias"], t["out_kernel"],
            t["out_bias"], torch.zeros(1, dtype=torch.int32), sm_scale=HD**-0.5,
        ),
        inp, ATT_ARGS,
    )
    np.testing.assert_allclose(got, np.asarray(want), **OUT_TOL)
    _assert_grads_close(got_grads, want_grads)


@pytest.mark.parametrize("activation", ["gelu", "relu", "silu"])
def test_mlp_plain_matches_jax_train_kernel(activation):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_blocks import mlp_block_train as jax_mlp

    inp = _mlp_inputs(M=B * L, H=H, I=2 * H, seed=1)
    cot = jnp.asarray(inp["cotangent"])

    def f(*args):
        o = jax_mlp(*args, activation=activation, interpret=True)
        return jnp.sum(o * cot), o

    (_, want), want_grads = jax.value_and_grad(f, argnums=tuple(range(5)), has_aux=True)(
        *(jnp.asarray(inp[k]) for k in MLP_ARGS)
    )
    got, got_grads = _torch_value_and_grads(
        lambda t: tb.mlp_block_train(*(t[k] for k in MLP_ARGS), activation=activation),
        inp, MLP_ARGS,
    )
    np.testing.assert_allclose(got, np.asarray(want), **OUT_TOL)
    _assert_grads_close(got_grads, want_grads)


def _numpy_attention_with_dropout(inp, keep, rate):
    """The TPU kernel's formula in numpy: e = exp(s - m), D = sum e, ctx =
    (keep e) v / (D (1 - rate)), out = ctx Wo + bo (float64)."""
    x = inp["hidden"].astype(np.float64)
    q, k, v = np.moveaxis(np.einsum("blh,hsnd->sblnd", x, inp["qkv_kernel"]), 0, 0) + \
        inp["qkv_bias"][:, None, None]
    seg = inp["segment_ids"]
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    s = np.einsum("blnd,bmnd->bnlm", q, k) * HD**-0.5 + np.where(allowed, 0.0, -1e9)[:, None]
    e = np.exp(s - s.max(-1, keepdims=True))
    denom = e.sum(-1, keepdims=True) * (1.0 - rate)
    ctx = np.einsum("bnlm,bmnd->blnd", np.where(keep, e, 0.0), v) / np.moveaxis(denom, 1, 2)
    return np.einsum("blnd,ndh->blh", ctx, inp["out_kernel"]) + inp["out_bias"]


def test_attention_dropout_replays_the_kernel_mask():
    rate, seed = 0.1, 20231016
    inp = _attention_inputs(B, L, H, NH, seed=2)
    seed_t = torch.tensor([seed], dtype=torch.int32)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = tb.attention_block_train(
        *(t[k] for k in ("hidden", "segment_ids", "qkv_kernel", "qkv_bias", "out_kernel",
                         "out_bias")), seed_t, sm_scale=HD**-0.5, dropout_rate=rate,
    ).numpy()
    # the kernels' mask: keep iff philox(seed; b, h, row, col) >= int(rate * 2^32)
    b, h, r, c = np.ix_(np.arange(B), np.arange(NH), np.arange(L), np.arange(L))
    keep = tb.philox_bits(seed, b, h, r, c) >= np.uint32(int(rate * 2**32))
    np.testing.assert_array_equal(tb.dropout_keep_mask(seed_t, B, NH, L, rate).numpy(), keep)
    assert abs(keep.mean() - (1 - rate)) < 5e-3
    want = _numpy_attention_with_dropout(inp, keep, rate)
    # rows of padding (segment 0) mask every key: float32 scores + -1e9 lose
    # the dot product there, float64 keeps it, so only valid rows compare
    valid = inp["segment_ids"] > 0
    np.testing.assert_allclose(got[valid], want[valid], **OUT_TOL)
    # another seed drops other probabilities
    other = tb.attention_block_train(
        *(t[k] for k in ("hidden", "segment_ids", "qkv_kernel", "qkv_bias", "out_kernel",
                         "out_bias")), seed_t + 1, sm_scale=HD**-0.5, dropout_rate=rate,
    ).numpy()
    assert np.abs(other - got).max() > 1e-3


def test_philox_known_answer():
    # Random123's known-answer vector for philox4x32-10: counter 0, key 0
    assert int(tb.philox_bits(0, 0, 0, 0, 0)) == 0x6627E8D5
    assert tb.dropout_threshold(0.0) == 0
    assert tb.dropout_threshold(0.1) == int(0.1 * 2**32)
    assert tb.dropout_threshold(1.0) == 2**32 - 1


def test_wrappers_on_cpu_count_no_launches():
    counters = [tb.attention_train_fwd, tb.attention_train_bwd, tb.mlp_train_fwd,
                tb.mlp_train_bwd]
    before = [f.launches for f in counters]
    inp = _mlp_inputs(M=16, H=32, I=64, seed=3)
    _torch_value_and_grads(lambda t: tb.mlp_block_train(*(t[k] for k in MLP_ARGS)), inp,
                           MLP_ARGS)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="activation"):
        tb.mlp_block_train(*(torch.from_numpy(inp[k]) for k in MLP_ARGS), activation="none")


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normalized_err(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _grads_on_card(fn, tensors, names):
    for k in names:
        tensors[k] = tensors[k].detach().requires_grad_(True)
    out = fn(tensors)
    (out.float() * tensors["cotangent"]).sum().backward()
    return [out.detach()] + [tensors[k].grad for k in names]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Bc,Lc,Hc,nh", [(4, 200, 256, 4), (2, 130, 256, 8), (2, 96, 256, 2),
                                         (3, 64, 64, 4)])
def test_attention_kernels_match_plain_on_card(cuda, dtype, rate, Bc, Lc, Hc, nh):
    hd = Hc // nh
    inp = _attention_inputs(Bc, Lc, Hc, nh, seed=Lc, w_scale=Hc**-0.5)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in inp.items()}
    t["hidden"] = t["hidden"].to(dtype)
    seed = torch.tensor([7 + Lc], dtype=torch.int32, device=cuda)
    keep = tb.dropout_keep_mask(seed, Bc, nh, Lc, rate) if rate else None
    args = ("segment_ids",)
    n_fwd, n_bwd = tb.attention_train_fwd.launches, tb.attention_train_bwd.launches
    got = _grads_on_card(
        lambda s: tb.attention_block_train(
            s["hidden"], s["segment_ids"], s["qkv_kernel"], s["qkv_bias"], s["out_kernel"],
            s["out_bias"], seed, sm_scale=hd**-0.5, dropout_rate=rate),
        dict(t), ATT_ARGS,
    )
    torch.cuda.synchronize()
    assert (tb.attention_train_fwd.launches, tb.attention_train_bwd.launches) == (
        n_fwd + 1, n_bwd + 1)
    ref = dict(t)
    ref["qkv_kernel"], ref["out_kernel"] = t["qkv_kernel"].to(dtype), t["out_kernel"].to(dtype)
    want = _grads_on_card(
        lambda s: tb.attention_train_plain(
            s["hidden"], s[args[0]], s["qkv_kernel"], s["qkv_bias"], s["out_kernel"],
            s["out_bias"], sm_scale=hd**-0.5, dropout_rate=rate, keep=keep),
        ref, ATT_ARGS,
    )
    for name, g, w in zip(("out",) + ATT_ARGS, got, want):
        err = _normalized_err(g, w)
        assert err < CARD_TOL["attention"][dtype], (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,Hc,I", [(1000, 256, 1024), (70, 768, 3072)])
@pytest.mark.parametrize("activation", ["gelu", "relu", "silu"])
def test_mlp_kernels_match_plain_on_card(cuda, dtype, M, Hc, I, activation):
    t = {k: torch.from_numpy(v).to(cuda) for k, v in _mlp_inputs(M, Hc, I, seed=M).items()}
    t["x"] = t["x"].to(dtype)
    n = (tb.mlp_train_fwd.launches, tb.mlp_train_bwd.launches)
    got = _grads_on_card(
        lambda s: tb.mlp_block_train(*(s[k] for k in MLP_ARGS), activation=activation), dict(t),
        MLP_ARGS)
    torch.cuda.synchronize()
    assert (tb.mlp_train_fwd.launches, tb.mlp_train_bwd.launches) == (n[0] + 1, n[1] + 1)
    ref = dict(t)
    ref["w1"], ref["w2"] = t["w1"].to(dtype), t["w2"].to(dtype)
    want = _grads_on_card(
        lambda s: tb.mlp_train_plain(*(s[k] for k in MLP_ARGS), activation=activation), ref,
        MLP_ARGS)
    for name, g, w in zip(("out",) + MLP_ARGS, got, want):
        err = _normalized_err(g, w)
        assert err < CARD_TOL["mlp"][dtype], (name, err)


@pytest.mark.gpu
def test_dropout_mask_on_card_matches_numpy(cuda):
    seed = torch.tensor([987654], dtype=torch.int32)
    want = tb.dropout_keep_mask(seed, 2, 3, 70, 0.25)
    got = tb.dropout_keep_mask(seed.to(cuda), 2, 3, 70, 0.25).cpu()
    assert torch.equal(got, want)
