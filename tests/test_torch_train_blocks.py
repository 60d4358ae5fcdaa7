"""Port training blocks: the plain versions against the JAX training kernels
on the CPU, the dropout mask against a numpy reference of the kernels'
formula, and the CUDA kernels against the plain versions on the card
(``-m gpu``). JAX is imported inside the CPU tests only, so the card tests
do not depend on it.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the backward products' card limit and its planted faults)

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


# ------------------------------------------------------- explicit backwards
# The explicit plain backwards (train_blocks.*_bwd_plain) in float32 equal
# autograd of the plain forwards (the same sums, another order of a few:
# to 1e-5 of each gradient's largest magnitude) and the JAX kernels' VJPs
# (GRAD_RTOL, as the plain forwards' gradients).
EXPLICIT_RTOL = 1e-5


def _assert_close_rel(got, want, rtol, names=None):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64).reshape(np.shape(g))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max() + 1e-12,
                                   err_msg=str(names[i] if names else i))


def _mlp_explicit(inp, activation="gelu"):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return [g.numpy() for g in tb.mlp_train_bwd_plain(
        t["x"], t["w1"], t["b1"], t["w2"], t["cotangent"], activation=activation)]


def _attention_explicit(inp, rate=0.0, keep=None):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return [g.numpy() for g in tb.attention_train_bwd_plain(
        t["hidden"], t["segment_ids"], t["qkv_kernel"], t["qkv_bias"], t["out_kernel"],
        t["cotangent"], sm_scale=HD**-0.5, dropout_rate=rate, keep=keep)]


@pytest.mark.parametrize("activation", ["gelu", "relu", "silu"])
def test_mlp_explicit_backward_matches_autograd_of_plain(activation):
    inp = _mlp_inputs(M=B * L, H=H, I=2 * H, seed=4)
    _, want = _torch_value_and_grads(
        lambda t: tb.mlp_train_plain(*(t[k] for k in MLP_ARGS), activation=activation), inp,
        MLP_ARGS)
    _assert_close_rel(_mlp_explicit(inp, activation), [want[0], *want[1:3], *want[3:]],
                      EXPLICIT_RTOL, MLP_ARGS)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_explicit_backward_matches_autograd_of_plain(rate):
    inp = _attention_inputs(B, L, H, NH, seed=5)
    seed = torch.tensor([99], dtype=torch.int32)
    keep = tb.dropout_keep_mask(seed, B, NH, L, rate) if rate else None
    _, want = _torch_value_and_grads(
        lambda t: tb.attention_train_plain(
            t["hidden"], t["segment_ids"], t["qkv_kernel"], t["qkv_bias"], t["out_kernel"],
            t["out_bias"], sm_scale=HD**-0.5, dropout_rate=rate, keep=keep), inp, ATT_ARGS)
    _assert_close_rel(_attention_explicit(inp, rate, keep), want, EXPLICIT_RTOL, ATT_ARGS)


def test_explicit_backwards_match_jax_kernels_vjp():
    """The MLP and attention kernels' explicit plain backwards against the
    VJPs of JAX's training kernels (interpret mode) at rate 0."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_blocks import attention_block_train as jax_attention
    from spokennlp_tpu.ops.pallas.train_blocks import mlp_block_train as jax_mlp

    inp = _mlp_inputs(M=B * L, H=H, I=2 * H, seed=6)
    cot = jnp.asarray(inp["cotangent"])
    _, vjp = jax.vjp(lambda *a: jax_mlp(*a, activation="gelu", interpret=True),
                     *(jnp.asarray(inp[k]) for k in MLP_ARGS))
    _assert_close_rel(_mlp_explicit(inp), vjp(cot), GRAD_RTOL, MLP_ARGS)

    inp = _attention_inputs(B, L, H, NH, seed=7)
    seg, seed = jnp.asarray(inp["segment_ids"]), jnp.zeros((1,), jnp.int32)
    _, vjp = jax.vjp(lambda h, *w: jax_attention(h, seg, *w, seed, HD**-0.5, dropout_rate=0.0,
                                                 interpret=True),
                     *(jnp.asarray(inp[k]) for k in ATT_ARGS))
    _assert_close_rel(_attention_explicit(inp), vjp(jnp.asarray(inp["cotangent"])), GRAD_RTOL,
                      ATT_ARGS)


def _gemm_limit_readings(fn, **kw):
    """chip_smoke's backward-product readings of ``fn()`` ({output: tensor})
    with backward_product summed in float64 (another order) against fn()
    itself, and with each planted fault against it."""
    from spokennlp_tpu_torch.ops.cuda import train_blocks

    want = fn()
    f64 = lambda real, a, b: (a.double() @ b.double()).float()
    with chip_smoke.planted([(train_blocks, "backward_product", None, f64)]):
        other = fn()
    assert any(not torch.equal(other[k], want[k]) for k in want)  # another order did run
    readings = {"float64": max(chip_smoke.backward_gemm_readings(other, want).values())}
    for fault, patches in chip_smoke.backward_gemm_faults().items():
        with chip_smoke.planted(patches):
            readings[fault] = max(chip_smoke.backward_gemm_readings(fn(), want).values())
    return readings


@pytest.mark.parametrize("kernel", ["mlp_train_bwd", "attention_train_bwd"])
def test_backward_gemm_limit_accepts_other_sum_orders_and_rejects_planted_faults(kernel):
    """The bf16 backward products' limit (chip_smoke.BWD_GEMM_TOL, element by
    element) accepts the explicit plain backward with its products summed in
    another order and rejects it with each of the GEMM tile's planted faults:
    partial sums rounded to bf16 every k-stage, the last k-step dropped."""
    bf = torch.bfloat16
    if kernel == "mlp_train_bwd":
        t = {k: torch.from_numpy(v) for k, v in _mlp_inputs(512, 128, 256, seed=8).items()}
        x, g, w1, w2 = (t[k].to(bf) for k in ("x", "cotangent", "w1", "w2"))
        names = ("dx", "dw1", "db1", "dw2", "db2")
        fn = lambda: dict(zip(names, tb.mlp_train_bwd_plain(x, w1, t["b1"], w2, g,
                                                            activation="gelu")))
    else:
        inp = _attention_inputs(4, 128, 128, 4, seed=9, w_scale=128**-0.5)
        t = {k: torch.from_numpy(v) for k, v in inp.items()}
        x, g = t["hidden"].to(bf).reshape(-1, 128), t["cotangent"].to(bf).reshape(-1, 128)
        rng = np.random.default_rng(9)
        bufs = {"ctx": torch.from_numpy(rng.normal(size=(512, 128)).astype(np.float32)).to(bf),
                "dproj": torch.from_numpy(rng.normal(size=(512, 384)).astype(np.float32)).to(bf)}
        wqkv, wo = t["qkv_kernel"].to(bf).reshape(128, 384), t["out_kernel"].to(bf).reshape(128, 128)
        fn = lambda: chip_smoke.projection_gemms_plain(x, g, bufs, wqkv, wo)
    readings = _gemm_limit_readings(fn)
    tol = chip_smoke.BWD_GEMM_TOL[kernel]
    assert readings.pop("float64") <= tol
    for fault, r in readings.items():
        assert r > tol, (fault, r)


def test_weight_grad_splits_and_workspace():
    """The split rule at the training paths' shapes on 132 SMs, the
    workspace's size (csrc/bf16_gemm.cuh's formula) and the CPU path."""
    assert tb.weight_grad_splits(16384, 768, 3072, 132) == 7
    assert tb.weight_grad_splits(16384, 768, 768, 132) == 7
    assert tb.weight_grad_splits(16384, 768, 4608, 132) == 1  # 216 tiles fill the card
    assert tb.weight_grad_splits(4096, 768, 768, 132) == 7
    assert tb.weight_grad_splits(126, 68, 136, 132) == 1  # too few rows to split
    assert tb.weight_grad_workspace(1, 768, 768) == 0
    assert tb.weight_grad_workspace(3, 67, 131) == 3 * (8780 + 132)
    x, dy = torch.randn(40, 6), torch.randn(40, 10)
    n = tb.weight_grad.launches
    dw, db = tb.weight_grad(x, dy)
    assert tb.weight_grad.launches == n
    torch.testing.assert_close(dw, x.t() @ dy)
    torch.testing.assert_close(db, dy.sum(0))


# ------------------------------------------- the bf16 cores' rounding models


def _dense_leaves(Bm, Lm, nh, hd, seed):
    """q, k, v (B, nh, L, hd) and dctx (B, L, nh, hd) float32, and the
    segment ids (B, L) of ``_segments``."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return (f(Bm, nh, Lm, hd), f(Bm, nh, Lm, hd), f(Bm, nh, Lm, hd), f(Bm, Lm, nh, hd),
            torch.from_numpy(_segments(Bm, Lm, seed)))


def _plain_scores(q, k, seg, sm):
    """q k^T sm + (0 where allowed, else -1e9), (B, nh, L, L): the plain
    core's scores."""
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    return q @ k.transpose(-1, -2) * sm + torch.where(allowed, 0.0, -1e9)[:, None]


def test_attention_rows_model_matches_jax_kernel_context_in_float32():
    """attention_rows_model in float32 against the context of the TPU kernel
    in interpret mode, read through an identity output projection (H = nh
    hd, zero bias): every row, the padded ones too (the -1e9 mask of both
    spreads them over the sequence), to 1e-5 of the largest."""
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_blocks import attention_block_train as jax_attention

    inp = _attention_inputs(B, L, H, NH, seed=3)
    inp["out_kernel"] = np.eye(H, dtype=np.float32).reshape(NH, HD, H)
    inp["out_bias"] = np.zeros(H, np.float32)
    want = jax_attention(jnp.asarray(inp["hidden"]), jnp.asarray(inp["segment_ids"]),
                         *(jnp.asarray(inp[k]) for k in ATT_ARGS[1:]), jnp.zeros((1,), jnp.int32),
                         HD**-0.5, dropout_rate=0.0, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    qkv = (torch.einsum("blh,hsnd->sbnld", t["hidden"], t["qkv_kernel"])
           + t["qkv_bias"][:, None, :, None])
    got, _ = tb.attention_rows_model(qkv[0], qkv[1], qkv[2], t["segment_ids"], sm_scale=HD**-0.5)
    want = np.asarray(want)
    np.testing.assert_allclose(got.reshape(B, L, H).numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_rows_model_statistics_match_autograd_of_plain_softmax(rate):
    """float32: attention_rows_model's statistics against the plain softmax
    of the -1e9-masked scores: m its maximum and m + log D its logsumexp on
    real rows, and rowsum(dp p_eff) / (D keep_prob) = sum_k p_k dL/dp_k from
    autograd of ctx = (kept p / keep_prob) . v with the cotangent dctx on
    every row; to 1e-5 of the largest."""
    Bm, Lm, nh, hd = 2, 96, 2, 16
    sm = hd**-0.5
    q, k, v, dctx, seg = _dense_leaves(Bm, Lm, nh, hd, 31)
    keep = tb.dropout_keep_mask(torch.tensor([5], dtype=torch.int32), Bm, nh, Lm, rate) \
        if rate else None
    _, stats = tb.attention_rows_model(q, k, v, seg, sm_scale=sm, dctx=dctx, dropout_rate=rate,
                                       keep=keep)
    s = _plain_scores(q, k, seg, sm)
    p = torch.softmax(s, -1).requires_grad_()
    kept = p if keep is None else torch.where(keep, p, 0.0)
    (gp,) = torch.autograd.grad(kept / (1.0 - rate) @ v, p, dctx.transpose(1, 2))
    real = (seg > 0)[:, None].expand(Bm, nh, Lm)
    for got, want in ((stats[0][real], s.amax(-1)[real]),
                      ((stats[0] + stats[1].log())[real], torch.logsumexp(s, -1)[real]),
                      (stats[2], (p * gp).sum(-1))):
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=0,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_core_bwd_model_matches_autograd_of_plain_core(rate):
    """float32: attention_core_bwd_model's dq, dk, dv (its statistics taken
    by attention_rows_model, as the kernels' statistics pass takes them)
    against autograd of the plain core with the cotangent dctx, the keep
    mask replayed; to 1e-5 of the largest."""
    Bm, Lm, nh, hd = 2, 96, 2, 16
    sm = hd**-0.5
    q, k, v, dctx, seg = _dense_leaves(Bm, Lm, nh, hd, 37)
    keep = tb.dropout_keep_mask(torch.tensor([6], dtype=torch.int32), Bm, nh, Lm, rate) \
        if rate else None
    _, stats = tb.attention_rows_model(q, k, v, seg, sm_scale=sm, dctx=dctx, dropout_rate=rate,
                                       keep=keep)
    got = tb.attention_core_bwd_model(q, k, v, dctx, seg, sm_scale=sm, stats=stats,
                                      dropout_rate=rate, keep=keep)
    leaves = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    ctx = tb._attention_core_train(*leaves, seg, sm, rate, keep)
    want = torch.autograd.grad(ctx, leaves, dctx)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5 * w.abs().max().item(),
                                   err_msg=name)


def _bf16_dense_leaves(Bm, Lm, nh, hd, seed):
    q, k, v, dctx, seg = _dense_leaves(Bm, Lm, nh, hd, seed)
    return (*(t.to(torch.bfloat16) for t in (q, k, v, dctx)), seg)


@pytest.mark.parametrize("fault", chip_smoke.ROWS_FAULTS)
def test_dense_rows_gate_rejects_the_planted_faults(fault):
    """chip_smoke's limits of the rows kernels (ROWS_TOL) reject each planted
    fault of attention_rows_model in bf16 at L=256, rate 0.1: ctx alone (the
    forward) and ctx with the statistics, the model with the fault read
    against the model."""
    Bm, Lm, nh, hd = 2, 256, 2, 64
    q, k, v, dctx, seg = _bf16_dense_leaves(Bm, Lm, nh, hd, 41)
    keep = tb.dropout_keep_mask(torch.tensor([3], dtype=torch.int32), Bm, nh, Lm, 0.1)
    for dc in (None, dctx):
        model = lambda: tb.attention_rows_model(q, k, v, seg, sm_scale=hd**-0.5, dctx=dc,
                                                dropout_rate=0.1, keep=keep)
        want = model()
        if dc is None:
            want = (want[0], None)
        with chip_smoke.planted(chip_smoke.rows_faults("attn_rows")[fault]):
            bad = model()
        tol = chip_smoke.rows_tol(want)
        assert chip_smoke.core_bwd_excess(chip_smoke.rows_readings(want, bad), tol) > 1
        assert chip_smoke.core_bwd_excess(chip_smoke.rows_readings(want, want), tol) == 0


@pytest.mark.parametrize("fault", chip_smoke.BWD_CORE_FAULTS)
def test_dense_core_gate_rejects_the_planted_faults(fault):
    """chip_smoke's limits of the gradient kernels
    (BWD_CORE_TOL["attention_train_bwd"]) reject each planted fault of
    attention_core_bwd_model in bf16 at L=256, rate 0.1."""
    Bm, Lm, nh, hd = 2, 256, 2, 64
    q, k, v, dctx, seg = _bf16_dense_leaves(Bm, Lm, nh, hd, 43)
    keep = tb.dropout_keep_mask(torch.tensor([4], dtype=torch.int32), Bm, nh, Lm, 0.1)
    model = lambda: torch.stack(tb.attention_core_bwd_model(
        q, k, v, dctx, seg, sm_scale=hd**-0.5, dropout_rate=0.1, keep=keep), dim=2).reshape(
            Bm * Lm, -1)
    want = model()
    with chip_smoke.planted(chip_smoke.core_bwd_faults("attention_train_bwd")[fault]):
        bad = model()
    tol = chip_smoke.BWD_CORE_TOL["attention_train_bwd"]
    assert chip_smoke.core_bwd_excess(chip_smoke.core_bwd_readings(want, bad, nh * hd), tol) > 1
    assert chip_smoke.core_bwd_excess(chip_smoke.core_bwd_readings(want, want, nh * hd), tol) == 0


def test_core_wrappers_on_cpu_run_the_models_and_count_no_launches():
    """attention_rows and attention_grad on CPU tensors run the rounding
    models and launch nothing; dense_ds_elements sizes the dS tiles."""
    Bm, Lm, nh, hd = 2, 70, 2, 16
    q, k, v, dctx, seg = _dense_leaves(Bm, Lm, nh, hd, 47)
    qkv, seed = torch.stack([q, k, v]), torch.tensor([9], dtype=torch.int32)
    n = (tb.attention_rows.launches, tb.attention_grad.launches)
    kw = dict(sm_scale=hd**-0.5, dropout_rate=0.1)
    ctx, stats = tb.attention_rows(qkv, seg, seed, dctx=dctx.reshape(Bm, Lm, -1), **kw)
    keep = tb.dropout_keep_mask(seed, Bm, nh, Lm, 0.1)
    want = tb.attention_rows_model(q, k, v, seg, dctx=dctx, keep=keep, **kw)
    assert torch.equal(ctx, want[0]) and torch.equal(stats, want[1])
    dproj, ds = tb.attention_grad(qkv, seg, seed, dctx.reshape(Bm, Lm, -1), stats, **kw)
    grads = tb.attention_core_bwd_model(q, k, v, dctx, seg, stats=stats, keep=keep, **kw)
    assert ds is None and torch.equal(dproj, torch.stack(grads, dim=2).reshape(Bm * Lm, -1))
    assert (tb.attention_rows.launches, tb.attention_grad.launches) == n
    assert tb.dense_ds_elements(2, 3, 70) == 2 * 3 * 2 * 2 * 64 * 64


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


# The backward's products in bf16 against the explicit plain backward, element
# by element within chip_smoke.BWD_GEMM_TOL, at the GEMM tile's ragged widths:
# H = 68 (4-byte copies), odd H and I (element-wise staging), sequences of 63
# (row tails, a weight gradient's depth B * 63), and the main path's shape.
BWD_NAMES = ("dx", "dw_all", "db_all", "dwo", "dbo")
MLP_NAMES = ("dx", "dw1", "db1", "dw2", "db2")


def _bf16_mlp(M, Hc, I, device, seed):
    t = {k: torch.from_numpy(v).to(device) for k, v in _mlp_inputs(M, Hc, I, seed=seed).items()}
    for k in ("x", "w1", "w2", "cotangent"):
        t[k] = t[k].to(torch.bfloat16)
    return t


def _mlp_bwd(fn, t):
    return dict(zip(MLP_NAMES, fn(t["x"], t["w1"], t["b1"], t["w2"], t["cotangent"],
                                  activation="gelu")))


@pytest.mark.gpu
@pytest.mark.parametrize("M,Hc,I", [(2 * 63, 68, 136), (3 * 63, 67, 131), (4 * 63, 768, 3072),
                                    (32 * 512, 768, 3072)])
def test_mlp_backward_products_match_explicit_plain_on_card(cuda, M, Hc, I):
    t = _bf16_mlp(M, Hc, I, cuda, seed=M + Hc)
    n = tb.mlp_train_bwd.launches
    got = _mlp_bwd(tb.mlp_train_bwd, t)
    torch.cuda.synchronize()
    assert tb.mlp_train_bwd.launches == n + 1
    readings = chip_smoke.backward_gemm_readings(got, _mlp_bwd(tb.mlp_train_bwd_plain, t))
    assert max(readings.values()) <= chip_smoke.BWD_GEMM_TOL["mlp_train_bwd"], readings


def _bf16_attention(Bc, Lc, Hc, nh, hd, device, seed):
    """Inputs of attention_train_bwd with any H beside nh heads of hd."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
    HN, bf = nh * hd, torch.bfloat16
    t = dict(hidden=f(Bc, Lc, Hc).to(bf), seg=torch.from_numpy(_segments(Bc, Lc, seed)),
             wqkv=f(Hc, 3 * HN, scale=Hc**-0.5).to(bf), bqkv=f(3 * HN, scale=0.1),
             wo=f(HN, Hc, scale=HN**-0.5).to(bf), g=f(Bc, Lc, Hc).to(bf),
             seed=torch.tensor([seed], dtype=torch.int32))
    return {k: v.to(device) for k, v in t.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("Bc,Lc,Hc,nh,hd", [(2, 63, 68, 2, 32), (3, 63, 67, 2, 16),
                                            (4, 200, 256, 4, 64), (32, 512, 768, 12, 64)])
def test_attention_backward_products_match_explicit_plain_on_card(cuda, Bc, Lc, Hc, nh, hd):
    """dctx, dx, the weight and the bias gradients of the attention block's
    backward against its explicit plain products on the intermediates the
    kernel's products read (its ctx, and dproj from its attention core)."""
    t = _bf16_attention(Bc, Lc, Hc, nh, hd, cuda, seed=Lc + Hc)
    bufs = {}
    got = tb.attention_train_bwd(t["hidden"], t["seg"], t["seed"], t["wqkv"], t["bqkv"], t["wo"],
                                 t["g"], num_heads=nh, sm_scale=hd**-0.5, dropout_rate=0.1,
                                 buffers=bufs)
    want = chip_smoke.projection_gemms_plain(t["hidden"].reshape(-1, Hc), t["g"].reshape(-1, Hc),
                                             bufs, t["wqkv"], t["wo"])
    readings = chip_smoke.backward_gemm_readings(
        {"dctx": bufs["dctx"], **dict(zip(BWD_NAMES, got))}, want)
    assert max(readings.values()) <= chip_smoke.BWD_GEMM_TOL["attention_train_bwd"], readings


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,Hin,N,splits", [(126, 68, 136, None), (189, 67, 131, 2),
                                            (63, 136, 68, 1), (3000, 768, 768, 5),
                                            (32 * 512, 768, 3072, None)])
def test_weight_grad_tile_matches_plain_on_card(cuda, dtype, M, Hin, N, splits):
    """The weight gradient alone (its row ranges summed in order, the bias
    gradient from the same pass) against weight_grad_plain."""
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(M, Hin, generator=g, device=cuda).to(dtype)
    dy = torch.randn(M, N, generator=g, device=cuda).to(dtype)
    n = tb.weight_grad.launches
    dw, db = tb.weight_grad(x, dy, splits=splits)
    torch.cuda.synchronize()
    assert tb.weight_grad.launches == n + 1
    want = dict(zip(("dw", "db"), tb.weight_grad_plain(x, dy)))
    readings = chip_smoke.backward_gemm_readings({"dw": dw, "db": db}, want)
    assert max(readings.values()) <= chip_smoke.BWD_GEMM_TOL["mlp_train_bwd"], readings


def _long_backward(kernel, device):
    """A bf16 call of the Longformer or BigBird backward kernel at the
    training shape (B=2, L=2048, BERT-base widths, dropout 0.1)."""
    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import bigbird_block, sliding_block
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    g = torch.Generator(device=device).manual_seed(5)
    randn = lambda *s: torch.randn(*s, generator=g, device=device)
    bf, Lc = torch.bfloat16, 2048
    hidden, cot = randn(2, Lc, 768).to(bf), randn(2, Lc, 768).to(bf)
    mask = (torch.arange(Lc, device=device)[None] < torch.tensor([[Lc], [1500]],
                                                                   device=device)).int()
    seed = torch.tensor([9], dtype=torch.int32, device=device)
    p = [randn(768, 3, 12, 64) * 0.036, randn(3, 12, 64) * 0.02, randn(12, 64, 768) * 0.036]
    kw = dict(num_heads=12, sm_scale=0.125, dropout_rate=0.1)
    if kernel == "sliding_train_bwd":
        glob = torch.zeros_like(mask)
        glob[:, 0] = 1
        w = sliding_block.card_weights(p[0], p[1], p[0], p[1], p[2], bf)
        return lambda: ts.sliding_train_bwd(hidden, mask, glob, seed, w, cot, window=512,
                                            max_globals=16, global_rows=True, **kw)[1:]
    w = bigbird_block.card_weights(*p, bf)
    tables = bigbird_tables(Lc // 64, 2, 3, 0, device)
    return lambda: tbb.bigbird_train_bwd(hidden, mask, seed, w, cot, tables, block_size=64,
                                         **kw)[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["mlp_train_bwd", "attention_train_bwd", "sliding_train_bwd",
                                    "bigbird_train_bwd", "weight_grad"])
def test_bf16_weight_gradients_repeat_bit_for_bit_on_card(cuda, kernel):
    """Each bf16 weight gradient (the rows split into ranges, summed in
    order) gives the same bits on a second run, at the main paths' shapes."""
    if kernel in ("sliding_train_bwd", "bigbird_train_bwd"):
        run = _long_backward(kernel, cuda)
    elif kernel == "mlp_train_bwd":
        t = _bf16_mlp(32 * 512, 768, 3072, cuda, seed=3)
        run = lambda: list(_mlp_bwd(tb.mlp_train_bwd, t).values())[1:]
    elif kernel == "attention_train_bwd":
        t = _bf16_attention(32, 512, 768, 12, 64, cuda, seed=3)
        run = lambda: tb.attention_train_bwd(
            t["hidden"], t["seg"], t["seed"], t["wqkv"], t["bqkv"], t["wo"], t["g"],
            num_heads=12, sm_scale=0.125, dropout_rate=0.1)[1:]
    else:
        g = torch.Generator(device=cuda).manual_seed(3)
        x, dy = (torch.randn(32 * 512, n, generator=g, device=cuda).to(torch.bfloat16)
                 for n in (768, 768))
        run = lambda: tb.weight_grad(x, dy)
    first = run()
    assert all(torch.equal(a, b) for a, b in zip(first, run()))


# (B, L, H, heads): L not a multiple of the 64-row tile, head dims 64, 32,
# 128 and 16, and the main path's shape (every L above 64, so that the
# planted fault's dropped key tile, keys 64-127 of rows 64-127, exists)
DENSE_CARD_SHAPES = [(4, 200, 256, 4), (2, 130, 256, 8), (2, 96, 256, 2), (3, 80, 64, 4),
                     (2, 512, 768, 12)]


def _dense_backward(cuda, Bc, Lc, Hc, nh, rate, seed):
    """bf16 inputs of the attention block on the card, a backward's
    intermediates (``attention_train_bwd``'s buffers), the keep mask and the
    seed."""
    hd = Hc // nh
    inp = _attention_inputs(Bc, Lc, Hc, nh, seed=seed, w_scale=Hc**-0.5)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in inp.items()}
    bf = torch.bfloat16
    seed_t = torch.tensor([seed], dtype=torch.int32, device=cuda)
    wqkv = t["qkv_kernel"].to(bf).reshape(Hc, 3 * Hc).contiguous()
    wo = t["out_kernel"].to(bf).reshape(Hc, Hc).contiguous()
    args = (t["hidden"].to(bf), t["segment_ids"], seed_t, wqkv, t["qkv_bias"].reshape(-1), wo,
            t["cotangent"].to(bf))
    bufs = {}
    got = tb.attention_train_bwd(*args, num_heads=nh, sm_scale=hd**-0.5, dropout_rate=rate,
                                 buffers=bufs)
    keep = tb.dropout_keep_mask(seed_t, Bc, nh, Lc, rate) if rate else None
    return args, bufs, got, keep, seed_t


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fwd", "stats"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Bc,Lc,Hc,nh", DENSE_CARD_SHAPES)
def test_attention_rows_kernel_matches_rounding_model_on_card(cuda, mode, rate, Bc, Lc, Hc, nh):
    """bf16: attn_rows_kernel alone (tb.attention_rows) on the q, k, v and
    dctx of a backward of the block against attention_rows_model within
    chip_smoke.ROWS_TOL: the forward's ctx, and the statistics pass (ctx and
    the statistics, which must equal the backward's own); two runs give the
    same bits; each planted fault of the model fails the limits."""
    hd = Hc // nh
    _, bufs, _, keep, seed = _dense_backward(cuda, Bc, Lc, Hc, nh, rate, Lc + 5)
    qkv, seg = bufs["qkv"], bufs["seg"]
    dctx = bufs["dctx"].reshape(Bc, Lc, Hc) if mode == "stats" else None
    n = tb.attention_rows.launches
    runs = [tb.attention_rows(qkv, seg, seed, sm_scale=hd**-0.5, dctx=dctx, dropout_rate=rate)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert tb.attention_rows.launches == n + 2
    if mode == "stats":
        assert torch.equal(runs[0][1], bufs["stats"])
        assert torch.equal(runs[0][0].reshape(Bc * Lc, Hc), bufs["ctx"])
    model = lambda: tb.attention_rows_model(
        qkv[0], qkv[1], qkv[2], seg, sm_scale=hd**-0.5, dropout_rate=rate, keep=keep,
        dctx=None if dctx is None else dctx.reshape(Bc, Lc, nh, hd))
    want = model()
    readings = chip_smoke.rows_readings(runs[0], want if dctx is not None else (want[0], None))
    print(f"{Bc}x{Lc} hd {hd} {mode} rate {rate}: {readings}")
    tol = chip_smoke.rows_tol(runs[0])
    assert chip_smoke.core_bwd_excess(readings, tol) <= 1, readings
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(*runs))
    for fault, patches in chip_smoke.rows_faults("attn_rows").items():
        with chip_smoke.planted(patches):
            bad = model()
        bad = chip_smoke.rows_readings(runs[0], bad if dctx is not None else (bad[0], None))
        print(f"  {fault}: {bad}")
        assert chip_smoke.core_bwd_excess(bad, tol) > 1, (fault, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Bc,Lc,Hc,nh", DENSE_CARD_SHAPES)
def test_attention_gradient_kernels_match_rounding_model_on_card(cuda, rate, Bc, Lc, Hc, nh):
    """bf16: the gradient kernels' dproj against attention_core_model_dproj
    on the kernel's own intermediates, within
    chip_smoke.BWD_CORE_TOL["attention_train_bwd"] element by element and in
    norm in each slot; two runs give the same bits; attn_dkv then attn_dq
    launched alone (tb.attention_grad) give the backward's dproj; each
    planted fault of the model fails the limits."""
    hd = Hc // nh
    args, bufs, _, keep, seed = _dense_backward(cuda, Bc, Lc, Hc, nh, rate, Lc + 9)
    again = {}
    tb.attention_train_bwd(*args, num_heads=nh, sm_scale=hd**-0.5, dropout_rate=rate,
                           buffers=again)
    assert torch.equal(bufs["dproj"], again["dproj"])
    kw = dict(sm_scale=hd**-0.5, dropout_rate=rate)
    dctx = bufs["dctx"].reshape(Bc, Lc, Hc)
    out = tb.attention_grad(bufs["qkv"], bufs["seg"], seed, dctx, bufs["stats"], which=1, **kw)
    alone, _ = tb.attention_grad(bufs["qkv"], bufs["seg"], seed, dctx, bufs["stats"], which=2,
                                 out=out, **kw)
    assert torch.equal(alone, bufs["dproj"])
    model = lambda: tb.attention_core_model_dproj(bufs, keep=keep, **kw)
    readings = chip_smoke.core_bwd_readings(bufs["dproj"], model(), Hc)
    print(f"{Bc}x{Lc} hd {hd} rate {rate}: {readings}")
    tol = chip_smoke.BWD_CORE_TOL["attention_train_bwd"]
    assert chip_smoke.core_bwd_excess(readings, tol) <= 1, readings
    for fault, patches in chip_smoke.core_bwd_faults("attention_train_bwd").items():
        with chip_smoke.planted(patches):
            bad = chip_smoke.core_bwd_readings(bufs["dproj"], model(), Hc)
        print(f"  {fault}: {bad}")
        assert chip_smoke.core_bwd_excess(bad, tol) > 1, (fault, bad)
