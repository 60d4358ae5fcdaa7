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


@pytest.mark.parametrize("part", ["gemm", "gemm_gate", "gemm_t", "residual", "residual_ln", "qkv",
                                  "unpaired"])
def test_forward_tile_on_cpu_runs_its_plain_arithmetic(part):
    """train_blocks.forward_tile on a CPU tensor: the tile's arithmetic in
    plain float32 (bias, activation, gate, a weight read transposed; residual
    and LayerNorm; the q/k/v scatter with q scaled), no launch counted; a
    residual without its LayerNorm or the reverse, and another device,
    raise."""
    import torch.nn.functional as F

    rng = np.random.default_rng(15)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    a, w, bias, gate, resid = f(9, 20), f(20, 24), f(24), f(9, 24), f(9, 24)
    ln = (1 + 0.1 * f(24), 0.1 * f(24))
    y = a @ w + bias
    n = tb.forward_tile.launches
    if part == "unpaired":
        for kw in (dict(resid=resid), dict(ln=ln), dict(kernel="gemm", resid=resid, ln=ln)):
            with pytest.raises(ValueError, match="resid and ln"):
                tb.forward_tile(a, w, bias, **{"kernel": "residual_ln", **kw})
        return
    if part == "gemm":
        got, want = tb.forward_tile(a, w, bias), y
    elif part == "gemm_gate":
        got = tb.forward_tile(a, w, bias, gate=gate, activation="gelu")
        want = F.gelu(y, approximate="tanh") * gate
    elif part == "gemm_t":
        got = tb.forward_tile(a, w.t().contiguous(), bias, kernel="gemm_t", gate=gate)
        want = y * gate
    elif part == "residual":
        got, want = tb.forward_tile(a, w, bias, kernel="residual_ln"), y
    elif part == "residual_ln":
        got = tb.forward_tile(a, w, bias, kernel="residual_ln", resid=resid, ln=ln)
        want = F.layer_norm(y + resid, (24,), *ln, eps=1e-12)
    else:
        got = tb.forward_tile(a, w, bias, kernel="qkv", heads=2, sm_scale=0.5)
        q, k, v = y.reshape(9, 3, 2, 4).unbind(1)
        want = torch.stack([q * 0.5, k, v]).permute(0, 2, 1, 3)[:, None]
    assert tb.forward_tile.launches == n
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        tb.forward_tile(a.to("meta"), w.to("meta"), bias.to("meta"))


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


def test_weight_grad_plan_in_float32():
    """The float32 split rule (the 3xTF32 tile also splits a gradient of 1.5
    tiles an SM or more, where bf16 leaves it whole) and the shared
    workspace's length at the training paths' shapes on 132 SMs."""
    f32, bf = torch.float32, torch.bfloat16
    assert tb.weight_grad_splits(16384, 768, 4608, 132, f32) == 6  # 216 tiles
    assert tb.weight_grad_splits(16384, 768, 4608, 132, bf) == 1
    assert tb.weight_grad_splits(4096, 768, 4608, 132, f32) == 6
    assert tb.weight_grad_splits(126, 68, 136, 132, f32) == 1  # too few rows to split
    splits, floats = tb.weight_grad_layout(f32, 16384, [(768, 3072), (3072, 768)], 132)
    assert splits == [7, 7] and floats == 7 * (768 * 3072 + 3072)
    splits, floats = tb.weight_grad_layout(f32, 16384, [(768, 2304), (768, 768)], 132)
    assert splits == [7, 7] and floats == 7 * (768 * 2304 + 2304)
    splits, floats = tb.weight_grad_layout(f32, 4096, [(768, 4608), (768, 768)], 132)
    assert splits == [6, 7] and floats == max(6 * (768 * 4608 + 4608), 7 * (768 * 768 + 768))
    assert tb.weight_grad_layout(f32, 126, [(68, 136)], 132) == ([1], 0)


# The float32 backwards' products on the card take the 3xTF32 tile
# (csrc/tf32x3_gemm.cuh), which int8_matmul.tf32x3_product models: against a
# float64 product it errs by float32's own rounding, within 1e-6 of the
# largest output (kernel 9's limit, tests/test_torch_ponet.py); plain TF32
# (terms=1, the planted fault of chip_smoke.F32_BWD_GEMM_TOL) falls a
# hundred times beyond that limit, and beyond the card's gate.
TF32X3_RTOL = 1e-6


@pytest.mark.parametrize("product", ["transposed_weight", "weight_gradient"])
def test_tf32x3_model_of_the_backward_products(product):
    from spokennlp_tpu_torch.ops.cuda.int8_matmul import tf32x3_product

    rng = np.random.default_rng(11)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    if product == "transposed_weight":  # dx = dproj W^T, W (N, K) read transposed
        a, w = f(512, 768), f(192, 768)
        got = {terms: tf32x3_product(a, w.t(), terms) for terms in (3, 1)}
        ref = a.double() @ w.double().t()
    else:  # dW = x^T dy summed over 4096 rows
        x, dy = f(4096, 96), f(4096, 160)
        got = {terms: tf32x3_product(x.t(), dy, terms) for terms in (3, 1)}
        ref = x.double().t() @ dy.double()
    reading = {t: ((g.double() - ref).abs().max() / ref.abs().max()).item()
               for t, g in got.items()}
    assert reading[3] <= TF32X3_RTOL, reading
    assert reading[1] > 100 * TF32X3_RTOL, reading
    assert chip_smoke.f32_gemm_excess(chip_smoke.f32_gemm_readings(
        {"out": got[1]}, {"out": ref.float()})["out"]) > 1


def _tf32x3_products():
    """planted() patches: every product of the explicit plain backwards
    through the 3xTF32 model, as the card's float32 backwards take theirs."""
    from spokennlp_tpu_torch.ops.cuda.int8_matmul import tf32x3_product

    return [(tb, "backward_product", None, lambda real, a, b: tf32x3_product(a, b))]


@pytest.mark.parametrize("kernel", ["mlp_train_bwd", "attention_train_bwd"])
def test_float32_backward_gemm_gate_rejects_plain_tf32(kernel):
    """chip_smoke's float32 backward-product gate (F32_BWD_GEMM_TOL, each
    output against the explicit plain backward) accepts a backward with its
    products through the 3xTF32 model and rejects it with plain TF32
    products, in every output a product reaches (not db2 and dbo, column
    sums of the cotangent)."""
    if kernel == "mlp_train_bwd":
        t = {k: torch.from_numpy(v) for k, v in _mlp_inputs(1024, 128, 512, seed=12).items()}
        names = ("dx", "dw1", "db1", "dw2", "db2")
        plain = lambda: dict(zip(names, tb.mlp_train_bwd_plain(
            t["x"], t["w1"], t["b1"], t["w2"], t["cotangent"], activation="gelu")))
        moved = ("dx", "dw1", "db1", "dw2")
    else:
        inp = _attention_inputs(4, 128, 128, 4, seed=12, w_scale=128**-0.5)
        t = {k: torch.from_numpy(v) for k, v in inp.items()}
        x, g = t["hidden"].reshape(-1, 128), t["cotangent"].reshape(-1, 128)
        rng = np.random.default_rng(12)
        bufs = {"ctx": torch.from_numpy(rng.normal(size=(512, 128)).astype(np.float32)),
                "dproj": torch.from_numpy(rng.normal(size=(512, 384)).astype(np.float32))}
        wqkv, wo = t["qkv_kernel"].reshape(128, 384), t["out_kernel"].reshape(128, 128)
        plain = lambda: chip_smoke.projection_gemms_plain(x, g, bufs, wqkv, wo)
        moved = ("dctx", "dx", "dw_all", "dwo")
    with chip_smoke.planted(_tf32x3_products()):
        got = plain()
    chip_smoke.check_f32_backward_gemms(kernel, got, plain)
    with chip_smoke.planted(chip_smoke.plain_tf32_products()):
        bad = plain()
    with pytest.raises(RuntimeError, match="beyond its limit"):
        chip_smoke.check_f32_backward_gemms(kernel, bad, plain)
    readings = chip_smoke.f32_gemm_readings(bad, plain())
    assert all(chip_smoke.f32_gemm_excess(readings[k]) > 1 for k in moved), readings


def test_mlp_explicit_backward_on_the_tf32x3_model_matches_jax_kernel_vjp():
    """Row 11's explicit plain backward with every product through the 3xTF32
    model, as the card's float32 backward takes its products, against the
    VJP of JAX's training kernel (interpret mode) in float32: to
    EXPLICIT_RTOL of each gradient's largest magnitude, as the float32
    products themselves."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_blocks import mlp_block_train as jax_mlp

    inp = _mlp_inputs(M=B * L, H=H, I=4 * H, seed=13)
    _, vjp = jax.vjp(lambda *a: jax_mlp(*a, activation="gelu", interpret=True),
                     *(jnp.asarray(inp[k]) for k in MLP_ARGS))
    with chip_smoke.planted(_tf32x3_products()):
        got = _mlp_explicit(inp)
    _assert_close_rel(got, vjp(jnp.asarray(inp["cotangent"])), EXPLICIT_RTOL, MLP_ARGS)


def test_mlp_plain_forward_on_the_tf32x3_model_matches_jax_kernel():
    """Row 11's plain forward with both products through the 3xTF32 model
    (chip_smoke.float_products), as the card's float32 forward takes them,
    against JAX's training kernel (interpret mode) in float32: to
    EXPLICIT_RTOL of the output's largest magnitude."""
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_blocks import mlp_block_train as jax_mlp

    inp = _mlp_inputs(M=B * L, H=H, I=4 * H, seed=14)
    want = jax_mlp(*(jnp.asarray(inp[k]) for k in MLP_ARGS), activation="gelu", interpret=True)
    with chip_smoke.planted(chip_smoke.float_products(chip_smoke.tf32x3_model)):
        got = tb.mlp_train_plain(*(torch.from_numpy(inp[k]) for k in MLP_ARGS),
                                 activation="gelu")
    _assert_close_rel([got], [want], EXPLICIT_RTOL)


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


# Row 10's float32 cores run S, dP, P V, dS k, dS^T q and p_eff^T dctx as
# 3xTF32 on the tensor cores; their rounding models take those products
# through attention_models.core_product, which the card gates put on the
# 3xTF32 model (chip_smoke.core_products(chip_smoke.tf32x3_model)). On the
# CPU, the block assembled from those models (and its projections on the
# same model) against JAX's training kernel in interpret mode at rate 0:
# the output and every gradient within MODEL_BLOCK_RTOL of its largest
# magnitude (measured: at most 8.1e-7), as the float32 products themselves.
MODEL_BLOCK_RTOL = 1e-5
# chip_smoke.F32_BWD_CORE_TOL: the float32 gradient kernels' dproj against
# their rounding model on the 3xTF32 model, (share of max |ref|, of ||ref||)
F32_CORE_TOL = (1e-4, 8e-5)


def _model_block(inp, dctx_from=None):
    """Row 10's float32 block from its rounding models, every product on
    the 3xTF32 model: (out, dx, dWqkv, dbqkv, dWo, dbo) at rate 0 for the
    cotangent of ``inp``."""
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x, seg, g = t["hidden"], t["segment_ids"], t["cotangent"]
    Bm, Lm, Hm = x.shape
    nh, hd = t["qkv_kernel"].shape[2:]
    wqkv, wo = t["qkv_kernel"].reshape(Hm, -1), t["out_kernel"].reshape(-1, Hm)
    mm = lambda a, b: chip_smoke.tf32x3_model(None, a, b)
    with chip_smoke.planted(chip_smoke.core_products(chip_smoke.tf32x3_model)):
        qkv = (mm(x, wqkv) + t["qkv_bias"].reshape(-1)).reshape(Bm, Lm, 3, nh, hd)
        q, k, v = (u.transpose(1, 2) for u in qkv.unbind(2))
        dctx = mm(g, wo.t()).reshape(Bm, Lm, nh, hd)
        ctx, stats = tb.attention_rows_model(q, k, v, seg, sm_scale=hd**-0.5, dctx=dctx)
        ctx = ctx.reshape(Bm * Lm, nh * hd)
        out = mm(ctx, wo) + t["out_bias"]
        dproj = torch.stack(tb.attention_core_bwd_model(q, k, v, dctx, seg, sm_scale=hd**-0.5,
                                                        stats=stats), 2).reshape(Bm * Lm, -1)
    x2, g2 = x.reshape(Bm * Lm, Hm), g.reshape(Bm * Lm, Hm)
    return [out.reshape(Bm, Lm, Hm), mm(dproj, wqkv.t()).reshape(Bm, Lm, Hm),
            mm(x2.t(), dproj).reshape(t["qkv_kernel"].shape), dproj.sum(0).reshape(3, nh, hd),
            mm(ctx.t(), g2).reshape(t["out_kernel"].shape), g2.sum(0)]


def test_attention_models_on_the_tf32x3_model_match_jax_kernel_vjp():
    """Row 10's float32 rounding models (attention_rows_model,
    attention_core_bwd_model), their products on the 3xTF32 model, assembled
    into the block with its projections on the same model: the output and
    its VJP against JAX's attention_block_train (interpret mode, rate 0),
    within MODEL_BLOCK_RTOL of each output's largest magnitude."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_blocks import attention_block_train as jax_attention

    inp = _attention_inputs(B, L, H, NH, seed=51, w_scale=H**-0.5)
    seg, seed = jnp.asarray(inp["segment_ids"]), jnp.zeros((1,), jnp.int32)
    out, vjp = jax.vjp(lambda h, *w: jax_attention(h, seg, *w, seed, HD**-0.5, dropout_rate=0.0,
                                                   interpret=True),
                       *(jnp.asarray(inp[k]) for k in ATT_ARGS))
    want = [out, *vjp(jnp.asarray(inp["cotangent"]))]
    got = _model_block(inp)
    for name, g, w in zip(("out",) + ATT_ARGS, got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w.reshape(g.shape)).max() / np.abs(w).max()
        assert err <= MODEL_BLOCK_RTOL, (name, err)


def _f32_core_case(Bm=2, Lm=256, Hm=256, nh=4, rate=0.1, seed=53):
    """float32 leaves of row 10 at rate ``rate`` with its keep mask."""
    inp = _attention_inputs(Bm, Lm, Hm, nh, seed=seed, w_scale=Hm**-0.5)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    keep = tb.dropout_keep_mask(torch.tensor([seed], dtype=torch.int32), Bm, nh, Lm, rate)
    return t, keep


@pytest.mark.parametrize("gate", ["rows", "dproj", "forward", "gradients"])
def test_float32_core_gates_reject_plain_tf32(gate):
    """Each float32 gate of row 10 in chip_smoke.py, fed outputs whose core
    products are exact float32 (they differ from the 3xTF32 model by float32
    rounding, as the kernels' sums do), passes them and rejects
    chip_smoke.F32_CORE_FAULT, plain TF32 in the rounding model's core
    products: the rows kernel's ctx and statistics (ROWS_TOL), the gradient
    kernels' dproj (F32_BWD_CORE_TOL), the forward (F32_FWD_TOL) and the
    block's output and gradients against autograd of its plain version
    (F32_TOL, the fault taken through the backward's products too). Each
    check raises where it accepts a fault."""
    t, keep = _f32_core_case()
    Bm, Lm, Hm = t["hidden"].shape
    nh, hd = t["qkv_kernel"].shape[2:]
    sm, rate = hd**-0.5, 0.1
    q, k, v, dctx = (torch.randn(Bm, nh, Lm, hd, generator=torch.Generator().manual_seed(i))
                     for i in range(4))
    dctx = dctx.transpose(1, 2).contiguous()
    seg = t["segment_ids"]
    if gate == "rows":
        model = lambda: tb.attention_rows_model(q, k, v, seg, sm_scale=sm, dctx=dctx,
                                                dropout_rate=rate, keep=keep)
        gated = chip_smoke.check_rows("attn_rows float32", "attn_rows", model(), model, f32=True)
        assert set(gated["faults"]) == {chip_smoke.ROWS_FAULTS[1], chip_smoke.F32_CORE_FAULT}
    elif gate == "dproj":
        model = lambda: torch.stack(tb.attention_core_bwd_model(
            q, k, v, dctx, seg, sm_scale=sm, dropout_rate=rate, keep=keep), 2).reshape(Bm * Lm, -1)
        gated = chip_smoke.check_f32_backward_cores("attention_train_bwd", model(), model, nh * hd)
        assert gated["reading"] <= F32_CORE_TOL[0] and len(gated["faults"]) == 2
    else:
        args = [t[n] for n in ATT_ARGS]
        plain = lambda h, *w: tb.attention_train_plain(h, seg, *w, sm_scale=sm,
                                                       dropout_rate=rate, keep=keep)
        if gate == "forward":
            gated = chip_smoke.check_f32_forward(
                "attention_train_fwd", {"out": plain(*args)}, lambda: {"out": plain(*args)},
                core=True)
            assert gated["core_fault_excess"] > 1
        else:
            def run(patches):
                leaves = [a.detach().requires_grad_() for a in args]
                with chip_smoke.planted(patches):
                    out = plain(*leaves)
                    return [out, *torch.autograd.grad(out, leaves, t["cotangent"])]

            got = run([])
            gated = chip_smoke.f32_tol_fault(
                got, run(chip_smoke.core_products(chip_smoke.plain_tf32)), ("out",) + ATT_ARGS,
                "attention_train")
            assert min(gated.values()) > 1
            honest = run(chip_smoke.core_products(chip_smoke.tf32x3_model))
            for g, w, lim in zip(honest, got, [1e-4] + [2e-4] * 5):
                assert ((g - w).abs().max() / w.abs().max()).item() <= lim


def test_float32_core_gate_limits_match_chip_smoke():
    """The card tests and chip_smoke.py hold row 10's float32 cores to the
    same limits."""
    assert chip_smoke.F32_BWD_CORE_TOL == F32_CORE_TOL
    assert chip_smoke.F32_TOL["attention_train_bwd"] == CARD_TOL["attention"][torch.float32]


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


def _bf16_mlp(M, Hc, I, device, seed, dtype=torch.bfloat16):
    t = {k: torch.from_numpy(v).to(device) for k, v in _mlp_inputs(M, Hc, I, seed=seed).items()}
    for k in ("x", "w1", "w2", "cotangent"):
        t[k] = t[k].to(dtype)
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


def _bf16_attention(Bc, Lc, Hc, nh, hd, device, seed, dtype=torch.bfloat16):
    """Inputs of attention_train_bwd with any H beside nh heads of hd."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
    HN, dt = nh * hd, dtype
    t = dict(hidden=f(Bc, Lc, Hc).to(dt), seg=torch.from_numpy(_segments(Bc, Lc, seed)),
             wqkv=f(Hc, 3 * HN, scale=Hc**-0.5).to(dt), bqkv=f(3 * HN, scale=0.1),
             wo=f(HN, Hc, scale=HN**-0.5).to(dt), g=f(Bc, Lc, Hc).to(dt),
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
    gradient from the same pass) against weight_grad_plain: bf16 within the
    bf16 backward products' limit, float32 (the 3xTF32 tile) within
    chip_smoke.F32_BWD_GEMM_TOL."""
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(M, Hin, generator=g, device=cuda).to(dtype)
    dy = torch.randn(M, N, generator=g, device=cuda).to(dtype)
    n = tb.weight_grad.launches
    dw, db = tb.weight_grad(x, dy, splits=splits)
    torch.cuda.synchronize()
    assert tb.weight_grad.launches == n + 1
    want = dict(zip(("dw", "db"), tb.weight_grad_plain(x, dy)))
    if dtype == torch.float32:
        readings = chip_smoke.f32_gemm_readings({"dw": dw, "db": db}, want)
        assert all(chip_smoke.f32_gemm_excess(r) <= 1 for r in readings.values()), readings
        return
    readings = chip_smoke.backward_gemm_readings({"dw": dw, "db": db}, want)
    assert max(readings.values()) <= chip_smoke.BWD_GEMM_TOL["mlp_train_bwd"], readings


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", [(70, 67, 131), (129, 130, 33), (200, 68, 3), (1000, 768, 3072),
                                   (300, 2304, 4608)])
@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gate"])
def test_transposed_weight_tile_matches_tf32x3_model_on_card(cuda, M, N, K, gated):
    """The float32 backwards' product with a weight read transposed alone
    (train_blocks.forward_tile's "gemm_t" on the 3xTF32 tile; the MLP's act' gate
    multiplied in) against the 3xTF32 model of the same product at ragged M,
    N and K (4-byte copies where K is odd), within chip_smoke.F32_BWD_GEMM_TOL;
    the plain-TF32 model lies beyond it."""
    from spokennlp_tpu_torch.ops.cuda.int8_matmul import tf32x3_product

    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = torch.randn(M, K, generator=g, device=cuda)
    w = torch.randn(N, K, generator=g, device=cuda)
    gate = torch.rand(M, N, generator=g, device=cuda) if gated else None
    n = tb.forward_tile.launches
    got = tb.forward_tile(a, w, kernel="gemm_t", gate=gate)
    torch.cuda.synchronize()
    assert tb.forward_tile.launches == n + 1
    scale = lambda t: t if gate is None else t * gate
    want = {"out": scale(tf32x3_product(a, w.t()))}
    reading = chip_smoke.f32_gemm_readings({"out": got}, want)["out"]
    assert chip_smoke.f32_gemm_excess(reading) <= 1, reading
    bad = chip_smoke.f32_gemm_readings({"out": scale(tf32x3_product(a, w.t(), terms=1))},
                                       {"out": scale(a @ w.t())})["out"]
    assert chip_smoke.f32_gemm_excess(bad) > 1, bad


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", [(70, 67, 131), (129, 130, 33), (200, 68, 3), (1000, 768, 3072),
                                   (300, 2304, 4608)])
@pytest.mark.parametrize("part", ["gemm", "gemm_gate", "residual", "residual_ln"])
def test_forward_tiles_match_tf32x3_model_on_card(cuda, M, N, K, part):
    """Each float32 forward tile function alone (train_blocks.forward_tile on
    the 3xTF32 tile: the GEMM with bias and activation, with the act' gate
    multiplied in; the residual-LayerNorm row block with and without its
    LayerNorm) against the 3xTF32 model of the same arithmetic at ragged M,
    N and K (4-byte copies where K or N is odd), within
    chip_smoke.F32_FWD_TOL; the plain-TF32 model lies beyond it."""
    import torch.nn.functional as F

    from spokennlp_tpu_torch.ops.cuda.int8_matmul import tf32x3_product

    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = torch.randn(M, K, generator=g, device=cuda)
    w = torch.randn(K, N, generator=g, device=cuda) * K**-0.5
    bias = torch.randn(N, generator=g, device=cuda) * 0.1
    kw, epilogue = {}, lambda y: y + bias
    if part == "gemm_gate":
        kw = dict(gate=torch.rand(M, N, generator=g, device=cuda), activation="gelu")
        epilogue = lambda y: F.gelu(y + bias, approximate="tanh") * kw["gate"]
    elif part.startswith("residual"):
        resid = torch.randn(M, N, generator=g, device=cuda)
        ln = (1 + 0.1 * torch.randn(N, generator=g, device=cuda),
              0.1 * torch.randn(N, generator=g, device=cuda))
        kw = dict(kernel="residual_ln")
        if part == "residual_ln":
            kw.update(resid=resid, ln=ln)
            epilogue = lambda y: F.layer_norm(y + bias + resid, (N,), *ln, eps=1e-12)
    n = tb.forward_tile.launches
    got = tb.forward_tile(a, w, bias, **kw)
    torch.cuda.synchronize()
    assert tb.forward_tile.launches == n + 1
    reading = chip_smoke.f32_gemm_readings({"out": got}, {"out": epilogue(tf32x3_product(a, w))})
    assert chip_smoke.f32_gemm_excess(reading["out"], chip_smoke.F32_FWD_TOL) <= 1, reading
    bad = chip_smoke.f32_gemm_readings({"out": epilogue(tf32x3_product(a, w, terms=1))},
                                       {"out": epilogue(a @ w)})
    assert chip_smoke.f32_gemm_excess(bad["out"], chip_smoke.F32_FWD_TOL) > 1, bad


@pytest.mark.gpu
@pytest.mark.parametrize("M,heads,hd,K", [(70, 2, 11, 131), (129, 3, 7, 33), (1000, 12, 64, 768),
                                          (513, 4, 32, 768)])
def test_qkv_projection_tile_matches_tf32x3_model_on_card(cuda, M, heads, hd, K):
    """The float32 q/k/v projection tile alone (its scatter to (3, 1, nh, M,
    hd), q scaled; odd head dims store element by element) against the
    3xTF32 model, within chip_smoke.F32_FWD_TOL."""
    from spokennlp_tpu_torch.ops.cuda.int8_matmul import tf32x3_product

    N = 3 * heads * hd
    g = torch.Generator(device=cuda).manual_seed(M + K)
    a = torch.randn(M, K, generator=g, device=cuda)
    w = torch.randn(K, N, generator=g, device=cuda) * K**-0.5
    bias = torch.randn(N, generator=g, device=cuda) * 0.1
    got = tb.forward_tile(a, w, bias, kernel="qkv", heads=heads, sm_scale=hd**-0.5)
    want = tf32x3_product(a, w) + bias
    want[:, :N // 3] *= hd**-0.5
    want = want.reshape(M, 3, heads, hd).permute(1, 2, 0, 3)[:, None]
    reading = chip_smoke.f32_gemm_readings({"qkv": got}, {"qkv": want})["qkv"]
    assert chip_smoke.f32_gemm_excess(reading, chip_smoke.F32_FWD_TOL) <= 1, reading


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["attention", "mlp", "sliding", "bigbird"])
def test_float32_backward_recomputes_the_forwards_products_on_card(cuda, kernel):
    """Each float32 training backward (rows 10-13) recomputes its forward's
    products on the forward's kernels and tiles: the backward's q, k, v (and
    Longformer's global k, v; the MLP's h) equal the forward's bit for bit,
    so it differentiates the forward's own values."""
    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import bigbird_block, sliding_block
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    g = torch.Generator(device=cuda).manual_seed(17)
    randn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    seed = torch.tensor([9], dtype=torch.int32, device=cuda)
    fb, bb = {}, {}
    if kernel == "mlp":
        x, cot = randn(1000, 768), randn(1000, 768)
        w1, b1, w2, b2 = randn(768, 3072) * 0.036, randn(3072) * 0.02, randn(3072, 768) * 0.018, \
            randn(768) * 0.02
        tb.mlp_train_fwd(x, w1, b1, w2, b2, activation="gelu", buffers=fb)
        tb.mlp_train_bwd(x, w1, b1, w2, cot, activation="gelu", buffers=bb)
        keys = ("h",)
    elif kernel == "attention":
        Bk, Lk = 3, 200
        hidden, cot = randn(Bk, Lk, 256), randn(Bk, Lk, 256)
        seg = torch.ones(Bk, Lk, dtype=torch.int32, device=cuda)
        seg[1, 150:] = 0
        wqkv, bqkv = randn(256, 768) * 0.06, randn(768) * 0.02
        wo, bo = randn(256, 256) * 0.06, randn(256) * 0.02
        kw = dict(num_heads=4, sm_scale=0.125, dropout_rate=0.1)
        tb.attention_train_fwd(hidden, seg, seed, wqkv, bqkv, wo, bo, **kw, buffers=fb)
        tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, cot, **kw, buffers=bb)
        keys = ("qkv",)
    else:
        Lk = 1024
        hidden, cot = randn(2, Lk, 768), randn(2, Lk, 768)
        mask = (torch.arange(Lk, device=cuda)[None] < torch.tensor([[Lk], [700]],
                                                                    device=cuda)).int()
        p = [randn(768, 3, 12, 64) * 0.036, randn(3, 12, 64) * 0.02, randn(12, 64, 768) * 0.036]
        kw = dict(num_heads=12, sm_scale=0.125, dropout_rate=0.1)
        if kernel == "sliding":
            glob = torch.zeros_like(mask)
            glob[:, 0] = 1
            w = sliding_block.card_weights(p[0], p[1], p[0], p[1], p[2], torch.float32)
            lk = dict(kw, window=256, max_globals=16, global_rows=True)
            ts.sliding_train_fwd(hidden, mask, glob, seed, w, randn(768) * 0.02, **lk, buffers=fb)
            ts.sliding_train_bwd(hidden, mask, glob, seed, w, cot, **lk, buffers=bb)
            keys = ("qkv", "gkv")
        else:
            w = bigbird_block.card_weights(*p, torch.float32)
            tables = bigbird_tables(Lk // 64, 2, 3, 0, cuda)
            tbb.bigbird_train_fwd(hidden, mask, seed, w, randn(768) * 0.02, tables,
                                  block_size=64, **kw, buffers=fb)
            tbb.bigbird_train_bwd(hidden, mask, seed, w, cot, tables, block_size=64, **kw,
                                  buffers=bb)
            keys = ("qkv",)
    torch.cuda.synchronize()
    for k in keys:
        assert torch.equal(fb[k], bb[k]), k


def _long_backward(kernel, device, dtype=torch.bfloat16):
    """A call of the Longformer or BigBird backward kernel at the training
    shape (B=2, L=2048, BERT-base widths, dropout 0.1)."""
    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import bigbird_block, sliding_block
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    g = torch.Generator(device=device).manual_seed(5)
    randn = lambda *s: torch.randn(*s, generator=g, device=device)
    dt, Lc = dtype, 2048
    hidden, cot = randn(2, Lc, 768).to(dt), randn(2, Lc, 768).to(dt)
    mask = (torch.arange(Lc, device=device)[None] < torch.tensor([[Lc], [1500]],
                                                                   device=device)).int()
    seed = torch.tensor([9], dtype=torch.int32, device=device)
    p = [randn(768, 3, 12, 64) * 0.036, randn(3, 12, 64) * 0.02, randn(12, 64, 768) * 0.036]
    kw = dict(num_heads=12, sm_scale=0.125, dropout_rate=0.1)
    if kernel == "sliding_train_bwd":
        glob = torch.zeros_like(mask)
        glob[:, 0] = 1
        w = sliding_block.card_weights(p[0], p[1], p[0], p[1], p[2], dt)
        return lambda: ts.sliding_train_bwd(hidden, mask, glob, seed, w, cot, window=512,
                                            max_globals=16, global_rows=True, **kw)[1:]
    w = bigbird_block.card_weights(*p, dt)
    tables = bigbird_tables(Lc // 64, 2, 3, 0, device)
    return lambda: tbb.bigbird_train_bwd(hidden, mask, seed, w, cot, tables, block_size=64,
                                         **kw)[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["mlp_train_bwd", "attention_train_bwd", "sliding_train_bwd",
                                    "bigbird_train_bwd", "weight_grad"])
def test_bf16_weight_gradients_repeat_bit_for_bit_on_card(cuda, kernel, dtype):
    """Each weight gradient, bf16 and float32 (the rows split into ranges,
    summed in order; in float32 on the 3xTF32 tile) gives the same bits on a
    second run, at the main paths' shapes."""
    if kernel in ("sliding_train_bwd", "bigbird_train_bwd"):
        run = _long_backward(kernel, cuda, dtype)
    elif kernel == "mlp_train_bwd":
        t = _bf16_mlp(32 * 512, 768, 3072, cuda, seed=3, dtype=dtype)
        run = lambda: list(_mlp_bwd(tb.mlp_train_bwd, t).values())[1:]
    elif kernel == "attention_train_bwd":
        t = _bf16_attention(32, 512, 768, 12, 64, cuda, seed=3, dtype=dtype)
        run = lambda: tb.attention_train_bwd(
            t["hidden"], t["seg"], t["seed"], t["wqkv"], t["bqkv"], t["wo"], t["g"],
            num_heads=12, sm_scale=0.125, dropout_rate=0.1)[1:]
    else:
        g = torch.Generator(device=cuda).manual_seed(3)
        x, dy = (torch.randn(32 * 512, n, generator=g, device=cuda).to(dtype)
                 for n in (768, 768))
        run = lambda: tb.weight_grad(x, dy)
    first = run()
    assert all(torch.equal(a, b) for a, b in zip(first, run()))


# (B, L, H, heads): L not a multiple of the 64-row tile, head dims 64, 32,
# 128 and 16, and the main path's shape (every L above 64, so that the
# planted fault's dropped key tile, keys 64-127 of rows 64-127, exists)
DENSE_CARD_SHAPES = [(4, 200, 256, 4), (2, 130, 256, 8), (2, 96, 256, 2), (3, 80, 64, 4),
                     (2, 512, 768, 12)]


def _dense_backward(cuda, Bc, Lc, Hc, nh, rate, seed, dtype=torch.bfloat16):
    """bf16 (or ``dtype``) inputs of the attention block on the card, a
    backward's intermediates (``attention_train_bwd``'s buffers), the keep
    mask and the seed."""
    hd = Hc // nh
    inp = _attention_inputs(Bc, Lc, Hc, nh, seed=seed, w_scale=Hc**-0.5)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in inp.items()}
    bf = dtype
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


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fwd", "stats"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Bc,Lc,Hc,nh", DENSE_CARD_SHAPES)
def test_float32_attention_rows_kernel_matches_tf32x3_model_on_card(cuda, mode, rate, Bc, Lc,
                                                                     Hc, nh):
    """float32 (3xTF32): attn_rows_kernel alone on the q, k, v and dctx of a
    backward of the block against attention_rows_model on the 3xTF32 model
    within chip_smoke.ROWS_TOL (check_rows, which also fails where the model
    with its key tile dropped or with F32_CORE_FAULT passes); the
    statistics pass equals the backward's own
    statistics and ctx; two runs give the same bits."""
    hd = Hc // nh
    _, bufs, _, keep, seed = _dense_backward(cuda, Bc, Lc, Hc, nh, rate, Lc + 5, torch.float32)
    qkv, seg = bufs["qkv"], bufs["seg"]
    dctx = bufs["dctx"].reshape(Bc, Lc, Hc) if mode == "stats" else None
    runs = [tb.attention_rows(qkv, seg, seed, sm_scale=hd**-0.5, dctx=dctx, dropout_rate=rate)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(*runs))
    if mode == "stats":
        assert torch.equal(runs[0][1], bufs["stats"])
        assert torch.equal(runs[0][0].reshape(Bc * Lc, Hc), bufs["ctx"])
    model = lambda: tb.attention_rows_model(
        qkv[0], qkv[1], qkv[2], seg, sm_scale=hd**-0.5, dropout_rate=rate, keep=keep,
        dctx=None if dctx is None else dctx.reshape(Bc, Lc, nh, hd))
    got = runs[0] if dctx is not None else (runs[0][0], None)
    wanted = (lambda: model()) if dctx is not None else (lambda: (model()[0], None))
    chip_smoke.check_rows(f"attn_rows float32 {Bc}x{Lc} {mode} rate {rate}", "attn_rows", got,
                          wanted, f32=True)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Bc,Lc,Hc,nh", DENSE_CARD_SHAPES)
def test_float32_attention_gradient_kernels_match_tf32x3_model_on_card(cuda, rate, Bc, Lc, Hc,
                                                                        nh):
    """float32 (3xTF32): the gradient kernels' dproj against
    attention_core_model_dproj on the 3xTF32 model within
    chip_smoke.F32_BWD_CORE_TOL in each slot (check_f32_backward_cores,
    which also fails where F32_CORE_FAULT or the dropped key tile passes);
    two runs give the same bits; attn_dkv then attn_dq launched alone
    (tb.attention_grad, float32 dS tiles) give the backward's dproj."""
    hd = Hc // nh
    args, bufs, _, keep, seed = _dense_backward(cuda, Bc, Lc, Hc, nh, rate, Lc + 9, torch.float32)
    again = {}
    tb.attention_train_bwd(*args, num_heads=nh, sm_scale=hd**-0.5, dropout_rate=rate,
                           buffers=again)
    assert torch.equal(bufs["dproj"], again["dproj"])
    kw = dict(sm_scale=hd**-0.5, dropout_rate=rate)
    dctx = bufs["dctx"].reshape(Bc, Lc, Hc)
    out = tb.attention_grad(bufs["qkv"], bufs["seg"], seed, dctx, bufs["stats"], which=1, **kw)
    alone, ds = tb.attention_grad(bufs["qkv"], bufs["seg"], seed, dctx, bufs["stats"], which=2,
                                  out=out, **kw)
    assert ds.dtype == torch.float32 and ds.numel() == tb.dense_ds_elements(Bc, nh, Lc)
    assert torch.equal(alone, bufs["dproj"])
    model = lambda: tb.attention_core_model_dproj(bufs, keep=keep, **kw)
    chip_smoke.check_f32_backward_cores("attention_train_bwd", bufs["dproj"], model, Hc)
