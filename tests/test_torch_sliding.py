"""Port Longformer attention: ``ops/sliding_attention.py``, the plain versions
of the sliding-window inference block and training block against the JAX
package's Pallas kernels (interpret mode) on the CPU, the Philox keep masks
of the three probability sets, and the CUDA kernels against the plain
versions on the card (``-m gpu``). JAX is imported inside the CPU tests only.

Tolerances: float32 to 1e-4 (the same math summed in another order),
gradients to 1e-3 of their largest magnitude; bfloat16, where the JAX kernel
rounds q, k, v, the probabilities and ctx to bf16 (unit roundoff 2^-9) and
the plain version stays in float32, to 3e-2 of the largest output. Only real
rows are compared: a padding row with no allowed key is defined differently
(the kernels give it a zero context).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.ops import sliding_attention as sa
from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

F32_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_RTOL = 1e-3
BF16_RTOL = 3e-2
# card: largest |kernel - plain| over the largest |plain| of each output;
# bf16 as for the dense training kernels (tests/test_torch_train_blocks.py),
# float32 from the H100 readings of kernels 7 and 12 in chip_smoke.py
# (PERF.md: 2.5e-7 to 6.0e-6), about ten times the largest
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the backward products' card limit)

B, L, H, NH, WINDOW = 2, 32, 32, 2, 16
HD = H // NH
ARGS = ("hidden", "qkv_kernel", "qkv_bias", "gqkv_kernel", "gqkv_bias", "out_kernel", "out_bias")


def _masks(B, L, seed, n_globals=(1, 2), global_rows=True):
    """Suffix padding (row 0 full, the others cut at 40-90 %) and a prefix of
    globals per row (none without global rows)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, L), np.int32)
    glob = np.zeros((B, L), np.int32)
    for b in range(B):
        mask[b, : L if b == 0 else int(rng.integers(int(0.4 * L), int(0.9 * L)))] = 1
        if global_rows:
            glob[b, : n_globals[b % len(n_globals)]] = 1
    return mask, glob


def _inputs(B, L, H, nh, seed, global_rows=True, w_scale=None):
    hd = H // nh
    rng = np.random.default_rng(seed)
    w_scale = w_scale or H**-0.5
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    mask, glob = _masks(B, L, seed, global_rows=global_rows)
    return dict(
        hidden=f(B, L, H), attention_mask=mask, global_mask=glob,
        qkv_kernel=f(H, 3, nh, hd, scale=w_scale), qkv_bias=f(3, nh, hd, scale=0.1),
        gqkv_kernel=f(H, 3, nh, hd, scale=w_scale), gqkv_bias=f(3, nh, hd, scale=0.1),
        out_kernel=f(nh, hd, H, scale=w_scale), out_bias=f(H, scale=0.1),
        ln_scale=1 + f(H, scale=0.1), ln_bias=f(H, scale=0.1),
        cotangent=f(B, L, H) * mask[:, :, None],
    )


def _normalized(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------ ops/sliding_attention


@pytest.mark.parametrize("globals_,padded", [(True, True), (False, True), (True, False)])
def test_sliding_attention_ops_match_jax(globals_, padded):
    import jax.numpy as jnp

    from spokennlp_tpu.ops import sliding_attention as jsa

    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(B, L, NH, HD)).astype(np.float32) for _ in range(3))
    mask, glob = _masks(B, L, 3)
    if not padded:
        mask[:] = 1
    glob = glob if globals_ else None
    jg = None if glob is None else jnp.asarray(glob)
    want = jsa.sliding_window_attention_mask_bias(jnp.asarray(mask), WINDOW, jg)
    got = sa.sliding_window_attention_mask_bias(
        torch.from_numpy(mask), WINDOW, None if glob is None else torch.from_numpy(glob))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jsa.chunked_sliding_window_attention(*map(jnp.asarray, (q, k, v, mask)), jg, WINDOW,
                                                max_globals=4)
    got = sa.chunked_sliding_window_attention(
        *map(torch.from_numpy, (q, k, v, mask)), None if glob is None else torch.from_numpy(glob),
        WINDOW, max_globals=4)
    live = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], **F32_TOL)


# --------------------------------------------------- kernel 7: plain vs JAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
@pytest.mark.parametrize("fuse_ln", [True, False], ids=["ln", "no_ln"])
def test_sliding_block_plain_matches_jax_kernel(dtype, global_rows, fuse_ln):
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.sliding_block import fused_sliding_attention_block as jax_block

    inp = _inputs(B, L, H, NH, seed=5, global_rows=global_rows)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ln = ({"ln_scale": inp["ln_scale"], "ln_bias": inp["ln_bias"]} if fuse_ln else {})
    kw = dict(sm_scale=HD**-0.5, window=WINDOW, max_globals=16, global_rows=global_rows)
    j = {k: jnp.asarray(inp[k]) for k in ARGS[1:]}
    want = jax_block(jnp.asarray(inp["hidden"]).astype(jdt), jnp.asarray(inp["attention_mask"]),
                     jnp.asarray(inp["global_mask"]), **j, interpret=True,
                     **{k: jnp.asarray(v) for k, v in ln.items()}, **kw)
    t = {k: torch.from_numpy(inp[k]) for k in ARGS[1:]}
    for k in ("qkv_kernel", "gqkv_kernel", "out_kernel"):  # the weights the kernel reads
        t[k] = t[k].to(tdt)
    got = sb.fused_sliding_attention_block(
        torch.from_numpy(inp["hidden"]).to(tdt), torch.from_numpy(inp["attention_mask"]),
        torch.from_numpy(inp["global_mask"]), **t,
        **{k: torch.from_numpy(v) for k, v in ln.items()}, **kw)
    live = inp["attention_mask"].astype(bool)
    got, want = got.float().numpy()[live], np.asarray(want.astype(jnp.float32))[live]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert _normalized(got, want) < BF16_RTOL


# -------------------------------------------------- kernel 12: plain vs JAX


@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
def test_sliding_train_plain_and_grads_match_jax_kernel(global_rows):
    """Rate 0: the output and all seven gradients (dx, dWqkv, dbqkv, dWg,
    dbg, dWo, dbo)."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_sliding import sliding_attention_block_train as jax_train

    inp = _inputs(B, L, H, NH, seed=6, global_rows=global_rows)
    mask, glob = jnp.asarray(inp["attention_mask"]), jnp.asarray(inp["global_mask"])
    cot = jnp.asarray(inp["cotangent"])
    kw = dict(window=WINDOW, max_globals=16, global_rows=global_rows)

    def f(hidden, *params):
        o = jax_train(hidden, mask, glob, *params, jnp.zeros((1,), jnp.int32), HD**-0.5,
                      dropout_rate=0.0, interpret=True, **kw)
        return jnp.sum(o * cot), o

    (_, want), want_grads = jax.value_and_grad(f, argnums=tuple(range(7)), has_aux=True)(
        *(jnp.asarray(inp[k]) for k in ARGS))
    ts_ = {k: torch.from_numpy(inp[k]).requires_grad_(k in ARGS) for k in inp}
    out = ts.sliding_attention_block_train(
        ts_["hidden"], ts_["attention_mask"], ts_["global_mask"], *(ts_[k] for k in ARGS[1:]),
        torch.zeros(1, dtype=torch.int32), sm_scale=HD**-0.5, **kw)
    (out * ts_["cotangent"]).sum().backward()
    live = inp["attention_mask"].astype(bool)
    np.testing.assert_allclose(out.detach().numpy()[live], np.asarray(want)[live], **F32_TOL)
    for name, w in zip(ARGS, want_grads):
        w = np.asarray(w)
        g = ts_[name].grad  # None where the plain version does not read the parameter
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max() + 1e-12, err_msg=name)


def _explicit_backward(inp, global_rows, rate=0.0, keep=None):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return [g.numpy() for g in ts.sliding_train_bwd_plain(
        t["hidden"], t["attention_mask"], t["global_mask"], *(t[k] for k in ARGS[1:6]),
        t["cotangent"], sm_scale=HD**-0.5, window=WINDOW, max_globals=16,
        global_rows=global_rows, dropout_rate=rate, keep=keep)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
def test_sliding_explicit_backward_matches_autograd_of_plain(global_rows, rate):
    """The backward kernel's explicit plain version in float32 against
    autograd of sliding_train_plain: to 1e-5 of each gradient's largest
    magnitude."""
    inp = _inputs(B, L, H, NH, seed=8, global_rows=global_rows)
    seed = torch.tensor([5], dtype=torch.int32)
    keep = (ts.sliding_keep_masks(seed, B, NH, L, WINDOW, sb.global_columns(16, L), rate)
            if rate else None)
    t = {k: torch.from_numpy(v).requires_grad_(k in ARGS) for k, v in inp.items()}
    out = ts.sliding_train_plain(t["hidden"], t["attention_mask"], t["global_mask"],
                                 *(t[k] for k in ARGS[1:]), sm_scale=HD**-0.5, window=WINDOW,
                                 global_rows=global_rows, dropout_rate=rate, keep=keep)
    want = torch.autograd.grad(out, [t[k] for k in ARGS], t["cotangent"], allow_unused=True)
    got = _explicit_backward(inp, global_rows, rate, keep)
    for name, g, w in zip(ARGS, got, want):
        w = np.zeros_like(g) if w is None else w.numpy().reshape(g.shape)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
def test_sliding_explicit_backward_matches_jax_kernel_vjp(global_rows):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_sliding import sliding_attention_block_train as jax_train

    inp = _inputs(B, L, H, NH, seed=9, global_rows=global_rows)
    mask, glob = jnp.asarray(inp["attention_mask"]), jnp.asarray(inp["global_mask"])
    _, vjp = jax.vjp(
        lambda h, *p: jax_train(h, mask, glob, *p, jnp.zeros((1,), jnp.int32), HD**-0.5,
                                dropout_rate=0.0, interpret=True, window=WINDOW, max_globals=16,
                                global_rows=global_rows),
        *(jnp.asarray(inp[k]) for k in ARGS))
    want = vjp(jnp.asarray(inp["cotangent"]))
    for name, g, w in zip(ARGS, _explicit_backward(inp, global_rows), want):
        w = np.asarray(w).reshape(g.shape)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max() + 1e-12, err_msg=name)


@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
def test_train_forward_on_the_tf32x3_model_matches_jax_kernel(global_rows):
    """Row 12's plain forward with its products through the 3xTF32 model
    (chip_smoke.float_products: the projections and the out projection; the
    global query stays exact, as the global-rows kernel sums it on the CUDA
    cores), as the card's float32 forward takes them, against JAX's
    training kernel (interpret mode) in float32: to 1e-5 of the output's
    largest magnitude on the real rows."""
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_sliding import sliding_attention_block_train as jax_train

    inp = _inputs(B, L, H, NH, seed=11, global_rows=global_rows)
    mask, glob = jnp.asarray(inp["attention_mask"]), jnp.asarray(inp["global_mask"])
    kw = dict(window=WINDOW, max_globals=16, global_rows=global_rows)
    want = jax_train(jnp.asarray(inp["hidden"]), mask, glob,
                     *(jnp.asarray(inp[k]) for k in ARGS[1:]), jnp.zeros((1,), jnp.int32),
                     HD**-0.5, dropout_rate=0.0, interpret=True, **kw)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    with chip_smoke.planted(chip_smoke.float_products(chip_smoke.tf32x3_model)):
        got = ts.sliding_train_plain(t["hidden"], t["attention_mask"], t["global_mask"],
                                     *(t[k] for k in ARGS[1:]), sm_scale=HD**-0.5, **kw)
    live = inp["attention_mask"].astype(bool)
    assert _normalized(got.numpy()[live], np.asarray(want)[live]) <= 1e-5


@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
def test_explicit_backward_on_the_tf32x3_model_matches_jax_kernel_vjp(global_rows):
    """Row 12's explicit plain backward with every product through the 3xTF32
    model (int8_matmul.tf32x3_product, as the card's float32 backward takes
    its products) against the VJP of JAX's training kernel (interpret mode)
    in float32: to 1e-5 of each gradient's largest magnitude, as the float32
    explicit backward against autograd."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_sliding import sliding_attention_block_train as jax_train
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.ops.cuda.int8_matmul import tf32x3_product

    inp = _inputs(B, L, H, NH, seed=10, global_rows=global_rows)
    mask, glob = jnp.asarray(inp["attention_mask"]), jnp.asarray(inp["global_mask"])
    _, vjp = jax.vjp(
        lambda h, *p: jax_train(h, mask, glob, *p, jnp.zeros((1,), jnp.int32), HD**-0.5,
                                dropout_rate=0.0, interpret=True, window=WINDOW, max_globals=16,
                                global_rows=global_rows),
        *(jnp.asarray(inp[k]) for k in ARGS))
    want = vjp(jnp.asarray(inp["cotangent"]))
    model = [(tb, "backward_product", None, lambda real, a, b: tf32x3_product(a, b))]
    with chip_smoke.planted(model):
        got = _explicit_backward(inp, global_rows)
    for name, g, w in zip(ARGS, got, want):
        w = np.asarray(w).reshape(g.shape)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


# ------------------------------------- the gradient kernels' rounding model


def _core_leaves(B, L, nh, hd, seed, n_valid):
    """q, k, v, qg, kg, vg (B, L, nh, hd) float32 leaves and dctx, zero on
    padding rows (as g Wo^T of a masked cotangent)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    leaves = [f(B, L, nh, hd).requires_grad_() for _ in range(6)]
    real = (torch.arange(L)[None] < n_valid[:, None])[..., None, None]
    return leaves, f(B, L, nh, hd) * real


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
def test_core_bwd_model_matches_autograd_in_float32(global_rows, rate):
    """sliding_core_bwd_model in float32, where its roundings are exact and
    the statistics are its own, against autograd of sliding_attend: every
    gradient of q, k, v (and qg, kg, vg) to 1e-5 of its largest magnitude."""
    Bm, Lm, nh, hd, window = 2, 64, 2, 16, 32
    G, sm = sb.global_columns(16, Lm), hd**-0.5
    n_valid = torch.tensor([Lm, 40])
    n_glob = torch.tensor([1, 2]) if global_rows else torch.zeros(2, dtype=torch.long)
    (q, k, v, qg, kg, vg), dctx = _core_leaves(Bm, Lm, nh, hd, 21, n_valid)
    keep = (ts.sliding_keep_masks(torch.tensor([5], dtype=torch.int32), Bm, nh, Lm, window, G,
                                  rate) if rate else None)
    glob_qkv = (qg[:, :G] * sm, kg, vg) if global_rows else None
    ctx = sb.sliding_attend(q * sm, k, v, glob_qkv, n_valid, n_glob, window=window, G=G,
                            dropout_rate=rate, keep=keep)
    leaves = [q, k, v] + ([qg, kg, vg] if global_rows else [])
    want = torch.autograd.grad(ctx, leaves, dctx)
    heads = lambda t: t.detach().transpose(1, 2)
    got = ts.sliding_core_bwd_model(
        heads(q) * sm, heads(k), heads(v),
        (heads(qg)[:, :, :G] * sm, heads(kg), heads(vg)) if global_rows else None, dctx,
        n_valid, n_glob, window=window, sm_scale=sm, dropout_rate=rate, keep=keep)
    assert len(got) == len(want)
    for name, g, w in zip(("dq", "dk", "dv", "dqg", "dkg", "dvg"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * w.abs().max().item(), err_msg=name)


@pytest.mark.parametrize("fault", chip_smoke.BWD_CORE_FAULTS)
def test_core_gate_rejects_the_planted_faults(fault):
    """chip_smoke's limits of the gradient kernels (BWD_CORE_TOL) reject each
    planted fault of the rounding model: in bf16 at L=256, window 64, CLS
    global, rate 0.1, the model with the fault read against the model."""
    Bm, Lm, nh, hd, window = 2, 256, 2, 64, 64
    G, sm = sb.global_columns(16, Lm), hd**-0.5
    n_valid, n_glob = torch.tensor([Lm, 200]), torch.tensor([1, 1])
    (q, k, v, qg, kg, vg), dctx = _core_leaves(Bm, Lm, nh, hd, 23, n_valid)
    heads = lambda t, scale=1.0: (t.detach() * scale).to(torch.bfloat16).transpose(1, 2)
    keep = ts.sliding_keep_masks(torch.tensor([3], dtype=torch.int32), Bm, nh, Lm, window, G, 0.1)
    model = lambda: torch.stack(ts.sliding_core_bwd_model(
        heads(q, sm), heads(k), heads(v), (heads(qg, sm)[:, :, :G], heads(kg), heads(vg)),
        dctx.to(torch.bfloat16), n_valid, n_glob, window=window, sm_scale=sm, dropout_rate=0.1,
        keep=keep), dim=2).reshape(Bm * Lm, -1)
    want = model()
    with chip_smoke.planted(chip_smoke.core_bwd_faults("sliding_train_bwd")[fault]):
        bad = model()
    readings = chip_smoke.core_bwd_readings(want, bad, nh * hd)
    assert chip_smoke.core_bwd_excess(readings, chip_smoke.BWD_CORE_TOL["sliding_train_bwd"]) > 1
    assert chip_smoke.core_bwd_excess(chip_smoke.core_bwd_readings(want, want, nh * hd),
                                      chip_smoke.BWD_CORE_TOL["sliding_train_bwd"]) == 0


# ------------------------------------------ the rows kernels' rounding model


@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
def test_rows_model_matches_jax_kernel_context_in_float32(global_rows):
    """sliding_rows_model (with the global rows over it) in float32 against
    the context of the TPU kernel in interpret mode, read through an
    identity output projection (H = nh hd, zero bias, no LayerNorm): real
    rows to 1e-5 of the largest."""
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.sliding_block import fused_sliding_attention_block as jax_block

    inp = _inputs(B, L, H, NH, seed=41, global_rows=global_rows)
    inp["out_kernel"] = np.eye(H, dtype=np.float32).reshape(NH, HD, H)
    inp["out_bias"] = np.zeros(H, np.float32)
    kw = dict(sm_scale=HD**-0.5, window=WINDOW, max_globals=16, global_rows=global_rows)
    want = jax_block(*(jnp.asarray(inp[k]) for k in ("hidden", "attention_mask", "global_mask")),
                     *(jnp.asarray(inp[k]) for k in ARGS[1:]), interpret=True, **kw)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x, G = t["hidden"], sb.global_columns(16, L)
    proj = lambda w, b: torch.einsum("blh,hnd->bnld", x, w) + b[None, :, None]
    sm = HD**-0.5
    q, k, v = (proj(t["qkv_kernel"][:, i], t["qkv_bias"][i]) for i in range(3))
    gq, gk, gv = (proj(t["gqkv_kernel"][:, i], t["gqkv_bias"][i]) for i in range(3))
    n_valid, n_glob = sb._counts(t["attention_mask"], t["global_mask"], G, global_rows)
    got, _ = ts.sliding_rows_model(q * sm, k, v, (gq[:, :, :G] * sm, gk, gv) if global_rows
                                   else None, n_valid, n_glob, window=WINDOW)
    live = inp["attention_mask"].astype(bool)
    want = np.asarray(want)[live]
    np.testing.assert_allclose(got.reshape(B, L, H).numpy()[live], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_rows_model_statistics_match_autograd_of_plain_softmax(rate):
    """float32: sliding_rows_model's statistics against the plain softmax
    over each local row's allowed keys (band and global columns): m its
    maximum, m + log D its logsumexp, and rowsum(dp p_eff) / (D keep_prob)
    = sum_k p_k dL/dp_k from autograd of ctx = (kept p / keep_prob) . v
    with the cotangent dctx, zero on global rows; to 1e-5 of the largest."""
    Bm, Lm, nh, hd, window = 2, 64, 2, 16, 32
    C, G = window // 2, sb.global_columns(16, Lm)
    n_valid, n_glob = torch.tensor([Lm, 40]), torch.tensor([1, 2])
    (q, k, v, *_), dctx = _core_leaves(Bm, Lm, nh, hd, 43, n_valid)
    q, k, v = (t.detach().transpose(1, 2) for t in (q, k, v))
    keep = (ts.sliding_keep_masks(torch.tensor([8], dtype=torch.int32), Bm, nh, Lm, window, G,
                                  rate) if rate else None)
    _, stats = ts.sliding_rows_model(q, k, v, None, n_valid, n_glob, window=window, dctx=dctx,
                                     dropout_rate=rate, keep=keep)
    for b in range(Bm):
        ng = int(n_glob[b])
        allowed = ts.sliding_model_allowed(Lm, C, int(n_valid[b]), ng, "cpu")
        s = torch.where(allowed, q[b] @ k[b].transpose(-1, -2), -torch.inf)
        p = torch.softmax(s, -1).requires_grad_()
        kept = p if keep is None else torch.where(ts._sliding_dense_keep(keep, b, Lm, C, ng),
                                                  p, 0.0)
        dc = dctx[b].transpose(0, 1).clone()
        dc[:, :ng] = 0.0
        (gp,) = torch.autograd.grad(kept / (1.0 - rate) @ v[b], p, dc)
        for got, want in ((stats[0, b], s.amax(-1)),
                          (stats[0, b] + stats[1, b].log(), torch.logsumexp(s, -1)),
                          (stats[2, b], (p * gp).sum(-1))):
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=0,
                                       atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("fault", chip_smoke.ROWS_FAULTS)
def test_rows_gate_rejects_the_planted_faults(fault):
    """chip_smoke's limits of the rows kernels (ROWS_TOL) reject each planted
    fault of the rounding model in bf16 at L=256, window 64, CLS global:
    ctx and the statistics at rate 0.1, and the W8A8 mode's float32 ctx,
    the model with the fault read against the model."""
    Bm, Lm, nh, hd, window = 2, 256, 2, 64, 64
    G, sm = sb.global_columns(16, Lm), hd**-0.5
    n_valid, n_glob = torch.tensor([Lm, 200]), torch.tensor([1, 1])
    (q, k, v, *_), dctx = _core_leaves(Bm, Lm, nh, hd, 45, n_valid)
    q, k, v = ((t.detach() * sc).to(torch.bfloat16).transpose(1, 2)
               for t, sc in ((q, sm), (k, 1.0), (v, 1.0)))
    keep = ts.sliding_keep_masks(torch.tensor([3], dtype=torch.int32), Bm, nh, Lm, window, G, 0.1)
    for rate, ctx_dtype, dc in ((0.1, None, dctx.to(torch.bfloat16)), (0.0, torch.float32, None)):
        model = lambda: ts.sliding_rows_model(q, k, v, None, n_valid, n_glob, window=window,
                                              dctx=dc, dropout_rate=rate,
                                              keep=keep if rate else None, ctx_dtype=ctx_dtype)
        want = model()
        if dc is None:
            want = (want[0], None)
        with chip_smoke.planted(chip_smoke.rows_faults("band_rows")[fault]):
            bad = model()
        tol = chip_smoke.rows_tol(want)
        assert chip_smoke.core_bwd_excess(chip_smoke.rows_readings(want, bad), tol) > 1
        assert chip_smoke.core_bwd_excess(chip_smoke.rows_readings(want, want), tol) == 0


@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
def test_explicit_backward_with_model_core_matches_jax_kernel_vjp_in_bf16(global_rows):
    """bf16: the explicit plain backward with its core's gradient from the
    rounding model against the TPU kernel's custom VJP in interpret mode,
    both in bf16, to BF16_RTOL of each gradient's largest magnitude (the two
    round q, k, v, dctx, e, dS and the outputs to bf16 at their own points)."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_sliding import sliding_attention_block_train as jax_train

    inp = _inputs(B, L, H, NH, seed=10, global_rows=global_rows)
    mask, glob = jnp.asarray(inp["attention_mask"]), jnp.asarray(inp["global_mask"])
    bf16 = lambda k: jnp.asarray(inp[k]).astype(jnp.bfloat16 if k == "hidden" else jnp.float32)
    _, vjp = jax.vjp(
        lambda h, *p: jax_train(h, mask, glob, *p, jnp.zeros((1,), jnp.int32), HD**-0.5,
                                dropout_rate=0.0, interpret=True, window=WINDOW, max_globals=16,
                                global_rows=global_rows),
        *(bf16(k) for k in ARGS))
    want = vjp(jnp.asarray(inp["cotangent"]).astype(jnp.bfloat16))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = ts.sliding_train_bwd_plain(
        t["hidden"].bfloat16(), t["attention_mask"], t["global_mask"], *(t[k] for k in ARGS[1:6]),
        t["cotangent"].bfloat16(), sm_scale=HD**-0.5, window=WINDOW, max_globals=16,
        global_rows=global_rows, model_core=True)
    assert got[0].dtype == torch.bfloat16
    for name, g, w in zip(ARGS, got, want):
        w = np.asarray(w.astype(jnp.float32)).reshape(g.shape)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=BF16_RTOL * np.abs(w).max() + 1e-12, err_msg=name)


# --------------------------------------------- the global rows alone (CPU)


def _jnp_philox_global_rows(seed: int, b, h: int, shape):
    """The global-row plane's Philox words (ts.philox_bits at (b, h | 2 << 16,
    g, key)) in jnp uint32 over a (G, L) grid, for a Pallas kernel traced in
    interpret mode (which captures no constant arrays): the 32 x 32 -> 64
    products from 16-bit halves."""
    import jax
    import jax.numpy as jnp

    u32 = lambda v: jnp.asarray(v).astype(jnp.uint32)

    def mulhilo(a, m):
        lo = a * jnp.uint32(m)
        a_lo, a_hi, m_lo, m_hi = a & 0xFFFF, a >> 16, m & 0xFFFF, m >> 16
        t = a_lo * jnp.uint32(m_lo)
        mid = a_hi * jnp.uint32(m_lo) + (t >> 16)
        mid2 = a_lo * jnp.uint32(m_hi) + (mid & 0xFFFF)
        return a_hi * jnp.uint32(m_hi) + (mid >> 16) + (mid2 >> 16), lo

    zero = jnp.zeros(shape, jnp.uint32)
    c = [zero + u32(b), zero + jnp.uint32(h | ts.GLOBAL_ROW_STREAM),
         jax.lax.broadcasted_iota(jnp.int32, shape, 0).astype(jnp.uint32),
         jax.lax.broadcasted_iota(jnp.int32, shape, 1).astype(jnp.uint32)]
    k0, k1 = seed & 0xFFFFFFFF, 0
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) & 0xFFFFFFFF
        hi0, lo0 = mulhilo(c[0], 0xD2511F53)
        hi1, lo1 = mulhilo(c[2], 0xCD9E8D57)
        c = [hi1 ^ c[1] ^ jnp.uint32(k0), lo1, hi0 ^ c[3] ^ jnp.uint32(k1), lo0]
    return c[0]


def _global_rows_inputs(seed, n_glob, Lg=64):
    """Float32 inputs at B=2, L=64 with n_glob global tokens a row (G the
    whole global block when n_glob is "G") and suffix padding, the output
    projection the identity (H = nh hd, zero bias): the training block's
    output is its context."""
    inp = _inputs(B, Lg, H, NH, seed=seed)
    G = sb.global_columns(16, Lg)
    ng = G if n_glob == "G" else n_glob
    inp["global_mask"][:] = 0
    inp["global_mask"][:, :ng] = 1
    inp["out_kernel"] = np.eye(H, dtype=np.float32).reshape(NH, HD, H)
    inp["out_bias"] = np.zeros(H, np.float32)
    return inp, G


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n_glob", [1, 2, "G"])
def test_global_rows_wrapper_matches_jax_kernel(n_glob, rate):
    """sliding_global_rows on the CPU (the plain query and the global-rows
    part of the rows model) against the global rows of the TPU training
    kernel's forward in interpret mode, read through an identity output
    projection, in float32 on padded rows: 1, 2 or G global tokens. At rate
    0.1 the kernel's PRNG draws (pltpu.prng_random_bits) are replaced by the
    port's Philox words of the global-row plane (and keep-everything for
    the band and global columns, whose rows are not compared), so both keep
    the same probabilities; to 1e-5 of the largest."""
    from unittest import mock

    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from spokennlp_tpu.ops.pallas.train_sliding import sliding_attention_block_train as jax_train

    Lg, seed = 64, 20231023
    inp, G = _global_rows_inputs(17, n_glob, Lg)
    calls = {"n": 0}

    def bits(shape):
        if tuple(shape) != (G, Lg):
            return jnp.full(shape, 0xFFFFFFFF, jnp.uint32)
        h = calls["n"] % NH
        calls["n"] += 1
        return _jnp_philox_global_rows(seed, pl.program_id(0), h, tuple(shape))

    kw = dict(sm_scale=HD**-0.5, window=WINDOW, max_globals=16, dropout_rate=rate,
              interpret=True)
    with mock.patch.object(pltpu, "prng_random_bits", bits), \
            mock.patch.object(pltpu, "prng_seed", lambda *a: None):
        want = jax_train(*(jnp.asarray(inp[k]) for k in ("hidden", "attention_mask",
                                                           "global_mask")),
                         *(jnp.asarray(inp[k]) for k in ARGS[1:]),
                         jnp.asarray([seed], jnp.int32), **kw)
    assert rate == 0.0 or calls["n"] >= NH
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x, HN = t["hidden"], NH * HD
    gw, gb = t["gqkv_kernel"], t["gqkv_bias"]
    gkv = torch.stack([torch.einsum("blh,hnd->bnld", x, gw[:, i]) + gb[i][None, :, None]
                       for i in (1, 2)]).contiguous()
    n_valid, n_g = sb._counts(t["attention_mask"], t["global_mask"], G, True)
    counts = torch.stack([n_valid, n_g], 1).int()
    ctx, qg, stats, dqg = ts.sliding_global_rows(
        x, gw[:, 0].reshape(H, HN), gb[0].reshape(HN), gkv, counts,
        torch.tensor([seed], dtype=torch.int32), sm_scale=HD**-0.5, dropout_rate=rate)
    assert ctx.shape == (B, G, NH, HD) and qg.shape == (B, NH, G, HD) and stats is None
    want = np.asarray(want)
    for b in range(B):
        ng = int(n_g[b])
        w = want[b, :ng]
        np.testing.assert_allclose(ctx[b, :ng].reshape(ng, H).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
        assert not ctx[b, ng:].any() and not qg[b, :, ng:].any()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_global_rows_model_statistics_and_dqg_match_autograd(rate):
    """float32: sliding_global_rows (CPU) in its statistics pass against a
    plain softmax over each global row's real keys: m its maximum, m + log D
    its logsumexp, rowsum(dp p_eff) / (D keep_prob) = sum_k p_k dL/dp_k and
    dqg = sm_scale dL/dqg from autograd of ctx = (kept p / keep_prob) . vg
    with the cotangent dctx; to 1e-5 of the largest."""
    Lg, seed = 64, torch.tensor([5], dtype=torch.int32)
    inp, G = _global_rows_inputs(19, 2, Lg)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    x, HN, sm = t["hidden"], NH * HD, HD**-0.5
    gw, gb = t["gqkv_kernel"], t["gqkv_bias"]
    gkv = torch.stack([torch.einsum("blh,hnd->bnld", x, gw[:, i]) + gb[i][None, :, None]
                       for i in (1, 2)]).contiguous()
    n_valid, n_g = sb._counts(t["attention_mask"], t["global_mask"], G, True)
    counts = torch.stack([n_valid, n_g], 1).int()
    dctx = torch.from_numpy(np.random.default_rng(3).normal(size=(B, Lg, HN)).astype(np.float32))
    ctx, qg, stats, dqg = ts.sliding_global_rows(
        x, gw[:, 0].reshape(H, HN), gb[0].reshape(HN), gkv, counts, seed, sm_scale=sm,
        dctx=dctx, dropout_rate=rate)
    keep = ts.sliding_keep_masks(seed, B, NH, Lg, WINDOW, G, rate)[2] if rate else None
    for b in range(B):
        ng, nv = int(n_g[b]), int(n_valid[b])
        q = qg[b, :, :ng].clone().requires_grad_()
        s = torch.where(torch.arange(Lg) < nv, q @ gkv[0, b].transpose(-1, -2), -torch.inf)
        p = torch.softmax(s, -1)
        p.retain_grad()
        kept = p if keep is None else torch.where(keep[b][:, :ng], p, 0.0)
        dc = dctx[b, :ng].reshape(ng, NH, HD).transpose(0, 1)
        (kept / (1.0 - rate) @ gkv[1, b]).backward(dc)
        for got, want in ((stats[0, b, :, :ng], s.amax(-1)),
                          (stats[0, b, :, :ng] + stats[1, b, :, :ng].log(),
                           torch.logsumexp(s, -1)),
                          (stats[2, b, :, :ng], (p * p.grad).sum(-1)),
                          (dqg[b, :ng].transpose(0, 1), q.grad * sm)):
            want = want.detach()
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5 * want.abs().max().item())
        assert not stats[:, b, :, ng:].any() and not dqg[b, ng:].any()


@pytest.mark.parametrize("fault", chip_smoke.ROWS_FAULTS)
def test_global_rows_gate_rejects_the_planted_faults(fault):
    """chip_smoke's limits of the global rows (ROWS_TOL on ctx and the
    statistics, BWD_CORE_TOL on dqg) reject each planted fault of the
    rounding model in bf16 at L=256, CLS global: the statistics pass at rate
    0.1 and the W8A8 mode's float32 ctx, the model with the fault read
    against the model."""
    Bm, Lm, nh, hd = 2, 256, 2, 64
    G, sm = sb.global_columns(16, Lm), hd**-0.5
    n_valid, n_glob = torch.tensor([Lm, 200]), torch.tensor([1, 1])
    rng = np.random.default_rng(47)
    f = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32)).to(torch.bfloat16)
    qg, kg, vg = f(Bm, nh, G, hd, scale=sm), f(Bm, nh, Lm, hd), f(Bm, nh, Lm, hd)
    dctx = f(Bm, Lm, nh, hd)
    keep = ts.sliding_keep_masks(torch.tensor([3], dtype=torch.int32), Bm, nh, Lm, 64, G,
                                 0.1)[2]
    for rate, ctx_dtype, dc in ((0.1, None, dctx), (0.0, torch.float32, None)):
        model = lambda: ts.sliding_global_rows_model(qg, kg, vg, n_valid, n_glob, sm_scale=sm,
                                                     dctx=dc, dropout_rate=rate,
                                                     keep=keep if rate else None,
                                                     ctx_dtype=ctx_dtype)
        want = model()
        got = (want[0], qg, want[1], want[2])
        with chip_smoke.planted(chip_smoke.rows_faults("global_rows")[fault]):
            bad = model()
        assert chip_smoke.global_rows_excess(chip_smoke.global_rows_readings(got, bad),
                                             want[0].dtype) > 1
        assert chip_smoke.global_rows_excess(chip_smoke.global_rows_readings(got, want),
                                             want[0].dtype) == 0


@pytest.mark.parametrize("Bm,nh,keys,within", [(3, 2, 192, False), (2, 12, 2048, True)],
                         ids=["16 rows of 192 keys", "16 rows of 2048 keys"])
def test_global_rows_norm_reading_of_score_noise(Bm, nh, keys, within):
    """Why the card test holds 16 live global rows at 2048 keys: the bf16
    rounding model against itself, its float32 scores moved by 1e-7 (about
    what two float32 sum orders of a 64-term product differ by), read as
    chip_smoke reads a bf16 ctx. One s - m that crosses a bf16 rounding
    boundary moves a whole global row's ctx, so over 40 draws the norm
    reading of 16 rows of 192 keys a head passes ROWS_TOL's bf16 norm limit,
    and over 6 draws of 2048 keys it stays within."""
    from spokennlp_tpu_torch.ops.cuda import attention_models as am

    worst = 0.0
    for seed in range(40 if keys < 1024 else 6):
        g = torch.Generator().manual_seed(seed)
        qg = (torch.randn(Bm, nh, 16, 64, generator=g) / 8).to(torch.bfloat16).float()
        kg, vg = (torch.randn(Bm, nh, keys, 64, generator=g).to(torch.bfloat16).float()
                  for _ in range(2))
        s = qg @ kg.transpose(-1, -2)
        allowed = torch.ones(16, keys, dtype=torch.bool)
        ctx = lambda sc: am.rows_attend(sc, vg, allowed, None, torch.bfloat16, 1.0)[0].to(
            torch.bfloat16)
        moved = ctx(s + 1e-7 * torch.randn(s.shape, generator=g))
        worst = max(worst, chip_smoke.rows_readings((moved, None), (ctx(s), None))["ctx"][1])
    assert (worst <= chip_smoke.ROWS_TOL["bfloat16"][1]) == within, worst


# ------------------------------------------------------------------ dropout


def test_keep_masks_are_deterministic_disjoint_and_fair():
    seed = torch.tensor([20231016], dtype=torch.int32)
    Bm, nh, Lm, window, G, rate = 2, 3, 96, 32, 16, 0.1
    masks = ts.sliding_keep_masks(seed, Bm, nh, Lm, window, G, rate)
    again = ts.sliding_keep_masks(seed, Bm, nh, Lm, window, G, rate)
    other = ts.sliding_keep_masks(seed + 1, Bm, nh, Lm, window, G, rate)
    C = window // 2
    assert [tuple(m.shape) for m in masks] == [(Bm, nh, Lm // C, C, 3 * C), (Bm, nh, Lm, G),
                                               (Bm, nh, G, Lm)]
    for m, a, o in zip(masks, again, other):
        assert torch.equal(m, a) and not torch.equal(m, o)
        assert abs(m.float().mean().item() - (1 - rate)) < 1e-2
    # the three counter spaces differ where their indices coincide: the
    # band's (row, key) against the global columns' (row, g) and the global
    # rows' (g, key), for keys and g in [0, G)
    band, gcol, grow = masks
    rows = torch.arange(G)
    band_abs = np.zeros((Bm, nh, G, G), bool)
    for r in range(G):  # band entry of row r against absolute key j: cj = j - (r - r % C) + C
        for jj in range(G):
            band_abs[:, :, r, jj] = band[:, :, r // C, r % C, jj - (r - r % C) + C].numpy()
    assert (band_abs != gcol[:, :, rows][:, :, :, :G].numpy()).any()
    assert (band_abs != grow[:, :, :, :G].numpy()).any()
    bits = [ts.philox_bits(7, 0, h, 3, 5) for h in (1, 1 | ts.GLOBAL_COL_STREAM,
                                                     1 | ts.GLOBAL_ROW_STREAM)]
    assert len({int(b) for b in bits}) == 3


def test_dropout_replays_the_keep_masks_on_cpu():
    """At rate 0.1 the block equals the plain version given the masks, and
    another seed drops other probabilities."""
    inp = _inputs(B, L, H, NH, seed=7)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    seed = torch.tensor([99], dtype=torch.int32)
    kw = dict(sm_scale=HD**-0.5, window=WINDOW, max_globals=16, dropout_rate=0.1)
    args = (t["hidden"], t["attention_mask"], t["global_mask"], *(t[k] for k in ARGS[1:]))
    got = ts.sliding_attention_block_train(*args, seed, **kw)
    keep = ts.sliding_keep_masks(seed, B, NH, L, WINDOW, 16, 0.1)
    want = ts.sliding_train_plain(*args, keep=keep, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (ts.sliding_attention_block_train(*args, seed + 1, **kw) - got).abs().max() > 1e-3
    nodrop = ts.sliding_train_plain(*args, **{**kw, "dropout_rate": 0.0})
    assert (nodrop - got).abs().max() > 1e-3


def test_wrappers_on_cpu_count_no_launches_and_check_nothing_on_card():
    before = (sb.fused_sliding_attention_block.launches, ts.sliding_train_fwd.launches,
              ts.sliding_train_bwd.launches)
    inp = _inputs(B, L, H, NH, seed=8)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    args = (t["hidden"], t["attention_mask"], t["global_mask"], *(t[k] for k in ARGS[1:]))
    sb.fused_sliding_attention_block(*args, sm_scale=HD**-0.5, window=WINDOW)
    ts.sliding_attention_block_train(*args, torch.zeros(1, dtype=torch.int32), sm_scale=HD**-0.5,
                                     window=WINDOW)
    assert (sb.fused_sliding_attention_block.launches, ts.sliding_train_fwd.launches,
            ts.sliding_train_bwd.launches) == before
    with pytest.raises(ValueError, match="window // 2"):
        sb.check_contract(L=40, window=32, max_globals=16, where="test")
    with pytest.raises(ValueError, match="window // 2"):
        sb.check_contract(L=36, window=12, max_globals=16, where="test")
    with pytest.raises(ValueError, match="max_globals"):
        sb.check_contract(L=256, window=32, max_globals=100, where="test")


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, L, H, nh, window): odd band tiles (C = 32, 24, 16), head dims 64, 16,
# 32 and 128, and the slice's shape (the recipe's micro-batch of 2 for
# training)
CARD_SHAPES = [(3, 192, 128, 2, 64), (2, 240, 64, 4, 48), (2, 256, 128, 4, 128),
               (2, 160, 256, 2, 32), (2, 2048, 768, 12, 512)]


def _card_tensors(inp, device, dtype):
    t = {k: torch.from_numpy(v).to(device) for k, v in inp.items()}
    t["hidden"] = t["hidden"].to(dtype)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,window", CARD_SHAPES[:4] + [(8, 2048, 768, 12, 512)])
def test_sliding_block_kernel_matches_plain_on_card(cuda, dtype, global_rows, Bc, Lc, Hc, nh,
                                                    window):
    inp = _inputs(Bc, Lc, Hc, nh, seed=Lc, global_rows=global_rows)
    t = _card_tensors(inp, cuda, dtype)
    hd = Hc // nh
    kw = dict(sm_scale=hd**-0.5, window=window, max_globals=16, global_rows=global_rows,
              ln_scale=t["ln_scale"], ln_bias=t["ln_bias"])
    args = [t["hidden"], t["attention_mask"], t["global_mask"], *(t[k] for k in ARGS[1:])]
    n = sb.fused_sliding_attention_block.launches
    got = sb.fused_sliding_attention_block(*args, **kw)
    torch.cuda.synchronize()
    assert sb.fused_sliding_attention_block.launches == n + 1
    for i in (3, 5, 7):  # the weights the kernel reads
        args[i] = args[i].to(dtype)
    want = sb.sliding_block_plain(*args, **kw)
    live = t["attention_mask"].bool()
    assert torch.isfinite(got).all()
    err = (got[live].float() - want[live].float()).abs().max() / want[live].float().abs().max()
    assert err.item() < CARD_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,window", CARD_SHAPES)
def test_sliding_train_kernels_match_plain_on_card(cuda, dtype, rate, global_rows, Bc, Lc, Hc,
                                                   nh, window):
    inp = _inputs(Bc, Lc, Hc, nh, seed=Lc + 1, global_rows=global_rows)
    hd = Hc // nh
    seed = torch.tensor([11 + Lc], dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=hd**-0.5, window=window, max_globals=16, global_rows=global_rows,
              dropout_rate=rate)

    def run(fn, weights_dtype=None, **extra):
        t = _card_tensors(inp, cuda, dtype)
        for k in ARGS:
            t[k] = (t[k].to(weights_dtype) if weights_dtype and k.endswith("kernel")
                    else t[k]).detach().requires_grad_()
        out = fn(t["hidden"], t["attention_mask"], t["global_mask"], *(t[k] for k in ARGS[1:]),
                 **extra, **kw)
        grads = torch.autograd.grad(out, [t[k] for k in ARGS], t["cotangent"].to(out.dtype),
                                    allow_unused=True)
        return [out.detach(), *grads]

    n = (ts.sliding_train_fwd.launches, ts.sliding_train_bwd.launches)
    got = run(ts.sliding_attention_block_train, seed=seed)
    torch.cuda.synchronize()
    assert (ts.sliding_train_fwd.launches, ts.sliding_train_bwd.launches) == (n[0] + 1, n[1] + 1)
    keep = (ts.sliding_keep_masks(seed, Bc, nh, Lc, window, sb.global_columns(16, Lc), rate)
            if rate else None)
    want = run(ts.sliding_train_plain, weights_dtype=dtype, keep=keep)
    live = torch.from_numpy(inp["attention_mask"]).bool().to(cuda)
    got[0], want[0] = got[0][live], want[0][live]
    for name, g, w in zip(("out",) + ARGS, got, want):
        if not global_rows and name.startswith("gqkv"):
            assert (g == 0).all(), name
            continue
        assert torch.isfinite(g).all(), name
        err = ((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30)).item()
        assert err < CARD_TOL[dtype], (name, err)
    again = run(ts.sliding_attention_block_train, seed=seed)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))  # deterministic backward


@pytest.mark.gpu
def test_keep_masks_on_card_match_numpy(cuda):
    seed = torch.tensor([4242], dtype=torch.int32)
    want = ts.sliding_keep_masks(seed, 2, 3, 96, 32, 16, 0.25)
    got = ts.sliding_keep_masks(seed.to(cuda), 2, 3, 96, 32, 16, 0.25)
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,window", CARD_SHAPES)
def test_sliding_backward_products_match_explicit_plain_on_card(cuda, global_rows, Bc, Lc, Hc,
                                                               nh, window):
    """bf16: dctx, dx, the weight and the bias gradients of the backward
    kernel against its explicit plain products on the intermediates the
    kernel's products read (its ctx, and dproj from its attention core),
    within chip_smoke.BWD_GEMM_TOL element by element."""
    inp = _inputs(Bc, Lc, Hc, nh, seed=Lc + 2, global_rows=global_rows)
    t = _card_tensors(inp, cuda, torch.bfloat16)
    hd = Hc // nh
    w = sb.card_weights(*(t[k] for k in ARGS[1:6]), torch.bfloat16)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    bufs = {}
    got = ts.sliding_train_bwd(
        t["hidden"], t["attention_mask"], t["global_mask"], seed, w,
        t["cotangent"].to(torch.bfloat16), num_heads=nh, window=window, max_globals=16,
        global_rows=global_rows, sm_scale=hd**-0.5, dropout_rate=0.1, buffers=bufs)
    if global_rows:
        out = {"dx": got[0], "dw_all": torch.cat([got[1], got[3]], 1),
               "db_all": torch.cat([got[2], got[4]]), "dwo": got[5], "dbo": got[6]}
    else:
        out = dict(zip(("dx", "dw_all", "db_all"), got[:3]), dwo=got[5], dbo=got[6])
    want = chip_smoke.projection_gemms_plain(
        t["hidden"].reshape(-1, Hc), t["cotangent"].to(torch.bfloat16).reshape(-1, Hc), bufs,
        bufs["w_all"], w["wo"])
    readings = chip_smoke.backward_gemm_readings({"dctx": bufs["dctx"], **out}, want)
    assert max(readings.values()) <= chip_smoke.BWD_GEMM_TOL["sliding_train_bwd"], readings


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,window", CARD_SHAPES)
def test_sliding_gradient_kernels_match_rounding_model_on_card(cuda, rate, global_rows, Bc, Lc,
                                                               Hc, nh, window):
    """bf16: the gradient kernels' dproj against sliding_core_bwd_model on the
    kernel's own intermediates, within chip_smoke.BWD_CORE_TOL element by
    element and in norm in each slot; two runs give the same bits; each
    planted fault of the model fails the limits."""
    inp = _inputs(Bc, Lc, Hc, nh, seed=Lc + 3, global_rows=global_rows)
    t = _card_tensors(inp, cuda, torch.bfloat16)
    hd = Hc // nh
    w = sb.card_weights(*(t[k] for k in ARGS[1:6]), torch.bfloat16)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    runs = [{}, {}]
    for bufs in runs:
        ts.sliding_train_bwd(t["hidden"], t["attention_mask"], t["global_mask"], seed, w,
                             t["cotangent"].to(torch.bfloat16), num_heads=nh, window=window,
                             max_globals=16, global_rows=global_rows, sm_scale=hd**-0.5,
                             dropout_rate=rate, buffers=bufs)
    keep = (ts.sliding_keep_masks(seed, Bc, nh, Lc, window, sb.global_columns(16, Lc), rate)
            if rate else None)
    model = lambda: ts.sliding_core_model_dproj(runs[0], window=window, sm_scale=hd**-0.5,
                                                dropout_rate=rate, keep=keep)
    readings = chip_smoke.core_bwd_readings(runs[0]["dproj"], model(), nh * hd)
    print(f"{Bc}x{Lc} hd {hd} window {window} global_rows={global_rows} rate {rate}: {readings}")
    tol = chip_smoke.BWD_CORE_TOL["sliding_train_bwd"]
    assert chip_smoke.core_bwd_excess(readings, tol) <= 1, readings
    assert torch.equal(runs[0]["dproj"], runs[1]["dproj"])
    for fault, patches in chip_smoke.core_bwd_faults("sliding_train_bwd").items():
        with chip_smoke.planted(patches):
            bad = chip_smoke.core_bwd_readings(runs[0]["dproj"], model(), nh * hd)
        print(f"  {fault}: {bad}")
        assert chip_smoke.core_bwd_excess(bad, tol) > 1, (fault, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "w8a8", "stats"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,window", CARD_SHAPES)
def test_sliding_rows_kernel_matches_rounding_model_on_card(cuda, mode, rate, Bc, Lc, Hc, nh,
                                                            window):
    """bf16: band_rows_kernel alone (ts.sliding_rows) on the q, k, v, counts
    and dctx of a backward of the block (CLS and a second global token)
    against sliding_rows_model within chip_smoke.ROWS_TOL, in each mode: a
    bf16 ctx, the W8A8 blocks' float32 ctx, and the statistics pass (bf16
    ctx and the statistics, which must equal the backward's own); two runs
    give the same bits; each planted fault of the model fails the limits."""
    inp = _inputs(Bc, Lc, Hc, nh, seed=Lc + 7)
    t = _card_tensors(inp, cuda, torch.bfloat16)
    hd = Hc // nh
    w = sb.card_weights(*(t[k] for k in ARGS[1:6]), torch.bfloat16)
    seed = torch.tensor([11], dtype=torch.int32, device=cuda)
    bufs = {}
    ts.sliding_train_bwd(t["hidden"], t["attention_mask"], t["global_mask"], seed, w,
                         t["cotangent"].to(torch.bfloat16), num_heads=nh, window=window,
                         max_globals=16, global_rows=True, sm_scale=hd**-0.5, dropout_rate=rate,
                         buffers=bufs)
    qkv, counts = bufs["qkv"], bufs["counts"]
    dctx = bufs["dctx"] if mode == "stats" else None
    cdt = torch.float32 if mode == "w8a8" else None
    runs = [ts.sliding_rows(qkv, counts, seed, window=window, dctx=dctx, dropout_rate=rate,
                            ctx_dtype=cdt) for _ in range(2)]
    if mode == "stats":
        assert torch.equal(runs[0][1], bufs["stats"])
    n = counts.long()
    keep = (ts.sliding_keep_masks(seed, Bc, nh, Lc, window, sb.global_columns(16, Lc), rate)
            if rate else None)
    model = lambda: ts.sliding_rows_model(
        qkv[0], qkv[1], qkv[2], None, n[:, 0], n[:, 1], window=window, dropout_rate=rate,
        keep=keep, ctx_dtype=cdt, dctx=None if dctx is None else dctx.reshape(Bc, Lc, nh, hd))
    readings = chip_smoke.rows_readings(runs[0], model())
    print(f"{Bc}x{Lc} hd {hd} window {window} {mode} rate {rate}: {readings}")
    tol = chip_smoke.rows_tol(runs[0])
    assert chip_smoke.core_bwd_excess(readings, tol) <= 1, readings
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(*runs))
    for fault, patches in chip_smoke.rows_faults("band_rows").items():
        with chip_smoke.planted(patches):
            bad = chip_smoke.rows_readings(runs[0], model())
        print(f"  {fault}: {bad}")
        assert chip_smoke.core_bwd_excess(bad, tol) > 1, (fault, bad)



GLOBAL_MODES = [("bf16", 0.0), ("bf16", 0.1), ("w8a8", 0.0), ("stats", 0.0), ("stats", 0.1)]
# (shape, n_glob): 1 and 2 global tokens at every card shape; all G = 16 rows
# of the tile live at 2048 tokens, in each head dim. A global row sees every
# key, and where two float32 sum orders put one s - m on either side of a
# bf16 rounding boundary, that e moves by a step: at 16 rows of 192 keys one
# such step moves a whole row's bf16 ctx, and the norm part of ROWS_TOL,
# set for the main paths' 2048 keys, reads it (3.0e-4 on the H100 with 48
# rows of 192 keys; the model against itself with its scores moved by 1e-7
# reads up to 2.8e-4 there and 1.2e-4 at 2048 keys:
# test_global_rows_norm_reading_of_score_noise).
GLOBAL_CARD_CASES = ([(shape, n) for shape in CARD_SHAPES for n in (1, 2)]
                     + [(shape, "G") for shape in ((2, 2048, 64, 4, 512), (2, 2048, 128, 4, 512),
                                                   (2, 2048, 768, 12, 512),
                                                   (2, 2048, 256, 2, 512))])


@pytest.mark.gpu
@pytest.mark.parametrize("mode,rate", GLOBAL_MODES)
@pytest.mark.parametrize("shape,n_glob", GLOBAL_CARD_CASES)
def test_sliding_global_rows_kernel_matches_rounding_model_on_card(cuda, mode, rate, shape,
                                                                   n_glob):
    """bf16: global_rows_kernel alone (ts.sliding_global_rows) on the kg, vg,
    counts and dctx of a backward of the block with 1, 2 or G global tokens,
    in each mode: a bf16 ctx, the W8A8 blocks' int8 query with a float32
    ctx, and the statistics pass. qg against the plain query (chip_smoke's
    QG_TOL; W8A8 bit for bit), ctx, the statistics and dqg against
    sliding_global_rows_model within chip_smoke's limits; the statistics
    pass's qg, statistics and dqg equal the backward's own; two runs give
    the same bits; each planted fault of the model fails the limits."""
    Bc, Lc, Hc, nh, window = shape
    from spokennlp_tpu_torch.ops.cuda.int8_matmul import quantize_colwise, rowquant_plain

    inp = _inputs(Bc, Lc, Hc, nh, seed=Lc + 11)
    G = sb.global_columns(16, Lc)
    inp["global_mask"][:] = 0
    inp["global_mask"][:, :G if n_glob == "G" else n_glob] = 1
    t = _card_tensors(inp, cuda, torch.bfloat16)
    hd, HN = Hc // nh, Hc
    w = sb.card_weights(*(t[k] for k in ARGS[1:6]), torch.bfloat16)
    seed = torch.tensor([13], dtype=torch.int32, device=cuda)
    bufs = {}
    ts.sliding_train_bwd(t["hidden"], t["attention_mask"], t["global_mask"], seed, w,
                         t["cotangent"].to(torch.bfloat16), num_heads=nh, window=window,
                         max_globals=16, global_rows=True, sm_scale=hd**-0.5, dropout_rate=rate,
                         buffers=bufs)
    counts, gkv = bufs["counts"], bufs["gkv"]
    x = t["hidden"]
    quant = None
    if mode == "w8a8":
        x8, sx = rowquant_plain(x.reshape(-1, Hc))
        w8, sw = quantize_colwise(w["wgq"].float())
        quant = dict(x8=x8, sx=sx.reshape(-1).contiguous(), wgq8=w8.contiguous(),
                     swgq=sw.reshape(-1).contiguous())
    dctx = bufs["dctx"] if mode == "stats" else None
    runs = [ts.sliding_global_rows(x, w["wgq"], w["bgq"], gkv, counts, seed, sm_scale=hd**-0.5,
                                   dctx=dctx, dropout_rate=rate, quant=quant) for _ in range(2)]
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(*runs))
    ctx, qg, stats, dqg = runs[0]
    n = counts.long()
    live = torch.arange(G, device=cuda)[None] < n[:, 1:2]
    want_q = ts.sliding_global_query(x, w["wgq"], w["bgq"], n[:, 1], num_heads=nh,
                                     sm_scale=hd**-0.5, G=G, quant=quant)
    if quant is not None:
        assert torch.equal(qg, want_q)
    else:
        assert chip_smoke.query_reading(qg, want_q) <= chip_smoke.QG_TOL[0]
    if mode == "stats":
        assert torch.equal(qg, torch.where(live[:, None, :, None], bufs["qg"], 0.0))
        assert torch.equal(stats, torch.where(live[None, :, None], bufs["gstats"], 0.0))
        dproj = bufs["dproj"].reshape(Bc, Lc, 6, nh, hd)[:, :G, 3]
        assert torch.equal(dqg, torch.where(live[:, :, None, None], dproj, 0.0))
    keep = (ts.sliding_keep_masks(seed, Bc, nh, Lc, window, G, rate)[2] if rate else None)
    model = lambda: ts.sliding_global_rows_model(
        qg, gkv[0], gkv[1], n[:, 0], n[:, 1], sm_scale=hd**-0.5,
        dctx=None if dctx is None else dctx.reshape(Bc, Lc, nh, hd), dropout_rate=rate,
        keep=keep, ctx_dtype=torch.float32 if quant is not None else None)
    readings = chip_smoke.global_rows_readings(runs[0], model())
    print(f"{Bc}x{Lc} hd {hd} n_glob {n_glob} {mode} rate {rate}: {readings}")
    assert chip_smoke.global_rows_excess(readings, ctx.dtype) <= 1, readings
    for fault, patches in chip_smoke.rows_faults("global_rows").items():
        with chip_smoke.planted(patches):
            bad = chip_smoke.global_rows_readings(runs[0], model())
        print(f"  {fault}: {bad}")
        assert chip_smoke.global_rows_excess(bad, ctx.dtype) > 1, (fault, bad)
