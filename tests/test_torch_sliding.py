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

