"""Port BigBird attention: ``ops/bigbird_attention.py`` (the index table, the
bias, block and reference paths), the plain versions of the BigBird
inference block and training block against the JAX package's Pallas kernels
(interpret mode) on the CPU, the kernels' tables, the Philox keep masks of
the four probability sets, and the CUDA kernels against the plain versions
on the card (``-m gpu``). JAX is imported inside the CPU tests only.

Shapes: B=2, H=32, 2 heads, blocks of 8 with 2 global and 3 random blocks,
at L=64 (nb=8) and at L=32 (nb=4, where short rows of the table fall back to
padded-self entries), and without random blocks (the JAX inference kernel
takes no zero-width table, so that case runs against the training kernel and
the gather path). Tolerances: the functions
of ops/bigbird_attention.py and the float32 blocks to 1e-5 (the same math
summed in another order); the training block's output and gradients to
1e-4 (gradients relative to their largest magnitude); bfloat16, where the
JAX kernel rounds q, k, v, the probabilities and ctx to bf16 (unit roundoff
2^-9) and the plain version stays in float32, to 3e-2 of the largest
output. Only real rows are compared where a row may have no allowed key.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.ops import bigbird_attention as ba
from spokennlp_tpu_torch.ops.cuda import bigbird_block as bb
from spokennlp_tpu_torch.ops.cuda import train_bigbird as tb

F32_TOL = dict(atol=1e-5, rtol=1e-5)
MODULE_TOL = 1e-4
BF16_RTOL = 3e-2
# card: largest |kernel - plain| over the largest |plain| of each output;
# bf16 as for the dense and Longformer training kernels
# (tests/test_torch_train_blocks.py), float32 from the H100 readings of
# kernels 8 and 13 in chip_smoke.py (PERF.md: 2.2e-7 to 5.5e-6), about ten
# times the largest
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the gradient kernels' card limit)
from test_torch_sliding import _tf32x3_everywhere  # noqa: E402

B, H, NH, BLOCK, G, R = 2, 32, 2, 8, 2, 3
HD = H // NH
ARGS = ("hidden", "qkv_kernel", "qkv_bias", "out_kernel", "out_bias")


def _inputs(B, L, H, nh, seed, n_valid=None, w_scale=None):
    """Suffix padding: row 0 full, the others cut to ``n_valid`` (default
    40-90 % of L)."""
    hd = H // nh
    rng = np.random.default_rng(seed)
    w_scale = w_scale or H**-0.5
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    mask = np.zeros((B, L), np.int32)
    for b in range(B):
        n = L if b == 0 else (n_valid or int(rng.integers(int(0.4 * L), int(0.9 * L))))
        mask[b, :n] = 1
    return dict(
        hidden=f(B, L, H), attention_mask=mask,
        qkv_kernel=f(H, 3, nh, hd, scale=w_scale), qkv_bias=f(3, nh, hd, scale=0.1),
        out_kernel=f(nh, hd, H, scale=w_scale), out_bias=f(H, scale=0.1),
        ln_scale=1 + f(H, scale=0.1), ln_bias=f(H, scale=0.1),
        cotangent=f(B, L, H) * mask[:, :, None],
    )


def _normalized(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------ ops/bigbird_attention


@pytest.mark.parametrize("nb,g,r,seed", [(8, 2, 3, 0), (4, 2, 3, 7), (16, 2, 3, 1), (1, 2, 3, 0),
                                         (6, 1, 2, 5), (5, 3, 0, 2), (64, 2, 3, 0)])
def test_index_table_and_tables_match_jax(nb, g, r, seed):
    """The static table is numpy's and identical to JAX's; the kernels' random
    tail, flags and inverse table follow from it."""
    from spokennlp_tpu.ops import bigbird_attention as jba

    idx = ba.bigbird_block_indices(nb, g, r, seed)
    np.testing.assert_array_equal(idx, jba.bigbird_block_indices(nb, g, r, seed))
    np.testing.assert_array_equal(ba._first_occurrence_mask(idx), jba._first_occurrence_mask(idx))
    t = ba.bigbird_tables(nb, g, r, seed, "cpu")
    assert ba.bigbird_tables(nb, g, r, seed, "cpu") is t  # cached
    Gk = min(g, nb)
    assert (t.G, t.R) == (Gk, r if nb > 1 else 0)
    occ = ba._first_occurrence_mask(ba.bigbird_block_indices(nb, Gk, r, seed))
    if t.R:
        np.testing.assert_array_equal(t.rand.numpy(), idx[:, Gk + 3:])
        np.testing.assert_array_equal(t.rok.numpy(), occ[:, Gk + 3:].astype(np.int32))
    # the inverse table lists each live entry of a non-global query block once
    want = sorted((int(t.rand[i, k]), i * t.R + k) for i in range(Gk, nb) for k in range(t.R)
                  if t.rok[i, k])
    off, ent = t.inv_offsets.numpy(), t.inv_entries.numpy()
    got = [(j, int(e)) for j in range(nb) for e in ent[off[j]:off[j + 1]]]
    assert got == want and off[-1] == len(want)


@pytest.mark.parametrize("L,r", [(64, 3), (32, 3), (64, 0)])
def test_bias_block_and_reference_match_jax(L, r):
    import jax.numpy as jnp

    from spokennlp_tpu.ops import bigbird_attention as jba

    rng = np.random.default_rng(L + r)
    q, k, v = (rng.normal(size=(B, L, NH, HD)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L), np.int32)
    mask[1, 13:] = 0  # fewer real tokens than the global blocks hold
    j = [jnp.asarray(a) for a in (q, k, v, mask)]
    t = [torch.from_numpy(a) for a in (q, k, v, mask)]
    pattern = (BLOCK, G, r, 3)
    np.testing.assert_array_equal(ba.bigbird_attention_bias(t[3], *pattern).numpy(),
                                  np.asarray(jba.bigbird_attention_bias(j[3], *pattern)))
    np.testing.assert_allclose(ba.bigbird_block_sparse_attention(*t, *pattern).numpy(),
                               np.asarray(jba.bigbird_block_sparse_attention(*j, *pattern)),
                               **F32_TOL)
    np.testing.assert_allclose(ba.reference_bigbird_attention(*t, *pattern).numpy(),
                               np.asarray(jba.reference_bigbird_attention(*j, *pattern)),
                               **F32_TOL)


# --------------------------------------------------- kernel 8: plain vs JAX


@pytest.mark.parametrize("L,n_valid,r,dtype,fuse_ln", [
    (64, 45, 3, "float32", True),    # suffix padding
    (64, 13, 3, "float32", False),   # n_valid < G * block: masked global columns
    (32, 20, 3, "float32", True),    # nb = 4: padded-self random entries
    (32, 32, 3, "float32", True),    # full rows
    (64, 45, 3, "bfloat16", True),
])
def test_bigbird_block_plain_matches_jax_kernel(L, n_valid, r, dtype, fuse_ln):
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.bigbird_block_kernel import fused_bigbird_attention_block as jb

    inp = _inputs(B, L, H, NH, seed=L + n_valid, n_valid=n_valid)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ln = ({"ln_scale": inp["ln_scale"], "ln_bias": inp["ln_bias"]} if fuse_ln else {})
    kw = dict(block_size=BLOCK, num_global_blocks=G, num_random_blocks=r, seed=3,
              sm_scale=HD**-0.5)
    want = jb(jnp.asarray(inp["hidden"]).astype(jdt), jnp.asarray(inp["attention_mask"]),
              *(jnp.asarray(inp[k]) for k in ARGS[1:]), interpret=True,
              **{k: jnp.asarray(v) for k, v in ln.items()}, **kw)
    t = {k: torch.from_numpy(inp[k]) for k in ARGS}
    for k in ("qkv_kernel", "out_kernel"):  # the weights the kernel reads
        t[k] = t[k].to(tdt)
    got = bb.fused_bigbird_attention_block(
        t["hidden"].to(tdt), torch.from_numpy(inp["attention_mask"]),
        *(t[k] for k in ARGS[1:]), **{k: torch.from_numpy(v) for k, v in ln.items()}, **kw)
    live = inp["attention_mask"].astype(bool)
    got, want = got.float().numpy()[live], np.asarray(want.astype(jnp.float32))[live]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert _normalized(got, want) < BF16_RTOL


# -------------------------------------------------- kernel 13: plain vs JAX


@pytest.mark.parametrize("L,n_valid,r", [(64, 45, 3), (32, 11, 3), (64, 50, 0)])
def test_bigbird_train_plain_and_grads_match_jax_kernel(L, n_valid, r):
    """Rate 0: the output and all five gradients (dx, dWqkv, dbqkv, dWo,
    dbo) through autograd of the plain version against the TPU kernel's
    custom VJP."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_bigbird import bigbird_attention_block_train as jt

    inp = _inputs(B, L, H, NH, seed=L + n_valid + 1, n_valid=n_valid)
    mask, cot = jnp.asarray(inp["attention_mask"]), jnp.asarray(inp["cotangent"])
    kw = dict(block_size=BLOCK, num_global_blocks=G, num_random_blocks=r, pattern_seed=4)

    def f(hidden, *params):
        o = jt(hidden, mask, *params, jnp.zeros((1,), jnp.int32), HD**-0.5, dropout_rate=0.0,
               interpret=True, **kw)
        return jnp.sum(o * cot), o

    (_, want), want_grads = jax.value_and_grad(f, argnums=tuple(range(5)), has_aux=True)(
        *(jnp.asarray(inp[k]) for k in ARGS))
    t = {k: torch.from_numpy(inp[k]).requires_grad_(k in ARGS) for k in inp}
    out = tb.bigbird_attention_block_train(
        t["hidden"], t["attention_mask"], *(t[k] for k in ARGS[1:]),
        torch.zeros(1, dtype=torch.int32), HD**-0.5, **kw)
    (out * t["cotangent"]).sum().backward()
    live = inp["attention_mask"].astype(bool)
    np.testing.assert_allclose(out.detach().numpy()[live], np.asarray(want)[live],
                               atol=MODULE_TOL, rtol=MODULE_TOL)
    for name, w in zip(ARGS, want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(t[name].grad.numpy(), w, rtol=MODULE_TOL,
                                   atol=MODULE_TOL * np.abs(w).max(), err_msg=name)


def _explicit_backward(inp, kw, rate=0.0, keep=None):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return [g.numpy() for g in tb.bigbird_train_bwd_plain(
        t["hidden"], t["attention_mask"], *(t[k] for k in ARGS[1:4]), t["cotangent"],
        sm_scale=HD**-0.5, dropout_rate=rate, keep=keep, **kw)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bigbird_explicit_backward_matches_autograd_of_plain(rate):
    """The backward kernel's explicit plain version in float32 against
    autograd of bigbird_train_plain, to 1e-5 of each gradient's largest
    magnitude."""
    L = 64
    inp = _inputs(B, L, H, NH, seed=12, n_valid=45)
    kw = dict(block_size=BLOCK, num_global_blocks=G, num_random_blocks=R, pattern_seed=4)
    seed = torch.tensor([6], dtype=torch.int32)
    keep = tb.bigbird_keep_masks(seed, B, NH, L, BLOCK, G, R, rate) if rate else None
    t = {k: torch.from_numpy(v).requires_grad_(k in ARGS) for k, v in inp.items()}
    out = tb.bigbird_train_plain(t["hidden"], t["attention_mask"], *(t[k] for k in ARGS[1:]),
                                 sm_scale=HD**-0.5, dropout_rate=rate, keep=keep, **kw)
    want = torch.autograd.grad(out, [t[k] for k in ARGS], t["cotangent"])
    for name, g, w in zip(ARGS, _explicit_backward(inp, kw, rate, keep), want):
        w = w.numpy().reshape(g.shape)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_bigbird_explicit_backward_matches_jax_kernel_vjp():
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_bigbird import bigbird_attention_block_train as jt

    inp = _inputs(B, 64, H, NH, seed=13, n_valid=50)
    kw = dict(block_size=BLOCK, num_global_blocks=G, num_random_blocks=R, pattern_seed=4)
    mask = jnp.asarray(inp["attention_mask"])
    _, vjp = jax.vjp(lambda h, *p: jt(h, mask, *p, jnp.zeros((1,), jnp.int32), HD**-0.5,
                                      dropout_rate=0.0, interpret=True, **kw),
                     *(jnp.asarray(inp[k]) for k in ARGS))
    want = vjp(jnp.asarray(inp["cotangent"]))
    for name, g, w in zip(ARGS, _explicit_backward(inp, kw), want):
        w = np.asarray(w).reshape(g.shape)
        np.testing.assert_allclose(g, w, rtol=MODULE_TOL, atol=MODULE_TOL * np.abs(w).max(),
                                   err_msg=name)


# ------------------------------------- the gradient kernels' rounding model


@pytest.mark.parametrize("rate,r", [(0.0, 3), (0.1, 3), (0.1, 0)])
def test_core_bwd_model_matches_autograd_in_float32(rate, r):
    """bigbird_core_bwd_model in float32, where its roundings are exact and
    the statistics are its own, against autograd of bigbird_attend at L=128
    in blocks of 16 (one padded row): dq, dk, dv to 1e-5 of their largest
    magnitude."""
    Lm, C, nh, hd = 128, 16, 2, 16
    sm = hd**-0.5
    rng = np.random.default_rng(22 + r)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    n_valid = torch.tensor([Lm, 70])
    mask = (torch.arange(Lm)[None] < n_valid[:, None]).int()
    q, k, v = (f(2, Lm, nh, hd).requires_grad_() for _ in range(3))
    dctx = f(2, Lm, nh, hd) * mask[..., None, None]
    tables = ba.bigbird_tables(Lm // C, G, r, 4, "cpu")
    keep = (tb.bigbird_keep_masks(torch.tensor([6], dtype=torch.int32), 2, nh, Lm, C, tables.G,
                                  tables.R, rate) if rate else None)
    ctx = bb.bigbird_attend(q * sm, k, v, mask, block_size=C, num_global_blocks=G,
                            num_random_blocks=r, seed=4, dropout_rate=rate, keep=keep)
    want = torch.autograd.grad(ctx, [q, k, v], dctx)
    heads = lambda t: t.detach().transpose(1, 2)
    got = tb.bigbird_core_bwd_model(heads(q) * sm, heads(k), heads(v), dctx, n_valid, tables,
                                    block_size=C, sm_scale=sm, dropout_rate=rate, keep=keep)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * w.abs().max().item(), err_msg=name)


@pytest.mark.parametrize("fault", chip_smoke.BWD_CORE_FAULTS)
def test_core_gate_rejects_the_planted_faults(fault):
    """chip_smoke's limits of the gradient kernels (BWD_CORE_TOL) reject each
    planted fault of the rounding model: in bf16 at L=256 in blocks of 32 (2
    global, 3 random), rate 0.1, the model with the fault read against the
    model."""
    Lm, C, nh, hd = 256, 32, 2, 64
    sm = hd**-0.5
    rng = np.random.default_rng(24)
    f = lambda *s, scale=1.0: torch.from_numpy(rng.normal(size=s).astype(np.float32) * scale)
    n_valid = torch.tensor([Lm, 200])
    q, k, v = (f(2, nh, Lm, hd, scale=sc).to(torch.bfloat16) for sc in (sm, 1.0, 1.0))
    dctx = (f(2, Lm, nh, hd) * (torch.arange(Lm)[None] < n_valid[:, None])[..., None, None])
    tables = ba.bigbird_tables(Lm // C, G, R, 4, "cpu")
    keep = tb.bigbird_keep_masks(torch.tensor([5], dtype=torch.int32), 2, nh, Lm, C, tables.G,
                                 tables.R, 0.1)
    model = lambda: torch.stack(tb.bigbird_core_bwd_model(
        q, k, v, dctx.to(torch.bfloat16), n_valid, tables, block_size=C, sm_scale=sm,
        dropout_rate=0.1, keep=keep), dim=2).reshape(2 * Lm, -1)
    want = model()
    with chip_smoke.planted(chip_smoke.core_bwd_faults("bigbird_train_bwd")[fault]):
        bad = model()
    tol = chip_smoke.BWD_CORE_TOL["bigbird_train_bwd"]
    assert chip_smoke.core_bwd_excess(chip_smoke.core_bwd_readings(want, bad, nh * hd), tol) > 1
    assert chip_smoke.core_bwd_excess(chip_smoke.core_bwd_readings(want, want, nh * hd), tol) == 0


# ------------------------------------------ the rows kernel's rounding model


@pytest.mark.parametrize("L,n_valid,r", [(64, 45, 3), (64, 13, 3), (32, 20, 3)])
def test_rows_model_matches_jax_kernel_context_in_float32(L, n_valid, r):
    """bigbird_rows_model in float32 against the context of the TPU kernel in
    interpret mode, read through an identity output projection (H = nh hd,
    zero bias, no LayerNorm): real rows to 1e-5 of the largest."""
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.bigbird_block_kernel import fused_bigbird_attention_block as jb

    inp = _inputs(B, L, H, NH, seed=L + n_valid + 50, n_valid=n_valid)
    inp["out_kernel"] = np.eye(H, dtype=np.float32).reshape(NH, HD, H)
    inp["out_bias"] = np.zeros(H, np.float32)
    kw = dict(block_size=BLOCK, num_global_blocks=G, num_random_blocks=r, seed=3,
              sm_scale=HD**-0.5)
    want = jb(jnp.asarray(inp["hidden"]), jnp.asarray(inp["attention_mask"]),
              *(jnp.asarray(inp[k]) for k in ARGS[1:]), interpret=True, **kw)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    q, k, v = (torch.einsum("blh,hnd->bnld", t["hidden"], t["qkv_kernel"][:, i])
               + t["qkv_bias"][i][None, :, None] for i in range(3))
    tables = ba.bigbird_tables(L // BLOCK, G, r, 3, "cpu")
    got, _ = tb.bigbird_rows_model(q * HD**-0.5, k, v, t["attention_mask"].sum(1), tables,
                                   block_size=BLOCK)
    live = inp["attention_mask"].astype(bool)
    want = np.asarray(want)[live]
    np.testing.assert_allclose(got.reshape(B, L, H).numpy()[live], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L,n_valid,cluster", [(512, 300, 0), (512, 300, 8), (2048, 1500, 0),
                                               (4096, 3100, 0), (4096, 3100, 8), (512, 40, 3)])
def test_global_rows_summed_over_the_cluster_ranges_match_the_model(dt, L, n_valid, cluster):
    """The card splits a global query tile's keys over a cluster of blocks
    (``global_cluster``: in bf16 1 at L=512, 2 at 2048 and 4096, blocks of
    64 with 2 global and 3 random blocks, in float32 1; or ``cluster``, the
    other sizes that csrc's ClusterRows takes) that walk
    ``global_key_ranges``: each block
    forms D and P.V over its range against the row's maximum over all ranges,
    and the first adds them in rank order. The ranges cover [0, n_valid) in
    order (some empty with more blocks than key tiles); the maxima over them
    are the model's bits, and the rank-order sums agree with
    bigbird_rows_model's dense ones (m, D, ctx of the global rows) within
    float32 rounding."""
    from spokennlp_tpu_torch.ops.cuda import attention_models as am

    C, nh, hd, GC = 64, 2, 16, 2 * 64
    cs = cluster or tb.global_cluster(L, C, 2, 3, dt)
    assert cs == cluster or cs == (1 if dt == torch.float32 else {512: 1, 2048: 2, 4096: 2}[L])
    ranges = tb.global_key_ranges(n_valid, cs)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_valid and len(ranges) == cs
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    g = torch.Generator().manual_seed(L + n_valid + cs)
    q, k, v = (torch.randn(1, nh, L, hd, generator=g).to(dt) for _ in range(3))
    q = (q.float() * hd**-0.5).to(dt)
    tables = ba.bigbird_tables(L // C, 2, 3, 0, "cpu")
    ctx, stats = tb.bigbird_rows_model(q, k, v, torch.tensor([n_valid]), tables, block_size=C,
                                       ctx_dtype=torch.float32)
    s = am.core_product(q[0, :, :GC].float(), k[0].float().transpose(-1, -2))  # (nh, GC, L)
    allowed = (torch.arange(L) < n_valid)[None, None]
    m, e = am.rows_softmax(s, allowed, dt)
    ninf = torch.tensor(-torch.inf)
    part_m = [torch.where(allowed[..., k0:k1], s[..., k0:k1], ninf).amax(-1)
              for k0, k1 in ranges if k1 > k0]
    assert torch.equal(torch.stack(part_m).amax(0), stats[0, 0, :, :GC])
    D = O = None
    for k0, k1 in ranges:  # rank order
        d, o = e[..., k0:k1].sum(-1), am.core_product(e[..., k0:k1], v[0, :, k0:k1].float())
        D, O = (d, o) if D is None else (D + d, O + o)
    torch.testing.assert_close(D, stats[1, 0, :, :GC], rtol=2e-6, atol=0)
    want = ctx[0, :GC].transpose(0, 1)  # (nh, GC, hd)
    torch.testing.assert_close(O / D[..., None], want, rtol=0, atol=2e-6 * want.abs().max())


@pytest.mark.parametrize("rate,r", [(0.0, 3), (0.1, 3), (0.1, 0)])
def test_rows_model_statistics_match_autograd_of_plain_softmax(rate, r):
    """float32: bigbird_rows_model's statistics against the plain softmax
    over each row's allowed keys (its regions of bigbird_model_regions): m
    its maximum, m + log D its logsumexp, and rowsum(dp p_eff) / (D
    keep_prob) = sum_k p_k dL/dp_k from autograd of ctx = (kept p /
    keep_prob) . v with the cotangent dctx; to 1e-5 of the largest."""
    Lm, C, nh, hd = 128, 16, 2, 16
    rng = np.random.default_rng(26 + r)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    n_valid = torch.tensor([Lm, 70])
    q, k, v = (f(2, nh, Lm, hd) for _ in range(3))
    dctx = f(2, Lm, nh, hd) * (torch.arange(Lm)[None] < n_valid[:, None])[..., None, None]
    tables = ba.bigbird_tables(Lm // C, G, r, 4, "cpu")
    keep = (tb.bigbird_keep_masks(torch.tensor([6], dtype=torch.int32), 2, nh, Lm, C, tables.G,
                                  tables.R, rate) if rate else None)
    _, stats = tb.bigbird_rows_model(q, k, v, n_valid, tables, block_size=C, dctx=dctx,
                                     dropout_rate=rate, keep=keep)
    rand, rok = tables.rand.numpy(), tables.rok.numpy()
    reg = torch.from_numpy(tb.bigbird_model_regions(Lm, C, tables.G, tables.R, rand, rok))
    for b in range(2):
        allowed = (reg > 0) & (torch.arange(Lm) < int(n_valid[b]))[None]
        s = torch.where(allowed, q[b] @ k[b].transpose(-1, -2), -torch.inf)
        p = torch.softmax(s, -1).requires_grad_()
        kept = p if keep is None else torch.where(
            tb._bigbird_dense_keep(keep, b, reg, C, tables.G, tables.R, rand, rok), p, 0.0)
        (gp,) = torch.autograd.grad(kept / (1.0 - rate) @ v[b], p, dctx[b].transpose(0, 1))
        for got, want in ((stats[0, b], s.amax(-1)),
                          (stats[0, b] + stats[1, b].log(), torch.logsumexp(s, -1)),
                          (stats[2, b], (p * gp).sum(-1))):
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=0,
                                       atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("fault", chip_smoke.ROWS_FAULTS)
def test_rows_gate_rejects_the_planted_faults(fault):
    """chip_smoke's limits of the rows kernels (ROWS_TOL) reject each planted
    fault of the rounding model in bf16 at L=256 in blocks of 32 (2 global,
    3 random): ctx and the statistics at rate 0.1, and the W8A8 mode's
    float32 ctx, the model with the fault read against the model."""
    Lm, C, nh, hd = 256, 32, 2, 64
    sm = hd**-0.5
    rng = np.random.default_rng(25)
    f = lambda *s, scale=1.0: torch.from_numpy(rng.normal(size=s).astype(np.float32) * scale)
    n_valid = torch.tensor([Lm, 200])
    q, k, v = (f(2, nh, Lm, hd, scale=sc).to(torch.bfloat16) for sc in (sm, 1.0, 1.0))
    dctx = (f(2, Lm, nh, hd) * (torch.arange(Lm)[None] < n_valid[:, None])[..., None, None])
    tables = ba.bigbird_tables(Lm // C, G, R, 4, "cpu")
    keep = tb.bigbird_keep_masks(torch.tensor([5], dtype=torch.int32), 2, nh, Lm, C, tables.G,
                                 tables.R, 0.1)
    for rate, ctx_dtype, dc in ((0.1, None, dctx.to(torch.bfloat16)), (0.0, torch.float32, None)):
        model = lambda: tb.bigbird_rows_model(q, k, v, n_valid, tables, block_size=C, dctx=dc,
                                              dropout_rate=rate, keep=keep if rate else None,
                                              ctx_dtype=ctx_dtype)
        want = model()
        if dc is None:
            want = (want[0], None)
        with chip_smoke.planted(chip_smoke.rows_faults("bigbird_rows")[fault]):
            bad = model()
        tol = chip_smoke.rows_tol(want)
        assert chip_smoke.core_bwd_excess(chip_smoke.rows_readings(want, bad), tol) > 1
        assert chip_smoke.core_bwd_excess(chip_smoke.rows_readings(want, want), tol) == 0


def test_explicit_backward_with_model_core_matches_jax_kernel_vjp_in_bf16():
    """bf16: the explicit plain backward with its core's gradient from the
    rounding model against the TPU kernel's custom VJP in interpret mode,
    both in bf16, to BF16_RTOL of each gradient's largest magnitude."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_bigbird import bigbird_attention_block_train as jt

    inp = _inputs(B, 64, H, NH, seed=14, n_valid=50)
    kw = dict(block_size=BLOCK, num_global_blocks=G, num_random_blocks=R, pattern_seed=4)
    mask = jnp.asarray(inp["attention_mask"])
    bf16 = lambda k: jnp.asarray(inp[k]).astype(jnp.bfloat16 if k == "hidden" else jnp.float32)
    _, vjp = jax.vjp(lambda h, *p: jt(h, mask, *p, jnp.zeros((1,), jnp.int32), HD**-0.5,
                                      dropout_rate=0.0, interpret=True, **kw),
                     *(bf16(k) for k in ARGS))
    want = vjp(jnp.asarray(inp["cotangent"]).astype(jnp.bfloat16))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = tb.bigbird_train_bwd_plain(
        t["hidden"].bfloat16(), t["attention_mask"], *(t[k] for k in ARGS[1:4]),
        t["cotangent"].bfloat16(), sm_scale=HD**-0.5, model_core=True, **kw)
    assert got[0].dtype == torch.bfloat16
    for name, g, w in zip(ARGS, got, want):
        w = np.asarray(w.astype(jnp.float32)).reshape(g.shape)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=BF16_RTOL * np.abs(w).max() + 1e-12, err_msg=name)


# ------------------------------- the float32 cores on the 3xTF32 model (CPU)


@pytest.mark.parametrize("L,n_valid,r", [(64, 45, 3), (64, 50, 0)])
def test_float32_models_on_the_tf32x3_model_match_jax_kernel_vjp(L, n_valid, r):
    """Row 13's float32 rounding models (bigbird_rows_model,
    bigbird_core_bwd_model), their products on the 3xTF32 model, assembled
    into the block with its projections on the same model: the output
    (bigbird_rows_model on the projections, then the out projection) and the
    explicit backward with its core's gradient from the model (model_core)
    against JAX's bigbird_attention_block_train and its VJP (interpret
    mode, rate 0) in float32, within 1e-5 of each output's largest magnitude
    (real rows of the output)."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.train_bigbird import bigbird_attention_block_train as jt
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tbl

    inp = _inputs(B, L, H, NH, seed=L + n_valid + 71, n_valid=n_valid)
    kw = dict(block_size=BLOCK, num_global_blocks=G, num_random_blocks=r, pattern_seed=4)
    mask = jnp.asarray(inp["attention_mask"])
    out, vjp = jax.vjp(lambda h, *p: jt(h, mask, *p, jnp.zeros((1,), jnp.int32), HD**-0.5,
                                        dropout_rate=0.0, interpret=True, **kw),
                       *(jnp.asarray(inp[k]) for k in ARGS))
    want = [out, *vjp(jnp.asarray(inp["cotangent"]))]
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    sm, tables = HD**-0.5, ba.bigbird_tables(L // BLOCK, G, r, 4, "cpu")
    heads = lambda z: z.transpose(1, 2)
    with chip_smoke.planted(_tf32x3_everywhere()):
        p = tbl.backward_product(t["hidden"].reshape(-1, H), t["qkv_kernel"].reshape(H, -1))
        p = (p + t["qkv_bias"].reshape(-1)).reshape(B, L, 3, NH, HD)
        ctx, _ = tb.bigbird_rows_model(heads(p[:, :, 0] * sm), heads(p[:, :, 1]),
                                       heads(p[:, :, 2]), t["attention_mask"].sum(1), tables,
                                       block_size=BLOCK)
        o = tbl.backward_product(ctx.reshape(B * L, -1), t["out_kernel"].reshape(-1, H))
        got = [(o + t["out_bias"]).reshape(B, L, H)] + list(tb.bigbird_train_bwd_plain(
            t["hidden"], t["attention_mask"], *(t[k] for k in ARGS[1:4]), t["cotangent"],
            sm_scale=sm, model_core=True, **kw))
    live = inp["attention_mask"].astype(bool)
    got[0], want[0] = got[0].numpy()[live], np.asarray(want[0])[live]
    for name, g, w in zip(("out",) + ARGS, got, want):
        g = np.asarray(g)
        w = np.asarray(w).reshape(g.shape)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("gate", ["rows", "dproj"])
def test_float32_core_gates_reject_plain_tf32(gate):
    """chip_smoke's float32 gates of row 13's cores, fed outputs whose core
    products are exact float32 (they differ from the 3xTF32 model by float32
    rounding, as the kernels' sums do), pass them and reject
    chip_smoke.F32_CORE_FAULT (plain TF32 in the model's core products) and
    the model with a random key block dropped, at L=128 in blocks of 16 (2
    global, 3 random), rate 0.1: the rows kernel's ctx and statistics
    (ROWS_TOL["float32"], check_rows with f32) and the gradient kernels'
    dproj (F32_BWD_CORE_TOL, check_f32_backward_cores). Each check raises
    where it accepts a fault."""
    Lm, C, nh, hd = 128, 16, 2, 64
    sm = hd**-0.5
    rng = np.random.default_rng(73)
    f = lambda *s, scale=1.0: torch.from_numpy(rng.normal(size=s).astype(np.float32) * scale)
    n_valid = torch.tensor([Lm, 100])
    q, k, v = (f(2, nh, Lm, hd, scale=sc) for sc in (sm, 1.0, 1.0))
    dctx = f(2, Lm, nh, hd) * (torch.arange(Lm)[None] < n_valid[:, None])[..., None, None]
    tables = ba.bigbird_tables(Lm // C, G, R, 4, "cpu")
    keep = tb.bigbird_keep_masks(torch.tensor([7], dtype=torch.int32), 2, nh, Lm, C, tables.G,
                                 tables.R, 0.1)
    if gate == "rows":
        model = lambda: tb.bigbird_rows_model(q, k, v, n_valid, tables, block_size=C, dctx=dctx,
                                              dropout_rate=0.1, keep=keep)
        gated = chip_smoke.check_rows("bigbird_rows float32", "bigbird_rows", model(), model,
                                      f32=True)
        assert set(gated["faults"]) == {chip_smoke.ROWS_FAULTS[1], chip_smoke.F32_CORE_FAULT}
    else:
        model = lambda: torch.stack(tb.bigbird_core_bwd_model(
            q, k, v, dctx, n_valid, tables, block_size=C, sm_scale=sm, dropout_rate=0.1,
            keep=keep), 2).reshape(2 * Lm, -1)
        gated = chip_smoke.check_f32_backward_cores("bigbird_train_bwd", model(), model, nh * hd)
        assert gated["reading"] <= chip_smoke.F32_BWD_CORE_TOL[0] and len(gated["faults"]) == 2


def test_float32_forward_and_tol_gates_reject_plain_tf32():
    """Kernel 8's and row 13's float32 gates on their plain versions, fed the
    plain versions with exact float32 products: F32_FWD_TOL with the core on
    the 3xTF32 model (check_f32_forward with core) rejects
    chip_smoke.F32_CORE_FAULT, and so does F32_TOL on row 13's output and
    gradients against autograd of its plain version with the fault in the
    core's products, forward and backward (f32_tol_fault), at L=128 in
    blocks of 16 (2 global, 3 random), rate 0.1."""
    Lm, Hm, nh, C = 128, 64, 2, 16
    inp = _inputs(2, Lm, Hm, nh, seed=75, n_valid=100)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    tables = ba.bigbird_tables(Lm // C, G, R, 4, "cpu")
    keep = tb.bigbird_keep_masks(torch.tensor([75], dtype=torch.int32), 2, nh, Lm, C, tables.G,
                                 tables.R, 0.1)
    pattern = dict(block_size=C, num_global_blocks=G, num_random_blocks=R)
    live = t["attention_mask"].bool()
    blk = lambda **ln: bb.bigbird_block_plain(t["hidden"], t["attention_mask"],
                                              *(t[k] for k in ARGS[1:]), **pattern, seed=4,
                                              sm_scale=(Hm // nh)**-0.5, **ln)[live]
    ln = dict(ln_scale=t["ln_scale"], ln_bias=t["ln_bias"])
    gated = chip_smoke.check_f32_forward("bigbird_attention_block",
                                         {"out": blk(**ln), "projection": blk()},
                                         lambda: {"out": blk(**ln), "projection": blk()},
                                         core=True)
    assert gated["core_fault_excess"] > 1

    def run(patches):
        leaves = [t[k].detach().requires_grad_() for k in ARGS]
        with chip_smoke.planted(patches):
            out = tb.bigbird_train_plain(leaves[0], t["attention_mask"], *leaves[1:], **pattern,
                                         pattern_seed=4, sm_scale=(Hm // nh)**-0.5,
                                         dropout_rate=0.1, keep=keep)
            return [out, *torch.autograd.grad(out, leaves, t["cotangent"])]

    got = run([])
    gated = chip_smoke.f32_tol_fault(got, run(chip_smoke.core_products(chip_smoke.plain_tf32)),
                                     ("out",) + ARGS, "bigbird_train")
    assert min(gated.values()) > 1


# ------------------------------------------------------------------ dropout


def test_keep_masks_are_deterministic_disjoint_and_fair():
    seed = torch.tensor([20231018], dtype=torch.int32)
    Bm, nh, Lm, C, Gm, Rm, rate = 2, 3, 256, 16, 2, 3, 0.1
    masks = tb.bigbird_keep_masks(seed, Bm, nh, Lm, C, Gm, Rm, rate)
    again = tb.bigbird_keep_masks(seed, Bm, nh, Lm, C, Gm, Rm, rate)
    other = tb.bigbird_keep_masks(seed + 1, Bm, nh, Lm, C, Gm, Rm, rate)
    assert [tuple(m.shape) for m in masks] == [
        (Bm, nh, Lm // C, C, 3 * C), (Bm, nh, Lm, Gm * C), (Bm, nh, Lm, Rm * C),
        (Bm, nh, Gm * C, Lm)]
    for m, a, o in zip(masks, again, other):
        assert torch.equal(m, a) and not torch.equal(m, o)
        assert abs(m.float().mean().item() - (1 - rate)) < 1e-2
    # the four counter spaces differ where their (row, column) coincide: the
    # window's (row, key) against the global columns', the random blocks'
    # and the global rows' for rows and columns in [0, G C)
    win, gcol, rnd, grow = masks
    n = Gm * C
    win_abs = np.zeros((Bm, nh, n, n), bool)
    for row in range(n):  # window entry of row against key j: cj = j - (row - row % C) + C
        for j in range(max(0, row - row % C - C), min(n, row - row % C + 2 * C)):
            win_abs[:, :, row, j] = win[:, :, row // C, row % C, j - (row - row % C) + C].numpy()
    band = np.abs(np.arange(n)[:, None] // C - np.arange(n)[None] // C) <= 1
    for m in (gcol[:, :, :n, :n], rnd[:, :, :n, :n], grow[:, :, :n, :n]):
        assert (win_abs != m.numpy())[:, :, band].any()
    bits = [tb.philox_bits(7, 0, 1 | s, 3, 5) for s in (0, tb.GLOBAL_COL_STREAM,
                                                         tb.GLOBAL_ROW_STREAM, tb.RANDOM_STREAM)]
    assert len({int(b) for b in bits}) == 4


@pytest.mark.parametrize("L,n_valid", [(64, 45), (32, 20)])
def test_dropout_replays_the_keep_masks_on_cpu(L, n_valid):
    """At rate 0.1 the block equals the plain version given the four masks,
    another seed drops other probabilities, and every mask takes part."""
    inp = _inputs(B, L, H, NH, seed=7, n_valid=n_valid)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    seed = torch.tensor([99], dtype=torch.int32)
    kw = dict(sm_scale=HD**-0.5, block_size=BLOCK, num_global_blocks=G, num_random_blocks=R,
              pattern_seed=4, dropout_rate=0.1)
    args = (t["hidden"], t["attention_mask"], *(t[k] for k in ARGS[1:]))
    got = tb.bigbird_attention_block_train(*args, seed, **kw)
    tables = ba.bigbird_tables(L // BLOCK, G, R, 4, "cpu")
    keep = tb.bigbird_keep_masks(seed, B, NH, L, BLOCK, tables.G, tables.R, 0.1)
    want = tb.bigbird_train_plain(*args, keep=keep, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (tb.bigbird_attention_block_train(*args, seed + 1, **kw) - got).abs().max() > 1e-3
    # keeping one set whole changes the output (at nb = 4 no non-global block
    # holds a live random block)
    for i in (0, 1, 2, 3) if tables.rok[G:].any() else (0, 1, 3):
        whole = tuple(torch.ones_like(m) if j == i else m for j, m in enumerate(keep))
        assert (tb.bigbird_train_plain(*args, keep=whole, **kw) - got).abs().max() > 1e-4, i


def test_wrappers_on_cpu_count_no_launches_and_check_the_contract():
    before = (bb.fused_bigbird_attention_block.launches, tb.bigbird_train_fwd.launches,
              tb.bigbird_train_bwd.launches)
    inp = _inputs(B, 64, H, NH, seed=8)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    args = (t["hidden"], t["attention_mask"], *(t[k] for k in ARGS[1:]))
    bb.fused_bigbird_attention_block(*args, BLOCK, G, R, 0, HD**-0.5)
    tb.bigbird_attention_block_train(*args, torch.zeros(1, dtype=torch.int32), HD**-0.5, BLOCK,
                                     G, R, 0)
    got = bb.fused_bigbird_attention_block(*args, BLOCK, G, R, 0, HD**-0.5, quantized=True)
    want = bb.bigbird_block_plain(*args, BLOCK, G, R, 0, HD**-0.5, quantized=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)  # the W8A8 mode's plain version
    assert (bb.fused_bigbird_attention_block.launches, tb.bigbird_train_fwd.launches,
            tb.bigbird_train_bwd.launches) == before
    for L, C in ((60, 8), (64, 12), (64, 0)):
        with pytest.raises(ValueError, match="block_size"):
            bb.check_contract(L, C, "test")


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, L, H, nh, block, R, n_valid of the padded rows): blocks of 64 with nb =
# 4 (padded-self entries) and 8, blocks of 32 and 16 (a tile holds one block),
# of 128 and 96 (a block spans two tiles, the last one short), head dims 64,
# 16, 32 and 128, short rows (n_valid below the global blocks), no random
# blocks; and the slice's shapes
CARD_SHAPES = [(2, 256, 128, 2, 64, 3, 100), (2, 512, 64, 4, 64, 3, 70),
               (2, 256, 128, 4, 32, 3, 200), (2, 192, 256, 2, 16, 2, 150),
               (2, 512, 128, 1, 128, 3, 300), (2, 384, 128, 2, 96, 1, 250),
               (2, 512, 128, 2, 64, 0, 400)]
SLICE_SHAPES = [(4, 4096, 768, 12, 64, 3, 3100), (8, 2048, 768, 12, 64, 3, 1500)]


def _card_tensors(inp, device, dtype):
    t = {k: torch.from_numpy(v).to(device) for k, v in inp.items()}
    t["hidden"] = t["hidden"].to(dtype)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,C,r,nv", CARD_SHAPES + SLICE_SHAPES[:1])
def test_bigbird_block_kernel_matches_plain_on_card(cuda, dtype, Bc, Lc, Hc, nh, C, r, nv):
    inp = _inputs(Bc, Lc, Hc, nh, seed=Lc + C, n_valid=nv)
    t = _card_tensors(inp, cuda, dtype)
    hd = Hc // nh
    pattern = (C, 2, r, 5, hd**-0.5)
    ln = dict(ln_scale=t["ln_scale"], ln_bias=t["ln_bias"])
    args = [t["hidden"], t["attention_mask"], *(t[k] for k in ARGS[1:])]
    n = bb.fused_bigbird_attention_block.launches
    got = bb.fused_bigbird_attention_block(*args, *pattern, **ln)
    torch.cuda.synchronize()
    assert bb.fused_bigbird_attention_block.launches == n + 1
    for i in (2, 4):  # the weights the kernel reads
        args[i] = args[i].to(dtype)
    want = bb.bigbird_block_plain(*args, *pattern, **ln)
    live = t["attention_mask"].bool()
    assert torch.isfinite(got).all()
    err = (got[live].float() - want[live].float()).abs().max() / want[live].float().abs().max()
    assert err.item() < CARD_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,C,r,nv", CARD_SHAPES + SLICE_SHAPES[1:])
def test_bigbird_train_kernels_match_plain_on_card(cuda, dtype, rate, Bc, Lc, Hc, nh, C, r, nv):
    inp = _inputs(Bc, Lc, Hc, nh, seed=Lc + C + 1, n_valid=nv)
    hd = Hc // nh
    seed = torch.tensor([11 + Lc], dtype=torch.int32, device=cuda)
    kw = dict(sm_scale=hd**-0.5, block_size=C, num_global_blocks=2, num_random_blocks=r,
              pattern_seed=6, dropout_rate=rate)

    def run(fn, weights_dtype=None, **extra):
        t = _card_tensors(inp, cuda, dtype)
        for k in ARGS:
            t[k] = (t[k].to(weights_dtype) if weights_dtype and k.endswith("kernel")
                    else t[k]).detach().requires_grad_()
        out = fn(t["hidden"], t["attention_mask"], *(t[k] for k in ARGS[1:]), **extra, **kw)
        grads = torch.autograd.grad(out, [t[k] for k in ARGS], t["cotangent"].to(out.dtype))
        return [out.detach(), *grads]

    n = (tb.bigbird_train_fwd.launches, tb.bigbird_train_bwd.launches)
    got = run(tb.bigbird_attention_block_train, seed=seed)
    torch.cuda.synchronize()
    assert (tb.bigbird_train_fwd.launches, tb.bigbird_train_bwd.launches) == (n[0] + 1, n[1] + 1)
    tables = ba.bigbird_tables(Lc // C, 2, r, 6, cuda)
    keep = (tb.bigbird_keep_masks(seed, Bc, nh, Lc, C, tables.G, tables.R, rate)
            if rate else None)
    want = run(tb.bigbird_train_plain, weights_dtype=dtype, keep=keep)
    live = torch.from_numpy(inp["attention_mask"]).bool().to(cuda)
    got[0], want[0] = got[0][live], want[0][live]
    for name, g, w in zip(("out",) + ARGS, got, want):
        assert torch.isfinite(g).all(), name
        err = ((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30)).item()
        assert err < CARD_TOL[dtype], (name, err)
    again = run(tb.bigbird_attention_block_train, seed=seed)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))  # deterministic backward


@pytest.mark.gpu
def test_keep_masks_on_card_match_numpy(cuda):
    seed = torch.tensor([4242], dtype=torch.int32)
    want = tb.bigbird_keep_masks(seed, 2, 3, 128, 16, 2, 3, 0.25)
    got = tb.bigbird_keep_masks(seed.to(cuda), 2, 3, 128, 16, 2, 3, 0.25)
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,C,r,nv", CARD_SHAPES + SLICE_SHAPES[1:])
def test_bigbird_gradient_kernels_match_rounding_model_on_card(cuda, rate, Bc, Lc, Hc, nh, C, r,
                                                                nv):
    """bf16: the gradient kernels' dproj against bigbird_core_bwd_model on the
    kernel's own intermediates, within chip_smoke.BWD_CORE_TOL element by
    element and in norm in each slot; two runs give the same bits; each
    planted fault of the model fails the limits."""
    inp = _inputs(Bc, Lc, Hc, nh, seed=Lc + C + 3, n_valid=nv)
    t = _card_tensors(inp, cuda, torch.bfloat16)
    hd = Hc // nh
    w = bb.card_weights(t["qkv_kernel"], t["qkv_bias"], t["out_kernel"], torch.bfloat16)
    seed = torch.tensor([9], dtype=torch.int32, device=cuda)
    tables = ba.bigbird_tables(Lc // C, 2, r, 6, cuda)
    runs = [{}, {}]
    for bufs in runs:
        tb.bigbird_train_bwd(t["hidden"], t["attention_mask"], seed, w,
                             t["cotangent"].to(torch.bfloat16), tables, num_heads=nh,
                             block_size=C, sm_scale=hd**-0.5, dropout_rate=rate, buffers=bufs)
    keep = (tb.bigbird_keep_masks(seed, Bc, nh, Lc, C, tables.G, tables.R, rate)
            if rate else None)
    model = lambda: tb.bigbird_core_model_dproj(runs[0], tables, block_size=C,
                                                sm_scale=hd**-0.5, dropout_rate=rate, keep=keep)
    readings = chip_smoke.core_bwd_readings(runs[0]["dproj"], model(), nh * hd)
    print(f"{Bc}x{Lc} hd {hd} block {C} R {r} rate {rate}: {readings}")
    tol = chip_smoke.BWD_CORE_TOL["bigbird_train_bwd"]
    assert chip_smoke.core_bwd_excess(readings, tol) <= 1, readings
    assert torch.equal(runs[0]["dproj"], runs[1]["dproj"])
    for fault, patches in chip_smoke.core_bwd_faults("bigbird_train_bwd").items():
        with chip_smoke.planted(patches):
            bad = chip_smoke.core_bwd_readings(runs[0]["dproj"], model(), nh * hd)
        print(f"  {fault}: {bad}")
        assert chip_smoke.core_bwd_excess(bad, tol) > 1, (fault, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "w8a8", "stats"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,C,r,nv", CARD_SHAPES)
def test_bigbird_rows_kernel_matches_rounding_model_on_card(cuda, mode, rate, Bc, Lc, Hc, nh, C,
                                                            r, nv):
    """bf16: bigbird_rows_kernel alone (tb.bigbird_rows) on the q, k, v,
    counts and dctx of a backward of the block against bigbird_rows_model
    within chip_smoke.ROWS_TOL, in each mode: a bf16 ctx, the W8A8 block's
    float32 ctx, and the statistics pass (bf16 ctx and the statistics, which
    must equal the backward's own); two runs give the same bits; each
    planted fault of the model fails the limits."""
    inp = _inputs(Bc, Lc, Hc, nh, seed=Lc + C + 7, n_valid=nv)
    t = _card_tensors(inp, cuda, torch.bfloat16)
    hd = Hc // nh
    w = bb.card_weights(t["qkv_kernel"], t["qkv_bias"], t["out_kernel"], torch.bfloat16)
    seed = torch.tensor([13], dtype=torch.int32, device=cuda)
    tables = ba.bigbird_tables(Lc // C, 2, r, 6, cuda)
    bufs = {}
    tb.bigbird_train_bwd(t["hidden"], t["attention_mask"], seed, w,
                         t["cotangent"].to(torch.bfloat16), tables, num_heads=nh, block_size=C,
                         sm_scale=hd**-0.5, dropout_rate=rate, buffers=bufs)
    qkv, counts = bufs["qkv"], bufs["counts"]
    dctx = bufs["dctx"] if mode == "stats" else None
    cdt = torch.float32 if mode == "w8a8" else None
    runs = [tb.bigbird_rows(qkv, counts, seed, tables, block_size=C, dctx=dctx,
                            dropout_rate=rate, ctx_dtype=cdt) for _ in range(2)]
    if mode == "stats":
        assert torch.equal(runs[0][1], bufs["stats"])
        assert torch.equal(runs[0][0].reshape(Bc * Lc, -1), bufs["ctx"])
    keep = (tb.bigbird_keep_masks(seed, Bc, nh, Lc, C, tables.G, tables.R, rate)
            if rate else None)
    model = lambda: tb.bigbird_rows_model(
        qkv[0], qkv[1], qkv[2], counts.long()[:, 0], tables, block_size=C, dropout_rate=rate,
        keep=keep, ctx_dtype=cdt, dctx=None if dctx is None else dctx.reshape(Bc, Lc, nh, hd))
    readings = chip_smoke.rows_readings(runs[0], model())
    print(f"{Bc}x{Lc} hd {hd} block {C} R {r} {mode} rate {rate}: {readings}")
    tol = chip_smoke.rows_tol(runs[0])
    assert chip_smoke.core_bwd_excess(readings, tol) <= 1, readings
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(*runs))
    for fault, patches in chip_smoke.rows_faults("bigbird_rows").items():
        with chip_smoke.planted(patches):
            bad = chip_smoke.rows_readings(runs[0], model())
        print(f"  {fault}: {bad}")
        assert chip_smoke.core_bwd_excess(bad, tol) > 1, (fault, bad)


# (B, L, H, nh, block, R, n_valid of the padded rows) of the global tiles'
# cluster cases: 5 key tiles of 300 real keys, blocks of 96 (a global block
# spans two query tiles, the second short), L=2048 (clusters of 2 in bf16)
CLUSTER_SHAPES = [(2, 512, 128, 2, 64, 3, 300), (2, 384, 128, 2, 96, 1, 250),
                  (2, 2048, 128, 2, 64, 3, 1500)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "w8a8", "stats", "f32", "f32 stats"])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,C,r,nv", CLUSTER_SHAPES)
def test_bigbird_global_tiles_split_over_a_cluster_on_card(cuda, mode, Bc, Lc, Hc, nh, C, r, nv):
    """bigbird_rows_kernel as the blocks launch it (in bf16 at L=2048 a
    global tile's keys split over a cluster of 2 blocks, else one block a
    tile) against the rows kernels' rounding model: ctx and the statistics
    within its limits, and two calls give the same bits; the global and
    the window tiles launched apart (``parts``; the window tiles alone one
    block a tile, without clusters) give the launch's bits, so the window
    rows do not depend on the split."""
    dt = torch.float32 if mode.startswith("f32") else torch.bfloat16
    inp = _inputs(Bc, Lc, Hc, nh, seed=Lc + C + 29, n_valid=nv)
    t = _card_tensors(inp, cuda, dt)
    hd, GC = Hc // nh, 2 * C
    w = bb.card_weights(t["qkv_kernel"], t["qkv_bias"], t["out_kernel"], dt)
    seed = torch.tensor([17], dtype=torch.int32, device=cuda)
    tables = ba.bigbird_tables(Lc // C, 2, r, 6, cuda)
    bufs = {}
    tb.bigbird_train_bwd(t["hidden"], t["attention_mask"], seed, w, t["cotangent"].to(dt),
                         tables, num_heads=nh, block_size=C, sm_scale=hd**-0.5, dropout_rate=0.1,
                         buffers=bufs)
    qkv, counts = bufs["qkv"], bufs["counts"]
    dctx = bufs["dctx"].reshape(Bc, Lc, Hc) if mode.endswith("stats") else None
    cdt = torch.float32 if mode == "w8a8" else None
    rows = lambda p="all": tb.bigbird_rows(qkv, counts, seed, tables, block_size=C, dctx=dctx,
                                           dropout_rate=0.1, ctx_dtype=cdt, parts=p)
    keep = tb.bigbird_keep_masks(seed, Bc, nh, Lc, C, tables.G, tables.R, 0.1)
    with chip_smoke.planted(chip_smoke.core_products(chip_smoke.tf32x3_model)
                            if dt == torch.float32 else []):
        model = tb.bigbird_rows_model(
            qkv[0], qkv[1], qkv[2], counts.long()[:, 0], tables, block_size=C,
            dropout_rate=0.1, keep=keep, ctx_dtype=cdt,
            dctx=None if dctx is None else dctx.reshape(Bc, Lc, nh, hd))
    runs = [rows(), rows()]
    torch.cuda.synchronize()
    got = runs[0]
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(*runs))
    readings = chip_smoke.rows_readings(got if dctx is not None else (got[0], None),
                                        model if dctx is not None else (model[0], None))
    print(f"{Bc}x{Lc} block {C} {mode} cluster "
          f"{tb.global_cluster(Lc, C, 2, r, dt)}: {readings}")
    assert chip_smoke.core_bwd_excess(readings, chip_smoke.rows_tol(got)) <= 1, readings
    parts = {p: rows(p) for p in ("global", "window")}
    torch.cuda.synchronize()
    assert torch.equal(parts["global"][0][:, :GC], got[0][:, :GC])
    assert torch.equal(parts["window"][0][:, GC:], got[0][:, GC:])
    if dctx is not None:
        assert torch.equal(parts["global"][1][..., :GC], got[1][..., :GC])
        assert torch.equal(parts["window"][1][..., GC:], got[1][..., GC:])


@pytest.mark.gpu
@pytest.mark.parametrize("rate,b", [(0.0, 1), (0.1, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bigbird_rows_do_not_depend_on_the_batch_on_card(cuda, dtype, rate, b):
    """At L=2048 (clusters of 2) one sequence's ctx and statistics are the
    same bits alone (B=1) and as row b of B=3, global rows included: the
    global tiles' split depends on L, never on B. With dropout the sequence
    keeps its index (row 0), since the keep bits' counters hold it."""
    Bc, Lc, nh, hd, C = 3, 2048, 2, 64, 64
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(3, Bc, nh, Lc, hd, generator=g, device=cuda)
    qkv[0] *= hd**-0.5
    qkv = qkv.to(dtype)
    dctx = torch.randn(Bc, Lc, nh * hd, generator=g, device=cuda).to(dtype)
    counts = torch.tensor([[1900, 0], [1500, 0], [700, 0]], dtype=torch.int32, device=cuda)
    seed = torch.tensor([23], dtype=torch.int32, device=cuda)
    tables = ba.bigbird_tables(Lc // C, 2, 3, 6, cuda)
    kw = dict(block_size=C, dropout_rate=rate)
    ctx3, st3 = tb.bigbird_rows(qkv, counts, seed, tables, dctx=dctx, **kw)
    ctx1, st1 = tb.bigbird_rows(qkv[:, b:b + 1].contiguous(), counts[b:b + 1].contiguous(), seed,
                                tables, dctx=dctx[b:b + 1].contiguous(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(ctx1[0], ctx3[b])
    assert torch.equal(st1[:, 0], st3[:, b])


# float32 (3xTF32) cases (B, L, H, nh, block, R, n_valid of the padded
# rows): L not a multiple of 64 (7 blocks of 32), blocks of 96 (a block spans
# two tiles, the last one short) and 16 (head dim 16), head dims 64 and 128,
# with 0 and 3 random blocks
F32_CARD_SHAPES = [(2, 224, 128, 2, 32, 3, 150), (2, 384, 128, 2, 96, 0, 250),
                   (2, 192, 64, 4, 16, 3, 150), (2, 512, 256, 2, 64, 3, 300),
                   (2, 1024, 128, 2, 64, 0, 700)]


def _f32_backward(cuda, Bc, Lc, Hc, nh, C, r, nv, rate, seed):
    """Two float32 backwards of the block on the card: (their buffers, the
    seed, the tables, the keep masks)."""
    inp = _inputs(Bc, Lc, Hc, nh, seed=seed, n_valid=nv)
    t = _card_tensors(inp, cuda, torch.float32)
    w = bb.card_weights(t["qkv_kernel"], t["qkv_bias"], t["out_kernel"], torch.float32)
    dseed = torch.tensor([seed], dtype=torch.int32, device=cuda)
    tables = ba.bigbird_tables(Lc // C, 2, r, 6, cuda)
    runs = [{}, {}]
    for bufs in runs:
        tb.bigbird_train_bwd(t["hidden"], t["attention_mask"], dseed, w, t["cotangent"], tables,
                             num_heads=nh, block_size=C, sm_scale=(Hc // nh)**-0.5,
                             dropout_rate=rate, buffers=bufs)
    keep = (tb.bigbird_keep_masks(dseed, Bc, nh, Lc, C, tables.G, tables.R, rate)
            if rate else None)
    return runs, dseed, tables, keep


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fwd", "stats"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,C,r,nv", F32_CARD_SHAPES)
def test_float32_bigbird_rows_kernel_matches_tf32x3_model_on_card(cuda, mode, rate, Bc, Lc, Hc,
                                                                   nh, C, r, nv):
    """float32 (3xTF32): bigbird_rows_kernel alone on the q, k, v, counts and
    dctx of a backward of the block against bigbird_rows_model on the
    3xTF32 model within chip_smoke.ROWS_TOL (check_rows, which also fails
    where the model with a key block dropped or with F32_CORE_FAULT
    passes); the statistics pass equals the backward's own statistics and
    ctx; two runs give the same bits."""
    hd = Hc // nh
    (bufs, _), seed, tables, keep = _f32_backward(cuda, Bc, Lc, Hc, nh, C, r, nv, rate,
                                                  Lc + C + 19)
    qkv, counts = bufs["qkv"], bufs["counts"]
    dctx = bufs["dctx"].reshape(Bc, Lc, Hc) if mode == "stats" else None
    runs = [tb.bigbird_rows(qkv, counts, seed, tables, block_size=C, dctx=dctx,
                            dropout_rate=rate) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(*runs))
    if mode == "stats":
        assert torch.equal(runs[0][1], bufs["stats"])
        assert torch.equal(runs[0][0].reshape(Bc * Lc, -1), bufs["ctx"])
    model = lambda: tb.bigbird_rows_model(
        qkv[0], qkv[1], qkv[2], counts.long()[:, 0], tables, block_size=C, dropout_rate=rate,
        keep=keep, dctx=None if dctx is None else dctx.reshape(Bc, Lc, nh, hd))
    got = runs[0] if dctx is not None else (runs[0][0], None)
    wanted = (lambda: model()) if dctx is not None else (lambda: (model()[0], None))
    chip_smoke.check_rows(f"bigbird_rows float32 {Bc}x{Lc} block {C} R {r} {mode} rate {rate}",
                          "bigbird_rows", got, wanted, f32=True)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Bc,Lc,Hc,nh,C,r,nv", F32_CARD_SHAPES)
def test_float32_bigbird_gradient_kernels_match_tf32x3_model_on_card(cuda, rate, Bc, Lc, Hc, nh,
                                                                      C, r, nv):
    """float32 (3xTF32): the gradient kernels' dproj (bigbird_dq,
    bigbird_dkv on float32 dS tiles) against bigbird_core_model_dproj on the
    3xTF32 model within chip_smoke.F32_BWD_CORE_TOL in each slot
    (check_f32_backward_cores, which also fails where F32_CORE_FAULT or the
    dropped key block passes); two runs give the same bits."""
    hd = Hc // nh
    runs, _, tables, keep = _f32_backward(cuda, Bc, Lc, Hc, nh, C, r, nv, rate, Lc + C + 23)
    assert torch.equal(runs[0]["dproj"], runs[1]["dproj"])
    model = lambda: tb.bigbird_core_model_dproj(runs[0], tables, block_size=C,
                                                sm_scale=hd**-0.5, dropout_rate=rate, keep=keep)
    chip_smoke.check_f32_backward_cores(
        "bigbird_train_bwd", runs[0]["dproj"], model, Hc,
        f"bigbird_train_bwd {Bc}x{Lc} block {C} R {r} rate {rate}")
