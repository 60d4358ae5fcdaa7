"""Port kernels: plain versions against the JAX kernels on the CPU, and the
CUDA kernels against the plain versions on the card (``-m gpu``).

JAX is imported inside the CPU tests only, so the card tests (``-m gpu``) do
not depend on it.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.ops.cuda.attention_block import (
    attention_block_plain,
    attention_core,
    attention_core_plain,
    fused_attention_block,
)
from spokennlp_tpu_torch.ops.cuda.blhd_attention import (
    reference_snld_attention,
    snld_attention_plain,
    snld_self_attention,
)
from spokennlp_tpu_torch.ops.cuda.int8_matmul import (
    ACTIVATIONS,
    int8_product,
    quantize_colwise,
    rowquant_plain,
)
from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain
from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the planted faults of the core's card gate)

# Tolerances. CPU: the plain float32 versions against the JAX kernels in
# interpret mode, as tests/test_attention_block.py compares them. Card,
# float32: the same math summed in another order. Card, bfloat16: both sides
# get the same bf16 inputs and weights; the kernels also round q, k, v, the
# probabilities and ctx (or the MLP intermediate) to bf16 (unit roundoff
# 2^-9 each) where the plain version stays in float32, on LayerNorm outputs
# of unit scale; chip_smoke.BF16_TOL gives each kernel's limit, from the
# H100 readings of this PR's tensor-core tile, and its reasons
# (test_bf16_limit_rejects_planted_faults holds it against two faults of a
# GEMM tile). The float32 limit comes from the H100 readings of kernels 1
# and 2 in chip_smoke.py (PERF.md: 1.4e-6 at most), about a hundred times the
# largest: an attention block that rounds its probabilities to bf16
# (test_f32_limit_rejects_bf16_probabilities) lands an order of magnitude
# beyond it, where it landed just beyond the old 1e-3.
CPU_TOL = dict(atol=5e-3, rtol=1e-2)
CARD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4)}


def _card_tol(kernel, dtype):
    """assert_close's limits of kernel 1 or 2 against its plain version."""
    if dtype == torch.float32:
        return CARD_TOL[dtype]
    atol, rtol = chip_smoke.BF16_TOL[kernel]
    return dict(atol=atol, rtol=rtol)
# W8A8 modes, plain version against the JAX kernel in interpret mode in
# float32: the same integer products and float32 epilogues, so 1e-5, except
# where a float32 sum of another order moves a value across an int8 rounding
# boundary: one int8 step of a row (1/127 of its absmax) then moves a few
# outputs by up to about 1e-2. At most W8A8_FLIPS of the outputs may do so.
# On the card in bfloat16 both sides round the output to bf16 (2^-7 |ref|),
# and the kernel's online softmax rounds the probabilities to bf16 against a
# running max, the plain version against the row's: ctx then rounds
# otherwise now and then, and each ctx value that takes another int8 step
# moves its row's outputs by about 1e-3. So bf16 outputs agree within
# BF16_W8A8_TOL + 2^-7 |ref| but for at most BF16_W8A8_FLIPS of them.
# chip_smoke.py holds the blocks at the main path's shapes the same way.
W8A8_TOL, W8A8_STEP_TOL, W8A8_FLIPS = 1e-5, 2e-2, 0.01
BF16_W8A8_TOL, BF16_W8A8_FLIPS = 2e-3, 0.002
# The dense core against its own rounding model (snld_attention_plain) on
# the card: the same roundings, float32 sums in another order, so in bf16
# the outputs differ by at most one bf16 step of the largest one (2^-7 of
# max |ctx|), plus CORE_ATOL for an exponent whose bf16 rounding another
# sum order flipped (it moves a context by about 1e-5 at these scales); in
# float32 by float32 rounding, held to CORE_F32_REL of max |ctx| (kernel
# 1's float32 limit) plus CORE_ATOL, which a core on TF32 or bf16 products
# would miss. chip_smoke.py's CORE_GATE holds the same limits. On the CPU
# the model against JAX's kernel in interpret mode, which rounds s - m
# against the row's max where the model rounds it against the running max:
# within the same 2^-7 of max |ctx| (measured: at most 2.6e-3 of it).
CORE_REL, CORE_F32_REL, CORE_ATOL = 2**-7, 1e-4, 1e-4
# Kernel 6 in float32 takes its exponent in bf16 while its 3xTF32 products
# sum in another order than the model's: it is held to the bf16 exponent's
# element-wise gate (CORE_REL, CORE_ATOL) and in norm to SNLD_F32_NORM of
# ||ctx|| (chip_smoke.SNLD_F32_GATE gives the readings).
SNLD_F32_NORM = 2e-4


def _snld_f32_gate(got, want):
    """Kernel 6's float32 gate: _core_gate at CORE_REL and the norm part."""
    _core_gate(got, want)
    norm = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert norm <= SNLD_F32_NORM, norm


def _core_rel(dtype):
    return CORE_F32_REL if dtype == torch.float32 else CORE_REL


def _core_model(dtype, fn, terms=3):
    """fn() with the cores' products (attention_models.core_product) on the
    3xTF32 model in float32, as the float32 core computes them (terms=1:
    plain TF32, chip_smoke.F32_CORE_FAULT)."""
    if dtype != torch.float32:
        return fn()
    stand_in = chip_smoke.tf32x3_model if terms == 3 else chip_smoke.plain_tf32
    with chip_smoke.planted(chip_smoke.core_products(stand_in)):
        return fn()


def _core_gate(got, want, rel=CORE_REL, atol=CORE_ATOL):
    """max |got - want| <= rel max |want| + atol."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item() + atol, err


def _ragged_segments(B, L, seed):
    """_segments' padding tails and packed windows (the first token always
    real), with the last key of every packed row a segment of its own (a
    query row with a single key) and, where B > 2, a last sequence with no
    real token."""
    seg = _segments(B, L, seed)
    seg[0, 0] = max(seg[0, 0], 1)
    for b in range(1, B, 2):
        n = int((seg[b] > 0).sum())
        if n > 2:
            seg[b, n - 1] = 3
    if B > 2:
        seg[-1] = 0
    return seg


def _segments(B, L, seed):
    """Padding tails on every row, and two packed windows on odd rows."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, L), np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L + 1))
        seg[b, :n] = 1
        if b % 2:
            seg[b, n // 2 : n] = 2
    return seg


def _attention_inputs(B, L, H, nh, hd, seed, ragged=False):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(
        hidden=f(B, L, H),
        segment_ids=(_ragged_segments if ragged else _segments)(B, L, seed),
        qkv_kernel=f(H, 3, nh, hd, scale=H**-0.5),
        qkv_bias=f(3, nh, hd, scale=0.02),
        out_kernel=f(nh, hd, H, scale=(nh * hd) ** -0.5),
        out_bias=f(H, scale=0.02),
        ln_scale=1.0 + f(H, scale=0.1),
        ln_bias=f(H, scale=0.1),
    )


def attention_block_bf16_probabilities(hidden, segment_ids, qkv_kernel, qkv_bias, out_kernel,
                                       out_bias, *, sm_scale, ln_scale, ln_bias, eps=1e-12):
    """A planted fault: the float32 attention block with its probabilities
    rounded to bf16 (2^-9 relative each)."""
    x = hidden.float()
    qkv = torch.einsum("blh,hsnd->blsnd", x, qkv_kernel.float()) + qkv_bias.float()
    q, k, v = qkv.unbind(2)
    scores = torch.einsum("blnd,bmnd->bnlm", q * sm_scale, k)
    allowed = (segment_ids[:, :, None] == segment_ids[:, None, :]) & (segment_ids[:, None, :] > 0)
    scores = scores + torch.where(allowed, 0.0, -1e9)[:, None]
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    ctx = torch.einsum("bnlm,bmnd->blnd", probs, v)
    out = torch.einsum("blnd,ndh->blh", ctx, out_kernel.float()) + out_bias.float()
    return torch.nn.functional.layer_norm(out + x, (x.shape[-1],), ln_scale, ln_bias, eps)


def _mlp_inputs(M, H, I, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(
        x=f(M, H), w1=f(H, I, scale=H**-0.5), b1=f(I, scale=0.02),
        w2=f(I, H, scale=I**-0.5), b2=f(H, scale=0.02),
        ln_scale=1.0 + f(H, scale=0.1), ln_bias=f(H, scale=0.1),
    )


def _torch(d, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


@pytest.fixture(scope="module")
def jx():
    """The JAX kernels the port is held against."""
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas import attention_block, blhd_attention, int8_matmul, mlp_block

    return SimpleNamespace(
        jnp=jnp,
        fused_attention_block=attention_block.fused_attention_block,
        reference_attention_block=attention_block.reference_attention_block,
        fused_mlp_block=mlp_block.fused_mlp_block,
        activations=int8_matmul._ACTIVATIONS,
        snld_self_attention=blhd_attention.snld_self_attention,
        reference_snld_attention=blhd_attention.reference_snld_attention,
        arrays=lambda d: {k: jnp.asarray(v) for k, v in d.items()},
    )


@pytest.mark.parametrize("fuse_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("L", [64, 48])
def test_attention_plain_matches_jax_kernel(jx, L, fuse_ln):
    B, H, nh, hd = 2, 32, 2, 16
    inp = _attention_inputs(B, L, H, nh, hd, seed=L)
    if not fuse_ln:
        inp.pop("ln_scale"), inp.pop("ln_bias")
    j = jx.arrays(inp)
    want = np.asarray(
        jx.fused_attention_block(
            j.pop("hidden"), j.pop("segment_ids"), j.pop("qkv_kernel"), j.pop("qkv_bias"),
            j.pop("out_kernel"), j.pop("out_bias"), sm_scale=hd**-0.5, interpret=True, **j,
        )
    )
    got = attention_block_plain(**_torch(inp), sm_scale=hd**-0.5).numpy()
    valid = inp["segment_ids"] > 0
    np.testing.assert_allclose(got[valid], want[valid], **CPU_TOL)


def test_attention_plain_matches_jax_reference(jx):
    B, L, H, nh, hd = 2, 64, 32, 4, 8
    inp = _attention_inputs(B, L, H, nh, hd, seed=7)
    inp.pop("ln_scale"), inp.pop("ln_bias")
    want = np.asarray(jx.reference_attention_block(**jx.arrays(inp), sm_scale=hd**-0.5))
    got = attention_block_plain(**_torch(inp), sm_scale=hd**-0.5).numpy()
    valid = inp["segment_ids"] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_mlp_plain_matches_jax_kernel(jx, activation):
    inp = _mlp_inputs(M=40, H=32, I=64, seed=3)
    want = np.asarray(
        jx.fused_mlp_block(
            *jx.arrays(inp).values(), activation=activation, eps=1e-12, quantized=False,
            interpret=True,
        )
    )
    got = mlp_block_plain(*_torch(inp).values(), activation=activation, eps=1e-12).numpy()
    np.testing.assert_allclose(got, want, **CPU_TOL)


# The float32 forwards on the card take their products on the 3xTF32 tile,
# which int8_matmul.tf32x3_product models (chip_smoke.tf32x3_model): the
# plain versions with every float product through it still match JAX's
# float32 kernels (interpret mode) to 1e-5 of each output's largest
# magnitude, as the float32 products themselves.
F32_MODEL_RTOL = 1e-5


def _assert_within_share(got, want, share, valid=None):
    """max |got - want| <= share max |want| (on the valid rows)."""
    got, want = np.asarray(got), np.asarray(want)
    if valid is not None:
        got, want = got[valid], want[valid]
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= share, err


@pytest.mark.parametrize("fuse_ln", [True, False], ids=["ln", "no_ln"])
def test_attention_plain_on_the_tf32x3_model_matches_jax_kernel(jx, fuse_ln):
    B, L, H, nh, hd = 2, 64, 64, 4, 16
    inp = _attention_inputs(B, L, H, nh, hd, seed=21)
    if not fuse_ln:
        inp.pop("ln_scale"), inp.pop("ln_bias")
    j = jx.arrays(inp)
    want = jx.fused_attention_block(
        j.pop("hidden"), j.pop("segment_ids"), j.pop("qkv_kernel"), j.pop("qkv_bias"),
        j.pop("out_kernel"), j.pop("out_bias"), sm_scale=hd**-0.5, interpret=True, **j)
    with chip_smoke.planted(chip_smoke.float_products(chip_smoke.tf32x3_model)):
        got = attention_block_plain(**_torch(inp), sm_scale=hd**-0.5)
    _assert_within_share(got, want, F32_MODEL_RTOL, inp["segment_ids"] > 0)


def test_mlp_plain_on_the_tf32x3_model_matches_jax_kernel(jx):
    inp = _mlp_inputs(M=40, H=64, I=256, seed=22)
    want = jx.fused_mlp_block(*jx.arrays(inp).values(), activation="gelu", eps=1e-12,
                              quantized=False, interpret=True)
    with chip_smoke.planted(chip_smoke.float_products(chip_smoke.tf32x3_model)):
        got = mlp_block_plain(*_torch(inp).values(), activation="gelu", eps=1e-12)
    _assert_within_share(got, want, F32_MODEL_RTOL)


def _f32_forward_gate_call(kernel):
    """(honest outputs, plain) of a float32 forward at BERT-base depths: the
    exact float32 products stand in for the card's (they differ from the
    3xTF32 model by float32 rounding, as the tile's truncating sums do)."""
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    if kernel in ("gemm 768", "gemm 3072"):
        K = int(kernel.split()[1])
        t = _torch(_mlp_inputs(M=64, H=K, I=256, seed=23))
        plain = lambda: {"out": tb.forward_tile(t["x"], t["w1"], t["b1"])}
    elif kernel == "fused_attention_block":
        t = _torch(_attention_inputs(2, 64, 768, 12, 64, seed=24))
        valid = t["segment_ids"] > 0
        call = lambda **ln: attention_block_plain(
            t["hidden"], t["segment_ids"], t["qkv_kernel"], t["qkv_bias"], t["out_kernel"],
            t["out_bias"], sm_scale=64**-0.5, **ln)[valid]
        plain = lambda: {"out": call(ln_scale=t["ln_scale"], ln_bias=t["ln_bias"]),
                         "projection": call()}
    else:  # fused_mlp_block: depths 768 (W1) and 3072 (W2)
        t = _torch(_mlp_inputs(M=64, H=768, I=3072, seed=25))
        plain = lambda: {"out": mlp_block_plain(*t.values(), activation="gelu", eps=1e-12)}
    return plain(), plain


@pytest.mark.parametrize("kernel", ["gemm 768", "gemm 3072", "fused_attention_block",
                                    "fused_mlp_block"])
def test_float32_forward_gate_rejects_plain_tf32(kernel):
    """chip_smoke's float32 forward gate (check_f32_forward: F32_FWD_TOL
    against the plain version on the 3xTF32 model, plain TF32 planted in its
    products) accepts exact float32 products at depths 768 and 3072 and
    rejects plain TF32 ones in the same outputs."""
    honest, plain = _f32_forward_gate_call(kernel)
    gate = chip_smoke.check_f32_forward(kernel, honest, plain)
    assert gate["fault_excess"] > 1, gate
    with chip_smoke.planted(chip_smoke.float_products(chip_smoke.plain_tf32)):
        bad = plain()
    with pytest.raises(RuntimeError, match="beyond its limit"):
        chip_smoke.check_f32_forward(kernel, bad, plain)


def test_dense_core_on_the_tf32x3_model_matches_jax_attention_kernel(jx):
    """The blocks' float32 core model (attention_core_plain, its products on
    the 3xTF32 model) against the context of JAX's fused_attention_block in
    interpret mode, read through an identity out projection (H = nh hd,
    zero bias, no LayerNorm), on the real rows: to F32_MODEL_RTOL of the
    largest, as the float32 products themselves."""
    B, L, nh, hd = 2, 96, 4, 16
    H = nh * hd
    inp = _attention_inputs(B, L, H, nh, hd, seed=31)
    inp.pop("ln_scale"), inp.pop("ln_bias")
    inp["out_kernel"] = np.eye(H, dtype=np.float32).reshape(nh, hd, H)
    inp["out_bias"] = np.zeros(H, np.float32)
    j = jx.arrays(inp)
    want = jx.fused_attention_block(
        j.pop("hidden"), j.pop("segment_ids"), j.pop("qkv_kernel"), j.pop("qkv_bias"),
        j.pop("out_kernel"), j.pop("out_bias"), sm_scale=hd**-0.5, interpret=True, **j)
    t = _torch(inp)
    qkv = torch.einsum("blh,hsnd->blsnd", t["hidden"], t["qkv_kernel"]) + t["qkv_bias"]
    q, k, v = qkv.unbind(2)
    got = _core_model(torch.float32, lambda: attention_core_plain(
        q * hd**-0.5, k, v, t["segment_ids"], torch.float32))
    _assert_within_share(got.reshape(B, L, H), want, F32_MODEL_RTOL, inp["segment_ids"] > 0)


@pytest.mark.parametrize("L", [65, 200])
def test_snld_core_model_on_the_tf32x3_model_matches_jax_kernel(jx, L):
    """Kernel 6's float32 rounding model with its products on the 3xTF32
    model against JAX's snld_self_attention (float32 qkv, interpret mode):
    within CORE_REL of the largest |ctx| on the real rows, as the exact
    model (test_snld_core_model_matches_jax_kernel; the exponent is bf16)."""
    hd = 64
    qkv, _ = _qkv_inputs(3, 4, L, hd, seed=L + 7)
    seg = _ragged_segments(3, L, seed=L + 7)
    want = np.asarray(jx.snld_self_attention(jx.jnp.asarray(qkv), jx.jnp.asarray(seg), hd**-0.5,
                                             heads_per_block=2, interpret=True))
    got = _core_model(torch.float32, lambda: snld_attention_plain(
        torch.from_numpy(qkv), torch.from_numpy(seg), hd**-0.5)).numpy()
    valid = np.broadcast_to(seg[:, None, :, None] > 0, got.shape)
    _core_gate(torch.from_numpy(got[valid]), torch.from_numpy(want[valid]), atol=0.0)


def _tf32x3_in_float64(real, a, b):
    """The 3xTF32 model's three products summed in float64, then rounded:
    the same TF32 terms as the card's core, in another order (a stand-in
    for the kernel's own sums)."""
    from spokennlp_tpu_torch.ops.cuda.int8_matmul import tf32_round

    a, b = a.float(), b.float()
    ab, bb = tf32_round(a), tf32_round(b)
    d = lambda t: t.double()
    return ((d(tf32_round(a - ab)) @ d(bb) + d(ab) @ d(tf32_round(b - bb))) + d(ab) @ d(bb)).float()


@pytest.mark.parametrize("B,nh,L,hd", [(4, 12, 512, 64), (2, 2, 130, 128), (3, 2, 513, 128)])
def test_snld_float32_gate_accepts_other_sum_orders_and_rejects_plain_tf32(B, nh, L, hd):
    """Kernel 6's float32 gate (chip_smoke.SNLD_F32_GATE: its exponent is
    bf16) accepts its model with the same TF32 terms summed in another order
    (float64), where flipped bf16 roundings of s - m exceed CORE_GATE's
    float32 limit, and rejects plain TF32 products (F32_CORE_FAULT) by its
    norm part; both planted faults of CORE_FAULTS fail it too."""
    qkv, seg = _qkv_inputs(B, nh, L, hd, seed=B + L)
    if B == 3:
        seg = _ragged_segments(B, L, seed=B + L)
    q, s = torch.from_numpy(qkv), torch.from_numpy(seg)
    valid = (s > 0)[:, None, :].expand(B, nh, L)
    fn = lambda: snld_attention_plain(q, s, hd**-0.5)[valid]
    want = _core_model(torch.float32, fn)
    with chip_smoke.planted(chip_smoke.core_products(_tf32x3_in_float64)):
        _snld_f32_gate(fn(), want)
    with pytest.raises(AssertionError):
        _snld_f32_gate(_core_model(torch.float32, fn, terms=1), want)
    for fault in chip_smoke.core_faults().values():
        with chip_smoke.planted(chip_smoke.core_products(chip_smoke.tf32x3_model) + [fault]):
            bad = fn()
        with pytest.raises(AssertionError):
            _snld_f32_gate(bad, want)


def test_float32_core_gate_rejects_plain_tf32():
    """chip_smoke's float32 core gate (CORE_GATE["float32"] against the
    blocks' core model on the 3xTF32 model) accepts the model with the same
    TF32 terms summed in another order (float64) and with exact float32
    products, and rejects it with plain TF32 products (F32_CORE_FAULT), at
    the main path's head dim over 512 keys."""
    B, nh, L, hd = 2, 4, 512, 64
    qkv = _block_qkv(B, nh, L, hd, seed=33, dtype=torch.float32)
    seg = torch.from_numpy(_segments(B, L, seed=33))
    fn = lambda: _block_core_model(qkv, seg)[seg > 0]
    want = _core_model(torch.float32, fn)
    rel, atol = chip_smoke.CORE_GATE["float32"]
    with chip_smoke.planted(chip_smoke.core_products(_tf32x3_in_float64)):
        _core_gate(fn(), want, rel=rel, atol=atol)
    _core_gate(fn(), want, rel=rel, atol=atol)
    with pytest.raises(AssertionError):
        _core_gate(_core_model(torch.float32, fn, terms=1), want, rel=rel, atol=atol)


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_table_matches_jax(jx, name):
    assert set(ACTIVATIONS) == set(jx.activations)
    x = np.linspace(-6.0, 6.0, 241, dtype=np.float32)
    want = np.asarray(jx.activations[name](jx.jnp.asarray(x)))
    got = ACTIVATIONS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_wrappers_on_cpu_run_plain_without_counting():
    att = _torch(_attention_inputs(2, 48, 32, 2, 16, seed=5))
    mlp = _torch(_mlp_inputs(M=24, H=32, I=64, seed=6))
    n_att, n_mlp = fused_attention_block.launches, fused_mlp_block.launches
    hidden, seg = att.pop("hidden"), att.pop("segment_ids")
    args = [att.pop(k) for k in ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias")]
    got = fused_attention_block(hidden, seg, *args, sm_scale=0.25, **att)
    want = attention_block_plain(hidden, seg, *args, sm_scale=0.25, **att)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    got = fused_mlp_block(*mlp.values(), activation="gelu", eps=1e-12, quantized=False)
    want = mlp_block_plain(*mlp.values(), activation="gelu", eps=1e-12)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert (fused_attention_block.launches, fused_mlp_block.launches) == (n_att, n_mlp)


def test_quantized_kernel_options_on_cpu_run_their_plain_versions():
    """The TPU kernels' int8 attention core and static intermediate scale
    run their plain versions on the CPU without counting a launch; without
    ``quantized`` both are ignored, as in JAX; an unknown core raises."""
    att = _torch(_attention_inputs(1, 16, 32, 2, 16, seed=8))
    mlp = _torch(_mlp_inputs(M=8, H=32, I=64, seed=9))
    n_att, n_mlp = fused_attention_block.launches, fused_mlp_block.launches
    for core in ("qk", "av", "both", True):
        for quantized in (True, False):
            kw = dict(sm_scale=0.25, quantized=quantized)
            got = fused_attention_block(**att, **kw, core_int8=core)
            want = attention_block_plain(**att, **kw, core_int8=core if quantized else False)
            torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="core_int8"):
        fused_attention_block(**att, sm_scale=0.25, quantized=True, core_int8="xyz")
    for quantized in (True, False):
        kw = dict(activation="gelu", eps=1e-12, quantized=quantized)
        got = fused_mlp_block(*mlp.values(), **kw, static_h_scale=True)
        want = mlp_block_plain(*mlp.values(), **kw, static_h_scale=quantized)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert (fused_attention_block.launches, fused_mlp_block.launches) == (n_att, n_mlp)


def assert_close_w8a8(got, want, bf16=False):
    """Within W8A8_TOL (1 + |ref|), but for at most a W8A8_FLIPS share of
    one-int8-step moves within W8A8_STEP_TOL; ``bf16``: outputs rounded to
    bf16 on the card, within BF16_W8A8_TOL + 2^-7 |ref| but for at most a
    BF16_W8A8_FLIPS share, each within W8A8_STEP_TOL beyond rounding."""
    if isinstance(got, torch.Tensor):
        got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    ref = np.abs(np.asarray(want, np.float64))
    rounding = 2**-7 * ref if bf16 else W8A8_TOL * ref
    assert (err - rounding).max() <= W8A8_STEP_TOL, err.max()
    atol, flips = (BF16_W8A8_TOL, BF16_W8A8_FLIPS) if bf16 else (W8A8_TOL, W8A8_FLIPS)
    share = (err > atol + rounding).mean()
    assert share <= flips, share


def _mlp_w8a8_bf16_intermediate(x, w1, b1, w2, b2, ln_scale, ln_bias):
    """A planted fault: the W8A8 MLP block (GELU) with its float32
    intermediate rounded to bf16 before its row quantisation."""
    (w1q, sw1), (w2q, sw2) = quantize_colwise(w1), quantize_colwise(w2)
    x8, sx = rowquant_plain(x.float())
    h = ACTIVATIONS["gelu"](int8_product(x8, w1q) * sx * sw1 + b1)
    h8, sh = rowquant_plain(h.to(torch.bfloat16).float())
    y = int8_product(h8, w2q) * sh * sw2 + b2
    return torch.nn.functional.layer_norm(y + x.float(), (x.shape[1],), ln_scale, ln_bias,
                                          eps=1e-12).to(x.dtype)


PLANTED = ["heads_per_block_ignored", "attention_unquantized", "mlp_bf16_intermediate",
           "mlp_unquantized"]


def _planted_fault(fault, att, mlp, hb):
    """(what a block with ``fault`` returns, the plain W8A8 version) on the
    given inputs; the attention block runs ``hb`` heads a group."""
    if fault.startswith("mlp"):
        want = mlp_block_plain(*mlp.values(), activation="gelu", eps=1e-12, quantized=True)
        if fault == "mlp_unquantized":
            return fused_mlp_block(*mlp.values(), activation="gelu", eps=1e-12,
                                   quantized=False), want
        return _mlp_w8a8_bf16_intermediate(*mlp.values()), want
    nh = att["qkv_kernel"].shape[2]
    want = attention_block_plain(**att, quantized=True, heads_per_block=hb)
    if fault == "heads_per_block_ignored":
        return fused_attention_block(**att, quantized=True, heads_per_block=nh), want
    return fused_attention_block(**att, quantized=False, heads_per_block=hb), want


@pytest.mark.parametrize("fault", PLANTED)
def test_w8a8_check_rejects_planted_faults(fault):
    """Each trap of the W8A8 blocks, planted once, fails assert_close_w8a8:
    the check the kernels are held to on the card can tell them apart."""
    att = _torch(_attention_inputs(2, 32, 64, 4, 16, seed=16))
    seg = att["segment_ids"]
    got, want = _planted_fault(fault, {**att, "sm_scale": 0.25},
                               _torch(_mlp_inputs(M=40, H=32, I=64, seed=17)), hb=2)
    valid = seg > 0 if fault in PLANTED[:2] else slice(None)
    with pytest.raises(AssertionError):
        assert_close_w8a8(got[valid], want[valid])


@pytest.mark.parametrize("hb,seqs", [(4, 1), (2, 1), (4, 2), (3, 1)],
                         ids=["hb=nh", "hb=nh/2", "seqs=2", "hb_not_dividing"])
def test_attention_w8a8_plain_matches_jax_kernel(jx, hb, seqs):
    """heads_per_block groups ctx for its row quantisation (the result
    changes with it); seqs_per_block=2 takes the JAX multi-sequence kernel;
    a heads_per_block that does not divide nh means one head a group."""
    B, L, H, nh, hd = 4, 48, 64, 4, 16
    inp = _attention_inputs(B, L, H, nh, hd, seed=11)
    j = jx.arrays(inp)
    kw = dict(sm_scale=hd**-0.5, quantized=True, heads_per_block=hb, seqs_per_block=seqs)
    want = np.asarray(
        jx.fused_attention_block(
            j.pop("hidden"), j.pop("segment_ids"), j.pop("qkv_kernel"), j.pop("qkv_bias"),
            j.pop("out_kernel"), j.pop("out_bias"), interpret=True, **kw, **j,
        )
    )
    got = fused_attention_block(**_torch(inp), **kw).numpy()
    valid = inp["segment_ids"] > 0
    assert_close_w8a8(got[valid], want[valid])


def test_attention_w8a8_head_groups_change_the_result():
    """Every output moves, each by less than an int8 step: only a check of
    the share of moved outputs tells the two apart."""
    inp = _torch(_attention_inputs(2, 32, 64, 4, 16, seed=12))
    one, two = (attention_block_plain(**inp, sm_scale=0.25, quantized=True, heads_per_block=hb)
                for hb in (4, 2))
    assert not torch.equal(one, two)
    torch.testing.assert_close(one, two, atol=5e-2, rtol=0)
    valid = inp["segment_ids"] > 0
    with pytest.raises(AssertionError):
        assert_close_w8a8(one[valid], two[valid])


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_mlp_w8a8_plain_matches_jax_kernel(jx, activation):
    inp = _mlp_inputs(M=40, H=32, I=64, seed=13)
    want = np.asarray(
        jx.fused_mlp_block(
            *jx.arrays(inp).values(), activation=activation, eps=1e-12, quantized=True,
            interpret=True,
        )
    )
    got = fused_mlp_block(*_torch(inp).values(), activation=activation, eps=1e-12,
                          quantized=True).numpy()
    assert_close_w8a8(got, want)


def _qkv_inputs(B, nh, L, hd, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, 3, nh, L, hd)).astype(np.float32), _segments(B, L, seed)


def test_snld_reference_matches_jax_reference(jx):
    qkv, seg = _qkv_inputs(2, 4, 48, 16, seed=14)
    want = np.asarray(jx.reference_snld_attention(jx.jnp.asarray(qkv), jx.jnp.asarray(seg), 0.25))
    got = reference_snld_attention(torch.from_numpy(qkv), torch.from_numpy(seg), 0.25).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_snld_wrapper_on_cpu_against_jax_kernel(jx):
    """The CPU wrapper runs the float32-softmax reference; the JAX kernel
    takes the exponent in bfloat16 (relative error 2^-9 per probability)."""
    qkv, seg = _qkv_inputs(2, 4, 48, 16, seed=15)
    want = np.asarray(jx.snld_self_attention(jx.jnp.asarray(qkv), jx.jnp.asarray(seg), 0.25,
                                             heads_per_block=2, interpret=True))
    n = snld_self_attention.launches
    got = snld_self_attention(torch.from_numpy(qkv), torch.from_numpy(seg), 0.25).numpy()
    assert snld_self_attention.launches == n
    valid = np.broadcast_to(seg[:, None, :, None] > 0, got.shape)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("L", [1, 65, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snld_core_model_matches_jax_kernel(jx, dtype, L, hd):
    """The kernel's rounding model (online max over key tiles of 64) against
    JAX's kernel in interpret mode, bf16 or f32 qkv, padding, packed
    windows, a single-key segment and a sequence with no real token:
    within 2^-7 of the largest |ctx| (CORE_REL) on the real rows, finite
    everywhere."""
    qkv, _ = _qkv_inputs(3, 4, L, hd, seed=L + hd)
    seg = _ragged_segments(3, L, seed=L + hd)
    jq = jx.jnp.asarray(qkv).astype(getattr(jx.jnp, dtype))
    want = np.asarray(jx.snld_self_attention(jq, jx.jnp.asarray(seg), hd**-0.5,
                                             heads_per_block=2, interpret=True)
                      .astype(jx.jnp.float32))
    tq = torch.from_numpy(qkv).to(getattr(torch, dtype))
    got = snld_attention_plain(tq, torch.from_numpy(seg), hd**-0.5)
    assert got.dtype == tq.dtype and got.shape == (3, 4, L, hd)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    valid = np.broadcast_to(seg[:, None, :, None] > 0, got.shape)
    _core_gate(torch.from_numpy(got[valid]), torch.from_numpy(want[valid]), atol=0.0)


@pytest.mark.parametrize("fault", chip_smoke.CORE_FAULTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_snld_core_model_gate_rejects_planted_faults(dtype, fault):
    """The card gate of the core, at its limit for the dtype, fails for
    each fault chip_smoke.py plants in the model: rescales not applied, the
    packed-segment mask reduced to the padding mask."""
    qkv, _ = _qkv_inputs(4, 2, 512, 64, seed=5)
    seg = torch.from_numpy(_segments(4, 512, seed=5))
    q = torch.from_numpy(qkv).to(dtype)
    want = snld_attention_plain(q, seg, 0.125)
    valid = (seg > 0)[:, None, :].expand(4, 2, 512)
    _core_gate(want[valid], want[valid], rel=_core_rel(dtype))
    with chip_smoke.planted([chip_smoke.core_faults()[fault]]):
        bad = snld_attention_plain(q, seg, 0.125)
    with pytest.raises(AssertionError):
        _core_gate(bad[valid], want[valid], rel=_core_rel(dtype))


def _bf16_block_call(kernel, seed, B=2, L=128, M=256):
    """(call(fn), fn's plain version, valid rows) of kernel 1 or 2 at BERT-base
    widths over a few rows, bf16 inputs and weights."""
    if kernel == "fused_attention_block":
        t = _on_card(_attention_inputs(B, L, 768, 12, 64, seed=seed), "cpu", torch.bfloat16,
                     {"hidden"})
        args = [t[k] for k in ("hidden", "segment_ids", "qkv_kernel", "qkv_bias", "out_kernel",
                               "out_bias")]
        kw = dict(sm_scale=0.125, ln_scale=t["ln_scale"], ln_bias=t["ln_bias"])
        return (lambda fn: fn(*args, **kw)), attention_block_plain, t["segment_ids"] > 0
    t = _on_card(_mlp_inputs(M, 768, 3072, seed=seed), "cpu", torch.bfloat16, {"x"})
    return ((lambda fn: fn(*t.values(), activation="gelu", eps=1e-12)), mlp_block_plain,
            slice(None))


@pytest.mark.parametrize("kernel", ["fused_attention_block", "fused_mlp_block"])
def test_bf16_limit_accepts_other_sum_orders_and_rejects_planted_faults(kernel):
    """Kernels 1 and 2's bf16 limit (chip_smoke.BF16_TOL) accepts the plain
    version with its products summed in another order (float64, then
    rounded to float32) and rejects it with each of the GEMM tile's planted
    faults: partial sums rounded to bf16 every k-stage, the last k-step
    dropped."""
    from spokennlp_tpu_torch.ops.cuda import attention_block as ab
    from spokennlp_tpu_torch.ops.cuda import mlp_block as mb

    call, plain, valid = _bf16_block_call(kernel, seed=7)
    want = call(plain)
    tol = chip_smoke.BF16_TOL[kernel]
    f64 = lambda real, x, w: (x.double() @ w.double()).float()
    with chip_smoke.planted([(ab, "float_product", None, f64), (mb, "float_product", None, f64)]):
        other = call(plain)
    assert not torch.equal(other, want)  # the sums did run in another order
    assert chip_smoke.beyond_limit(other[valid], want[valid], tol) <= 0
    for fault, patches in chip_smoke.bf16_gemm_faults().items():
        with chip_smoke.planted(patches):
            bad = call(plain)
        assert chip_smoke.beyond_limit(bad[valid], want[valid], tol) > 0, fault


def test_sass_verdict_on_canned_counts():
    """chip_smoke.sass_verdict on disassembly counts {function: [IMMA,
    IDP4A, HMMA]}: a passing library, then one fault at a time."""
    ns, bf = "_ZN3spk", "13__nv_bfloat16"
    stack = "_ZN3spk12_GLOBAL__N_1"
    good = {
        f"{ns}18gemm_act_i8_kernelI{bf}EEvPKa": [8, 0, 0],
        f"{ns}24gemm_act_quant_i8_kernelILi0EEEvPKa": [8, 0, 0],
        f"{ns}18qkv_proj_i8_kernelI{bf}EEvPKa": [8, 0, 0],
        f"{ns}21residual_ln_i8_kernelI{bf}EEvPKa": [8, 0, 0],
        f"{stack}23encoder_stack_i8_kernelI{bf}Li64EEEvNS0_9StackArgsE": [8, 0, 4],
        f"{stack}23encoder_stack_i8_kernelIfLi64EEEvNS0_9StackArgsE": [8, 0, 0],
        f"{ns}17attn_core_i8_kernelI{bf}Li64EEEvPKT_": [0, 6, 0],
        f"{ns}16attn_core_kernelI{bf}Li64ES1_EEvPKT_": [0, 0, 16],
        f"{ns}16attn_core_kernelIfLi64EfEEvPKT_": [0, 0, 48],
        f"{ns}16attn_core_kernelIfLi64E{bf}EEvPKT_": [0, 0, 48],
        f"{ns}20gemm_bias_act_kernelI{bf}Lb0EEEvPKT_": [0, 0, 32],
        f"{ns}20gemm_bias_act_kernelI{bf}Lb1EEEvPKT_": [0, 0, 32],
        f"{ns}20gemm_bias_act_kernelIfLb0EEEvPKT_": [0, 0, 192],
        f"{ns}20gemm_bias_act_kernelIfLb1EEEvPKT_": [0, 0, 384],
        f"{ns}18weight_grad_kernelI{bf}EEvPKT_": [0, 0, 64],
        f"{ns}18weight_grad_kernelIfEEvPKT_": [0, 0, 384],
        f"{stack}25weight_grad_reduce_kernelEPKfimmPfmS2_i": [0, 0, 0],
        f"{stack}19act_and_grad_kernelI{bf}EEvPKT_": [0, 0, 32],
        f"{stack}19act_and_grad_kernelIfEEvPKT_": [0, 0, 192],
        f"{ns}15qkv_proj_kernelI{bf}EEvPKT_": [0, 0, 32],
        f"{ns}15qkv_proj_kernelIfEEvPKT_": [0, 0, 192],
        f"{ns}28gemm_bias_residual_ln_kernelI{bf}EEvPKT_": [0, 0, 16],
        f"{ns}28gemm_bias_residual_ln_kernelIfEEvPKT_": [0, 0, 96],
        f"{stack}20encoder_stack_kernelI{bf}Li64EEEvNS0_9StackArgsE": [0, 0, 0],
        f"{stack}20encoder_stack_kernelIfLi64EEEvNS0_9StackArgsE": [0, 0, 0],
        f"{stack}15stack_core_itemI{bf}Li64EEEvPKT_": [0, 0, 16],
        f"{stack}15stack_core_itemIfLi64EEEvPKT_": [0, 0, 48],
        f"{stack}14stack_qkv_itemI{bf}EEvPKT_": [0, 0, 32],
        f"{stack}19stack_gemm_act_itemI{bf}EEvPKT_": [0, 0, 32],
        f"{stack}22stack_residual_ln_itemI{bf}EEvPKT_": [0, 0, 16],
        f"{stack}14stack_qkv_itemIfEEvPKT_": [0, 0, 192],
        f"{stack}19stack_gemm_act_itemIfEEvPKT_": [0, 0, 192],
        f"{stack}22stack_residual_ln_itemIfEEvPKT_": [0, 0, 96],
        f"{ns}18global_rows_kernelI{bf}Li64ELb0ES1_EEvPKT_": [0, 0, 64],
        f"{ns}18global_rows_kernelI{bf}Li64ELb0EfEEvPKT_": [0, 2, 64],
        f"{ns}18global_rows_kernelI{bf}Li64ELb1ES1_EEvPKT_": [0, 0, 112],
        f"{ns}18global_rows_kernelIfLi64ELb0EfEEvPKT_": [0, 2, 72],
        f"{ns}18global_rows_kernelIfLi64ELb1EfEEvPKT_": [0, 0, 120],
        f"{stack}14band_dq_kernelI{bf}Li64EEEvPKT_": [0, 0, 32],
        f"{stack}14band_dq_kernelIfLi64EEEvPKT_": [0, 0, 96],
        f"{stack}15band_dkv_kernelI{bf}Li64EEEvPKT_": [0, 0, 48],
        f"{stack}15band_dkv_kernelIfLi64EEEvPKT_": [0, 0, 144],
        f"{stack}17bigbird_dq_kernelI{bf}Li64EEEvPKT_": [0, 0, 32],
        f"{stack}17bigbird_dq_kernelIfLi64EEEvPKT_": [0, 0, 96],
        f"{stack}18bigbird_dkv_kernelI{bf}Li64EEEvPKT_": [0, 0, 48],
        f"{stack}18bigbird_dkv_kernelIfLi64EEEvPKT_": [0, 0, 144],
        f"{ns}16band_rows_kernelI{bf}Li64ELb0ES1_EEvPKT_": [0, 0, 96],
        f"{ns}16band_rows_kernelI{bf}Li64ELb0EfEEvPKT_": [0, 0, 96],
        f"{ns}16band_rows_kernelI{bf}Li64ELb1ES1_EEvPKT_": [0, 0, 128],
        f"{ns}16band_rows_kernelIfLi64ELb0EfEEvPKT_": [0, 0, 72],
        f"{ns}19bigbird_rows_kernelI{bf}Li64ELb0ES1_EEvPKT_": [0, 0, 96],
        f"{ns}19bigbird_rows_kernelIfLi64ELb1EfEEvPKT_": [0, 0, 96],
        f"{stack}16attn_rows_kernelI{bf}Li64ELb0EEEvPKT_": [0, 0, 96],
        f"{stack}16attn_rows_kernelI{bf}Li64ELb1EEEvPKT_": [0, 0, 128],
        f"{stack}16attn_rows_kernelIfLi64ELb0EEEvPKT_": [0, 0, 72],
        f"{stack}16attn_rows_kernelIfLi64ELb1EEEvPKT_": [0, 0, 96],
        f"{stack}14attn_dq_kernelI{bf}Li64EEEvPKT_": [0, 0, 32],
        f"{stack}14attn_dq_kernelIfLi64EEEvPKT_": [0, 0, 96],
        f"{stack}15attn_dkv_kernelI{bf}Li64EEEvPKT_": [0, 0, 48],
        f"{stack}15attn_dkv_kernelIfLi64EEEvPKT_": [0, 0, 144],
        f"{stack}21global_kv_grad_kernelIfLi64EEEvPKT_": [0, 0, 0],
    }
    assert chip_smoke.sass_verdict(good) == []

    def with_counts(name, counts):
        changed = {k: list(v) for k, v in good.items()}
        changed[name] = counts
        return chip_smoke.sass_verdict(changed)

    # a GEMM tile kernel's bf16 or float32 instantiation without HMMA (the
    # forward GEMM, the projection, the residual LayerNorm, the backward's
    # transposed-weight GEMM, weight gradient and recomputed product among
    # them): the float32 ones as the SIMT tile left them, the old verdict's
    # passing case; a float stack whose GEMM items hold no HMMA
    for name in (f"{ns}15qkv_proj_kernelI{bf}EEvPKT_",
                 f"{ns}28gemm_bias_residual_ln_kernelI{bf}EEvPKT_",
                 f"{ns}20gemm_bias_act_kernelI{bf}Lb1EEEvPKT_",
                 f"{ns}18weight_grad_kernelI{bf}EEvPKT_",
                 f"{stack}19act_and_grad_kernelI{bf}EEvPKT_",
                 f"{ns}20gemm_bias_act_kernelIfLb0EEEvPKT_",
                 f"{ns}15qkv_proj_kernelIfEEvPKT_",
                 f"{ns}28gemm_bias_residual_ln_kernelIfEEvPKT_",
                 f"{ns}20gemm_bias_act_kernelIfLb1EEEvPKT_",
                 f"{ns}18weight_grad_kernelIfEEvPKT_",
                 f"{stack}19act_and_grad_kernelIfEEvPKT_",
                 f"{stack}19stack_gemm_act_itemI{bf}EEvPKT_",
                 f"{stack}14stack_qkv_itemIfEEvPKT_",
                 f"{stack}22stack_residual_ln_itemIfEEvPKT_"):
        assert with_counts(name, [0, 0, 0]), name
    # the float32 stack as it was: no GEMM items of its own (the SIMT tile
    # functions inline), no HMMA
    simt_stack = {k: v for k, v in good.items()
                  if not any(f"{p}If" in k for p in chip_smoke.STACK_GEMM_ITEMS)}
    found = chip_smoke.sass_verdict(simt_stack)
    assert found and all("encoder_stack_kernelIf" in m for m in found), found
    # a missing float32 instantiation
    found = chip_smoke.sass_verdict({k: v for k, v in good.items()
                                     if k != f"{ns}15qkv_proj_kernelIfEEvPKT_"})
    assert found == ["cuobjdump -sass shows no float32 instantiation of qkv_proj_kernel"], found
    # the Longformer and BigBird backwards' gradient kernels and rows
    # kernels, on the tensor cores in both dtypes: a bf16 instantiation (the
    # W8A8 mode's float32 ctx among them) without HMMA, a float32 one without
    # it (as the SIMT bodies left them, the old verdict's passing case), or a
    # float32 one missing
    assert with_counts(f"{stack}15band_dkv_kernelI{bf}Li64EEEvPKT_", [0, 0, 0])
    assert with_counts(f"{ns}16band_rows_kernelI{bf}Li64ELb0EfEEvPKT_", [0, 0, 0])
    assert with_counts(f"{ns}19bigbird_rows_kernelI{bf}Li64ELb0ES1_EEvPKT_", [0, 0, 0])
    for name in (f"{stack}14band_dq_kernelIfLi64EEEvPKT_", f"{stack}15band_dkv_kernelIfLi64EEEvPKT_",
                 f"{stack}17bigbird_dq_kernelIfLi64EEEvPKT_",
                 f"{stack}18bigbird_dkv_kernelIfLi64EEEvPKT_",
                 f"{ns}16band_rows_kernelIfLi64ELb0EfEEvPKT_",
                 f"{ns}19bigbird_rows_kernelIfLi64ELb1EfEEvPKT_"):
        found = with_counts(name, [0, 0, 0])
        assert found == [f"{name} has no HMMA: its float32 products do not run on the tensor "
                         "cores"], found
    found = chip_smoke.sass_verdict({k: v for k, v in good.items()
                                     if "bigbird_dkv_kernelIf" not in k})
    assert found == ["cuobjdump -sass shows no float32 instantiation of bigbird_dkv_kernel"], found
    # row 10's cores and the dense core, on the tensor cores in both dtypes:
    # either instantiation without HMMA (the float32 ones as the SIMT bodies
    # left them, the old verdict's passing case), or a float32 one missing
    assert with_counts(f"{stack}16attn_rows_kernelI{bf}Li64ELb1EEEvPKT_", [0, 0, 0])
    assert with_counts(f"{stack}15attn_dkv_kernelI{bf}Li64EEEvPKT_", [0, 0, 0])
    assert with_counts(f"{stack}14attn_dq_kernelI{bf}Li64EEEvPKT_", [0, 0, 0])
    for name in (f"{stack}15attn_dkv_kernelIfLi64EEEvPKT_", f"{stack}14attn_dq_kernelIfLi64EEEvPKT_",
                 f"{stack}16attn_rows_kernelIfLi64ELb1EEEvPKT_",
                 f"{ns}16attn_core_kernelIfLi64EfEEvPKT_",
                 f"{ns}16attn_core_kernelIfLi64E{bf}EEvPKT_"):
        found = with_counts(name, [0, 0, 0])
        assert found == [f"{name} has no HMMA: its float32 products do not run on the tensor "
                         "cores"], found
    found = chip_smoke.sass_verdict({k: v for k, v in good.items() if "attn_rows_kernelIf" not in k})
    assert found == ["cuobjdump -sass shows no float32 instantiation of attn_rows_kernel"], found
    # the stacks' out-of-line core items of either type without HMMA: the
    # float32 stack's core on the CUDA cores, and the W8A8 stack's
    for name in (f"{stack}15stack_core_itemIfLi64EEEvPKT_",
                 f"{stack}15stack_core_itemI{bf}Li64EEEvPKT_"):
        assert with_counts(name, [0, 0, 0]), name
    found = with_counts(f"{stack}15stack_core_itemIfLi64EEEvPKT_", [0, 0, 0])
    assert any("encoder_stack_i8_kernelIf" in m for m in found), found
    # global_kv_grad_kernel stays on the CUDA cores in both dtypes: holding
    # HMMA fails
    found = with_counts(f"{stack}21global_kv_grad_kernelIfLi64EEEvPKT_", [0, 0, 4])
    assert len(found) == 1 and "HMMA outside" in found[0], found
    # the global rows, on the tensor cores in both dtypes: a bf16
    # instantiation (the W8A8 mode's float32 ctx and the statistics pass
    # among them) without HMMA, a float32 one without it (as the CUDA-core
    # body left them, the old verdict's passing case), or the float32 ones
    # missing
    assert with_counts(f"{ns}18global_rows_kernelI{bf}Li64ELb0EfEEvPKT_", [0, 2, 0])
    assert with_counts(f"{ns}18global_rows_kernelI{bf}Li64ELb1ES1_EEvPKT_", [0, 0, 0])
    for name in (f"{ns}18global_rows_kernelIfLi64ELb0EfEEvPKT_",
                 f"{ns}18global_rows_kernelIfLi64ELb1EfEEvPKT_"):
        found = with_counts(name, [0, 2, 0])
        assert found == [f"{name} has no HMMA: its float32 products do not run on the tensor "
                         "cores"], found
    found = chip_smoke.sass_verdict({k: v for k, v in good.items()
                                     if "global_rows_kernelIf" not in k})
    assert found == ["cuobjdump -sass shows no float32 instantiation of global_rows_kernel"], found
    # a stray function with HMMA or IDP4A, an int8 tile kernel without IMMA
    assert with_counts(f"{stack}25weight_grad_reduce_kernelEPKfimmPfmS2_i", [0, 0, 4])
    assert with_counts(f"{ns}16band_rows_kernelI{bf}Li64ELb1ES1_EEvPKT_", [0, 3, 128])
    assert with_counts(f"{ns}18gemm_act_i8_kernelI{bf}EEvPKa", [0, 0, 0])


def test_sass_rule_puts_the_band_and_bigbird_cores_on_the_tensor_cores():
    """The SASS rule's lists: the band and BigBird rows and gradient kernels
    and the Longformer global rows need HMMA in both dtypes
    (CORE_HMMA_KERNELS; no list holds kernels whose float32 instances must
    stay off the tensor cores), and global_kv_grad_kernel, on no list, none
    at all."""
    seven = ("band_rows_kernel", "bigbird_rows_kernel", "band_dq_kernel", "band_dkv_kernel",
             "bigbird_dq_kernel", "bigbird_dkv_kernel", "global_rows_kernel")
    assert set(seven) <= set(chip_smoke.CORE_HMMA_KERNELS)
    assert not hasattr(chip_smoke, "HMMA_KERNELS")
    lists = chip_smoke.CORE_HMMA_KERNELS + chip_smoke.GEMM_HMMA_KERNELS
    assert "global_kv_grad_kernel" not in lists
    assert "global_rows_kernel" in chip_smoke.IDP4A_ALLOWED  # the W8A8 query


def test_core_gate_limits_match_chip_smoke():
    """The card test and chip_smoke.py hold the core to the same limits."""
    assert chip_smoke.CORE_GATE == {"bfloat16": (CORE_REL, CORE_ATOL),
                                    "float32": (CORE_F32_REL, CORE_ATOL)}
    assert chip_smoke.SNLD_F32_GATE == (chip_smoke.CORE_GATE["bfloat16"], SNLD_F32_NORM)
    assert SNLD_F32_NORM == chip_smoke.ROWS_TOL["bfloat16"][1]


def _block_qkv(B, nh, L, hd, seed, dtype):
    """A qkv buffer as the attention block's QKV projection leaves it:
    (3, B, nh, L, hd), q scaled by hd^-0.5, in ``dtype``."""
    qkv, _ = _qkv_inputs(B, nh, L, hd, seed)
    qkv = torch.from_numpy(qkv).transpose(0, 1).contiguous()
    qkv[0] *= hd**-0.5
    return qkv.to(dtype)


def _block_core_model(qkv, seg):
    """The block's core's rounding model, (B, L, nh, hd): the exponent in
    bfloat16 over key tiles of 64 (snld_attention_plain, scale 1) for bf16,
    in float32 (attention_core_plain) for float32."""
    if qkv.dtype == torch.bfloat16:
        return snld_attention_plain(qkv.transpose(0, 1), seg, 1.0).transpose(1, 2)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(0))
    return attention_core_plain(q, k, v, seg, torch.float32)


@pytest.mark.parametrize("L", [1, 65, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_core_on_cpu_matches_its_rounding_model(dtype, L):
    """The blocks' core alone (attention_core) runs its plain version on the
    CPU, counting no launch: its rounding model within the core's card
    gate on the real rows, finite everywhere; a qkv buffer of another shape
    raises."""
    B, nh, hd = 3, 2, 32
    qkv = _block_qkv(B, nh, L, hd, seed=L, dtype=dtype)
    seg = torch.from_numpy(_ragged_segments(B, L, seed=L))
    n = attention_core.launches
    got = attention_core(qkv, seg)
    assert attention_core.launches == n
    assert got.dtype == dtype and got.shape == (B, L, nh * hd)
    assert torch.isfinite(got).all()
    valid = seg > 0
    want = _block_core_model(qkv, seg)
    _core_gate(got.reshape(B, L, nh, hd)[valid], want[valid], rel=_core_rel(dtype))
    with pytest.raises(ValueError):
        attention_core(qkv[:2], seg)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on_card(inp, device, dtype, activations):
    """Inputs on the card: activations in ``dtype``, weights rounded to it
    (what the kernels compute with), biases and LayerNorm in float32."""
    out = {}
    for k, v in _torch(inp, device).items():
        if k in activations or k.endswith("kernel") or k in ("w1", "w2"):
            v = v.to(dtype)
        out[k] = v
    return out


# the core's ragged shapes: L around its 64-key and 128-row tiles, every
# head dim it is built for, three sequences (_ragged_segments: a single-key
# segment, a sequence with no real token)
RAGGED_L, CORE_HEAD_DIMS = (1, 63, 64, 65, 127, 129, 513), (16, 32, 64, 128)
RAGGED_CORE = [(3, L, 2, hd) for L in RAGGED_L for hd in CORE_HEAD_DIMS]


# the attention block's card shapes
ATTENTION_CARD_SHAPES = (
    [(32, 512, 768, 12, 64), (3, 48, 256, 4, 64), (2, 200, 256, 8, 32), (2, 130, 256, 2, 128),
     (2, 96, 1024, 16, 64)]
    + [(B, L, 96, nh, hd) for B, L, nh, hd in RAGGED_CORE]
    # the GEMM tile's ragged widths (K tails, N % 8 != 0, the 4-byte copies
    # of H = 68 and the element-wise staging of an odd H)
    + [(3, 70, 68, 2, 32), (2, 129, 100, 3, 16), (2, 65, 67, 2, 16)]
)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,H,nh,hd", ATTENTION_CARD_SHAPES)
def test_attention_kernel_matches_plain_on_card(cuda, dtype, B, L, H, nh, hd):
    inp = _attention_inputs(B, L, H, nh, hd, seed=B + L, ragged=H == 96)
    t = _on_card(inp, cuda, dtype, activations={"hidden"})
    for ln in (True, False):
        kw = dict(sm_scale=hd**-0.5)
        if ln:
            kw.update(ln_scale=t["ln_scale"], ln_bias=t["ln_bias"])
        args = [t[k] for k in ("hidden", "segment_ids", "qkv_kernel", "qkv_bias",
                               "out_kernel", "out_bias")]
        n = fused_attention_block.launches
        got = fused_attention_block(*args, **kw)
        torch.cuda.synchronize()
        assert fused_attention_block.launches == n + 1
        want = attention_block_plain(*args, **kw)
        valid = t["segment_ids"] > 0
        torch.testing.assert_close(got[valid].float(), want[valid].float(),
                                   **_card_tol("fused_attention_block", dtype))


def test_f32_limit_rejects_bf16_probabilities():
    """The float32 card limit tells an attention block that rounds its
    probabilities to bf16 from the float32 block."""
    inp = _torch(_attention_inputs(4, 512, 768, 12, 64, seed=3))
    args = [inp[k] for k in ("hidden", "segment_ids", "qkv_kernel", "qkv_bias", "out_kernel",
                             "out_bias")]
    kw = dict(sm_scale=0.125, ln_scale=inp["ln_scale"], ln_bias=inp["ln_bias"])
    want = attention_block_plain(*args, **kw)
    bad = attention_block_bf16_probabilities(*args, **kw)
    valid = inp["segment_ids"] > 0
    with pytest.raises(AssertionError):
        torch.testing.assert_close(bad[valid], want[valid], **CARD_TOL[torch.float32])


def _attention_model_call(B, L, H, nh, hd, device, ln=True, seed=None):
    """(call(fn), valid rows) of the attention block on bf16 inputs and
    weights at these shapes, with or without the LayerNorm epilogue."""
    inp = _attention_inputs(B, L, H, nh, hd, seed=B + L if seed is None else seed,
                            ragged=H == 96)
    t = _on_card(inp, device, torch.bfloat16, activations={"hidden"})
    kw = dict(sm_scale=hd**-0.5)
    if ln:
        kw.update(ln_scale=t["ln_scale"], ln_bias=t["ln_bias"])
    args = [t[k] for k in ("hidden", "segment_ids", "qkv_kernel", "qkv_bias", "out_kernel",
                           "out_bias")]
    return (lambda fn: fn(*args, **kw)), t["segment_ids"] > 0


def test_bf16_model_limit_accepts_other_sum_orders_and_rejects_planted_faults():
    """Kernel 1's bf16 limit against its rounding model
    (chip_smoke.BF16_MODEL_TOL) at two sequences of 128, BERT-base widths:
    the model with its products summed in another order (float64, then
    rounded to float32) passes, the model with each of the GEMM tile's
    planted faults fails."""
    from spokennlp_tpu_torch.ops.cuda import attention_block as ab
    from spokennlp_tpu_torch.ops.cuda.blhd_attention import attention_block_model

    call, valid = _attention_model_call(2, 128, 768, 12, 64, "cpu", seed=7)
    want = call(attention_block_model)
    f64 = lambda real, x, w: (x.double() @ w.double()).float()
    with chip_smoke.planted([(ab, "float_product", None, f64)]):
        other = call(attention_block_model)
    assert not torch.equal(other, want)
    assert chip_smoke.beyond_limit(other[valid], want[valid], chip_smoke.BF16_MODEL_TOL) <= 0
    for fault, patches in chip_smoke.bf16_gemm_faults().items():
        with chip_smoke.planted(patches):
            bad = call(attention_block_model)
        assert chip_smoke.beyond_limit(bad[valid], want[valid], chip_smoke.BF16_MODEL_TOL) > 0, \
            fault


@pytest.mark.gpu
@pytest.mark.parametrize("ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("B,L,H,nh,hd", ATTENTION_CARD_SHAPES)
def test_attention_kernel_matches_its_rounding_model_on_card(cuda, ln, B, L, H, nh, hd):
    """Kernel 1 in bf16 against blhd_attention.attention_block_model within
    chip_smoke.BF16_MODEL_TOL on the valid rows."""
    from spokennlp_tpu_torch.ops.cuda.blhd_attention import attention_block_model

    call, valid = _attention_model_call(B, L, H, nh, hd, cuda, ln)
    got, want = call(fused_attention_block), call(attention_block_model)
    assert torch.isfinite(got).all()
    assert chip_smoke.beyond_limit(got[valid], want[valid], chip_smoke.BF16_MODEL_TOL) <= 0


@pytest.mark.gpu
def test_f32_limit_rejects_bf16_probabilities_on_card(cuda):
    """The float32 kernel passes the float32 limit against its plain
    version; the same check rejects the plain block with bf16
    probabilities."""
    inp = _torch(_attention_inputs(32, 512, 768, 12, 64, seed=5), cuda)
    args = [inp[k] for k in ("hidden", "segment_ids", "qkv_kernel", "qkv_bias", "out_kernel",
                             "out_bias")]
    kw = dict(sm_scale=0.125, ln_scale=inp["ln_scale"], ln_bias=inp["ln_bias"])
    got = fused_attention_block(*args, **kw)
    valid = inp["segment_ids"] > 0
    torch.testing.assert_close(got[valid], attention_block_plain(*args, **kw)[valid],
                               **CARD_TOL[torch.float32])
    bad = attention_block_bf16_probabilities(*args, **kw)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got[valid], bad[valid], **CARD_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,H,I", [(32 * 512, 768, 3072), (100, 256, 640), (70, 1024, 4096),
                                   # the GEMM tile's ragged widths: K tails, N % 8 != 0,
                                   # 4-byte copies (68, 100, 250), odd widths (67, 131)
                                   (70, 68, 136), (129, 100, 250), (50, 67, 131), (1, 96, 8)])
def test_mlp_kernel_matches_plain_on_card(cuda, dtype, M, H, I):
    t = _on_card(_mlp_inputs(M, H, I, seed=M), cuda, dtype, activations={"x"})
    n = fused_mlp_block.launches
    got = fused_mlp_block(*t.values(), activation="gelu", eps=1e-12, quantized=False)
    torch.cuda.synchronize()
    assert fused_mlp_block.launches == n + 1
    want = mlp_block_plain(*t.values(), activation="gelu", eps=1e-12)
    torch.testing.assert_close(got.float(), want.float(), **_card_tol("fused_mlp_block", dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused_attention_block", "fused_mlp_block"])
def test_bf16_limit_rejects_planted_faults_on_card(cuda, kernel):
    """At the main path's shapes (B=32, L=512, BERT-base) the bf16 kernel
    passes its limit against its plain version, and the same check rejects
    the plain version with each of the GEMM tile's planted faults."""
    if kernel == "fused_attention_block":
        t = _on_card(_attention_inputs(32, 512, 768, 12, 64, seed=11), cuda, torch.bfloat16,
                     {"hidden"})
        args = [t[k] for k in ("hidden", "segment_ids", "qkv_kernel", "qkv_bias", "out_kernel",
                               "out_bias")]
        kw = dict(sm_scale=0.125, ln_scale=t["ln_scale"], ln_bias=t["ln_bias"])
        call, plain, valid = (lambda fn: fn(*args, **kw)), attention_block_plain, \
            t["segment_ids"] > 0
    else:
        t = _on_card(_mlp_inputs(32 * 512, 768, 3072, seed=11), cuda, torch.bfloat16, {"x"})
        call = lambda fn, **kw: fn(*t.values(), activation="gelu", eps=1e-12, **kw)
        plain, valid = mlp_block_plain, slice(None)
    got = (call(fused_attention_block) if kernel == "fused_attention_block"
           else call(fused_mlp_block, quantized=False))
    tol = chip_smoke.BF16_TOL[kernel]
    assert chip_smoke.beyond_limit(got[valid], call(plain)[valid], tol) <= 0
    for fault, patches in chip_smoke.bf16_gemm_faults().items():
        with chip_smoke.planted(patches):
            bad = call(plain)
        assert chip_smoke.beyond_limit(got[valid], bad[valid], tol) > 0, fault


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hb", [12, 6])
def test_attention_w8a8_kernel_matches_plain_on_card(cuda, dtype, hb):
    """Both sides quantise the float32 weights the same way and round q, k,
    v, e and ctx where the TPU kernel does (in float32 on the kernel's own
    core, chip_smoke.on_card_core: the 3xTF32 core's truncating sums would
    move ctx's int8 steps beyond W8A8_FLIPS); the kernel's sum order moves
    the rest by float32 rounding, which can move an int8 step."""
    B, L, H, nh, hd = 8, 512, 768, 12, 64
    inp = _attention_inputs(B, L, H, nh, hd, seed=21)
    t = _on_card(inp, cuda, torch.float32, activations=set())
    t["hidden"] = t["hidden"].to(dtype)
    kw = dict(sm_scale=hd**-0.5, quantized=True, heads_per_block=hb)
    n = fused_attention_block.launches
    got = fused_attention_block(**t, **kw)
    torch.cuda.synchronize()
    assert fused_attention_block.launches == n + 1
    want = chip_smoke.on_card_core(str(dtype).split(".")[-1],
                                   lambda: attention_block_plain(**t, **kw))
    valid = t["segment_ids"] > 0
    assert_close_w8a8(got[valid], want[valid], bf16=dtype == torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mlp_w8a8_kernel_matches_plain_on_card(cuda, dtype):
    t = _on_card(_mlp_inputs(4096, 768, 3072, seed=22), cuda, torch.float32, activations=set())
    t["x"] = t["x"].to(dtype)
    n = fused_mlp_block.launches
    got = fused_mlp_block(*t.values(), activation="gelu", eps=1e-12, quantized=True)
    torch.cuda.synchronize()
    assert fused_mlp_block.launches == n + 1
    want = mlp_block_plain(*t.values(), activation="gelu", eps=1e-12, quantized=True)
    assert_close_w8a8(got, want, bf16=dtype == torch.bfloat16)


# Ragged shapes for the int8 tile's launchers (csrc/int8_gemm.cuh): rows M
# = B L of 1, 70 and 16,384; K of 68 and 136 (the tile's 4-byte copies), 768
# and 3072; N of 68, 192, 768, 2304 and 3072; G = 1, 2 and 12 head groups in
# the out projection. Each block against its plain version at the W8A8
# limits.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,H,nh,hd,hb", [(1, 1, 68, 2, 32, 2), (1, 70, 68, 2, 32, 1),
                                            (2, 35, 768, 12, 64, 1), (32, 512, 768, 12, 64, 6)])
def test_attention_w8a8_launchers_on_ragged_shapes_on_card(cuda, dtype, B, L, H, nh, hd, hb):
    """qkv_proj_i8 (slots 3) and residual_ln_i8 with nh / hb head groups (in
    float32 on the kernel's own core, chip_smoke.on_card_core)."""
    t = _on_card(_attention_inputs(B, L, H, nh, hd, seed=L + hb), cuda, torch.float32, set())
    if L < 8:  # every row real
        t["segment_ids"] = torch.ones_like(t["segment_ids"])
    t["hidden"] = t["hidden"].to(dtype)
    kw = dict(sm_scale=hd**-0.5, quantized=True, heads_per_block=hb)
    got = fused_attention_block(**t, **kw)
    torch.cuda.synchronize()
    want = chip_smoke.on_card_core(str(dtype).split(".")[-1],
                                   lambda: attention_block_plain(**t, **kw))
    valid = t["segment_ids"] > 0
    assert_close_w8a8(got[valid], want[valid], bf16=dtype == torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("static_h", [False, True], ids=["per_row", "static"])
@pytest.mark.parametrize("M,H,I", [(1, 68, 136), (70, 768, 3072), (16384, 768, 3072)])
def test_mlp_w8a8_launchers_on_ragged_shapes_on_card(cuda, dtype, static_h, M, H, I):
    """gemm_act_i8 with its float32 intermediate, or gemm_act_quant_i8 (the
    static scale), then residual_ln_i8 over K = I."""
    t = _on_card(_mlp_inputs(M, H, I, seed=M + I), cuda, torch.float32, activations=set())
    t["x"] = t["x"].to(dtype)
    kw = dict(activation="gelu", eps=1e-12, quantized=True, static_h_scale=static_h)
    got = fused_mlp_block(*t.values(), **kw)
    torch.cuda.synchronize()
    assert_close_w8a8(got, mlp_block_plain(*t.values(), **kw), bf16=dtype == torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stack_w8a8_equals_chain_on_ragged_shapes_on_card(cuda, dtype):
    """Kernel 3 in W8A8 runs the tile's device functions on the per-layer
    kernels' tiles: bit-identical to the chain of kernels 1 and 2 at M = 210
    rows, H = 68 (4-byte copies), I = 136."""
    B, L, H, nh, hd, I, NL = 3, 70, 68, 2, 32, 136, 2
    rng = np.random.default_rng(31)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
    p = [f(NL, H, 3, nh, hd, scale=H**-0.5), f(NL, 3, nh, hd, scale=0.02),
         f(NL, nh, hd, H, scale=(nh * hd) ** -0.5), f(NL, H, scale=0.02), 1 + f(NL, H, scale=0.1),
         f(NL, H, scale=0.1), f(NL, H, I, scale=H**-0.5), f(NL, I, scale=0.02),
         f(NL, I, H, scale=I**-0.5), f(NL, H, scale=0.02), 1 + f(NL, H, scale=0.1),
         f(NL, H, scale=0.1)]
    p = [t.to(cuda) for t in p]
    seg = torch.from_numpy(_segments(B, L, seed=31)).to(cuda)
    hidden = f(B, L, H).to(cuda, dtype)
    got = fused_encoder_stack(hidden, seg, *p, sm_scale=hd**-0.5, quantized=True)
    h = hidden
    for l in range(NL):
        # one head group, as the stack quantises ctx
        h = fused_attention_block(h, seg, *(t[l] for t in p[:4]), sm_scale=hd**-0.5,
                                  ln_scale=p[4][l], ln_bias=p[5][l], quantized=True,
                                  heads_per_block=nh)
        h = fused_mlp_block(h.reshape(B * L, H), *(t[l] for t in p[6:]), activation="gelu",
                            eps=1e-12, quantized=True).reshape(B, L, H)
    torch.cuda.synchronize()
    valid = seg > 0
    assert torch.equal(got[valid], h[valid])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L", [70, 129])
def test_stack_float_equals_chain_on_ragged_shapes_on_card(cuda, dtype, L):
    """Kernel 3's float modes run the core (bf16: 128-row tiles on the
    tensor cores) and the float tiles of kernels 1 and 2: bit-identical to
    their chain at ragged L, a single-key segment and a sequence with no
    real token."""
    B, H, nh, hd, I, NL = 3, 68, 2, 32, 136, 2
    rng = np.random.default_rng(L)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
    p = [f(NL, H, 3, nh, hd, scale=H**-0.5), f(NL, 3, nh, hd, scale=0.02),
         f(NL, nh, hd, H, scale=(nh * hd) ** -0.5), f(NL, H, scale=0.02), 1 + f(NL, H, scale=0.1),
         f(NL, H, scale=0.1), f(NL, H, I, scale=H**-0.5), f(NL, I, scale=0.02),
         f(NL, I, H, scale=I**-0.5), f(NL, H, scale=0.02), 1 + f(NL, H, scale=0.1),
         f(NL, H, scale=0.1)]
    p = [t.to(cuda) for t in p]
    seg = torch.from_numpy(_ragged_segments(B, L, seed=L)).to(cuda)
    hidden = f(B, L, H).to(cuda, dtype)
    got = fused_encoder_stack(hidden, seg, *p, sm_scale=hd**-0.5, quantized=False)
    h = hidden
    for l in range(NL):
        h = fused_attention_block(h, seg, *(t[l] for t in p[:4]), sm_scale=hd**-0.5,
                                  ln_scale=p[4][l], ln_bias=p[5][l])
        h = fused_mlp_block(h.reshape(B * L, H), *(t[l] for t in p[6:]), activation="gelu",
                            eps=1e-12, quantized=False).reshape(B, L, H)
    torch.cuda.synchronize()
    valid = seg > 0
    assert torch.isfinite(got).all()
    assert torch.equal(got[valid], h[valid])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fault", PLANTED)
def test_w8a8_check_rejects_planted_faults_on_card(cuda, dtype, fault):
    """The check the W8A8 kernels pass above fails for each planted fault at
    the same shapes (the faulty block's kernel where it has one)."""
    att = _on_card(_attention_inputs(8, 512, 768, 12, 64, seed=21), cuda, torch.float32, set())
    att["hidden"] = att["hidden"].to(dtype)
    mlp = _on_card(_mlp_inputs(4096, 768, 3072, seed=22), cuda, torch.float32, activations=set())
    mlp["x"] = mlp["x"].to(dtype)
    got, want = _planted_fault(fault, {**att, "sm_scale": 0.125}, mlp, hb=6)
    valid = att["segment_ids"] > 0 if fault in PLANTED[:2] else slice(None)
    with pytest.raises(AssertionError):
        assert_close_w8a8(got[valid], want[valid], bf16=dtype == torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nh,L,hd",
                         [(8, 12, 512, 64), (2, 3, 200, 32), (2, 2, 130, 128)] + RAGGED_CORE)
def test_snld_kernel_matches_plain_on_card(cuda, dtype, B, nh, L, hd):
    """The kernel takes the exponent in bfloat16, the plain reference in
    float32: 2^-9 relative per probability. Against its own rounding model
    (snld_attention_plain; in float32 its products on the 3xTF32 model):
    within one bf16 step of the largest output (_core_gate; in float32 also
    SNLD_F32_NORM in norm, which plain TF32 there fails). The ragged cases
    (B = 3) add a single-key segment and a sequence with no real token,
    whose output must be finite. Two runs give the same bits."""
    qkv, seg = _qkv_inputs(B, nh, L, hd, seed=B + L)
    if B == 3:
        seg = _ragged_segments(B, L, seed=B + L)
    q, s = torch.from_numpy(qkv).to(cuda, dtype), torch.from_numpy(seg).to(cuda)
    n = snld_self_attention.launches
    got = snld_self_attention(q, s, hd**-0.5)
    torch.cuda.synchronize()
    assert snld_self_attention.launches == n + 1
    assert torch.isfinite(got).all()
    want = reference_snld_attention(q, s, hd**-0.5)
    valid = (s > 0)[:, None, :].expand(B, nh, L)
    torch.testing.assert_close(got[valid].float(), want[valid].float(), atol=1e-2, rtol=2e-2)
    model = lambda terms=3: _core_model(dtype, lambda: snld_attention_plain(q, s, hd**-0.5),
                                        terms)[valid]
    gate = _snld_f32_gate if dtype == torch.float32 else _core_gate
    gate(got[valid], model())
    assert torch.equal(got, snld_self_attention(q, s, hd**-0.5))
    if dtype == torch.float32 and L >= 64:  # plain TF32 in the model's products fails it
        with pytest.raises(AssertionError):
            gate(got[valid], model(terms=1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nh,L,hd", [(8, 12, 512, 64)] + RAGGED_CORE)
def test_attention_core_matches_its_rounding_model_on_card(cuda, dtype, B, nh, L, hd):
    """The blocks' core alone at their launch (attention_core, the block
    layout, the exponent in the element type) within the core's gate of
    its rounding model (in float32 on the 3xTF32 model, which plain TF32
    there fails), finite everywhere, one launch counted, the same bits
    twice."""
    qkv = _block_qkv(B, nh, L, hd, seed=B + L + hd, dtype=dtype).to(cuda)
    seg = torch.from_numpy(_ragged_segments(B, L, seed=B + L + hd)).to(cuda)
    n = attention_core.launches
    got = attention_core(qkv, seg)
    torch.cuda.synchronize()
    assert attention_core.launches == n + 1
    assert torch.isfinite(got).all()
    valid = seg > 0
    model = lambda terms=3: _core_model(dtype, lambda: _block_core_model(qkv, seg), terms)[valid]
    _core_gate(got.reshape(B, L, nh, hd)[valid], model(), rel=_core_rel(dtype))
    assert torch.equal(got, attention_core(qkv, seg))
    if dtype == torch.float32 and L >= 64:
        with pytest.raises(AssertionError):
            _core_gate(got.reshape(B, L, nh, hd)[valid], model(terms=1), rel=_core_rel(dtype))


@pytest.mark.gpu
def test_kernel_wrappers_reject_bad_inputs_on_card(cuda):
    t = _on_card(_attention_inputs(2, 64, 256, 4, 64, seed=1), cuda, torch.float32, {"hidden"})
    args = [t[k] for k in ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias")]
    with pytest.raises(TypeError):
        fused_attention_block(t["hidden"].half(), t["segment_ids"], *args, sm_scale=0.125)
    with pytest.raises(ValueError):
        fused_attention_block(t["hidden"].transpose(0, 1), t["segment_ids"], *args, sm_scale=0.125)
    with pytest.raises(ValueError):
        fused_attention_block(t["hidden"], t["segment_ids"].cpu(), *args, sm_scale=0.125)
    m = _on_card(_mlp_inputs(16, 256, 512, seed=2), cuda, torch.float32, {"x"})
    with pytest.raises(ValueError):
        fused_mlp_block(m["x"].t(), *list(m.values())[1:], activation="gelu", eps=1e-12,
                        quantized=False)
