"""Port W8A8 matmul (ops/cuda/int8_matmul.py) against the JAX module on the
CPU, and the CUDA kernels against their plain versions on the card
(``-m gpu``).

JAX is imported inside the CPU tests only. Tolerances: the quantisers and
the integer products are exact on both sides; the float32 epilogue is the
same arithmetic in the same order, so the outputs agree to float32 rounding
(1e-6 relative) or, in bfloat16, to one bf16 step (at most 2^-7 of the
value). The tanh GELU is computed by two libraries (1e-6).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.ops.cuda import int8_matmul as im

ACTS = sorted(im.ACTIVATIONS)


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas import int8_matmul

    return SimpleNamespace(jnp=jnp, m=int8_matmul)


def _data(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[3] *= 40.0  # a row with outliers
    x[5] = 0.0  # an all-zero row: the 1e-6 scale floor
    w = (rng.normal(size=(K, N)) * K**-0.5).astype(np.float32)
    b = (rng.normal(size=(N,)) * 0.1).astype(np.float32)
    return x, w, b


def test_quantize_rowwise_and_colwise_match_jax_exactly(jx):
    x, w, _ = _data(24, 40, 16, seed=0)
    for port, jax_fn, a in ((im.quantize_rowwise, jx.m.quantize_rowwise, x),
                            (im.quantize_colwise, jx.m.quantize_colwise, w)):
        q, s = port(torch.from_numpy(a))
        jq, js = jax_fn(jx.jnp.asarray(a))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_colwise_of_a_stack_quantises_each_matrix():
    w = torch.from_numpy(_data(8, 12, 6, seed=1)[1].reshape(2, 6, 6))
    q, s = im.quantize_colwise(w)
    for i in range(2):
        qi, si = im.quantize_colwise(w[i])
        torch.testing.assert_close(q[i], qi, atol=0, rtol=0)
        torch.testing.assert_close(s[i], si, atol=0, rtol=0)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w8a8_matmul_plain_matches_jax_kernel(jx, out_dtype, bias):
    x, w, b = _data(40, 64, 24, seed=2)
    x8, sx = im.quantize_rowwise(torch.from_numpy(x))
    w8, sw = im.quantize_colwise(torch.from_numpy(w))
    jdt = getattr(jx.jnp, out_dtype)
    want = jx.m.w8a8_matmul(
        jx.jnp.asarray(x8.numpy()), jx.jnp.asarray(sx.numpy()), jx.jnp.asarray(w8.numpy()),
        jx.jnp.asarray(sw.numpy()), jx.jnp.asarray(b) if bias else None, out_dtype=jdt,
        block_m=8, interpret=True,
    )
    got = im.w8a8_matmul(x8, sx, w8, sw, torch.from_numpy(b) if bias else None,
                         out_dtype=getattr(torch, out_dtype))
    tol = dict(atol=1e-6, rtol=1e-6) if out_dtype == "float32" else dict(atol=0, rtol=2**-7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    ref = im.w8a8_matmul_reference(x8, sx, w8, sw, torch.from_numpy(b) if bias else None,
                                   out_dtype=getattr(torch, out_dtype))
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("activation", ACTS)
def test_w8a8_matmul_bf16in_plain_matches_jax_kernel(jx, activation):
    """The in-kernel quantiser multiplies by 1 / s on both sides: the int8
    activations are equal, so the outputs agree to float32 rounding."""
    x, w, b = _data(40, 64, 24, seed=3)
    w8, sw = im.quantize_colwise(torch.from_numpy(w))
    want = jx.m.w8a8_matmul_bf16in(
        jx.jnp.asarray(x), jx.jnp.asarray(w8.numpy()), jx.jnp.asarray(sw.numpy()),
        jx.jnp.asarray(b), out_dtype=jx.jnp.float32, block_m=8, interpret=True,
        activation=activation,
    )
    got = im.w8a8_matmul_bf16in(torch.from_numpy(x), w8, sw, torch.from_numpy(b),
                                out_dtype=torch.float32, activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("activation", ["none", "gelu"])
def test_quant_dense_matches_jax_off_tpu(jx, activation):
    """JAX's off-TPU branch: divide to quantise, the activation after the
    rounding to out_dtype; the port's CPU branch is the same arithmetic."""
    x, w, b = _data(30, 64, 24, seed=4)
    x3 = x.reshape(3, 10, 64)
    for dt in ("float32", "bfloat16"):
        want = jx.m.quant_dense(jx.jnp.asarray(x3), jx.jnp.asarray(w), jx.jnp.asarray(b),
                                out_dtype=getattr(jx.jnp, dt), use_pallas=False,
                                activation=activation)
        got = im.quant_dense(torch.from_numpy(x3), torch.from_numpy(w), torch.from_numpy(b),
                             out_dtype=getattr(torch, dt), activation=activation)
        assert got.shape == (3, 10, 24)
        tol = dict(atol=1e-6, rtol=1e-5) if dt == "float32" else dict(atol=0, rtol=2**-7)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_rowquant_plain_groups_quantise_each_group():
    x = torch.from_numpy(_data(6, 32, 4, seed=5)[0])
    q, s = im.rowquant_plain(x, groups=4)
    assert q.shape == (6, 32) and s.shape == (6, 4)
    for g in range(4):
        qg, sg = im.rowquant_plain(x[:, g * 8:(g + 1) * 8])
        torch.testing.assert_close(q[:, g * 8:(g + 1) * 8], qg, atol=0, rtol=0)
        torch.testing.assert_close(s[:, g:g + 1], sg, atol=0, rtol=0)
    assert q.abs().max() <= 127 and (q == -128).sum() == 0


@pytest.mark.parametrize("case", ["matrix", "stack", "grouped"])
def test_kmajor_product_matches_int8_product_and_jax(jx, case):
    """The kernels' K-major weights (N, K) (``kmajor``) give the exact
    integer product of the (K, N) layout: int64 x8 . kmajor(w8)^T equals
    int8_product and JAX's w8a8_matmul_reference with unit scales, for one
    matrix, each matrix of a stack (NL, K, N), and each head group of an
    out projection quantised per group (group g is K-columns [g K / G, (g +
    1) K / G) of the transposed whole)."""
    rng = np.random.default_rng(12)
    M, K, N, G = 10, 48, 20, 4
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    lead = (3,) if case == "stack" else ()
    w = torch.from_numpy(rng.normal(size=(*lead, K, N)).astype(np.float32))
    if case == "grouped":
        w8 = im.quantize_colwise(w.reshape(G, K // G, N))[0].reshape(K, N)
        x8 = im.rowquant_plain(x, G)[0]
        groups = [slice(g * K // G, (g + 1) * K // G) for g in range(G)]
    else:
        w8, x8, groups = im.quantize_colwise(w)[0], im.rowquant_plain(x)[0], [slice(None)]
    wt = im.kmajor(w8)
    assert wt.shape == (*lead, N, K) and wt.dtype == torch.int8 and wt.is_contiguous()
    mats = [(w8[i], wt[i]) for i in range(lead[0])] if lead else [(w8, wt)]
    j = lambda t: jx.jnp.asarray(t.numpy())
    for wk, wn in mats:
        for cols in groups:
            got = (x8[:, cols].long() @ wn[:, cols].long().T).float()
            torch.testing.assert_close(got, im.int8_product(x8[:, cols], wk[cols]), atol=0,
                                       rtol=0)
            want = jx.m.w8a8_matmul_reference(j(x8[:, cols]), jx.jnp.ones((M, 1)), j(wk[cols]),
                                              jx.jnp.ones((1, N)), out_dtype=jx.jnp.float32)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_on_cpu_run_plain_without_counting():
    x, w, b = (torch.from_numpy(a) for a in _data(16, 32, 8, seed=6))
    n = (im.w8a8_matmul.launches, im.w8a8_matmul_bf16in.launches)
    w8, sw = im.quantize_colwise(w)
    got = im.w8a8_matmul_bf16in(x, w8, sw, b, activation="gelu")
    x8, sx = im.rowquant_plain(x)
    want = im.w8a8_matmul_plain(x8, sx, w8, sw, b, activation="gelu")
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert (im.w8a8_matmul.launches, im.w8a8_matmul_bf16in.launches) == n


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(512, 768, 2304), (300, 3072, 768), (70, 68, 40)])
def test_int8_accumulator_exact_on_card(cuda, M, K, N):
    """With unit scales and no bias the kernel's float32 output is float(acc):
    it equals the exact integer product, rounded once to float32."""
    g = torch.Generator(device=cuda).manual_seed(M)
    x8 = torch.randint(-127, 128, (M, K), generator=g, device=cuda, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (K, N), generator=g, device=cuda, dtype=torch.int8)
    ones = lambda n: torch.ones(n, device=cuda)
    n = im.w8a8_matmul.launches
    got = im.w8a8_matmul(x8, ones(M), w8, ones(N), out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert im.w8a8_matmul.launches == n + 1
    torch.testing.assert_close(got, im.int8_product(x8, w8), atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["none", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_w8a8_bf16in_kernel_matches_plain_on_card(cuda, dtype, activation):
    """The row quantiser is the same float32 arithmetic on both sides (int8
    equal); the epilogue the same products and sums in the same order, the
    tanh of two libraries apart: one output step in bf16 (at most 2^-7 of
    the value)."""
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _data(512, 768, 3072, seed=7))
    x = x.to(dtype)
    w8, sw = im.quantize_colwise(w)
    x8, sx = im.rowquant_cuda(x)
    px8, psx = im.rowquant_plain(x)
    torch.testing.assert_close(x8, px8, atol=0, rtol=0)
    torch.testing.assert_close(sx, psx, atol=0, rtol=0)
    got = im.w8a8_matmul_bf16in(x, w8, sw, b, out_dtype=dtype, activation=activation)
    want = im.w8a8_matmul_plain(px8, psx, w8, sw, b, dtype, activation)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=2**-7)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [68, 768, 3072])
@pytest.mark.parametrize("N", [40, 768, 2304])
@pytest.mark.parametrize("M", [1, 70, 16384])
def test_gemm_i8_launcher_on_ragged_shapes_on_card(cuda, M, N, K):
    """launch_gemm_i8 through kernel 5 (K = 68: the tile's 4-byte copies):
    with unit scales and no bias the float32 output is float(acc) and equals
    the exact product; with scales, bias and the tanh GELU in bf16 it equals
    the plain version within one output step (2^-7 of the value)."""
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    x8 = torch.randint(-127, 128, (M, K), generator=g, device=cuda, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (K, N), generator=g, device=cuda, dtype=torch.int8)
    ones = lambda n: torch.ones(n, device=cuda)
    got = im.w8a8_matmul(x8, ones(M), w8, ones(N), out_dtype=torch.float32)
    torch.testing.assert_close(got, im.int8_product(x8, w8), atol=0, rtol=0)
    sx = torch.rand(M, generator=g, device=cuda) * 1e-3 + 1e-4
    sw = torch.rand(N, generator=g, device=cuda) * 1e-2 + 1e-3
    b = torch.randn(N, generator=g, device=cuda) * 0.1
    got = im.w8a8_matmul(x8, sx, w8, sw, b, torch.bfloat16, "gelu")
    want = im.w8a8_matmul_plain(x8, sx, w8, sw, b, torch.bfloat16, "gelu")
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=2**-7)
