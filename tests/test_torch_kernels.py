"""Port kernels: plain versions against the JAX kernels on the CPU, and the
CUDA kernels against the plain versions on the card (``-m gpu``).

JAX is imported inside the CPU tests only, so the card tests (``-m gpu``) do
not depend on it.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.ops.cuda.attention_block import (
    attention_block_plain,
    fused_attention_block,
)
from spokennlp_tpu_torch.ops.cuda.int8_matmul import ACTIVATIONS
from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain

# Tolerances. CPU: the plain float32 versions against the JAX kernels in
# interpret mode, as tests/test_attention_block.py compares them. Card,
# float32: the same math summed in another order. Card, bfloat16: both sides
# get the same bf16 inputs and weights; the kernels also round q, k, v, the
# probabilities and ctx (or the MLP intermediate) to bf16 (unit roundoff
# 2^-9 each) where the plain version stays in float32, on LayerNorm outputs
# of unit scale.
CPU_TOL = dict(atol=5e-3, rtol=1e-2)
CARD_TOL = {torch.float32: dict(atol=1e-3, rtol=1e-3), torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}


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


def _attention_inputs(B, L, H, nh, hd, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(
        hidden=f(B, L, H),
        segment_ids=_segments(B, L, seed),
        qkv_kernel=f(H, 3, nh, hd, scale=H**-0.5),
        qkv_bias=f(3, nh, hd, scale=0.02),
        out_kernel=f(nh, hd, H, scale=(nh * hd) ** -0.5),
        out_bias=f(H, scale=0.02),
        ln_scale=1.0 + f(H, scale=0.1),
        ln_bias=f(H, scale=0.1),
    )


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

    from spokennlp_tpu.ops.pallas import attention_block, int8_matmul, mlp_block

    return SimpleNamespace(
        jnp=jnp,
        fused_attention_block=attention_block.fused_attention_block,
        reference_attention_block=attention_block.reference_attention_block,
        fused_mlp_block=mlp_block.fused_mlp_block,
        activations=int8_matmul._ACTIVATIONS,
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


def test_quantized_kernels_raise():
    att = _torch(_attention_inputs(1, 16, 32, 2, 16, seed=8))
    mlp = _torch(_mlp_inputs(M=8, H=32, I=64, seed=9))
    with pytest.raises(NotImplementedError):
        fused_attention_block(
            att["hidden"], att["segment_ids"], att["qkv_kernel"], att["qkv_bias"],
            att["out_kernel"], att["out_bias"], sm_scale=0.25, quantized=True,
        )
    with pytest.raises(NotImplementedError):
        fused_mlp_block(*mlp.values(), activation="gelu", eps=1e-12, quantized=True)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "B,L,H,nh,hd", [(32, 512, 768, 12, 64), (3, 48, 256, 4, 64), (2, 200, 256, 8, 32),
                    (2, 130, 256, 2, 128), (2, 96, 1024, 16, 64)],
)
def test_attention_kernel_matches_plain_on_card(cuda, dtype, B, L, H, nh, hd):
    inp = _attention_inputs(B, L, H, nh, hd, seed=B + L)
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
        torch.testing.assert_close(got[valid].float(), want[valid].float(), **CARD_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,H,I", [(32 * 512, 768, 3072), (100, 256, 640), (70, 1024, 4096)])
def test_mlp_kernel_matches_plain_on_card(cuda, dtype, M, H, I):
    t = _on_card(_mlp_inputs(M, H, I, seed=M), cuda, dtype, activations={"x"})
    n = fused_mlp_block.launches
    got = fused_mlp_block(*t.values(), activation="gelu", eps=1e-12, quantized=False)
    torch.cuda.synchronize()
    assert fused_mlp_block.launches == n + 1
    want = mlp_block_plain(*t.values(), activation="gelu", eps=1e-12)
    torch.testing.assert_close(got.float(), want.float(), **CARD_TOL[dtype])


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
