"""Port whole-stack kernel (ops/cuda/stack_block.py): its plain version
against the JAX kernel in interpret mode, the port's stack path against its
fused path on one ``state_dict``, and on the card (``-m gpu``) the kernel
against the chain of the per-layer kernels and the plain loop.

Sizes are those of tests/test_stack_block.py. JAX is imported inside the CPU
tests only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spokennlp_tpu.configs import EncoderConfig
from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
from spokennlp_tpu_torch.models.encoder import Encoder
from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack, stack_plain

NL, H, nh, hd, I = 3, 32, 4, 8, 64
# float32 both sides: the same layer math, sums in another order (1e-5); in
# W8A8 an order difference can move a value across an int8 rounding boundary,
# which moves a few outputs by up to about 1e-2 (tests/test_torch_kernels.py)
FLOAT_TOL = dict(atol=1e-5, rtol=1e-5)
# On the card, the stack against the plain loop of 2 layers: max |err| / max
# |ref| per (quantized, dtype). float32: sums in another order. bfloat16: the
# kernels round q, k, v, p, ctx and the intermediate to bf16 where the plain
# loop stays in float32. W8A8: int8 steps that those differences move, each
# spreading over its row in the next layer.
CARD_STACK_TOL = {(False, torch.float32): 1e-5, (False, torch.bfloat16): 2e-2,
                  (True, torch.float32): 3e-2, (True, torch.bfloat16): 5e-2}


def _params(rng, nl=NL, h=H, heads=nh, head_dim=hd, inter=I):
    f = lambda mean, std, *s: rng.normal(mean, std, s).astype(np.float32)
    return [f(0, 0.05, nl, h, 3, heads, head_dim), f(0, 0.01, nl, 3, heads, head_dim),
            f(0, 0.05, nl, heads, head_dim, h), f(0, 0.01, nl, h), f(1, 0.02, nl, h),
            f(0, 0.02, nl, h), f(0, 0.05, nl, h, inter), f(0, 0.01, nl, inter),
            f(0, 0.05, nl, inter, h), f(0, 0.01, nl, h), f(1, 0.02, nl, h), f(0, 0.02, nl, h)]


def _seg(B, L):
    seg = np.ones((B, L), np.int32)
    seg[:, L - 8:] = 0  # padding tail
    seg[1, L // 2: L - 8] = 2  # packed windows
    return seg


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "w8a8"])
def test_stack_plain_matches_jax_stack_kernel(quantized):
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.stack_block import fused_encoder_stack as jax_stack

    rng = np.random.default_rng(int(quantized))
    B, L = 2, 64
    p = _params(rng)
    hidden = rng.normal(0, 1, (B, L, H)).astype(np.float32)
    seg = _seg(B, L)
    want = np.asarray(jax_stack(jnp.asarray(hidden), jnp.asarray(seg), *map(jnp.asarray, p),
                                sm_scale=hd**-0.5, quantized=quantized, interpret=True))
    n = fused_encoder_stack.launches
    got = fused_encoder_stack(torch.from_numpy(hidden), torch.from_numpy(seg),
                              *map(torch.from_numpy, p), sm_scale=hd**-0.5,
                              quantized=quantized).numpy()
    assert fused_encoder_stack.launches == n
    valid = seg > 0
    if quantized:
        err = np.abs(got[valid] - want[valid])
        assert err.max() <= 2e-2 and (err > 1e-5 * (1 + np.abs(want[valid]))).mean() <= 0.01
    else:
        np.testing.assert_allclose(got[valid], want[valid], **FLOAT_TOL)


def _encoders(quantize, impls, heads=12):
    """Port encoders of each impl carrying one state_dict (12 heads, so the
    fused path's default head group is the whole row, as in the stack)."""
    cfg = EncoderConfig(vocab_size=128, hidden_size=heads * hd, num_layers=2, num_heads=heads,
                        intermediate_size=128, max_position_embeddings=64, quantize=quantize,
                        attention_impl=impls[0], add_pooler=True)
    first = Encoder(cfg, generator=torch.Generator().manual_seed(0)).eval()
    sd = first.state_dict()
    out = [first]
    for impl in impls[1:]:
        enc = Encoder(dataclasses.replace(cfg, attention_impl=impl)).eval()
        enc.load_state_dict(sd, strict=True)
        out.append(enc)
    return out


@pytest.mark.parametrize("quantize", ["none", "w8a8"])
def test_stack_path_equals_fused_path_on_one_state_dict(quantize):
    stack, fused = _encoders(quantize, ("stack", "fused"))
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(3, 127, (2, 40)).astype(np.int64))
    mask = torch.ones((2, 40), dtype=torch.int32)
    mask[1, 30:] = 0
    with torch.inference_mode():
        a = stack(ids, attention_mask=mask)
        b = fused(ids, attention_mask=mask)
    assert a.hidden_states is None
    torch.testing.assert_close(a.last_hidden_state, b.last_hidden_state, atol=0, rtol=0)
    torch.testing.assert_close(a.pooled_output, b.pooled_output, atol=0, rtol=0)


def test_stack_path_matches_jax_stack_path():
    """The encoder's stack path (stacked raw parameters, pack_segment_ids as
    the segments, pooler on the CLS row) against JAX's in interpret mode."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.encoder import Encoder as JaxEncoder

    cfg = EncoderConfig(vocab_size=128, hidden_size=H, num_layers=2, num_heads=nh,
                        intermediate_size=I, max_position_embeddings=64, quantize="w8a8",
                        attention_impl="stack", add_pooler=True)
    rng = np.random.default_rng(6)
    ids = rng.integers(3, 127, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.int32)
    mask[1, 24:] = 0
    pack = np.where(mask > 0, 1 + (np.arange(32) >= 12), 0).astype(np.int32)
    jenc = JaxEncoder(cfg)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    want = jenc.apply(params, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                      pack_segment_ids=jnp.asarray(pack))
    enc = Encoder(cfg).eval()
    enc.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params["params"])))
    with torch.inference_mode():
        got = enc(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                  pack_segment_ids=torch.from_numpy(pack))
    valid = pack > 0
    err = np.abs(got.last_hidden_state.numpy()[valid] - np.asarray(want.last_hidden_state)[valid])
    assert err.max() <= 2e-2 and err.mean() <= 2e-3  # tests/test_torch_encoder.py says why
    np.testing.assert_allclose(got.pooled_output.numpy(), np.asarray(want.pooled_output),
                               atol=2e-2)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "w8a8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stack_kernel_matches_chain_and_plain_on_card(cuda, dtype, quantized):
    """The stack runs the per-layer kernels' device functions on the same
    tiles: it equals their chain bit for bit. Against the plain loop: within
    CARD_STACK_TOL."""
    B, L, Hb, heads, inter = 4, 256, 768, 12, 3072
    p = [torch.from_numpy(a).to(cuda) for a in _params(np.random.default_rng(9), 2, Hb, heads,
                                                       64, inter)]
    seg = torch.from_numpy(_seg(B, L)).to(cuda)
    hidden = torch.randn(B, L, Hb, generator=torch.Generator().manual_seed(0)).to(cuda, dtype)
    n = fused_encoder_stack.launches
    got = fused_encoder_stack(hidden, seg, *p, sm_scale=0.125, quantized=quantized)
    torch.cuda.synchronize()
    assert fused_encoder_stack.launches == n + 1 and fused_encoder_stack.grid > 0
    h = hidden
    for l in range(2):
        h = fused_attention_block(h, seg, p[0][l], p[1][l], p[2][l], p[3][l], sm_scale=0.125,
                                  ln_scale=p[4][l], ln_bias=p[5][l], quantized=quantized)
        h = fused_mlp_block(h.reshape(B * L, Hb), *(t[l] for t in p[6:]), activation="gelu",
                            eps=1e-12, quantized=quantized).reshape(B, L, Hb)
    valid = seg > 0
    assert torch.equal(got[valid], h[valid])
    # the float modes compute with the weight matrices rounded to dtype
    rounded = [t.to(dtype) if i in (0, 2, 6, 8) and not quantized else t for i, t in enumerate(p)]
    want = stack_plain(hidden, seg, *rounded, sm_scale=0.125, quantized=quantized)
    g, w = got[valid].float(), want[valid].float()
    assert (g - w).abs().max() <= CARD_STACK_TOL[quantized, dtype] * w.abs().max()
