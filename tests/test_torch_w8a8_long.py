"""W8A8 long-context serving and the last kernel modes, against the JAX
package on the CPU: the W8A8 plain versions of the Longformer block (kernel
7) and the BigBird block (kernel 8), the W8A8 MLP block with a static
intermediate scale (2b) and the W8A8 attention block with the int8 attention
core (1c), each against JAX's Pallas kernel in interpret mode; the W8A8
Longformer and BigBird topic-segmentation models on the fused path against
JAX's; JAX parameters loading into the W8A8 configurations; the planted
faults of chip_smoke.py against the W8A8 check; and the CUDA kernels of the
new modes against their plain versions on the card (``-m gpu``).

Shapes: B=2, L=64, H=32, 2 heads of 16; window 16; BigBird blocks of 8 with
1 global and 2 random blocks; the MLP at M=1100 rows (a sample stride of 2).
Tolerances (``assert_close_long``): the W8A8 limits of
tests/test_torch_kernels.py, float32 rounding but for at most 1 % of the
outputs, each moved by at most one int8 step (in float32 the plain versions
meet JAX's kernels exactly on these inputs). In bfloat16 both sides round q,
k, v, the exponent and the output to bf16, so the rounding is 2e-3 + 2^-7
|ref|, and the same 1 % share: where a float32 sum of another order puts a
score or an output across a bf16 boundary, an exponent moves by 2^-8 and a
ctx value by an int8 step, which at H=32 carries a few outputs of its row
one bf16 step further (0.15-0.35 % of the outputs over four seeds of the
Longformer block; the card's 0.2 % is for H=768, where a step moves an
output about 1e-3). Whole models as tests/test_torch_encoder.py bounds
them: the largest logit error 5e-2, its mean 5e-3, argmax agreement >=
0.99.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_bigbird import _inputs as bigbird_inputs
from test_torch_bigbird_model import BIGBIRD
from test_torch_bigbird_model import _inputs as bigbird_ids
from test_torch_kernels import (
    W8A8_FLIPS,
    W8A8_STEP_TOL,
    _attention_inputs,
    _mlp_inputs,
    _torch,
    assert_close_w8a8,
)
from test_torch_longformer import LONGFORMER, _jax_cfg, _jax_task
from test_torch_longformer import _inputs as longformer_ids
from test_torch_sliding import _inputs as sliding_inputs
from test_torch_sliding import _masks as sliding_masks

from spokennlp_tpu_torch.configs import TopicSegConfig
from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
from spokennlp_tpu_torch.models.topic_seg import TopicSegModel
from spokennlp_tpu_torch.ops.cuda import bigbird_block as bb
from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
from spokennlp_tpu_torch.ops.cuda.attention_block import (
    attention_block_plain,
    fused_attention_block,
)
from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the planted faults the card run gates)

B, L, H, NH, WINDOW, BLOCK, GB, RB = 2, 64, 32, 2, 16, 8, 1, 2
HD = H // NH
SLIDING_ARGS = ("qkv_kernel", "qkv_bias", "gqkv_kernel", "gqkv_bias", "out_kernel", "out_bias")
BIGBIRD_ARGS = ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias")
DTYPES = ["float32", "bfloat16"]


def assert_close_long(got, want, bf16=False):
    """assert_close_w8a8 with the float32 share of flips (1 %) also in
    bf16, where the rounding is 2e-3 + 2^-7 |ref| (the module docstring
    gives the reasons)."""
    if not bf16:
        return assert_close_w8a8(got, want)
    if isinstance(got, torch.Tensor):
        got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    rounding = 2e-3 + 2**-7 * np.abs(np.asarray(want, np.float64))
    assert (err - rounding).max() <= W8A8_STEP_TOL, err.max()
    share = (err > rounding).mean()
    assert share <= W8A8_FLIPS, share


def _split(inp, names, dtype):
    """(hidden in dtype, the float32 weights in order, ln kwargs) as torch
    and as jax arrays."""
    import jax.numpy as jnp

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ln = ("ln_scale", "ln_bias")
    port = (torch.from_numpy(inp["hidden"]).to(tdt), [torch.from_numpy(inp[k]) for k in names],
            {k: torch.from_numpy(inp[k]) for k in ln})
    jax_ = (jnp.asarray(inp["hidden"]).astype(jdt), [jnp.asarray(inp[k]) for k in names],
            {k: jnp.asarray(inp[k]) for k in ln})
    return port, jax_


# ------------------------------------------------- kernel 7 W8A8: plain vs JAX


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("global_rows", [True, False], ids=["globals", "no_globals"])
def test_sliding_w8a8_plain_matches_jax_kernel(dtype, global_rows):
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.sliding_block import fused_sliding_attention_block as jax_block

    inp = sliding_inputs(B, L, H, NH, seed=21, global_rows=global_rows)
    (h, w, ln), (jh, jw, jln) = _split(inp, SLIDING_ARGS, dtype)
    kw = dict(sm_scale=HD**-0.5, window=WINDOW, max_globals=16, global_rows=global_rows)
    want = np.asarray(jax_block(jh, jnp.asarray(inp["attention_mask"]),
                                jnp.asarray(inp["global_mask"]), *jw, quantized=True,
                                interpret=True, **jln, **kw).astype(jnp.float32))
    mask, glob = torch.from_numpy(inp["attention_mask"]), torch.from_numpy(inp["global_mask"])
    n = sb.fused_sliding_attention_block.launches
    got = sb.fused_sliding_attention_block(h, mask, glob, *w, quantized=True, **ln, **kw)
    assert sb.fused_sliding_attention_block.launches == n  # the CPU runs the plain version
    assert got.dtype == h.dtype
    valid = inp["attention_mask"] > 0
    assert_close_long(got.float().numpy()[valid], want[valid], bf16=dtype == "bfloat16")


# ------------------------------------------------- kernel 8 W8A8: plain vs JAX


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq", [64, 32], ids=["nb8", "nb4"])
def test_bigbird_w8a8_plain_matches_jax_kernel(dtype, seq):
    """nb4: 4 blocks, where random entries fall back to padded self."""
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.bigbird_block_kernel import (
        fused_bigbird_attention_block as jax_block,
    )

    inp = bigbird_inputs(B, seq, H, NH, seed=22)
    (h, w, ln), (jh, jw, jln) = _split(inp, BIGBIRD_ARGS, dtype)
    pattern = (BLOCK, GB, RB, 3)
    want = np.asarray(jax_block(jh, jnp.asarray(inp["attention_mask"]), *jw, *pattern,
                                sm_scale=HD**-0.5, quantized=True, interpret=True,
                                **jln).astype(jnp.float32))
    got = bb.fused_bigbird_attention_block(h, torch.from_numpy(inp["attention_mask"]), *w,
                                           *pattern, HD**-0.5, quantized=True, **ln)
    valid = inp["attention_mask"] > 0
    assert_close_long(got.float().numpy()[valid], want[valid], bf16=dtype == "bfloat16")


# -------------------------------------------- 2b: the static intermediate scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_mlp_static_h_scale_plain_matches_jax_kernel(dtype, activation):
    """M=1100: the sample takes every second row (550 rows), not 512."""
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.mlp_block import fused_mlp_block as jax_mlp

    inp = _mlp_inputs(M=1100, H=H, I=64, seed=23)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    j["x"] = j["x"].astype(jdt)
    kw = dict(activation=activation, eps=1e-12, quantized=True)
    want = np.asarray(jax_mlp(*j.values(), **kw, static_h_scale=True,
                              interpret=True).astype(jnp.float32))
    t = _torch(inp)
    t["x"] = t["x"].to(tdt)
    got = fused_mlp_block(*t.values(), **kw, static_h_scale=True)
    assert_close_long(got.float().numpy(), want, bf16=dtype == "bfloat16")
    # the mode changes the result: per-row scales are another function
    per_row = fused_mlp_block(*t.values(), **kw)
    assert not torch.equal(per_row, got)


def test_static_h_scale_estimate_samples_with_stride():
    from spokennlp_tpu_torch.ops.cuda.mlp_block import static_h_scale_estimate

    t = _torch(_mlp_inputs(M=1100, H=H, I=64, seed=24))
    x, w1, b1 = t["x"], t["w1"], t["b1"]
    h = torch.relu(x[::2] @ w1 + b1)
    want = h.abs().amax().clamp_min(1e-3) * (1.0 / 127.0)
    torch.testing.assert_close(static_h_scale_estimate(x, w1, b1, "relu"), want.reshape(1))
    assert static_h_scale_estimate(x[:10] * 0, w1 * 0, b1 * 0, "relu").item() == pytest.approx(
        1e-3 / 127)


# ------------------------------------------------- 1c: the int8 attention core


def _core_inputs(seed, hidden=H, hd=8):
    """B=3, 4 heads of ``hd``: row 0 padded at its tail, row 1 two packed
    segments and a padded tail, row 2 padding only (every query row of it
    has no allowed key)."""
    inp = _attention_inputs(3, L, hidden, 4, hd, seed)
    seg = np.zeros((3, L), np.int32)
    seg[0, :50] = 1
    seg[1, :30], seg[1, 30:56] = 1, 2
    inp["segment_ids"] = seg
    return inp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hb", [4, 2], ids=["one_group", "two_groups"])
@pytest.mark.parametrize("core", ["qk", "av", "both", True])
def test_core_int8_plain_matches_jax_kernel(core, hb, dtype):
    """Every mode at head groups of 4 (one group) and 2. With a "qk" core a
    query row with no allowed key is uniform by construction, so all rows are
    compared; with "av" alone only real rows (a padded row's -1e9 scores
    cancel in float32 as the sum order has it)."""
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.attention_block import fused_attention_block as jax_block

    inp = _core_inputs(seed=25)
    names = ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias")
    (h, w, ln), (jh, jw, jln) = _split(inp, names, dtype)
    kw = dict(sm_scale=8**-0.5, quantized=True, heads_per_block=hb, core_int8=core)
    seg = inp["segment_ids"]
    want = np.asarray(jax_block(jh, jnp.asarray(seg), *jw, interpret=True, **jln,
                                **kw).astype(jnp.float32))
    got = fused_attention_block(h, torch.from_numpy(seg), *w, **ln, **kw).float().numpy()
    rows = np.ones_like(seg, bool) if core in ("qk", "both", True) else seg > 0
    assert_close_long(got[rows], want[rows], bf16=dtype == "bfloat16")


def test_core_int8_changes_the_result_and_is_ignored_unquantised():
    import jax.numpy as jnp

    from spokennlp_tpu.ops.pallas.attention_block import fused_attention_block as jax_block

    inp = _core_inputs(seed=26)
    t = _torch(inp)
    kw = dict(sm_scale=8**-0.5, heads_per_block=4)
    base = fused_attention_block(**t, **kw, quantized=True)
    for core in ("qk", "av", "both"):
        assert not torch.equal(fused_attention_block(**t, **kw, quantized=True, core_int8=core),
                               base)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    want = np.asarray(jax_block(**j, **kw, quantized=False, core_int8="both", interpret=True))
    got = fused_attention_block(**t, **kw, quantized=False, core_int8="both")
    torch.testing.assert_close(got, fused_attention_block(**t, **kw, quantized=False), atol=0,
                               rtol=0)
    valid = inp["segment_ids"] > 0
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=5e-3, rtol=1e-2)


# ----------------------------------------------- the W8A8 slice as a whole


def _w8a8_model_case(trunk):
    if trunk == "longformer":
        cfg = dataclasses.replace(LONGFORMER, sliding_window_impl="auto")
        return cfg, longformer_ids(2, 64, seed=27)
    cfg = dataclasses.replace(BIGBIRD, bigbird_impl="auto", bigbird_num_global_blocks=GB,
                              bigbird_num_random_blocks=RB)
    return cfg, bigbird_ids(3, 64, seed=27)


@pytest.mark.parametrize("trunk", ["longformer", "bigbird"])
def test_w8a8_topic_seg_fused_matches_jax(trunk):
    """The W8A8 TopicSegModel, 2 layers, attention_impl "fused": the port's
    plain versions of kernel 7 (or 8) and the W8A8 MLP block against JAX's
    Pallas kernels in interpret mode, from one JAX parameter tree."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel

    base, x = _w8a8_model_case(trunk)
    cfg = dataclasses.replace(base, attention_impl="fused", quantize="w8a8")
    jm = JaxTopicSegModel(_jax_cfg(cfg), _jax_task(TopicSegConfig()))
    ids, mask = jnp.asarray(x["ids"]), jnp.asarray(x["mask"])
    params = jm.init(jax.random.PRNGKey(1), ids, attention_mask=mask,
                     sent_positions=jnp.zeros((ids.shape[0], 4), jnp.int32))["params"]
    want = np.asarray(jm.apply({"params": params}, ids, attention_mask=mask)["token_logits"])
    port = TopicSegModel(cfg, TopicSegConfig()).eval()
    port.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x["ids"]),
                   attention_mask=torch.from_numpy(x["mask"]))["token_logits"].numpy()
    live = x["mask"].astype(bool)
    err = np.abs(got[live] - want[live])
    assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())
    assert (got[live].argmax(-1) == want[live].argmax(-1)).mean() >= 0.99
    # and it is the W8A8 function: the unquantised model is another one
    float_port = TopicSegModel(base, TopicSegConfig()).eval()
    float_port.load_state_dict(port.state_dict(), strict=True)
    with torch.inference_mode():
        other = float_port(torch.from_numpy(x["ids"]),
                           attention_mask=torch.from_numpy(x["mask"]))["token_logits"].numpy()
    assert np.abs(other[live] - want[live]).max() > err.max()


@pytest.mark.parametrize("trunk", ["longformer", "bigbird"])
def test_jax_params_load_strict_into_the_w8a8_config(trunk):
    """W8A8 consumes the float parameter tree: JAX's W8A8 model and its float
    model have the same tree, and it loads with strict=True into the port's
    W8A8 configuration."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel

    base, x = _w8a8_model_case(trunk)
    ids, mask = jnp.asarray(x["ids"]), jnp.asarray(x["mask"])
    trees = []
    for quantize in ("none", "w8a8"):
        cfg = dataclasses.replace(base, quantize=quantize)
        jm = JaxTopicSegModel(_jax_cfg(cfg), _jax_task(TopicSegConfig()))
        params = jm.init(jax.random.PRNGKey(2), ids, attention_mask=mask,
                         sent_positions=jnp.zeros((ids.shape[0], 4), jnp.int32))["params"]
        trees.append(jax.tree.map(lambda a: (a.shape, str(a.dtype)), params))
    assert trees[0] == trees[1]
    port = TopicSegModel(dataclasses.replace(base, quantize="w8a8"), TopicSegConfig())
    sd = jax_params_to_state_dict(jax.tree.map(np.asarray, params))
    port.load_state_dict(sd, strict=True)
    assert set(sd) == set(port.state_dict())


# ---------------------------------------------------- the check's teeth


def _sliding_case(dtype):
    inp = sliding_inputs(B, L, H, NH, seed=28)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return (t["hidden"].to(getattr(torch, dtype)), t["attention_mask"], t["global_mask"],
            [t[k] for k in SLIDING_ARGS], {"ln_scale": t["ln_scale"], "ln_bias": t["ln_bias"]})


@pytest.mark.parametrize("fault", [*chip_smoke.LONG_W8A8_FAULTS, chip_smoke.GLOBAL_FAULT])
def test_sliding_w8a8_planted_faults(fault):
    """chip_smoke.py's planted faults of kernel 7 W8A8, each patched into
    the plain version, fail the W8A8 check on real rows (the global-query
    fault on the global rows, the only ones it moves)."""
    h, mask, glob, w, ln = _sliding_case("float32")
    kw = dict(sm_scale=HD**-0.5, window=WINDOW, max_globals=16, **ln)
    want = sb.sliding_block_plain(h, mask, glob, *w, quantized=True, **kw)
    with chip_smoke.planted(chip_smoke.long_w8a8_faults(sb, NH)[fault]):
        got = sb.sliding_block_plain(h, mask, glob, *w, quantized=True, **kw)
    rows = (mask > 0) & (glob > 0) if fault == chip_smoke.GLOBAL_FAULT else mask > 0
    assert rows.any()
    with pytest.raises(AssertionError):
        assert_close_w8a8(got[rows], want[rows])
    # the patches are gone with the context
    torch.testing.assert_close(sb.sliding_block_plain(h, mask, glob, *w, quantized=True, **kw),
                               want, atol=0, rtol=0)


@pytest.mark.parametrize("fault", chip_smoke.LONG_W8A8_FAULTS)
def test_bigbird_w8a8_planted_faults(fault):
    inp = bigbird_inputs(B, L, H, NH, seed=29)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    ln = {"ln_scale": t["ln_scale"], "ln_bias": t["ln_bias"]}
    args = (t["hidden"], t["attention_mask"], *(t[k] for k in BIGBIRD_ARGS), BLOCK, GB, RB, 3,
            HD**-0.5)
    want = bb.bigbird_block_plain(*args, quantized=True, **ln)
    with chip_smoke.planted(chip_smoke.long_w8a8_faults(bb, NH)[fault]):
        got = bb.bigbird_block_plain(*args, quantized=True, **ln)
    valid = inp["attention_mask"] > 0
    with pytest.raises(AssertionError):
        assert_close_w8a8(got[valid], want[valid])


@pytest.mark.parametrize("trunk", ["sliding", "bigbird"])
def test_on_card_rows_reads_the_rows_kernels_wrappers(monkeypatch, trunk):
    """chip_smoke.on_card_rows sends the W8A8 blocks' float32 attention to the
    rows kernels' wrappers (train_sliding.sliding_rows,
    train_bigbird.bigbird_rows; on the CPU their rounding models, with exact
    products): the plain W8A8 block in float32 through them agrees with the
    plain one (the W8A8 check, float32; kernel 7's global rows from the plain
    attention), each wrapper runs once, and bf16 is left alone."""
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    owner, name = (ts, "sliding_rows") if trunk == "sliding" else (tbb, "bigbird_rows")
    calls = []
    real = getattr(owner, name)
    monkeypatch.setattr(owner, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    if trunk == "sliding":
        h, mask, glob, w, ln = _sliding_case("float32")
        plain = lambda h=h: sb.sliding_block_plain(h, mask, glob, *w, quantized=True,
                                                   sm_scale=HD**-0.5, window=WINDOW,
                                                   max_globals=16, **ln)
    else:
        t = {k: torch.from_numpy(v) for k, v in bigbird_inputs(B, L, H, NH, seed=29).items()}
        mask, h = t["attention_mask"], t["hidden"]
        plain = lambda h=h: bb.bigbird_block_plain(
            h, mask, *(t[k] for k in BIGBIRD_ARGS), BLOCK, GB, RB, 3, HD**-0.5, quantized=True,
            ln_scale=t["ln_scale"], ln_bias=t["ln_bias"])
    want = plain()
    got = chip_smoke.on_card_rows("float32", plain)
    assert len(calls) == 1
    valid = mask > 0
    assert_close_w8a8(got[valid], want[valid])
    chip_smoke.on_card_rows("bfloat16", lambda: plain(h.bfloat16()))
    assert len(calls) == 1


@pytest.mark.parametrize("fault", chip_smoke.CORE_MLP_FAULTS)
def test_core_and_static_scale_planted_faults(fault):
    """2b with the per-row scale of row 2 W8A8; 1c with q and k scales over
    the whole batch, or its denominator summed over the rounded p8."""
    att = _torch(_core_inputs(seed=30))
    mlp = _torch(_mlp_inputs(M=1100, H=H, I=64, seed=31))
    got, want, rows = chip_smoke.core_mlp_fault(fault, att, mlp, sm_scale=8**-0.5, hb=2)
    with pytest.raises(AssertionError):
        assert_close_w8a8(got[rows], want[rows])


@pytest.mark.parametrize("mode", ["fused_attention_block_core_int8", "fused_mlp_block_static_h"])
def test_chip_smoke_counts_the_modes_apart(monkeypatch, mode):
    """chip_smoke.py resets the counters of 1c and 2b with a main path's
    wrappers, adds what they read after its run to the kernels line's
    numbers, and fails when a main path ran one of them."""
    monkeypatch.setattr(chip_smoke, "MODE_LAUNCHES", dict.fromkeys(chip_smoke.MODE_LAUNCHES, 0))
    wrapper, counter = chip_smoke.mode_counters()[mode]
    monkeypatch.setattr(wrapper, counter, 5)
    monkeypatch.setattr(wrapper, "launches", 7)
    chip_smoke.reset_counts({"block": wrapper})
    assert (wrapper.launches, getattr(wrapper, counter)) == (0, 0)
    wrapper.launches = 3
    assert chip_smoke.read_counts({"block": wrapper}) == {"block": 3}
    setattr(wrapper, counter, 2)
    with pytest.raises(RuntimeError, match=f"{mode} ran 2 times on a main path"):
        chip_smoke.read_counts({"block": wrapper})
    assert chip_smoke.MODE_LAUNCHES[mode] == 2


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(d, device):
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else v) for k, v in d.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 128, 128, 2, 32, 2), (2, 512, 256, 4, 256, 16),
                                   (1, 192, 64, 1, 48, 8)], ids=["small", "wide", "one_head"])
def test_sliding_w8a8_kernel_matches_plain_on_card(cuda, dtype, shape):
    Bc, Lc, Hc, nh, window, max_globals = shape
    inp = sliding_inputs(Bc, Lc, Hc, nh, seed=Lc)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in inp.items()}
    h = t["hidden"].to(getattr(torch, dtype))
    for global_rows in (True, False):
        kw = dict(sm_scale=(Hc // nh) ** -0.5, window=window, max_globals=max_globals,
                  global_rows=global_rows, ln_scale=t["ln_scale"], ln_bias=t["ln_bias"],
                  quantized=True)
        args = (h, t["attention_mask"], t["global_mask"], *(t[k] for k in SLIDING_ARGS))
        n = sb.fused_sliding_attention_block.launches
        got = sb.fused_sliding_attention_block(*args, **kw)
        torch.cuda.synchronize()
        assert sb.fused_sliding_attention_block.launches == n + 1
        want = sb.sliding_block_plain(*args, **kw)
        valid = t["attention_mask"] > 0
        assert_close_long(got[valid], want[valid], bf16=dtype == "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Bc,Lc", [(1, 8), (3, 24)])
def test_sliding_w8a8_projection_slots_on_ragged_shapes_on_card(cuda, dtype, Bc, Lc):
    """The int8 tile's q/k/v scatter with slots 3 (q, k, v) and 2 (the
    global k, v) at ragged rows M = B L of 8 and 72 and H = 68, whose rows
    the tile copies 4 bytes at a time; two heads of 32, window 16."""
    Hc, nh, hd, window = 68, 2, 32, 16
    rng = np.random.default_rng(Lc)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.normal(size=s) * scale).astype(np.float32)).to(cuda)
    mask, glob = (torch.from_numpy(m).to(cuda) for m in sliding_masks(Bc, Lc, seed=Lc))
    w = Hc**-0.5
    weights = (f(Hc, 3, nh, hd, scale=w), f(3, nh, hd, scale=0.1), f(Hc, 3, nh, hd, scale=w),
               f(3, nh, hd, scale=0.1), f(nh, hd, Hc, scale=(nh * hd) ** -0.5),
               f(Hc, scale=0.1))
    ln = dict(ln_scale=1 + f(Hc, scale=0.1), ln_bias=f(Hc, scale=0.1))
    args = (f(Bc, Lc, Hc).to(getattr(torch, dtype)), mask, glob, *weights)
    kw = dict(sm_scale=hd**-0.5, window=window, max_globals=2, quantized=True, **ln)
    n = sb.fused_sliding_attention_block.launches
    got = sb.fused_sliding_attention_block(*args, **kw)
    torch.cuda.synchronize()
    assert sb.fused_sliding_attention_block.launches == n + 1
    want = sb.sliding_block_plain(*args, **kw)
    valid = mask > 0
    assert_close_long(got[valid], want[valid], bf16=dtype == "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 256, 128, 2, 64, 2, 3), (2, 96, 64, 2, 8, 1, 2),
                                   (1, 384, 256, 4, 128, 2, 1)], ids=["base", "small", "wide"])
def test_bigbird_w8a8_kernel_matches_plain_on_card(cuda, dtype, shape):
    Bc, Lc, Hc, nh, block, g, r = shape
    inp = bigbird_inputs(Bc, Lc, Hc, nh, seed=Lc)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in inp.items()}
    args = (t["hidden"].to(getattr(torch, dtype)), t["attention_mask"],
            *(t[k] for k in BIGBIRD_ARGS), block, g, r, 0, (Hc // nh) ** -0.5)
    ln = dict(ln_scale=t["ln_scale"], ln_bias=t["ln_bias"])
    n = bb.fused_bigbird_attention_block.launches
    got = bb.fused_bigbird_attention_block(*args, quantized=True, **ln)
    torch.cuda.synchronize()
    assert bb.fused_bigbird_attention_block.launches == n + 1
    want = bb.bigbird_block_plain(*args, quantized=True, **ln)
    valid = t["attention_mask"] > 0
    assert_close_long(got[valid], want[valid], bf16=dtype == "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,Hc,I", [(2048, 256, 1024), (1100, 64, 256), (300, 32, 64)])
def test_mlp_static_h_scale_kernel_matches_plain_on_card(cuda, dtype, M, Hc, I):
    t = _card(_torch(_mlp_inputs(M=M, H=Hc, I=I, seed=M)), cuda)
    t["x"] = t["x"].to(getattr(torch, dtype))
    kw = dict(activation="gelu", eps=1e-12, quantized=True, static_h_scale=True)
    n, n_static = fused_mlp_block.launches, fused_mlp_block.static_h_launches
    got = fused_mlp_block(*t.values(), **kw)
    torch.cuda.synchronize()
    assert (fused_mlp_block.launches, fused_mlp_block.static_h_launches) == (n + 1, n_static + 1)
    assert_close_long(got, mlp_block_plain(*t.values(), **kw), bf16=dtype == "bfloat16")
    fused_mlp_block(*t.values(), **dict(kw, static_h_scale=False))  # per-row scales
    assert (fused_mlp_block.launches, fused_mlp_block.static_h_launches) == (n + 2, n_static + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hb", [4, 2, 1])
@pytest.mark.parametrize("core", ["qk", "av", "both"])
def test_core_int8_kernel_matches_plain_on_card(cuda, dtype, hb, core):
    inp = _core_inputs(seed=32, hidden=128, hd=32)  # the kernels take head dims 32-128
    t = _card(_torch(inp), cuda)
    t["hidden"] = t["hidden"].to(getattr(torch, dtype))
    kw = dict(sm_scale=32**-0.5, quantized=True, heads_per_block=hb, core_int8=core)
    counts = lambda: (fused_attention_block.launches, fused_attention_block.core_int8_launches)
    n, n_core = counts()
    got = fused_attention_block(**t, **kw)
    torch.cuda.synchronize()
    assert counts() == (n + 1, n_core + 1)
    fused_attention_block(**t, **dict(kw, core_int8=False))  # the bf16 core
    assert counts() == (n + 2, n_core + 1)
    want = attention_block_plain(**t, **kw)
    seg = t["segment_ids"]
    rows = torch.ones_like(seg, dtype=torch.bool) if core != "av" else seg > 0
    assert_close_long(got[rows], want[rows], bf16=dtype == "bfloat16")


# ---------------------------------------------------------------- the build


def test_c_entries_match_their_ctypes_signatures():
    """Every extern "C" entry of csrc/*.cu takes the arguments ops/cuda/build.py
    declares for it, in kind and number (a pointer passed where an int is
    declared would be cut to 32 bits): checked by reading the sources, as no
    compiler runs here."""
    import ctypes
    import re

    from spokennlp_tpu_torch.ops.cuda import build

    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_uint: "uint", ctypes.c_size_t: "size_t"}
    found = {}
    for src in build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (spk_\w+)\(([^)]*)\)', src.read_text()):
            args = [a.strip() for a in params.split(",")]
            found[name] = ["ptr" if "*" in a else "float" if a.startswith("float")
                           else "uint" if a.startswith(("uint32_t", "unsigned"))
                           else "size_t" if a.startswith("size_t") else "int" for a in args]
    assert set(found) == set(build._SIGNATURES)
    for name, argtypes in build._SIGNATURES.items():
        assert found[name] == [kinds[t] for t in argtypes], name
