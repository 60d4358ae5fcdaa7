"""The port's BigBird trunk against the JAX package on the CPU: the encoder
on its bias and block paths, the topic-segmentation model's logits (the
einsum path, and the kernels' plain versions against JAX's Pallas kernels in
interpret mode), one composite AdamW step on the training blocks' path, the
attention-path resolution on CUDA device objects (no card needed), and the
inference CLI with ``--attention_type bigbird``.

Inputs are made with numpy from a seed; JAX parameters cross into the port
through ``models/convert.py`` with ``strict=True`` (BigBird has BERT's
layout: no ``qkv_global``). Tolerances: float32 outputs to 1e-4 (the same
math summed in another order); a full step's losses, gradient norm and
parameter updates to 1e-3 relative.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig, TrainConfig, WindowingConfig
from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
from spokennlp_tpu_torch.models.encoder import Encoder, resolve_attention_impl
from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

TOL = dict(atol=1e-4, rtol=1e-4)
STEP_RTOL = 1e-3

# 2 layers, H=32, 2 heads, blocks of 8 with 2 global and 3 random blocks
BIGBIRD = EncoderConfig(
    vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
    max_position_embeddings=72, add_pooler=False, attention_type="bigbird",
    bigbird_block_size=8, bigbird_num_global_blocks=2, bigbird_num_random_blocks=3,
    bigbird_seed=7, attention_impl="einsum", hidden_dropout=0.0, attention_dropout=0.0,
)


def _inputs(B, L, seed=0):
    """Ids with suffix padding (pad id 0), row 1 shorter than the global
    blocks."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 127, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 13:] = 0
    for b in range(2, B):
        mask[b, int(rng.integers(L // 2, L)):] = 0
    ids[mask == 0] = 0
    return dict(ids=ids, mask=mask, tt=np.zeros((B, L), np.int32))


def _jax_cfg(cfg):
    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig

    return JaxEncoderConfig(**dataclasses.asdict(cfg))


def _jax_task(task):
    from spokennlp_tpu.configs import TopicSegConfig as JaxTopicSegConfig

    return JaxTopicSegConfig(**dataclasses.asdict(task))


@pytest.mark.parametrize("bigbird_impl", ["bias", "block"])
def test_bigbird_encoder_matches_jax(bigbird_impl):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.encoder import Encoder as JaxEncoder

    cfg = dataclasses.replace(BIGBIRD, bigbird_impl=bigbird_impl)
    x = _inputs(3, 64, seed=1)
    enc = JaxEncoder(_jax_cfg(cfg))
    args = dict(attention_mask=jnp.asarray(x["mask"]), token_type_ids=jnp.asarray(x["tt"]))
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x["ids"]), **args)["params"]
    want = np.asarray(enc.apply({"params": params}, jnp.asarray(x["ids"]),
                                **args).last_hidden_state)
    assert resolve_attention_impl(cfg, torch.device("cpu"), False, False, 64, None) == bigbird_impl
    port = Encoder(cfg).eval()
    port.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x["ids"]), attention_mask=torch.from_numpy(x["mask"]),
                   token_type_ids=torch.from_numpy(x["tt"])).last_hidden_state.numpy()
    live = x["mask"].astype(bool)
    np.testing.assert_allclose(got[live], want[live], **TOL)


@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_topic_seg_bigbird_logits_match_jax(impl):
    """TopicSegModel promises suffix padding (prefix_globals=0) itself.
    "fused" on the CPU runs the kernels' plain versions against JAX's Pallas
    kernels in interpret mode (both with the MLP's tanh GELU)."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel

    cfg = dataclasses.replace(BIGBIRD, attention_impl=impl, bigbird_impl="auto")
    x = _inputs(2, 64, seed=4)
    jm = JaxTopicSegModel(_jax_cfg(cfg), _jax_task(TopicSegConfig()))
    ids, mask = jnp.asarray(x["ids"]), jnp.asarray(x["mask"])
    params = jm.init(jax.random.PRNGKey(1), ids, attention_mask=mask,
                     sent_positions=jnp.zeros((2, 4), jnp.int32))["params"]
    want = np.asarray(jm.apply({"params": params}, ids, attention_mask=mask)["token_logits"])
    port = TopicSegModel(cfg, TopicSegConfig()).eval()
    port.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x["ids"]),
                   attention_mask=torch.from_numpy(x["mask"]))["token_logits"].numpy()
    live = x["mask"].astype(bool)
    np.testing.assert_allclose(got[live], want[live], **TOL)


def _docs(seed, n_docs):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        ns = int(rng.integers(8, 20))
        labels = [int(rng.random() < 0.25) for _ in range(ns)]
        labels[-1] = 1
        docs.append({"sent_token_ids": [rng.integers(5, 120, size=rng.integers(3, 9)).tolist()
                                        for _ in range(ns)], "labels": labels})
    return docs


def test_bigbird_train_step_matches_jax():
    """One composite step (anchor + DA views, eop_list CSSL, TSSP) at dropout
    0 on the training blocks' path ("train_fused": the plain versions here,
    JAX's Pallas kernels in interpret mode): the losses and grad_norm, and
    the parameters after the AdamW update."""
    import jax

    from spokennlp_tpu.configs import TrainConfig as JaxTrainConfig
    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel
    from spokennlp_tpu.train.optim import make_optimizer as jax_make_optimizer
    from spokennlp_tpu.train.train_step import create_train_state
    from spokennlp_tpu.train.train_step import make_topic_seg_train_step as jax_make_step
    from spokennlp_tpu_torch.data.featurization import batches_from_docs
    from spokennlp_tpu_torch.train import optim
    from spokennlp_tpu_torch.train.train_step import batch_to_device, make_topic_seg_train_step

    enc = dataclasses.replace(BIGBIRD, attention_impl="train_fused")
    task = TopicSegConfig(cl_anchor_level="eop_list", cl_loss_weight=0.5, tssp_loss_weight=1.0,
                          do_tssp=True, do_da_ts=True, classifier_dropout=0.0)
    cfg = TrainConfig(learning_rate=1e-3, adam_eps=1e-3)
    wcfg = WindowingConfig(max_seq_length=64, cls_token_id=2, pad_token_id=0, bos_token_id=1)
    batch = next(iter(batches_from_docs(_docs(0, 4), wcfg, task, 3, np.random.default_rng(0))))

    jm = JaxTopicSegModel(_jax_cfg(enc), _jax_task(task))
    ids = jax.numpy.ones((2, 64), jax.numpy.int32)
    params = jm.init(jax.random.PRNGKey(0), ids, attention_mask=ids,
                     sent_positions=jax.numpy.zeros((2, 8), jax.numpy.int32))["params"]
    before = jax_params_to_state_dict(jax.tree.map(np.asarray, params))
    tx = jax_make_optimizer(JaxTrainConfig(**dataclasses.asdict(cfg)), total_steps=10)
    jstep, jstate = jax_make_step(jm, _jax_task(task), tx), create_train_state(params, tx)
    jstate, jmetrics = jstep(jstate, {k: jax.numpy.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0))
    port = TopicSegModel(enc, task)
    port.load_state_dict(before, strict=True)
    opt = optim.make_optimizer(port, cfg, total_steps=10)
    metrics = make_topic_seg_train_step(port, task, opt)(batch_to_device(batch,
                                                                         torch.device("cpu")))
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=STEP_RTOL,
                                   err_msg=k)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    for name, p in port.state_dict().items():
        moved = np.abs(want[name].numpy() - before[name].numpy()).max()
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=max(STEP_RTOL * moved, 1e-7), err_msg=name)


def test_bigbird_resolution():
    """No card is needed to resolve: on CUDA, "auto" gives the BigBird
    kernels when the contract holds (training whatever bigbird_impl says, as
    in JAX), "stack" means the fused kernels, a broken contract raises naming
    it, and W8A8 on the fused path raises; the CPU takes the einsum path as
    JAX does off the TPU."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    auto = dataclasses.replace(BIGBIRD, bigbird_block_size=64, attention_impl="auto")
    ok = dict(seq_len=4096, prefix_globals=0, batch_size=4)
    assert resolve_attention_impl(auto, cuda, False, False, **ok) == "fused"
    assert resolve_attention_impl(auto, cuda, False, True, **ok) == "train_fused"
    assert resolve_attention_impl(auto, cpu, False, False, **ok) == "block"
    assert resolve_attention_impl(auto, cpu, False, True, **{**ok, "seq_len": 512}) == "bias"
    assert resolve_attention_impl(auto, cuda, True, False, **ok) == "block"  # attentions
    stack = dataclasses.replace(auto, attention_impl="stack")
    assert resolve_attention_impl(stack, cuda, False, False, **ok) == "fused"
    assert resolve_attention_impl(stack, cuda, False, True, **ok) == "train_fused"
    for bb, eval_path in (("bias", "bias"), ("block", "block"), ("fused", "fused")):
        asked = dataclasses.replace(auto, bigbird_impl=bb)
        assert resolve_attention_impl(asked, cuda, False, False, **ok) == eval_path
        assert resolve_attention_impl(asked, cuda, False, True, **ok) == "train_fused"
    for breach, match in (({"seq_len": 4000}, "multiple"), ({"prefix_globals": None}, "prefix")):
        for training in (False, True):
            with pytest.raises(ValueError, match=match):
                resolve_attention_impl(auto, cuda, False, training, **{**ok, **breach})
    odd_block = dataclasses.replace(auto, bigbird_block_size=36)  # not a multiple of 8
    with pytest.raises(ValueError, match="multiple"):
        resolve_attention_impl(odd_block, cuda, False, False, **{**ok, "seq_len": 4032})
    # on the CPU a broken contract quietly takes the einsum path, as in JAX
    assert resolve_attention_impl(dataclasses.replace(auto, attention_impl="fused"), cpu, False,
                                  False, **{**ok, "prefix_globals": None}) == "block"
    einsum = dataclasses.replace(auto, attention_impl="einsum")
    assert resolve_attention_impl(einsum, cuda, False, True, **ok) == "block"
    assert resolve_attention_impl(dataclasses.replace(einsum, bigbird_impl="fused"), cuda, False,
                                  False, **ok) == "block"
    w8a8 = dataclasses.replace(auto, quantize="w8a8")  # the W8A8 mode of kernel 8
    assert resolve_attention_impl(w8a8, cuda, False, False, **ok) == "fused"
    assert resolve_attention_impl(w8a8, cuda, False, True, **ok) == "train_fused"
    assert resolve_attention_impl(dataclasses.replace(w8a8, attention_impl="einsum"), cuda, False,
                                  False, **ok) == "block"
    with pytest.raises(ValueError, match="bigbird_impl"):
        resolve_attention_impl(dataclasses.replace(auto, bigbird_impl="dense"), cuda, False,
                               False, **ok)


def test_run_inference_bigbird_cli(tmp_path):
    """``--attention_type bigbird`` through the inference CLI on the CPU at a
    tiny width: positions follow --max_seq_length, the windows are served and
    scored, and the fused and einsum paths give the same predictions."""
    from spokennlp_tpu_torch.cli import run_inference

    rng = np.random.default_rng(3)
    d = tmp_path / "wiki_section"
    d.mkdir()
    for split, n in (("train.jsonl", 1), ("dev.jsonl", 1), ("test.jsonl", 3)):
        with open(d / split, "w") as f:
            for _ in range(n):
                ns = int(rng.integers(20, 40))
                sents = [" ".join(f"w{i}" for i in rng.integers(0, 50, size=rng.integers(3, 9)))
                         for _ in range(ns)]
                labels = [int(rng.random() < 0.2) for _ in range(ns)]
                labels[-1] = 1
                f.write(json.dumps({"sentences": sents, "labels": labels}) + "\n")
    argv = ["--data_dir", str(d), "--device", "cpu", "--hidden_size", "32",
            "--num_hidden_layers", "1", "--num_attention_heads", "2", "--intermediate_size", "64",
            "--max_seq_length", "1088", "--attention_type", "bigbird",
            "--per_device_eval_batch_size", "2", "--threshold", "0.5"]
    outs = {impl: run_inference.main(argv + ["--output_dir", str(tmp_path / impl),
                                             "--attention_impl", impl])
            for impl in ("fused", "einsum")}
    for out in outs.values():
        assert out["num_windows"] >= 1 and np.isfinite(list(out["metrics"].values())).all()
    assert outs["fused"]["metrics"] == pytest.approx(outs["einsum"]["metrics"])
