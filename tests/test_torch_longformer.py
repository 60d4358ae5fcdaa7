"""The port's Longformer trunk against the JAX package on the CPU: RoBERTa
positions, the sliding-window encoder on its bias and chunked paths, the
topic-segmentation model's logits, one composite AdamW step with eop_list
CSSL and gradient accumulation, the attention-path resolution on CUDA device
objects (no card needed), and the fine-tuning CLI's ``--seeds``.

Inputs are made with numpy from a seed; JAX parameters cross into the port
through ``models/convert.py`` with ``strict=True`` (``qkv_global``
included). Tolerances: float32 outputs to 1e-4 (the same math summed in
another order); a full step's losses, gradient norm and parameter updates
to 1e-3 relative.
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

# 2 layers, H=32, 2 heads, window 16 (C = 8); pad id 1 as in RoBERTa
LONGFORMER = EncoderConfig(
    vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
    max_position_embeddings=1100, add_pooler=False, attention_type="sliding_window",
    attention_window=16, position_style="roberta", pad_token_id=1, attention_impl="einsum",
    hidden_dropout=0.0, attention_dropout=0.0,
)


def _inputs(B, L, seed=0):
    """Ids with suffix padding (pad id 1) and CLS as the one global token."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 127, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    for b in range(1, B):
        mask[b, int(rng.integers(L // 2, L)):] = 0
    ids[mask == 0] = 1
    glob = np.zeros((B, L), np.int32)
    glob[:, 0] = 1
    return dict(ids=ids, mask=mask, tt=np.zeros((B, L), np.int32), glob=glob)


def _jax_cfg(cfg):
    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig

    return JaxEncoderConfig(**dataclasses.asdict(cfg))


def _jax_encoder(cfg, x):
    """(params as numpy, last hidden state) of the JAX encoder."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.encoder import Encoder as JaxEncoder

    enc = JaxEncoder(_jax_cfg(cfg))
    args = dict(attention_mask=jnp.asarray(x["mask"]), token_type_ids=jnp.asarray(x["tt"]),
                global_attention_mask=jnp.asarray(x["glob"]), prefix_globals=1)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x["ids"]), **args)["params"]
    out = enc.apply({"params": params}, jnp.asarray(x["ids"]), **args)
    return jax.tree.map(np.asarray, params), np.asarray(out.last_hidden_state)


@pytest.mark.parametrize("pad", [1, 0])
def test_roberta_positions_match_jax(pad):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.encoder import Embeddings as JaxEmbeddings
    from spokennlp_tpu_torch.models.encoder import Embeddings

    cfg = dataclasses.replace(LONGFORMER, pad_token_id=pad, max_position_embeddings=48)
    x = _inputs(3, 40, seed=1)
    x["ids"][x["mask"] == 0] = pad
    emb = JaxEmbeddings(_jax_cfg(cfg))
    ids = jnp.asarray(x["ids"])
    params = emb.init(jax.random.PRNGKey(0), ids)["params"]
    want = np.asarray(emb.apply({"params": params}, ids))
    port = Embeddings(cfg, torch.float32).eval()
    port.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x["ids"])).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("L,path", [(32, "bias"), (1040, "chunked")])
def test_sliding_encoder_matches_jax(L, path):
    """The einsum paths: the (L, L) bias path with the dense global pass, and
    above 1024 tokens the chunked path with the O(G L) global pass."""
    x = _inputs(2, L, seed=L)
    params, want = _jax_encoder(LONGFORMER, x)
    assert resolve_attention_impl(LONGFORMER, torch.device("cpu"), False, False, L, 1,
                                  True) == path
    enc = Encoder(LONGFORMER).eval()
    enc.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.inference_mode():
        got = enc(torch.from_numpy(x["ids"]), attention_mask=torch.from_numpy(x["mask"]),
                  token_type_ids=torch.from_numpy(x["tt"]),
                  global_attention_mask=torch.from_numpy(x["glob"]), prefix_globals=1)
    live = x["mask"].astype(bool)
    np.testing.assert_allclose(got.last_hidden_state.numpy()[live], want[live], **TOL)


@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_topic_seg_longformer_logits_match_jax(impl):
    """TopicSegModel makes CLS global itself. "fused" on the CPU runs the
    kernels' plain versions (the MLP's GELU in its tanh form, as on the TPU)
    against JAX's Pallas kernels in interpret mode."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel

    cfg = dataclasses.replace(LONGFORMER, attention_impl=impl, sliding_window_impl="auto")
    x = _inputs(2, 32, seed=4)
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
    tol = TOL if impl == "einsum" else dict(atol=5e-3, rtol=1e-2)  # tanh GELU, as test_torch_encoder
    np.testing.assert_allclose(got[live], want[live], **tol)


def _jax_task(task):
    from spokennlp_tpu.configs import TopicSegConfig as JaxTopicSegConfig

    return JaxTopicSegConfig(**dataclasses.asdict(task))


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


def test_longformer_train_step_with_accumulation_matches_jax():
    """Two micro-batches of a composite step (anchor + DA views, eop_list
    CSSL, TSSP) with gradient accumulation 2 at dropout 0, on the training
    blocks' path ("train_fused": the kernels' plain versions here, JAX's
    Pallas kernels in interpret mode): each micro-step's losses and
    grad_norm, and the parameters after the AdamW update."""
    import jax

    from spokennlp_tpu.configs import TrainConfig as JaxTrainConfig
    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel
    from spokennlp_tpu.train.optim import make_optimizer as jax_make_optimizer
    from spokennlp_tpu.train.train_step import create_train_state
    from spokennlp_tpu.train.train_step import make_topic_seg_train_step as jax_make_step
    from spokennlp_tpu_torch.data.featurization import batches_from_docs
    from spokennlp_tpu_torch.train import optim
    from spokennlp_tpu_torch.train.train_step import batch_to_device, make_topic_seg_train_step

    enc = dataclasses.replace(LONGFORMER, attention_impl="train_fused",
                              max_position_embeddings=72, pad_token_id=0)
    task = TopicSegConfig(cl_anchor_level="eop_list", cl_loss_weight=0.5, tssp_loss_weight=1.0,
                          do_tssp=True, do_da_ts=True, classifier_dropout=0.0)
    cfg = TrainConfig(learning_rate=1e-3, adam_eps=1e-3, gradient_accumulation_steps=2)
    wcfg = WindowingConfig(max_seq_length=64, cls_token_id=2, pad_token_id=0, bos_token_id=1)
    batches = list(batches_from_docs(_docs(0, 6), wcfg, task, 3, np.random.default_rng(0)))[:2]

    jm = JaxTopicSegModel(_jax_cfg(enc), _jax_task(task))
    ids = jax.numpy.ones((2, 64), jax.numpy.int32)
    params = jm.init(jax.random.PRNGKey(0), ids, attention_mask=ids,
                     sent_positions=jax.numpy.zeros((2, 8), jax.numpy.int32))["params"]
    before = jax_params_to_state_dict(jax.tree.map(np.asarray, params))
    tx = jax_make_optimizer(JaxTrainConfig(**dataclasses.asdict(cfg)), total_steps=10)
    jstep, jstate = jax_make_step(jm, _jax_task(task), tx), create_train_state(params, tx)
    port = TopicSegModel(enc, task)
    port.load_state_dict(before, strict=True)
    opt = optim.make_optimizer(port, cfg, total_steps=10)
    step = make_topic_seg_train_step(port, task, opt)
    for batch in batches:
        jstate, jmetrics = jstep(jstate, {k: jax.numpy.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(0))
        metrics = step(batch_to_device(batch, torch.device("cpu")))
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=STEP_RTOL,
                                       err_msg=k)
    assert opt.micro_step == 2
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    for name, p in port.state_dict().items():
        moved = np.abs(want[name].numpy() - before[name].numpy()).max()
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=max(STEP_RTOL * moved, 1e-7), err_msg=name)


def test_resolution_on_cuda_devices():
    """No card is needed to resolve: "auto" on CUDA gives the Longformer
    kernels when the contract holds and raises, naming it, when not; the
    plain paths run on the card only when asked for; the CPU takes the
    einsum path as JAX does off the TPU."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    auto = dataclasses.replace(LONGFORMER, attention_window=512, attention_impl="auto")
    ok = dict(seq_len=2048, prefix_globals=1, has_global_mask=True)
    assert resolve_attention_impl(auto, cuda, False, False, **ok) == "fused"
    assert resolve_attention_impl(auto, cuda, False, True, **ok) == "train_fused"
    assert resolve_attention_impl(auto, cpu, False, True, **ok) == "chunked"
    assert resolve_attention_impl(auto, cpu, False, False, **{**ok, "seq_len": 512}) == "bias"
    assert resolve_attention_impl(auto, cuda, True, False, **ok) == "chunked"  # attentions
    for breach, match in (({"seq_len": 2000}, "multiple"), ({"prefix_globals": None}, "prefix"),
                          ({"has_global_mask": False}, "prefix"),
                          ({"prefix_globals": 17}, "max_global_tokens")):
        for training in (False, True):
            with pytest.raises(ValueError, match=match):
                resolve_attention_impl(auto, cuda, False, training, **{**ok, **breach})
    odd_window = dataclasses.replace(auto, attention_window=100)  # C = 50, not a multiple of 8
    with pytest.raises(ValueError, match="multiple"):
        resolve_attention_impl(odd_window, cuda, False, False, **{**ok, "seq_len": 2000})
    einsum = dataclasses.replace(auto, attention_impl="einsum")
    assert resolve_attention_impl(einsum, cuda, False, False, **ok) == "chunked"
    for sw, path in (("bias", "bias"), ("chunked", "chunked")):
        asked = dataclasses.replace(auto, sliding_window_impl=sw)
        assert resolve_attention_impl(asked, cuda, False, True, **ok) == path
    # on the CPU a broken contract quietly takes the einsum path, as in JAX
    assert resolve_attention_impl(dataclasses.replace(auto, attention_impl="fused"), cpu, False,
                                  False, **{**ok, "prefix_globals": None}) == "chunked"


def _write_corpus(root, seed=0):
    rng = np.random.default_rng(seed)
    d = root / "wiki_section"
    d.mkdir()
    for split, n in (("train.jsonl", 4), ("dev.jsonl", 2), ("test.jsonl", 2)):
        with open(d / split, "w") as f:
            for _ in range(n):
                ns = int(rng.integers(8, 16))
                sents = [" ".join(f"w{i}" for i in rng.integers(0, 50, size=rng.integers(3, 8)))
                         for _ in range(ns)]
                labels = [int(rng.random() < 0.25) for _ in range(ns)]
                labels[-1] = 1
                f.write(json.dumps({"sentences": sents, "labels": labels}) + "\n")
    return str(d)


def test_run_finetune_seeds_writes_the_multi_seed_table(tmp_path):
    """``--seeds 1 2`` at a tiny sliding-window config: one run per seed under
    seed_<n>, and multi_seed_results.json equal to compute_avg_std of their
    numeric results, itself equal to JAX's."""
    from spokennlp_tpu.eval.analysis import compute_avg_std as jax_avg_std
    from spokennlp_tpu_torch.cli import run_finetune
    from spokennlp_tpu_torch.eval.analysis import compute_avg_std

    out = tmp_path / "out"
    argv = [
        "--data_dir", _write_corpus(tmp_path), "--output_dir", str(out), "--device", "cpu",
        "--hidden_size", "32", "--num_hidden_layers", "1", "--num_attention_heads", "2",
        "--intermediate_size", "64", "--max_seq_length", "64", "--attention_type",
        "sliding_window", "--attention_window", "16", "--num_train_epochs", "1",
        "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "2",
        "--logging_steps", "1", "--do_train", "--do_eval", "--do_da_ts", "--do_tssp",
        "--tssp_loss_weight", "1.0", "--cl_loss_weight", "0.5", "--cl_anchor_level", "eop_list",
        "--seeds", "1", "2",
    ]
    agg = run_finetune.main(argv)
    per_seed = [json.loads((out / f"seed_{s}" / "all_results.json").read_text()) for s in (1, 2)]
    keys = sorted(k for k, v in per_seed[0].items() if isinstance(v, (int, float)))
    runs = [[float(r.get(k, 0.0)) for k in keys] for r in per_seed]
    # as text: best_f1 is -inf without an eval during training, its std nan
    same = lambda *tables: len({json.dumps(t, sort_keys=True) for t in tables}) == 1
    assert (out / "multi_seed_results.json").read_text() == json.dumps(agg, indent=2)
    assert same(agg, compute_avg_std(runs, keys), jax_avg_std(runs, keys))
    assert set(agg) == set(keys) and "eval_f1" in agg
    rng = np.random.default_rng(2)
    table = rng.normal(size=(3, 4)).tolist()
    assert same(compute_avg_std(table, list("abcd")), jax_avg_std(table, list("abcd")))
    assert same(compute_avg_std(table[:1], list("abcd")), jax_avg_std(table[:1], list("abcd")))
