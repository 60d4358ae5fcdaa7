"""Port training path against the JAX package on the CPU: losses, CSSL, the
composite topic-segmentation loss, the optimizer and its schedule, one full
train step, and the fine-tuning CLI.

Inputs are made with numpy from a seed and given to both sides; JAX
parameters cross into the port through ``models/convert.py``. Tolerances:
float32 outputs to 1e-4 (the same math, summed in another order), gradients
and parameter updates to 1e-3 relative, unless a test says why otherwise.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig, TrainConfig, WindowingConfig
from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
from spokennlp_tpu_torch.models.topic_seg import TopicSegModel, compute_topic_seg_loss
from spokennlp_tpu_torch.objectives import cssl
from spokennlp_tpu_torch.ops import losses
from spokennlp_tpu_torch.train import optim
from spokennlp_tpu_torch.train.train_step import batch_to_device, make_topic_seg_train_step

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_RTOL = 1e-3

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=64, add_pooler=False)
WCFG = dict(max_seq_length=64, cls_token_id=2, pad_token_id=0, bos_token_id=1)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ----------------------------------------------------------------- losses


def _logits_labels(seed, shape=(3, 17), C=2):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=shape + (C,)).astype(np.float32) * 2
    labels = rng.integers(0, C, size=shape).astype(np.int32)
    labels[rng.random(shape) < 0.3] = -100
    return logits, labels


@pytest.mark.parametrize("weight_label_zero,gamma", [(0.5, 0.0), (0.3, 0.0), (0.5, 2.0),
                                                    (0.7, 1.5)])
def test_cross_entropy_matches_jax(weight_label_zero, gamma):
    import jax.numpy as jnp

    from spokennlp_tpu.ops import losses as jl

    logits, labels = _logits_labels(0)
    jw, tw = jl.ts_class_weights(weight_label_zero), losses.ts_class_weights(weight_label_zero)
    assert (jw is None) == (tw is None)
    want = jl.cross_entropy_with_ignore(jnp.asarray(logits), jnp.asarray(labels),
                                        class_weights=jw, focal_gamma=gamma)
    got = losses.cross_entropy_with_ignore(torch.from_numpy(logits), torch.from_numpy(labels),
                                           class_weights=tw, focal_gamma=gamma)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_bce_and_all_ignored_match_jax():
    import jax.numpy as jnp

    from spokennlp_tpu.ops import losses as jl

    logits, labels = _logits_labels(1, C=1)
    logits, labels = logits[..., 0], np.clip(labels, -100, 1)
    want = jl.bce_with_logits_ignore(jnp.asarray(logits), jnp.asarray(labels))
    got = losses.bce_with_logits_ignore(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    none = np.full_like(labels, -100)
    assert float(losses.cross_entropy_with_ignore(
        torch.from_numpy(_logits_labels(1)[0]), torch.from_numpy(none))) == 0.0


# ------------------------------------------------------------------- CSSL


def _eop_inputs(seed, B=3, K=9, H=16):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, K, H)).astype(np.float32)
    labels = rng.integers(0, 2, size=(B, K)).astype(np.int32)
    n = rng.integers(2, K + 1, size=B)
    mask = (np.arange(K)[None] < n[:, None]).astype(np.int32)
    return feats, labels, mask


@pytest.mark.parametrize("temp", [0.0, 0.1, 1.0])
def test_cssl_functions_match_jax(temp):
    import jax.numpy as jnp

    from spokennlp_tpu.objectives import cssl as jc

    feats, labels, mask = _eop_inputs(int(temp * 10))
    j = lambda a: jnp.asarray(a)
    t = torch.from_numpy
    ids_w, valid_w, n_w = jc.topic_segment_ids(j(labels), j(mask))
    ids_g, valid_g, n_g = cssl.topic_segment_ids(t(labels), t(mask))
    np.testing.assert_array_equal(_np(ids_g), np.asarray(ids_w))
    np.testing.assert_array_equal(_np(valid_g), np.asarray(valid_w))
    assert int(n_g) == int(n_w)
    x = feats.reshape(-1, feats.shape[-1])
    np.testing.assert_allclose(_np(cssl.pairwise_similarity(t(x), t(x), temp)),
                               np.asarray(jc.pairwise_similarity(j(x), j(x), temp)), **TOL)
    np.testing.assert_allclose(_np(cssl.eop_matrix_cl_loss(t(feats), t(labels), t(mask), temp)),
                               np.asarray(jc.eop_matrix_cl_loss(j(feats), j(labels), j(mask),
                                                                temp)), **TOL)
    # an interior ignored slot: the pairing compacts the valid slots first
    mask[0, 1] = 0
    sims_w, lab_w = jc.eop_pair_cosine_similarity(j(feats), j(labels), j(mask), temp)
    sims_g, lab_g = cssl.eop_pair_cosine_similarity(t(feats), t(labels), t(mask), temp)
    np.testing.assert_allclose(_np(sims_g), np.asarray(sims_w), **TOL)
    np.testing.assert_array_equal(_np(lab_g), np.asarray(lab_w))


def test_list_cl_loss_matches_jax():
    import jax.numpy as jnp

    from spokennlp_tpu.objectives import cssl as jc
    from spokennlp_tpu_torch.data.cssl_sampling import build_cssl_list_indices

    feats, labels, mask = _eop_inputs(3)
    B, K, _ = feats.shape
    idx = build_cssl_list_indices(np.where(mask == 1, labels, 0), mask, "eop_list", 2, 2,
                                  np.random.default_rng(0), max_anchors=B * K)
    keys = ("anchor_indices", "positive_indices", "negative_indices", "anchor_valid")
    for temp in (0.0, 0.1):
        want = jc.list_cl_loss(jnp.asarray(feats), *(jnp.asarray(idx[k]) for k in keys), temp)
        got = cssl.list_cl_loss(torch.from_numpy(feats), *(torch.from_numpy(idx[k])
                                                           for k in keys), temp)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_cosine_normalisation_has_finite_gradient_at_a_zero_row():
    """x * rsqrt(sum x^2 + eps^2), not x / (|x| + eps): a zero feature row
    (an all-padding window) must not give NaN gradients."""
    feats, labels, mask = _eop_inputs(4)
    feats[0, 0] = 0.0
    x = torch.from_numpy(feats).requires_grad_()
    loss = cssl.eop_matrix_cl_loss(x, torch.from_numpy(labels), torch.from_numpy(mask), 0.1)
    sims, _ = cssl.eop_pair_cosine_similarity(x, torch.from_numpy(labels),
                                              torch.from_numpy(mask), 1.0)
    (loss + sims.clamp_min(-1).sum()).backward()
    assert torch.isfinite(x.grad).all()


# ------------------------------------------------------- composite loss


def _model_outputs(seed, B=2, L=24, K=6, H=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    outs = [{"seq_output": f(B, L, H), "token_logits": f(B, L, 2), "tssp_logits": f(B, K, 3)}
            for _ in range(2)]
    labels = rng.integers(0, 2, size=(B, 2, L)).astype(np.int32)
    labels[rng.random((B, 2, L)) < 0.4] = -100
    pos = np.sort(rng.choice(np.arange(1, L), size=(B, 2, K)), axis=-1).astype(np.int32)
    n = rng.integers(3, K + 1, size=(B, 2))
    mask = (np.arange(K) < n[..., None]).astype(np.int32)
    batch = {"labels": labels, "sent_positions": pos, "eop_mask": mask, "sent_mask": mask,
             "pair_orders": rng.integers(0, 3, size=(B, 2, K)).astype(np.int32)}
    return outs, batch


@pytest.mark.parametrize("predictor,cl_level", [("lt", "eop_matrix"), ("lt", "eop_list"),
                                                ("cos", "eop_matrix")])
def test_compute_topic_seg_loss_matches_jax(predictor, cl_level):
    import jax.numpy as jnp

    from spokennlp_tpu.models.topic_seg import compute_topic_seg_loss as jax_loss
    from spokennlp_tpu_torch.data.cssl_sampling import build_cssl_list_indices

    task = TopicSegConfig(ts_score_predictor=predictor, cl_anchor_level=cl_level,
                          cl_loss_weight=0.5, tssp_loss_weight=0.7, do_tssp=True, do_da_ts=True,
                          weight_label_zero=0.4)
    outs, batch = _model_outputs(5)
    idx = None
    if cl_level == "eop_list":
        B, _, K = batch["eop_mask"].shape
        lab = np.take_along_axis(batch["labels"][:, 0], batch["sent_positions"][:, 0], 1)
        idx = build_cssl_list_indices(np.where(batch["eop_mask"][:, 0] == 1, lab, 0),
                                      batch["eop_mask"][:, 0], cl_level, 1, 1,
                                      np.random.default_rng(1), max_anchors=B * K)
    jax_task = _jax_task(task)
    conv = lambda d, f: {k: f(v) for k, v in d.items()} if d is not None else None
    want_loss, want_aux = jax_loss(jax_task, conv(outs[0], jnp.asarray), conv(outs[1], jnp.asarray),
                                   conv(batch, jnp.asarray), conv(idx, jnp.asarray))
    got_loss, got_aux = compute_topic_seg_loss(
        task, conv(outs[0], torch.from_numpy), conv(outs[1], torch.from_numpy),
        conv(batch, torch.from_numpy), conv(idx, torch.from_numpy))
    assert set(got_aux) == set(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(_np(got_aux[k]), np.asarray(want_aux[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(_np(got_loss), np.asarray(want_loss), **TOL)


def _jax_task(task):
    from spokennlp_tpu.configs import TopicSegConfig as JaxTopicSegConfig

    return JaxTopicSegConfig(**dataclasses.asdict(task))


# ------------------------------------------------------------- optimizer


@pytest.mark.parametrize("warmup_ratio", [0.0, 0.3])
def test_lr_schedule_matches_optax(warmup_ratio):
    from spokennlp_tpu.train.optim import linear_warmup_schedule as jax_schedule

    total = 20
    warmup = int(warmup_ratio * total)
    want = jax_schedule(3e-4, total, warmup)
    got = optim.linear_warmup_schedule(3e-4, total, warmup)
    for step in range(total + 5):
        assert math.isclose(got(step), float(want(step)), rel_tol=1e-6, abs_tol=1e-12), step


def test_decay_mask_matches_jax():
    import jax

    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel
    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig
    from spokennlp_tpu.train.optim import _decay_mask

    params = _jax_init(JaxTopicSegModel(JaxEncoderConfig(**TINY), _jax_task(TopicSegConfig())))
    flat = jax.tree_util.tree_flatten_with_path(_decay_mask(params))[0]
    want = {".".join(k.key for k in path): bool(v) for path, v in flat}
    port = TopicSegModel(EncoderConfig(**TINY), TopicSegConfig())
    got = {n: optim.decays(n) for n, _ in port.named_parameters()}
    assert got == want


@pytest.mark.parametrize("accumulation", [1, 2])
def test_optimizer_updates_match_optax(accumulation):
    """AdamW + clipping (triggered) + schedule (+ MultiSteps) over 4 micro-
    steps of the same random gradients on both sides."""
    import jax.numpy as jnp
    import optax

    from spokennlp_tpu.configs import TrainConfig as JaxTrainConfig
    from spokennlp_tpu.train.optim import make_optimizer as jax_make_optimizer

    cfg = TrainConfig(learning_rate=1e-2, weight_decay=0.1, warmup_ratio=0.25, max_grad_norm=0.5,
                      gradient_accumulation_steps=accumulation)
    rng = np.random.default_rng(7)
    shapes = {"w.kernel": (4, 3), "w.bias": (3,), "mlp_ln.scale": (3,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    nest = lambda d: {"w": {"kernel": jnp.asarray(d["w.kernel"]), "bias": jnp.asarray(d["w.bias"])},
                      "mlp_ln": {"scale": jnp.asarray(d["mlp_ln.scale"])}}
    tx = jax_make_optimizer(JaxTrainConfig(**dataclasses.asdict(cfg)), total_steps=8)
    jp = nest(init)
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in shapes]
    opt = optim.TrainOptimizer(params, list(shapes), cfg, total_steps=8)
    for g in grads:
        updates, state = tx.update(nest(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(g[k].copy()) for k in shapes])
    want = [jp["w"]["kernel"], jp["w"]["bias"], jp["mlp_ln"]["scale"]]
    for p, w in zip(params, want):
        np.testing.assert_allclose(_np(p), np.asarray(w), atol=1e-6, rtol=1e-5)
    assert opt.micro_step == 4


@pytest.mark.parametrize("warmup", [1, 4000])
def test_noam_schedule_matches_jax(warmup):
    from spokennlp_tpu.train.optim import noam_schedule as jax_noam

    want, got = jax_noam(768, 2.0, warmup), optim.noam_schedule(768, 2.0, warmup)
    for step in (0, 1, 2, 10, 999, 3999, 4000, 10000):
        assert math.isclose(got(step), float(want(step)), rel_tol=1e-6), step


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_module_lr_optimizer_matches_optax(weight_decay):
    """One step of per-module learning-rate groups on both sides: paths
    that hold a key take its rate (the first key in sorted order), the rest
    the base rate."""
    import jax.numpy as jnp
    import optax

    from spokennlp_tpu.train.optim import make_module_lr_optimizer as jax_make

    rng = np.random.default_rng(3)
    shapes = {"encoder.layer_0.kernel": (4, 3), "cross_encoder.layer_0.kernel": (3, 2),
              "cross_encoder.head.bias": (2,), "head.bias": (3,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grad = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    module_lrs = {"cross_encoder": 1e-2, "head": 3e-3}

    def nest(d):
        tree = {}
        for name, v in d.items():
            *path, leaf = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(v)
        return tree

    assert optim.module_lr_groups(list(shapes), module_lrs) == [
        "__base__", "cross_encoder", "cross_encoder", "head"]
    tx = jax_make(1e-3, module_lrs, weight_decay=weight_decay)
    jp = nest(init)
    updates, _ = tx.update(nest(grad), tx.init(jp), jp)
    jp = optax.apply_updates(jp, updates)
    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in shapes]
    opt = optim.make_module_lr_optimizer(list(zip(shapes, params)), 1e-3, module_lrs,
                                         weight_decay=weight_decay)
    for p, k in zip(params, shapes):
        p.grad = torch.from_numpy(grad[k].copy())
    opt.step()
    for p, k in zip(params, shapes):
        node = jp
        for part in k.split("."):
            node = node[part]
        np.testing.assert_allclose(_np(p), np.asarray(node), atol=1e-6, rtol=0, err_msg=k)


def test_tensorboard_events_read_back_by_tensorboard(tmp_path):
    """MetricLogger's TensorBoard events, read with TensorBoard's reader:
    every numeric value of an event but its step, time and epoch, as
    <event>/<name> at the event's step; and run_finetune --report_to
    tensorboard writes the scalars its metrics.jsonl holds."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from spokennlp_tpu_torch.cli import run_finetune
    from spokennlp_tpu_torch.train.trainer import MetricLogger

    log = MetricLogger(str(tmp_path / "metrics.jsonl"), str(tmp_path / "tb"))
    logged = [{"event": "train", "step": s, "epoch": 1, "loss": 1.5 / s, "grad_norm": 0.25 * s}
              for s in (1, 2, 3)] + [{"event": "eval", "step": 3, "f1": 0.625}]
    for e in logged:
        log.log(e)
    log.close()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["eval/f1", "train/grad_norm", "train/loss"]
    for tag, key, event in (("train/loss", "loss", "train"), ("train/grad_norm", "grad_norm",
                                                               "train"), ("eval/f1", "f1", "eval")):
        want = [(e["step"], e[key]) for e in logged if e["event"] == event]
        got = [(s.step, s.value) for s in acc.Scalars(tag)]
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=1e-7)

    out = tmp_path / "out"
    run_finetune.main([
        "--data_dir", _write_corpus(tmp_path), "--output_dir", str(out), "--device", "cpu",
        "--hidden_size", "32", "--num_hidden_layers", "1", "--num_attention_heads", "2",
        "--intermediate_size", "64", "--max_seq_length", "64", "--num_train_epochs", "1",
        "--per_device_train_batch_size", "4", "--gradient_accumulation_steps", "1",
        "--logging_steps", "1", "--do_train", "--report_to", "tensorboard"])
    train = [e for e in map(json.loads, (out / "metrics.jsonl").read_text().splitlines())
             if e["event"] == "train"]
    acc = EventAccumulator(str(out / "tensorboard"))
    acc.Reload()
    got = [(s.step, s.value) for s in acc.Scalars("train/loss")]
    assert got == [(e["step"], pytest.approx(e["loss"], rel=1e-6)) for e in train] and got
    # the run's end: its final eval among the scalars
    assert {"train_end/final_f1", "train_end/train_steps"} <= set(acc.Tags()["scalars"])


# -------------------------------------------------------- full train step


def _jax_init(jax_model, B=2, L=64):
    import jax
    import jax.numpy as jnp

    return jax_model.init(jax.random.PRNGKey(0), jnp.ones((B, L), jnp.int32),
                          attention_mask=jnp.ones((B, L), jnp.int32),
                          token_type_ids=jnp.zeros((B, L), jnp.int32),
                          sent_positions=jnp.zeros((B, 8), jnp.int32), deterministic=True)["params"]


def _docs(seed, n_docs, rng_words=(3, 9)):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        ns = int(rng.integers(8, 20))
        labels = [int(rng.random() < 0.25) for _ in range(ns)]
        labels[-1] = 1
        docs.append({"sent_token_ids": [rng.integers(5, 120, size=rng.integers(*rng_words))
                                        .tolist() for _ in range(ns)], "labels": labels})
    return docs


@pytest.mark.parametrize("impl,cl_level", [("einsum", "eop_matrix"), ("train_fused", "eop_matrix"),
                                           ("einsum", "eop_list")])
def test_train_step_matches_jax(impl, cl_level):
    """One composite step (anchor + DA views, CSSL, TSSP) at dropout 0: the
    losses, grad_norm and the parameters after one clipped AdamW step.
    adam_eps is 1e-3 here: at 1e-8 the first Adam step is lr * sign(g), and a
    gradient entry near 0 summed in another order could flip it."""
    import jax

    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig
    from spokennlp_tpu.configs import TrainConfig as JaxTrainConfig
    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel
    from spokennlp_tpu.train.optim import make_optimizer as jax_make_optimizer
    from spokennlp_tpu.train.train_step import create_train_state
    from spokennlp_tpu.train.train_step import make_topic_seg_train_step as jax_make_step
    from spokennlp_tpu_torch.data.featurization import batches_from_docs

    enc = EncoderConfig(**TINY, hidden_dropout=0.0, attention_dropout=0.0, attention_impl=impl)
    task = TopicSegConfig(cl_anchor_level=cl_level, cl_loss_weight=0.5, tssp_loss_weight=1.0,
                          do_tssp=True, do_da_ts=True, classifier_dropout=0.0)
    cfg = TrainConfig(learning_rate=1e-3, adam_eps=1e-3, gradient_accumulation_steps=1)
    batch = next(batches_from_docs(_docs(0, 4), WindowingConfig(**WCFG), task, 4,
                                   np.random.default_rng(0)))

    jm = JaxTopicSegModel(JaxEncoderConfig(**dataclasses.asdict(enc)), _jax_task(task))
    params = _jax_init(jm)
    before = jax_params_to_state_dict(jax.tree.map(np.asarray, params))  # the step donates them
    tx = jax_make_optimizer(JaxTrainConfig(**dataclasses.asdict(cfg)), total_steps=10)
    jstate, jmetrics = jax_make_step(jm, _jax_task(task), tx)(
        create_train_state(params, tx), {k: jax.numpy.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))

    port = TopicSegModel(enc, task)
    port.load_state_dict(before, strict=True)
    opt = optim.make_optimizer(port, cfg, total_steps=10)
    metrics = make_topic_seg_train_step(port, task, opt)(batch_to_device(batch, torch.device("cpu")))

    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(jmetrics[k]), rtol=GRAD_RTOL,
                                   err_msg=k)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    for name, p in port.state_dict().items():
        step = np.abs(want[name].numpy() - before[name].numpy()).max()
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=max(GRAD_RTOL * step, 1e-7), err_msg=name)


def test_train_step_dropout_streams_are_reproducible():
    """Dropout on: the same seed and micro-step give the same masks and
    loss, another micro-step other masks."""
    enc = EncoderConfig(**TINY, attention_impl="train_fused")
    task = TopicSegConfig(cl_anchor_level="eop_matrix", do_tssp=True, do_da_ts=True,
                          tssp_loss_weight=1.0)
    from spokennlp_tpu_torch.data.featurization import batches_from_docs

    batch = batch_to_device(next(batches_from_docs(
        _docs(1, 3), WindowingConfig(**WCFG), task, 3, np.random.default_rng(0))),
        torch.device("cpu"))
    losses_seen = []
    for _ in range(2):
        port = TopicSegModel(enc, task, generator=torch.Generator().manual_seed(0))
        opt = optim.make_optimizer(port, TrainConfig(gradient_accumulation_steps=1), 10)
        step = make_topic_seg_train_step(port, task, opt, seed=3)
        losses_seen.append([float(step(batch)["loss"]) for _ in range(2)])
    assert losses_seen[0] == losses_seen[1]
    assert losses_seen[0][0] != losses_seen[0][1]


def test_fused_in_training_mode_takes_the_training_kernels_path():
    """attention_impl="fused" on a model in training mode runs the training
    blocks (Philox probability dropout), not the einsum path (whose masks
    come from the torch generator): its step equals "train_fused"'s."""
    from spokennlp_tpu_torch.data.featurization import batches_from_docs

    task = TopicSegConfig(cl_anchor_level="eop_matrix", do_tssp=True, do_da_ts=True,
                          tssp_loss_weight=1.0)
    batch = batch_to_device(next(batches_from_docs(
        _docs(1, 3), WindowingConfig(**WCFG), task, 3, np.random.default_rng(0))),
        torch.device("cpu"))
    loss = {}
    for impl in ("fused", "train_fused", "einsum"):
        port = TopicSegModel(EncoderConfig(**TINY, attention_impl=impl), task,
                             generator=torch.Generator().manual_seed(0))
        opt = optim.make_optimizer(port, TrainConfig(gradient_accumulation_steps=1), 10)
        loss[impl] = float(make_topic_seg_train_step(port, task, opt, seed=3)(batch)["loss"])
    assert loss["fused"] == loss["train_fused"] != loss["einsum"]


def test_train_profile_runs_on_cpu():
    """The profiler's control flow at a tiny size: step times, finite losses,
    and no device kernels or device memory on the CPU."""
    from spokennlp_tpu_torch.train import profiling

    run = profiling.measure(EncoderConfig(**TINY, attention_impl="auto"), batch_size=2,
                            slots=8, steps=1, device="cpu")
    assert run["attention_impl"] == "auto" and len(run["step_ms"]) == 1
    assert all(math.isfinite(v) for v in run["last_step"].values())
    assert run["kernel_ms"] == 0 and run["kernels"] == {}
    assert run["peak_gib"] is None and run["busy_share"] is None
    assert profiling.kernel_name("void spk::(anonymous namespace)::attn_fwd<float, 64>(int)") == \
        "attn_fwd"


# ------------------------------------------------------------------ CLI


def _write_corpus(root, seed=0):
    rng = np.random.default_rng(seed)
    d = root / "wiki_section"
    d.mkdir()
    for split, n in (("train.jsonl", 6), ("dev.jsonl", 2), ("test.jsonl", 2)):
        with open(d / split, "w") as f:
            for _ in range(n):
                ns = int(rng.integers(8, 16))
                sents = [" ".join(f"w{i}" for i in rng.integers(0, 50, size=rng.integers(3, 8)))
                         for _ in range(ns)]
                labels = [int(rng.random() < 0.25) for _ in range(ns)]
                labels[-1] = 1
                f.write(json.dumps({"sentences": sents, "labels": labels}) + "\n")
    return str(d)


def test_run_finetune_cli_on_cpu(tmp_path):
    from spokennlp_tpu_torch.cli import run_finetune

    out = tmp_path / "out"
    argv = [
        "--data_dir", _write_corpus(tmp_path), "--output_dir", str(out), "--device", "cpu",
        "--hidden_size", "32", "--num_hidden_layers", "1", "--num_attention_heads", "2",
        "--intermediate_size", "64", "--max_seq_length", "64", "--num_train_epochs", "2",
        "--per_device_train_batch_size", "4", "--gradient_accumulation_steps", "2",
        "--logging_steps", "1", "--do_train", "--do_eval", "--do_predict", "--do_da_ts",
        "--do_tssp", "--tssp_loss_weight", "1.0", "--cl_loss_weight", "0.5",
        "--cl_anchor_level", "eop_matrix", "--threshold", "0.5",
    ]
    results = run_finetune.main(argv)
    # the files the JAX CLI writes: metrics.jsonl, all_results.json, final_model/
    assert {"metrics.jsonl", "all_results.json", "final_model"} <= {p.name for p in out.iterdir()}
    events = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    train = [e for e in events if e["event"] == "train"]
    assert len(train) == results["train_steps"] // 2 >= 2
    assert all(math.isfinite(e[k]) for e in train for k in ("loss", "cl_loss", "tssp_loss",
                                                            "grad_norm"))
    assert [e["event"] for e in events][-1] == "train_end"
    saved = json.loads((out / "all_results.json").read_text())
    assert "eval_f1" in saved and "predict_pk" not in saved
    assert any(k.startswith("predict_") for k in saved)
    state = torch.load(out / "final_model" / "model.pt", weights_only=True)
    cfg = EncoderConfig(**json.loads((out / "final_model" / "config.json").read_text()))
    TopicSegModel(cfg, TopicSegConfig()).load_state_dict(state, strict=True)
    # a second run resumes from the kept checkpoint and trains no further
    again = run_finetune.main(argv)
    assert again["train_steps"] == results["train_steps"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_finetune.main(argv[:argv.index("--device")] + argv[argv.index("--device") + 2:])


# ------------------------------------------------------------- on the card


@pytest.mark.gpu
def test_train_step_on_card_matches_plain_on_cpu():
    """The training kernels (float32, dropout 0) against their plain versions
    through one whole composite step: losses, grad_norm and the updated
    parameters; float32 sums in another order, so 1e-3 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from spokennlp_tpu_torch.data.featurization import batches_from_docs
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    enc = EncoderConfig(**{**TINY, "hidden_size": 64}, hidden_dropout=0.0, attention_dropout=0.0,
                        attention_impl="train_fused")
    task = TopicSegConfig(cl_anchor_level="eop_matrix", cl_loss_weight=0.5, tssp_loss_weight=1.0,
                          do_tssp=True, do_da_ts=True, classifier_dropout=0.0)
    cfg = TrainConfig(learning_rate=1e-3, adam_eps=1e-3, gradient_accumulation_steps=1)
    batch = next(batches_from_docs(_docs(2, 4), WindowingConfig(**WCFG), task, 4,
                                   np.random.default_rng(0)))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = TopicSegModel(enc, task, generator=torch.Generator().manual_seed(0)).to(dev)
        opt = optim.make_optimizer(model, cfg, total_steps=10)
        n = tb.attention_train_bwd.launches
        metrics = make_topic_seg_train_step(model, task, opt)(
            batch_to_device(batch, torch.device(dev)))
        assert tb.attention_train_bwd.launches - n == (2 * enc.num_layers if dev == "cuda" else 0)
        runs[dev] = ({k: float(v) for k, v in metrics.items()},
                     {k: v.cpu() for k, v in model.state_dict().items()})
    (m_cpu, p_cpu), (m_card, p_card) = runs["cpu"], runs["cuda"]
    for k in m_cpu:
        assert math.isclose(m_card[k], m_cpu[k], rel_tol=GRAD_RTOL), (k, m_card[k], m_cpu[k])
    for k in p_cpu:
        torch.testing.assert_close(p_card[k], p_cpu[k], rtol=0, atol=1e-5, msg=k)
