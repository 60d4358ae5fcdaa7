"""MMVTS on the port against the JAX package: ``models/multimodal.py``,
``objectives/mmvts_losses.py``, ``projects/mmvts.py`` and
``eval/video_metrics.py``. JAX is imported inside the tests.

Sizes: fusion width 16, 2 heads, 2 cross-encoder layers, 4 experts, B=2,
K=6 clips (one row padded); the MMVTS model on a 1-layer trunk of width 32
over 64 tokens. Weights are drawn by the port and carried into JAX's tree
(``models/checkpoint_io.params_from_state_dict``), whose structure and
shapes equal JAX's own init (``jax.eval_shape``) and which loads back
through ``models/convert.py`` with ``strict=True``; JAX's own fresh init
crosses in the other direction in ``tests/test_torch_mmvts_cli.py``. In
float32: every variant's outputs within 1e-5; the losses and each aux term
within 1e-5 relative and the list-mode indices equal (the same numpy
draws); one step's gradients within 1e-4 of each gradient's largest
entry; featurize_video's rows and the video metrics equal.
"""


import numpy as np
import pytest
import torch

BASE = dict(hidden_size=16, text_hidden_size=12, vis_hidden_size=10, audio_hidden_size=8,
            num_cross_encoder_heads=2, intermediate_size=24, num_cross_encoder_layers=2,
            hidden_dropout=0.0, attention_dropout=0.0, moe_num_experts=4, moe_top_k=2)
VARIANTS = {
    "ma-linear-modal-splits": dict(out_modal_prob=True),
    "ca_moe-dispatch-transformer-projector-and-predictor": dict(
        cross_encoder_type="ca_moe", moe_impl="dispatch", projector_type="transformer",
        proj_skip=True, predictor_type="transformer"),
    "ma_moe-shared-hybrid-l-max": dict(
        cross_encoder_type="ma_moe", moe_share_in_layers=True, predictor_type="hybrid",
        predictor_hybrid_weight_type="l", predictor_hybrid_pooling="max"),
    "ca-hybrid-p-mean-fuse-mean": dict(cross_encoder_type="ca", predictor_type="hybrid",
                                       fuse_type="mean"),
    "ma_moe-dense-fuse-max": dict(cross_encoder_type="ma_moe", fuse_type="max"),
    "none-cat_t_v-modal-splits": dict(cross_encoder_type="none", fuse_type="cat_t_v",
                                      out_modal_prob=True),
    "vis_only": dict(fuse_type="vis_only"),
}
B, K = 2, 6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = {m: rng.normal(size=(B, K, BASE[f"{m}_hidden_size"])).astype(np.float32)
             for m in ("text", "vis", "audio")}
    mask = np.ones((B, K), np.int32)
    mask[1, 4:] = 0
    return mask, feats


def _jax_tree(module, jax_init_args):
    """The port module's weights as JAX's tree, checked against the
    structure and shapes of JAX's own init, and loaded back through
    models/convert.py with strict=True."""
    import jax

    from spokennlp_tpu_torch.models.checkpoint_io import params_from_state_dict
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    tree = params_from_state_dict(module.state_dict())
    shapes = jax.eval_shape(*jax_init_args)["params"]
    assert jax.tree.structure(shapes) == jax.tree.structure(tree)
    assert jax.tree.map(lambda s: tuple(s.shape), shapes) == jax.tree.map(np.shape, tree)
    module.load_state_dict(jax_params_to_state_dict(tree), strict=True)
    return tree


def _close(got, want, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fusion_matches_jax(variant):
    """Every projector, cross-encoder (MoE dense and dispatch, a shared
    bank), fuse and predictor: logits, fused, features, projected, the
    modal splits and the balance loss within 1e-5."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models import multimodal as jm
    from spokennlp_tpu_torch.models import multimodal as tm

    kw = {**BASE, **VARIANTS[variant]}
    mask, feats = _inputs()
    tmod = tm.MultiModalForTS(tm.MultimodalConfig(**kw), generator=torch.Generator().manual_seed(0))
    jmod = jm.MultiModalForTS(jm.MultimodalConfig(**kw))
    jf = {f"{m}_feats": jnp.asarray(v) for m, v in feats.items()}
    tree = _jax_tree(tmod, (jmod.init, jax.random.PRNGKey(0), jnp.asarray(mask)) + tuple(
        jf.values()))
    want = jax.jit(lambda p: jmod.apply({"params": p}, jnp.asarray(mask), **jf))(tree)
    got = tmod.eval()(torch.from_numpy(mask), **{k: torch.from_numpy(np.asarray(v))
                                                  for k, v in jf.items()})
    for key in ("logits", "fused"):
        _close(got[key], want[key], msg=key)
    for key in ("features", "projected"):
        assert got[key].keys() == want[key].keys()
        for m in want[key]:
            _close(got[key][m], want[key][m], msg=f"{key}.{m}")
    assert (got["modal_logits"] is None) == (want["modal_logits"] is None)
    for g, w in zip(got["modal_logits"] or (), want["modal_logits"] or ()):
        _close(g, w, msg="modal_logits")
    assert (got["moe_loss"] is None) == (want["moe_loss"] is None)
    if want["moe_loss"] is not None:
        _close(got["moe_loss"], want["moe_loss"], atol=0, rtol=1e-5, msg="moe_loss")


def _clip_labels(rng, mask):
    labels = rng.integers(0, 2, size=mask.shape).astype(np.int32)
    return np.where(mask.astype(bool), labels, -100).astype(np.int32)


def test_losses_and_list_indices_match_jax():
    """ts CE (weighted), modality InfoNCE, the matrix and list topic CL
    (simcse and ce), the composite loss with every aux key, zero feature
    rows included; the host-sampled list indices equal for both choices
    and several seeds, with as many draws."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.objectives import mmvts_losses as jl
    from spokennlp_tpu_torch.objectives import mmvts_losses as tl

    rng = np.random.default_rng(5)
    Bl, Kl, H = 3, 7, 8
    mask = np.ones((Bl, Kl), np.int32)
    mask[1, 5:] = 0
    mask[2, 3:] = 0
    labels = _clip_labels(rng, mask)
    feats = {m: rng.normal(size=(Bl, Kl, H)).astype(np.float32) for m in ("text", "vis", "audio")}
    feats["audio"][0, 2] = 0.0  # a zero row: the rsqrt normalisation keeps it finite
    for choice in ("random", "near"):
        for seed in range(4):
            j_rng, t_rng = np.random.default_rng(seed), np.random.default_rng(seed)
            want = jl.build_topic_cl_list_indices(labels, mask, 2, 3, choice, j_rng)
            got = tl.build_topic_cl_list_indices(labels, mask, 2, 3, choice, t_rng)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
            assert t_rng.random() == j_rng.random()
    assert want["anchor_valid"].any()
    idx = tl.build_topic_cl_list_indices(labels, mask, 2, 3, "random", np.random.default_rng(1))
    T = lambda x: torch.from_numpy(np.asarray(x))
    J = lambda x: jnp.asarray(x)
    jit = lambda f, *a: jax.jit(f)(*a)  # JAX's eager ops compile one by one
    for fct in ("simcse", "ce"):
        _close(tl.topic_cl_list_loss(T(feats["text"]), {k: T(v) for k, v in idx.items()}, 0.1,
                                     fct),
               jit(lambda f, i: jl.topic_cl_list_loss(f, i, 0.1, fct), feats["text"], idx),
               atol=0, msg=fct)
    _close(tl.modality_cl_loss(T(feats["audio"]), T(feats["vis"]), T(mask), 0.1),
           jit(lambda a, b, m: jl.modality_cl_loss(a, b, m, 0.1), feats["audio"], feats["vis"],
               mask), atol=0)
    _close(tl.topic_cl_matrix_loss(T(feats["vis"]), T(labels), T(mask), 0.1),
           jit(lambda f, y, m: jl.topic_cl_matrix_loss(f, y, m, 0.1), feats["vis"], labels,
               mask), atol=0)
    logits = rng.normal(size=(Bl, Kl, 2)).astype(np.float32)
    fused = np.concatenate([feats["text"], feats["vis"]], -1)
    for topic_type in ("matrix", "list"):
        kw = dict(weight_label_zero=0.7, do_modality_cl=True, align_pairs={"tv": 0.33, "av": 0.5,
                                                                           "at": 1.0},
                  modality_cl_lw=0.8, do_topic_mm_cl=True, topic_cl_type=topic_type)
        outs = {"logits": logits, "fused": fused, "projected": feats, "features": feats,
                "moe_loss": np.float32(0.25)}
        conv = lambda f: {k: ({m: f(x) for m, x in v.items()} if isinstance(v, dict) else f(v))
                          for k, v in outs.items()}
        j_total, j_aux = jit(lambda o, y, m, i: jl.mmvts_total_loss(
            None, o, y, m, **kw, topic_cl_indices=i), conv(J), labels, mask, idx)
        t_total, t_aux = tl.mmvts_total_loss(None, conv(T), T(labels), T(mask), **kw,
                                             topic_cl_indices={k: T(v) for k, v in idx.items()})
        assert t_aux.keys() == j_aux.keys()
        for k in j_aux:
            _close(t_aux[k], j_aux[k], atol=0, msg=k)
        _close(t_total, j_total, atol=0)


def _mmvts_configs(trunk):
    from spokennlp_tpu.configs import EncoderConfig as JEnc
    from spokennlp_tpu.models.multimodal import MultimodalConfig as JMM
    from spokennlp_tpu_torch.configs import EncoderConfig as TEnc
    from spokennlp_tpu_torch.models.multimodal import MultimodalConfig as TMM

    enc = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=48,
               max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0,
               add_pooler=False)
    if trunk == "sliding_window":
        enc.update(attention_type="sliding_window", attention_window=16,
                   position_style="roberta", pad_token_id=1, max_position_embeddings=72)
    mm = dict(BASE, text_hidden_size=32, cross_encoder_type="ma_moe", moe_impl="dispatch",
              num_cross_encoder_layers=1)
    return (JEnc(**enc), JMM(**mm)), (TEnc(**enc), TMM(**mm))


def _video_batch(wcfg_kw, seed=4):
    """Two videos' windows through the port's featurize_video (JAX's gives
    the same rows: test_featurize_video_matches_jax)."""
    from spokennlp_tpu_torch.configs import WindowingConfig
    from spokennlp_tpu_torch.projects.mmvts import featurize_video

    rng = np.random.default_rng(seed)
    rows = []
    for vid, n in enumerate((9, 7)):
        toks = [rng.integers(5, 60, size=int(rng.integers(2, 6))).tolist() for _ in range(n)]
        labels = rng.integers(0, 2, size=n).tolist()
        feats = {"vis": rng.normal(size=(n, 10)).astype(np.float32),
                 "audio": rng.normal(size=(n, 8)).astype(np.float32)}
        rows += featurize_video(toks, labels, feats, WindowingConfig(**wcfg_kw), vid, K)
    keys = ("input_ids", "attention_mask", "clip_positions", "clip_mask", "clip_labels",
            "vis_feats", "audio_feats")
    return {k: np.stack([r[k] for r in rows[:2]]) for k in keys}


@pytest.mark.parametrize("trunk", ["dense", "sliding_window"])
def test_mmvts_step_gradients_match_jax(trunk):
    """MMVTSModel (a dense or Longformer trunk: the all-zeros global mask,
    prefix_globals 0) with ma_moe dispatch and the composite loss (modality
    CL over tv and av, matrix topic CL): the loss, every aux term within
    1e-5 relative, every parameter's gradient within 1e-4 of its largest
    entry; then one port train step on AdamW runs and its pretraining step
    reads the alignment loss alone."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.objectives import mmvts_losses as jl
    from spokennlp_tpu.projects import mmvts as jp
    from spokennlp_tpu_torch.configs import TrainConfig
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.objectives import mmvts_losses as tl
    from spokennlp_tpu_torch.projects import mmvts as tp
    from spokennlp_tpu_torch.train import optim

    (jenc, jmm), (tenc, tmm) = _mmvts_configs(trunk)
    pad = 1 if trunk == "sliding_window" else 0
    batch = _video_batch(dict(max_seq_length=64, cls_token_id=2, pad_token_id=pad,
                              bos_token_id=3))
    tmodel = tp.MMVTSModel(tenc, tmm, generator=torch.Generator().manual_seed(0))
    jmodel = jp.MMVTSModel(jenc, jmm)
    args = [jnp.asarray(batch[k]) for k in ("input_ids", "attention_mask", "clip_positions",
                                            "clip_mask")]
    feats = dict(vis_feats=jnp.asarray(batch["vis_feats"]),
                 audio_feats=jnp.asarray(batch["audio_feats"]))
    tree = _jax_tree(tmodel, (lambda r: jmodel.init(r, *args, **feats), jax.random.PRNGKey(0)))
    kw = dict(weight_label_zero=0.7, do_modality_cl=True, align_pairs={"tv": 0.33, "av": 0.5},
              do_topic_mm_cl=True, topic_cl_type="matrix")

    def jloss(p):
        out = jmodel.apply({"params": p}, *args, **feats)
        return jl.mmvts_total_loss(None, out, jnp.asarray(batch["clip_labels"]), args[3], **kw)

    (j_total, j_aux), j_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(tree)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = tmodel(tb["input_ids"], tb["attention_mask"], tb["clip_positions"], tb["clip_mask"],
                 vis_feats=tb["vis_feats"], audio_feats=tb["audio_feats"])
    t_total, t_aux = tl.mmvts_total_loss(None, out, tb["clip_labels"], tb["clip_mask"], **kw)
    assert t_aux.keys() == j_aux.keys()
    for k in j_aux:
        _close(t_aux[k], j_aux[k], atol=0, msg=k)
    named = list(tmodel.named_parameters())
    grads = torch.autograd.grad(t_total, [p for _, p in named])
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, j_grads))
    assert set(want) == {n for n, _ in named}
    for (name, _), g in zip(named, grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=name)

    opt = optim.make_optimizer(tmodel, TrainConfig(gradient_accumulation_steps=1), 10)
    metrics = tp.make_mmvts_train_step(tmodel, opt, kw)(tb)
    _close(metrics["total_loss"], j_total, atol=0)
    pre = tp.make_mmvts_pretrain_step(tmodel, opt, {"tv": 1.0})(tb)
    assert set(pre) == {"ts_loss", "tv_cl_loss", "modality_cl_loss", "moe_loss", "total_loss"}
    assert float(pre["ts_loss"]) == 0.0 and float(pre["modality_cl_loss"]) > 0
    _close(pre["total_loss"], pre["modality_cl_loss"] + pre["moe_loss"], atol=0)


def test_featurize_video_matches_jax():
    """Windows of a long video (several windows, clip overlap) and a short
    one, both label inversions, features aligned per clip id (a feature
    table shorter than the clips leaves zeros)."""
    from spokennlp_tpu.configs import WindowingConfig as JW
    from spokennlp_tpu.projects.mmvts import featurize_video as jf
    from spokennlp_tpu_torch.configs import WindowingConfig as TW
    from spokennlp_tpu_torch.projects.mmvts import featurize_video as tf

    rng = np.random.default_rng(7)
    kw = dict(max_seq_length=32, cls_token_id=2, pad_token_id=0, bos_token_id=1)
    for n, K_w in ((23, 6), (4, 8)):
        toks = [rng.integers(5, 60, size=int(rng.integers(1, 7))).tolist() for _ in range(n)]
        labels = rng.integers(0, 2, size=n).tolist()
        feats = {"vis": rng.normal(size=(n - 1, 5)).astype(np.float32)}
        want, got = jf(toks, labels, feats, JW(**kw), 3, K_w), tf(toks, labels, feats, TW(**kw), 3,
                                                                 K_w)
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_video_metrics_match_jax():
    """bs@k, F1 tolerance, mIoU, clip F1, the corpus metrics, the by-type
    breakdown, the LLM scorer and the run summaries: equal."""
    from spokennlp_tpu.eval import video_metrics as jv
    from spokennlp_tpu_torch.eval import video_metrics as tv

    rng = np.random.default_rng(9)
    examples = []
    for i in range(6):
        n = int(rng.integers(3, 15))
        examples.append({"example_id": f"v{i}", "labels": rng.integers(0, 2, n).tolist(),
                         "preds": rng.integers(0, 2, n).tolist(),
                         "clip_end_seconds": np.cumsum(rng.uniform(3, 40, n)).tolist()})
    labels, preds = [20.0, 61.0, 95.0], [18.0, 40.0, 95.0, 130.0]
    for th in (5.0, 30.0):
        assert tv.bs_at_k(labels, preds, th) == jv.bs_at_k(labels, preds, th)
        assert tv.f1_tolerance(labels, preds, th) == jv.f1_tolerance(labels, preds, th)
        assert tv.evaluate_video_corpus(examples, th) == jv.evaluate_video_corpus(examples, th)
    assert tv.miou_by_overlap(labels, preds) == jv.miou_by_overlap(labels, preds)
    assert tv.clip_f1([e["labels"] for e in examples], [e["preds"] for e in examples]) == (
        jv.clip_f1([e["labels"] for e in examples], [e["preds"] for e in examples]))
    types = {"v0": "math", "v2": "bio", "v3": "math"}
    assert tv.evaluate_video_corpus_by_type(examples, types) == (
        jv.evaluate_video_corpus_by_type(examples, types))
    runs = [tv.evaluate_video_corpus(examples[i:i + 3]) for i in range(3)]
    assert tv.summarize_runs(runs) == jv.summarize_runs(runs)
    data = [{"example_id": "a", "labels": [0, 1, 0, 1], "topic_end_seconds": [20.0, 40.0],
             "stet": [[0, 10], [10, 20], [20, 30], [30, 40]]},
            {"example_id": "b", "labels": [0, 0, 1], "topic_end_seconds": [30.0],
             "stet": [[0, 10], [10, 20]]}]
    pred = [{"predict": [0, 1, "1", 1, 1, 0]}, {"predict": [1]}]
    assert tv.evaluate_llm_corpus(data, pred) == jv.evaluate_llm_corpus(data, pred)


@pytest.mark.gpu
def test_mmvts_model_on_the_card():
    """MMVTSModel on the card (dense and Longformer trunks, width 64, 2
    heads of 32, 64 tokens, window 32): training runs rows 10 / 12 and 11
    and evaluation kernel 3 / kernels 7 and 2 with no fallback; the loss
    within 1e-2 relative of the einsum twin (tanh GELU) at dropout 0, the
    eval logits within 1e-3 of the twin's largest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models.multimodal import MultimodalConfig
    from spokennlp_tpu_torch.objectives.mmvts_losses import mmvts_total_loss
    from spokennlp_tpu_torch.ops.cuda import (
        mlp_block, sliding_block, stack_block, train_blocks, train_sliding,
    )
    from spokennlp_tpu_torch.projects.mmvts import MMVTSModel

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for trunk, (train_k, eval_k) in {
            "dense": ((train_blocks.attention_train_fwd, train_blocks.mlp_train_fwd),
                      (stack_block.fused_encoder_stack,)),
            "sliding_window": ((train_sliding.sliding_train_fwd, train_blocks.mlp_train_fwd),
                               (sliding_block.fused_sliding_attention_block,
                                mlp_block.fused_mlp_block))}.items():
        enc = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
                   intermediate_size=128, max_position_embeddings=64, hidden_dropout=0.0,
                   attention_dropout=0.0, add_pooler=False)
        pad = 0
        if trunk == "sliding_window":
            enc.update(attention_type="sliding_window", attention_window=32,
                       position_style="roberta", pad_token_id=1, max_position_embeddings=72)
            pad = 1
        mm = MultimodalConfig(**dict(BASE, text_hidden_size=64, cross_encoder_type="ma_moe",
                                     moe_impl="dispatch"))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in _video_batch(dict(
            max_seq_length=64, cls_token_id=2, pad_token_id=pad, bos_token_id=3)).items()}
        models = {}
        for impl, act in (("auto", "gelu"), ("einsum", "gelu_new")):
            cfg = EncoderConfig(**enc, attention_impl=impl, hidden_act=act)
            with torch.device(dev):
                models[impl] = MMVTSModel(cfg, mm, generator=torch.Generator(dev).manual_seed(0))
        models["einsum"].load_state_dict(models["auto"].state_dict())
        args = [batch[k] for k in ("input_ids", "attention_mask", "clip_positions", "clip_mask")]
        feats = dict(vis_feats=batch["vis_feats"], audio_feats=batch["audio_feats"])
        losses = {}
        for impl, model in models.items():
            for fn in train_k:
                fn.launches = 0
            out = model.train()(*args, **feats)
            losses[impl] = mmvts_total_loss(mm, out, batch["clip_labels"], batch["clip_mask"],
                                            do_modality_cl=True, align_pairs={"tv": 1.0})[0]
            losses[impl].backward()
            if impl == "auto":
                assert all(fn.launches == enc["num_layers"] for fn in train_k), trunk
        assert abs(losses["auto"].item() - losses["einsum"].item()) <= 1e-2 * abs(
            losses["einsum"].item())
        with torch.no_grad():
            for fn in eval_k:
                fn.launches = 0
            got = models["auto"].eval()(*args, **feats)["logits"]
            assert all(fn.launches > 0 for fn in eval_k), trunk
            want = models["einsum"].eval()(*args, **feats)["logits"]
        assert (got - want).abs().max() <= 1e-3 * want.abs().max()
