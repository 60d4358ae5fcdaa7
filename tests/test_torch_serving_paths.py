"""The port's serving paths against the JAX package: the cos predictor (the
engine and the trainer's evaluate), attention_impl="flash", packed and
streamed inference, the per-batch scorer, and the inference CLI's cos
prediction file; the card cases hold the same paths on the kernels against
the einsum path or the CPU. JAX is imported inside the tests only (see
tests/test_torch_kernels.py)."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig, TrainConfig, WindowingConfig
from spokennlp_tpu_torch.data.windowing import stack_windows, window_document
from spokennlp_tpu_torch.data.windowing_fast import window_documents_stacked
from spokennlp_tpu_torch.eval import packed_inference as packed
from spokennlp_tpu_torch.eval.inference import (
    make_predict_fn, predict_cos_scores, predict_windows, predict_windows_scanned,
    run_topic_seg_inference,
)
from spokennlp_tpu_torch.eval.streaming import stream_topic_seg_inference
from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
from spokennlp_tpu_torch.models.encoder import resolve_attention_impl
from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

L = 128
ENC = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
           max_position_embeddings=L, add_pooler=False)
WIN = dict(max_seq_length=L, cls_token_id=2, pad_token_id=0, bos_token_id=1)
WCFG = WindowingConfig(**WIN)
STREAM_KEYS = ("featurize", "dispatch", "fetch", "aggregate", "metrics")


def _docs(seed=0, sizes=(20, 30, 15, 3, 4, 2, 5)):
    """Tokenized documents: three that take several windows, four short ones
    that packing puts several to a row."""
    rng = np.random.default_rng(seed)
    return [
        {"sent_token_ids": [rng.integers(10, 500, size=rng.integers(3, 12)).tolist()
                            for _ in range(n)],
         "labels": rng.integers(0, 2, size=n).tolist()}
        for n in sizes
    ]


@functools.lru_cache(maxsize=1)
def _jax_params():
    """The JAX model's parameters (they do not depend on the predictor or
    the attention path)."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig
    from spokennlp_tpu.configs import TopicSegConfig as JaxTopicSegConfig
    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel

    jm = JaxTopicSegModel(JaxEncoderConfig(**ENC), JaxTopicSegConfig())
    return jm.init(
        jax.random.PRNGKey(0), jnp.ones((2, L), jnp.int32),
        attention_mask=jnp.ones((2, L), jnp.int32), sent_positions=jnp.zeros((2, 3), jnp.int32),
    )["params"]


def _models(predictor="lt", impl="auto"):
    """The JAX model with its params, and the port carrying the same weights."""
    import jax

    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig
    from spokennlp_tpu.configs import TopicSegConfig as JaxTopicSegConfig
    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel

    jm = JaxTopicSegModel(JaxEncoderConfig(**ENC, attention_impl=impl),
                          JaxTopicSegConfig(ts_score_predictor=predictor))
    params = _jax_params()
    port = TopicSegModel(EncoderConfig(**ENC, attention_impl=impl),
                         TopicSegConfig(ts_score_predictor=predictor)).eval()
    port.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, port


def _jax_windowing():
    from spokennlp_tpu.configs import WindowingConfig as JaxWindowingConfig

    return JaxWindowingConfig(**WIN)


# ------------------------------------------------------------------- cos


def test_cos_inference_matches_jax():
    from spokennlp_tpu.eval.inference import run_topic_seg_inference as jax_run

    jm, params, port = _models("cos")
    docs = _docs()
    want = jax_run(jm, params, docs, _jax_windowing(), batch_size=8, threshold=0.5,
                   ts_score_predictor="cos")
    got = run_topic_seg_inference(port, docs, WCFG, batch_size=8, threshold=0.5,
                                  ts_score_predictor="cos")
    assert len(got["per_doc"]) == len(want["per_doc"]) == len(docs)
    for g, w in zip(got["per_doc"], want["per_doc"]):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert g["scores"].ndim == 1 and g["scores"].shape == w["scores"].shape
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5, rtol=0)
    assert set(got["metrics"]) == set(want["metrics"])
    for key, value in want["metrics"].items():
        assert got["metrics"][key] == pytest.approx(value), key


def test_trainer_cos_evaluate_matches_jax():
    """The trainer's cos evaluate: the same sigmoid-cos scores (within 1e-5)
    and the same window-level metrics as the JAX trainer on the same
    params."""
    from spokennlp_tpu.configs import TopicSegConfig as JaxTopicSegConfig
    from spokennlp_tpu.configs import TrainConfig as JaxTrainConfig
    from spokennlp_tpu.data.windowing import stack_windows as jax_stack
    from spokennlp_tpu.eval.inference import make_cos_predict_fn
    from spokennlp_tpu.train.trainer import TopicSegTrainer as JaxTrainer
    from spokennlp_tpu_torch.train.trainer import TopicSegTrainer

    jm, params, port = _models("cos")
    docs = _docs(1, sizes=(25, 12, 6))
    tcfg = dict(per_device_batch_size=4, checkpoint_dir=None, num_train_epochs=1.0)
    jt = JaxTrainer(jm, JaxTopicSegConfig(ts_score_predictor="cos"), JaxTrainConfig(**tcfg),
                    _jax_windowing(), train_docs=docs[:1], eval_docs=docs, params=params)
    pt = TopicSegTrainer(port, TopicSegConfig(ts_score_predictor="cos"), TrainConfig(**tcfg),
                         WCFG, train_docs=docs[:1], eval_docs=docs)
    want, got = jt.evaluate(), pt.evaluate()
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value), key

    windows = [w for i, d in enumerate(docs)
               for w in window_document(d["sent_token_ids"], d["labels"], WCFG, i)]
    batch = stack_windows(windows)
    sims = predict_cos_scores(port, batch, 4, 1.0)
    jb = {k: v[:4] for k, v in jax_stack(windows).items()}
    jsims = np.asarray(make_cos_predict_fn(jm, 1.0)(
        params, *(jb[k] for k in ("input_ids", "attention_mask", "token_type_ids",
                                  "sent_positions", "eop_mask", "labels"))))
    live = batch["eop_mask"][:4].astype(bool)
    np.testing.assert_allclose(sims[:4][live], jsims[live], atol=1e-5, rtol=0)


def test_run_inference_writes_the_cos_prediction_file(tmp_path):
    """The CLI with --ts_score_predictor cos: 1-d scores per document, and
    predictions O where the sigmoid-cos is above 0.5, as the JAX CLI writes
    them."""
    from spokennlp_tpu_torch.cli import run_inference

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(3)
    with open(data / "test.jsonl", "w") as f:
        for n in (12, 7):
            sents = [" ".join(f"w{i}" for i in rng.integers(0, 99, size=rng.integers(2, 9)))
                     for _ in range(n)]
            f.write(json.dumps({"sentences": sents, "labels": [0] * (n - 1) + [1]}) + "\n")
    out = run_inference.main([
        "--data_dir", str(data), "--output_dir", str(tmp_path / "out"), "--device", "cpu",
        "--hidden_size", "32", "--num_hidden_layers", "1", "--num_attention_heads", "2",
        "--intermediate_size", "64", "--max_seq_length", "64", "--ts_score_predictor", "cos",
        "--per_device_eval_batch_size", "4",
    ])
    lines = (tmp_path / "out" / "predict_test_max_seq64_ts_score_cos.txt").read_text().splitlines()
    assert len(lines) == 2
    for line, res in zip(lines, out["per_doc"]):
        row = json.loads(line)
        scores = np.asarray(row["predict_logits"])
        assert scores.ndim == 1 and len(scores) == len(row["int_labels"]) == len(res["labels"])
        assert row["predictions"] == ["O" if s > 0.5 else "B-EOP" for s in scores]


# ----------------------------------------------------------------- flash


def test_flash_on_the_cpu_is_the_einsum_path_and_matches_jax():
    from spokennlp_tpu.eval.inference import make_predict_fn as jax_make, predict_windows as jax_pw

    jm, params, port = _models(impl="flash")
    cfg = port.enc_cfg
    assert resolve_attention_impl(cfg, torch.device("cpu"), False) == "einsum"
    assert resolve_attention_impl(cfg, torch.device("cpu"), False, training=True) == "einsum"
    docs = _docs()
    batch = window_documents_stacked(docs, WCFG)
    got = predict_windows(make_predict_fn(port), batch, 8)
    want = jax_pw(jax_make(jm, params), batch, 8)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    _, _, einsum = _models(impl="einsum")
    np.testing.assert_array_equal(got, predict_windows(make_predict_fn(einsum), batch, 8))


def test_flash_resolves_to_the_port_kernels_on_cuda():
    """No card needed: the resolution alone. Inference takes kernel 6
    ("pallas"), training the training kernels; a shape outside the flash
    contract raises and names the einsum path; sparse trunks and
    output_attentions take the einsum path, as in JAX."""
    cuda = torch.device("cuda")
    cfg = EncoderConfig(**ENC, attention_impl="flash")
    assert resolve_attention_impl(cfg, cuda, False, seq_len=512) == "pallas"
    assert resolve_attention_impl(cfg, cuda, False, training=True, seq_len=512) == "train_fused"
    assert resolve_attention_impl(cfg, cuda, True, seq_len=512) == "einsum"
    for bad_len in (100, 640):
        with pytest.raises(ValueError, match="attention_impl='einsum'"):
            resolve_attention_impl(cfg, cuda, False, seq_len=bad_len)
    odd = dataclasses.replace(cfg, hidden_size=60, num_heads=5)  # head_dim 12
    with pytest.raises(ValueError, match="head_dim 12"):
        resolve_attention_impl(odd, cuda, False, seq_len=512)
    sliding = dataclasses.replace(cfg, attention_type="sliding_window", attention_window=64)
    assert resolve_attention_impl(sliding, cuda, False, seq_len=512, prefix_globals=1,
                                  has_global_mask=True) == "bias"


# ---------------------------------------------------------------- packed


def _windows(docs, jax=False):
    if jax:
        from spokennlp_tpu.data.windowing import window_document as jax_window

        wcfg, fn = _jax_windowing(), jax_window
    else:
        wcfg, fn = WCFG, window_document
    return [w for i, d in enumerate(docs) for w in fn(d["sent_token_ids"], d["labels"], wcfg, i)]


def test_packing_matches_jax():
    from spokennlp_tpu.eval import packed_inference as jax_packed

    docs = _docs()
    lengths = [int(w.attention_mask.sum()) for w in _windows(docs)]
    for max_len in (L, 64, 200):
        got = packed.pack_windows(lengths, max_len)
        want = jax_packed.pack_windows(lengths, max_len)
        assert [dataclasses.asdict(g) for g in got] == [dataclasses.asdict(w) for w in want]
    got, got_plan = packed.build_packed_batch(_windows(docs), L)
    want, want_plan = jax_packed.build_packed_batch(_windows(docs, jax=True), L)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert [dataclasses.asdict(g) for g in got_plan] == [dataclasses.asdict(w)
                                                           for w in want_plan]
    assert len(got_plan) < len(lengths) and max(len(p.window_indices) for p in got_plan) >= 2


def test_predict_windows_packed_matches_jax_and_the_unpacked_logits():
    from spokennlp_tpu.eval import packed_inference as jax_packed

    jm, params, port = _models()
    docs = _docs()
    windows = _windows(docs)
    got = packed.predict_windows_packed(port, windows, L, batch_size=4)
    want = jax_packed.predict_windows_packed(jm, params, _windows(docs, jax=True), L,
                                             batch_size=4)
    assert got.shape == want.shape == (len(windows), L, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    batch = stack_windows(windows)
    unpacked = predict_windows(make_predict_fn(port), batch, 4)
    real = batch["attention_mask"].astype(bool)
    np.testing.assert_allclose(got[real], unpacked[real], atol=1e-5, rtol=0)
    assert not got[~real].any()


# ------------------------------------------------------------- streaming


def test_streaming_matches_jax_and_the_batch_engine():
    """Per-document scores: JAX's within one bf16 step (both fetch bf16),
    the port's batch engine at the same batch bit for bit; the same metrics;
    the timing buckets add up to the total within 5 %; raw documents with a
    tokenize_fn give the same result."""
    from spokennlp_tpu.eval.streaming import stream_topic_seg_inference as jax_stream

    jm, params, port = _models()
    docs = _docs()
    kw = dict(batch_size=4, chunk_batches=2, sent_k=32, docs_per_group=3)
    want = jax_stream(jm, params, docs, _jax_windowing(), **kw)
    got = stream_topic_seg_inference(port, docs, WCFG, **kw)
    batch = run_topic_seg_inference(port, docs, WCFG, batch_size=4, threshold=0.5)
    assert len(got["per_doc"]) == len(want["per_doc"]) == len(batch["per_doc"]) == len(docs)
    for g, w, b in zip(got["per_doc"], want["per_doc"], batch["per_doc"]):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["labels"], b["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=2**-7, rtol=2**-7)
        np.testing.assert_array_equal(g["scores"], b["scores"])
    assert got["metrics"] == batch["metrics"]
    for key, value in want["metrics"].items():
        assert got["metrics"][key] == pytest.approx(value), key
    timing = got["timing"]
    assert set(timing) == set(want["timing"])
    assert timing["windows"] == want["timing"]["windows"] == batch["num_windows"]
    assert sum(timing[k] for k in STREAM_KEYS) == pytest.approx(timing["total"], rel=0.05)

    raw = [{"sentences": [" ".join(map(str, s)) for s in d["sent_token_ids"]],
            "labels": d["labels"]} for d in docs]
    tokenize = lambda sents: [[int(t) for t in s.split()] for s in sents]
    again = stream_topic_seg_inference(port, raw, WCFG, tokenize_fn=tokenize, **kw)
    for g, a in zip(got["per_doc"], again["per_doc"]):
        np.testing.assert_array_equal(g["scores"], a["scores"])


def test_streaming_raises_only_when_sentences_are_cut():
    """A window of exactly sent_k sentences streams; one of sent_k + 1
    raises (the JAX module raises on both)."""
    _, _, port = _models()
    one = lambda n: [{"sent_token_ids": [[7, 8]] * n, "labels": [1] * n}]
    out = stream_topic_seg_inference(port, one(4), WCFG, batch_size=2, sent_k=4)
    assert len(out["per_doc"][0]["labels"]) == 3  # the window's last label is masked
    with pytest.raises(ValueError, match="more than sent_k=4"):
        stream_topic_seg_inference(port, one(5), WCFG, batch_size=2, sent_k=4)


# ---------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_model(impl, dtype=torch.bfloat16, predictor="lt", quantize="none"):
    """A serving-width model (BERT-base widths, 2 layers) on the card, its
    weights drawn on the CPU from one seed."""
    enc = EncoderConfig(vocab_size=512, hidden_size=768, num_layers=2, num_heads=12,
                        intermediate_size=3072, max_position_embeddings=512, add_pooler=False,
                        attention_impl=impl, quantize=quantize)
    model = TopicSegModel(enc, TopicSegConfig(ts_score_predictor=predictor), dtype=dtype,
                          generator=torch.Generator().manual_seed(0))
    return model.cuda().eval()


def _card_docs():
    return _docs(5, sizes=(60, 45, 3, 5, 2, 4, 6, 3, 2, 8))


def _agreement(a, b):
    return float((a.argmax(-1) == b.argmax(-1)).mean())


@pytest.mark.gpu
def test_flash_runs_kernel_6_on_card(cuda):
    from spokennlp_tpu_torch.ops.cuda.blhd_attention import snld_self_attention

    wcfg = WindowingConfig(max_seq_length=512, cls_token_id=2, pad_token_id=0, bos_token_id=1)
    batch = window_documents_stacked(_card_docs(), wcfg)
    n = snld_self_attention.launches
    got = predict_windows_scanned(_card_model("flash"), batch, 8, gather_sents=True)
    assert snld_self_attention.launches - n == 2 * -(-len(batch["input_ids"]) // 8)
    want = predict_windows_scanned(_card_model("einsum"), batch, 8, gather_sents=True)
    live = batch["sent_labels"] != -100
    assert _agreement(got[live], want[live]) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("impl,batch_size", [("auto", 8), ("auto", 40), ("einsum", 8)],
                         ids=["stack", "blocks", "einsum"])
def test_packed_rows_on_card_match_the_unpacked_engine(cuda, impl, batch_size):
    """Packed rows (several windows a row) through kernel 3 (batch <= 32),
    kernels 1 + 2 (above) or the einsum path, in float32, against the
    unpacked windows on the same path."""
    wcfg = WindowingConfig(max_seq_length=512, cls_token_id=2, pad_token_id=0, bos_token_id=1)
    docs = _card_docs()
    windows = [w for i, d in enumerate(docs)
               for w in window_document(d["sent_token_ids"], d["labels"], wcfg, i)]
    model = _card_model(impl, dtype=torch.float32)
    got = packed.predict_windows_packed(model, windows, 512, batch_size=batch_size)
    batch = stack_windows(windows)
    want = predict_windows(make_predict_fn(model), batch, batch_size)
    real = batch["attention_mask"].astype(bool)
    assert np.abs(got[real] - want[real]).max() <= 1e-3 * np.abs(want[real]).max()


@pytest.mark.gpu
def test_streaming_on_card_equals_the_batch_engine(cuda):
    wcfg = WindowingConfig(max_seq_length=512, cls_token_id=2, pad_token_id=0, bos_token_id=1)
    docs = _card_docs()
    model = _card_model("auto")
    got = stream_topic_seg_inference(model, docs, wcfg, batch_size=4, chunk_batches=2,
                                     docs_per_group=3)
    want = run_topic_seg_inference(model, docs, wcfg, batch_size=4, threshold=0.5)
    for g, w in zip(got["per_doc"], want["per_doc"]):
        np.testing.assert_array_equal(g["scores"], w["scores"])
    assert got["metrics"] == want["metrics"]


@pytest.mark.gpu
def test_cos_on_card_matches_the_cpu(cuda):
    """The cos scores of the kernel path (the stack kernel at batch 8, bf16)
    against the einsum path in float32 on the CPU."""
    wcfg = WindowingConfig(max_seq_length=512, cls_token_id=2, pad_token_id=0, bos_token_id=1)
    batch = window_documents_stacked(_card_docs(), wcfg)
    got = predict_cos_scores(_card_model("auto", predictor="cos"), batch, 8, 1.0)
    cpu = _card_model("einsum", dtype=torch.float32, predictor="cos").cpu()
    want = predict_cos_scores(cpu, batch, 8, 1.0)
    live = batch["eop_mask"].astype(bool)
    assert np.abs(got[live] - want[live]).max() < 2e-2
    assert float(((got[live] > 0.5) == (want[live] > 0.5)).mean()) >= 0.99
