"""Port inference engine and CLI against the JAX engine, and the port's
isolation from JAX. JAX is imported inside the tests only (see
tests/test_torch_kernels.py)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spokennlp_tpu.configs import EncoderConfig, TopicSegConfig, WindowingConfig
from spokennlp_tpu_torch.cli import run_inference
from spokennlp_tpu_torch.eval.inference import predict_windows_scanned, run_topic_seg_inference
from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = EncoderConfig(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2,
                    intermediate_size=256, max_position_embeddings=128, add_pooler=False)
WCFG = WindowingConfig(max_seq_length=128, cls_token_id=2, pad_token_id=0, bos_token_id=1)
TASK = TopicSegConfig()


def _docs(seed=0, sizes=(20, 30, 15)):
    rng = np.random.default_rng(seed)
    return [
        {"sent_token_ids": [rng.integers(10, 1000, size=rng.integers(3, 12)).tolist()
                            for _ in range(n)],
         "labels": rng.integers(0, 2, size=n).tolist()}
        for n in sizes
    ]


def _models():
    """The JAX model with its params, and the port carrying the same weights."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel

    jm = JaxTopicSegModel(ENC, TASK)
    L = WCFG.max_seq_length
    params = jm.init(
        jax.random.PRNGKey(0), jnp.ones((2, L), jnp.int32),
        attention_mask=jnp.ones((2, L), jnp.int32), sent_positions=jnp.zeros((2, 3), jnp.int32),
    )["params"]
    port = TopicSegModel(ENC, TASK).eval()
    port.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, port


def test_run_topic_seg_inference_matches_jax():
    from spokennlp_tpu.eval.inference import run_topic_seg_inference as jax_run

    jm, params, port = _models()
    docs = _docs()
    want = jax_run(jm, params, docs, WCFG, batch_size=8, threshold=0.5)
    got = run_topic_seg_inference(port, docs, WCFG, batch_size=8, threshold=0.5)
    assert len(got["per_doc"]) == len(want["per_doc"]) == len(docs)
    for g, w in zip(got["per_doc"], want["per_doc"]):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        # both engines fetch bfloat16 logits: one bf16 step apart at most
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-2, rtol=1e-2)
    assert set(got["metrics"]) == set(want["metrics"])
    assert any(k.endswith("_pk") for k in got["metrics"])
    for key, value in want["metrics"].items():
        assert got["metrics"][key] == pytest.approx(value), key


def test_run_topic_seg_inference_w8a8_matches_jax():
    """The serving configuration (W8A8, bf16 softmax) on the stack path, JAX
    in interpret mode and the port's plain versions: the same integer
    arithmetic up to the rare int8 step a sum order moves (see
    tests/test_torch_encoder.py), well inside the bf16 fetch's tolerance
    here; the predictions and Pk/WD/F1 agree."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.eval.inference import run_topic_seg_inference as jax_run
    from spokennlp_tpu.models.topic_seg import TopicSegModel as JaxTopicSegModel

    enc = dataclasses.replace(ENC, quantize="w8a8", attention_impl="stack",
                              softmax_in_compute_dtype=True)
    jm = JaxTopicSegModel(enc, TASK)
    L = WCFG.max_seq_length
    params = jm.init(jax.random.PRNGKey(3), jnp.ones((2, L), jnp.int32),
                     attention_mask=jnp.ones((2, L), jnp.int32),
                     sent_positions=jnp.zeros((2, 3), jnp.int32))["params"]
    port = TopicSegModel(enc, TASK).eval()
    port.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    docs = _docs(2, sizes=(25, 18))
    want = jax_run(jm, params, docs, WCFG, batch_size=4, threshold=0.5)
    got = run_topic_seg_inference(port, docs, WCFG, batch_size=4, threshold=0.5)
    for g, w in zip(got["per_doc"], want["per_doc"]):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=2e-2, rtol=2e-2)
        np.testing.assert_array_equal(np.argmax(g["scores"], -1), np.argmax(w["scores"], -1))
    assert any(k.endswith("_pk") for k in got["metrics"])
    for key, value in want["metrics"].items():
        assert got["metrics"][key] == pytest.approx(value), key


def test_predict_windows_pads_the_tail_batch():
    port = TopicSegModel(ENC, TASK, generator=torch.Generator().manual_seed(0)).eval()
    from spokennlp_tpu.data.windowing_fast import window_documents_stacked

    batch = window_documents_stacked(_docs(1), WCFG)
    n = batch["input_ids"].shape[0]
    assert n % 4, "the corpus must leave a partial tail batch"
    full = predict_windows_scanned(port, batch, batch_size=4, gather_sents=True)
    one = predict_windows_scanned(port, batch, batch_size=1, gather_sents=True)
    assert full.shape == (n, batch["sent_positions"].shape[1], TASK.num_labels)
    np.testing.assert_allclose(full, one, atol=1e-2, rtol=1e-2)


def test_cos_predictor_not_ported():
    """The cos predictor is ported (tests/test_torch_serving_paths.py holds
    it against JAX): it gives one score a labelled sentence; a predictor
    that is neither lt nor cos raises."""
    port = TopicSegModel(ENC, TASK).eval()
    out = run_topic_seg_inference(port, _docs(), WCFG, ts_score_predictor="cos")
    for doc in out["per_doc"]:
        assert doc["scores"].shape == doc["labels"].shape
    with pytest.raises(ValueError):
        run_topic_seg_inference(port, _docs(), WCFG, ts_score_predictor="both")


def _write_corpus(root, n_test=3, seed=0):
    """A wiki_section corpus in the layout of tests/test_cli_and_analysis.py."""
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "topic", "sentence"]
    d = root / "wiki_section"
    d.mkdir()
    for split, n in (("train.jsonl", 2), ("dev.jsonl", 2), ("test.jsonl", n_test)):
        with open(d / split, "w") as f:
            for _ in range(n):
                ns = int(rng.integers(5, 12))
                sents = [" ".join(rng.choice(words, size=rng.integers(3, 6))) for _ in range(ns)]
                labels = [int(rng.random() < 0.3) for _ in range(ns)]
                labels[-1] = 1
                f.write(json.dumps({"sentences": sents, "labels": labels}) + "\n")
    return str(d)


def test_cli_run_inference_on_cpu(tmp_path):
    data = _write_corpus(tmp_path)
    out_dir = tmp_path / "out"
    out = run_inference.main([
        "--data_dir", data, "--output_dir", str(out_dir), "--device", "cpu",
        "--hidden_size", "32", "--num_hidden_layers", "1", "--num_attention_heads", "2",
        "--intermediate_size", "64", "--max_seq_length", "64", "--threshold", "0.5",
        "--per_device_eval_batch_size", "2",
    ])
    assert np.isfinite(list(out["metrics"].values())).all()
    stem = out_dir / "predict_test_max_seq64_ts_score_lt"
    lines = stem.with_suffix(".txt").read_text().splitlines()
    assert len(lines) == 3
    assert {"labels", "predictions", "predict_logits"} <= set(json.loads(lines[0]))
    saved = json.loads((out_dir / (stem.name + "_results.json")).read_text())
    assert saved == pytest.approx(out["metrics"])


def test_cli_device_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    data = _write_corpus(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_inference.main(["--data_dir", data, "--output_dir", str(tmp_path / "o"),
                            "--device", "cuda"])


def test_port_imports_neither_jax_nor_flax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import spokennlp_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 14, names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
