"""Checkpoints on the port: HF directories (bert, longformer, electra,
big_bird; safetensors and pytorch_model.bin) read without transformers,
models/hf_convert.py and models/hf_export.py against the JAX package's,
native and HF round trips through both CLIs, the safetensors reader and
writer against the safetensors package, the tokenizer of a checkpoint
directory, and the directories that must raise. HF models are built at
random inside the tests; nothing is downloaded. JAX is imported inside the
tests only."""

import argparse
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.cli import common, hf_checkpoint
from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig
from spokennlp_tpu_torch.models import checkpoint_io, hf_convert, hf_export
from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
from spokennlp_tpu_torch.models.encoder import Encoder
from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

transformers = pytest.importorskip("transformers")


def _args(path, impl="auto"):
    return argparse.Namespace(model_name_or_path=str(path), attention_impl=impl)


def _flags(impl="auto"):
    return EncoderConfig(attention_impl=impl)


# ----------------------------------------------------- HF directories


def _hf_model(kind):
    """(a random transformers model, sequence length, global mask or None)."""
    small = dict(vocab_size=300, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64)
    torch.manual_seed(0)
    if kind == "bert":
        return transformers.BertModel(transformers.BertConfig(**small)), 24, None
    if kind == "electra":
        cfg = transformers.ElectraConfig(**small, embedding_size=16)
        return transformers.ElectraModel(cfg), 24, None
    if kind == "longformer":
        cfg = transformers.LongformerConfig(**small, max_position_embeddings=80,
                                            type_vocab_size=1, attention_window=[8, 8])
        return transformers.LongformerModel(cfg), 32, True
    # BigBird at 4 blocks: its block-sparse pattern covers every key (HF runs
    # full attention below (5 + 2 r) blocks)
    cfg = transformers.BigBirdConfig(**small, max_position_embeddings=128, block_size=16,
                                     num_random_blocks=2, attention_type="original_full")
    return transformers.BigBirdModel(cfg), 64, None


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
@pytest.mark.parametrize("kind", ["bert", "longformer", "electra", "big_bird"])
def test_hf_directory_loads_and_matches_the_hf_model(tmp_path, kind, safe):
    hf, L, glob = _hf_model(kind)
    hf.eval().save_pretrained(tmp_path, safe_serialization=safe)
    assert (tmp_path / ("model.safetensors" if safe else "pytorch_model.bin")).exists()
    cfg, params = common.maybe_load_pretrained(_args(tmp_path), _flags())
    assert cfg.attention_type == {"longformer": "sliding_window",
                                  "big_bird": "bigbird"}.get(kind, "dense")
    enc = Encoder(cfg).eval()
    enc.load_state_dict(jax_params_to_state_dict(params), strict=True)

    rng = np.random.default_rng(0)
    ids = rng.integers(5, 299, size=(2, L))
    mask = np.ones((2, L), np.int64)
    mask[1, L - 5:] = 0
    ids[1, L - 5:] = hf.config.pad_token_id
    kw = {}
    if glob:
        g = np.zeros((2, L), np.int64)
        g[:, 0] = 1
        kw["global_attention_mask"] = torch.tensor(g)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask), **kw)
        got = enc(torch.tensor(ids), attention_mask=torch.tensor(mask, dtype=torch.int32),
                  **{k: v.int() for k, v in kw.items()})
    real = mask.astype(bool)
    np.testing.assert_allclose(got.last_hidden_state.numpy()[real],
                               want.last_hidden_state.numpy()[real], atol=1e-5, rtol=1e-5)


def test_a_bfloat16_safetensors_directory_loads_widened(tmp_path):
    hf, _, _ = _hf_model("bert")
    hf.to(torch.bfloat16).save_pretrained(tmp_path)
    _, params = common.maybe_load_pretrained(_args(tmp_path), _flags())
    emb = params["embeddings"]["word_embeddings"]["embedding"]
    assert emb.dtype == np.float32
    want = hf.embeddings.word_embeddings.weight.detach().float().numpy()
    np.testing.assert_array_equal(emb, want)


def test_config_defaults_match_transformers():
    """Every default written out in the port is the transformers class's."""
    classes = {"bert": transformers.BertConfig, "longformer": transformers.LongformerConfig,
               "electra": transformers.ElectraConfig, "big_bird": transformers.BigBirdConfig}
    for model_type, defaults in hf_checkpoint.HF_CONFIG_DEFAULTS.items():
        cfg = classes[model_type]()
        for key, value in defaults.items():
            assert getattr(cfg, key) == value, (model_type, key)


def test_a_minimal_config_json_reads_with_the_class_defaults(tmp_path):
    """A config.json holding only model_type reads as the class defaults,
    as transformers reads it."""
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "electra"}))
    got = hf_checkpoint.read_hf_config(str(tmp_path))
    want = transformers.AutoConfig.from_pretrained(tmp_path)
    for key in hf_checkpoint.HF_CONFIG_DEFAULTS["electra"]:
        assert getattr(got, key) == getattr(want, key), key


# ------------------------------------------------ the JAX package's copies


def _random_sd(keys_shapes, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in keys_shapes}


def _bert_keys(prefix, H, I, layers, vocab=50, pos=20, globals_=False, project=None):
    E = project or H
    out = [(f"{prefix}embeddings.word_embeddings.weight", (vocab, E)),
           (f"{prefix}embeddings.position_embeddings.weight", (pos, E)),
           (f"{prefix}embeddings.token_type_embeddings.weight", (2, E)),
           (f"{prefix}embeddings.LayerNorm.weight", (E,)),
           (f"{prefix}embeddings.LayerNorm.bias", (E,))]
    if project:
        out += [(f"{prefix}embeddings_project.weight", (H, E)),
                (f"{prefix}embeddings_project.bias", (H,))]
    names = ["query", "key", "value"] + (["query_global", "key_global", "value_global"]
                                         if globals_ else [])
    for i in range(layers):
        lp = f"{prefix}encoder.layer.{i}."
        for n in names:
            out += [(lp + f"attention.self.{n}.weight", (H, H)),
                    (lp + f"attention.self.{n}.bias", (H,))]
        out += [(lp + "attention.output.dense.weight", (H, H)),
                (lp + "attention.output.dense.bias", (H,)),
                (lp + "attention.output.LayerNorm.weight", (H,)),
                (lp + "attention.output.LayerNorm.bias", (H,)),
                (lp + "intermediate.dense.weight", (I, H)), (lp + "intermediate.dense.bias", (I,)),
                (lp + "output.dense.weight", (H, I)), (lp + "output.dense.bias", (H,)),
                (lp + "output.LayerNorm.weight", (H,)), (lp + "output.LayerNorm.bias", (H,))]
    out += [(f"{prefix}pooler.dense.weight", (H, H)), (f"{prefix}pooler.dense.bias", (H,))]
    return out


def _ponet_keys(prefix, H, I, layers):
    out = [k for k in _bert_keys(prefix, H, I, layers) if "attention.self" not in k[0]]
    for i in range(layers):
        for n in ("dense_q", "dense_k", "dense_o", "dense_segment", "dense_local"):
            lp = f"{prefix}encoder.layer.{i}.attention.self.{n}."
            out += [(lp + "weight", (H, H)), (lp + "bias", (H,))]
    return out


def _palm_keys(H, I, enc_layers, dec_layers):
    out = _bert_keys("palm.encoder.", H, I, enc_layers)
    out += [("palm.decoder.embeddings.weight", (50, H)), ("palm.decoder.layer_norm.weight", (H,)),
            ("palm.decoder.layer_norm.bias", (H,)),
            ("generator.linear.weight", (50, H)), ("generator.linear.bias", (50,)),
            ("generator.linear_copy.weight", (1, H)), ("generator.linear_copy.bias", (1,))]
    for i in range(dec_layers):
        lp = f"palm.decoder.transformer_layers.{i}."
        for attn in ("self_attn", "context_attn"):
            for n in ("linear_query", "linear_keys", "linear_values", "final_linear"):
                out += [(lp + f"{attn}.{n}.weight", (H, H)), (lp + f"{attn}.{n}.bias", (H,))]
        for n in ("layer_norm_1", "layer_norm_2", "feed_forward.layer_norm"):
            out += [(lp + n + ".weight", (H,)), (lp + n + ".bias", (H,))]
        out += [(lp + "feed_forward.w_1.weight", (I, H)), (lp + "feed_forward.w_1.bias", (I,)),
                (lp + "feed_forward.w_2.weight", (H, I)), (lp + "feed_forward.w_2.bias", (H,))]
    return out


def _same_tree(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def _hf_cfg(**kw):
    base = {**hf_checkpoint.HF_CONFIG_DEFAULTS["bert"], "vocab_size": 50, "hidden_size": 8,
            "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 16,
            "max_position_embeddings": 20}
    return types.SimpleNamespace(**{**base, **kw})


def test_hf_convert_matches_jax():
    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig
    from spokennlp_tpu.models import hf_convert as jax_convert

    H, I = 8, 16
    cases = [
        ("bert_to_encoder_params", _bert_keys("", H, I, 2), {}),
        ("longformer_to_encoder_params", _bert_keys("", H, I, 2, globals_=True), {}),
        ("electra_to_encoder_params", _bert_keys("e.", H, I, 2, project=4),
         {"prefix": "e.", "embedding_size": 4}),
        ("bert_pretraining_to_params", _bert_keys("bert.", H, I, 2) + [
            ("cls.predictions.transform.dense.weight", (H, H)),
            ("cls.predictions.transform.dense.bias", (H,)),
            ("cls.predictions.transform.LayerNorm.weight", (H,)),
            ("cls.predictions.transform.LayerNorm.bias", (H,)), ("cls.predictions.bias", (50,)),
            ("cls.seq_relationship.weight", (2, H)), ("cls.seq_relationship.bias", (2,))], {}),
        ("ponet_to_encoder_params", _ponet_keys("ponet.", H, I, 2), {}),
    ]
    for name, keys, extra in cases:
        sd = _random_sd(keys)
        cfg_kw = dict(vocab_size=50, hidden_size=H, num_layers=2, num_heads=2,
                      intermediate_size=I, max_position_embeddings=20)
        if "embedding_size" in extra:
            cfg_kw["embedding_size"] = extra["embedding_size"]
        kw = {"prefix": extra["prefix"]} if "prefix" in extra else {}
        got = getattr(hf_convert, name)(sd, EncoderConfig(**cfg_kw), **kw)
        want = getattr(jax_convert, name)(sd, JaxEncoderConfig(**cfg_kw), **kw)
        _same_tree(got, want, name)
    sd = _random_sd(_palm_keys(H, I, 2, 2))
    cfg_kw = dict(vocab_size=50, hidden_size=H, num_layers=2, num_heads=2, intermediate_size=I,
                  max_position_embeddings=20)
    _same_tree(hf_convert.palm_to_params(sd, EncoderConfig(**cfg_kw), 2),
               jax_convert.palm_to_params(sd, JaxEncoderConfig(**cfg_kw), 2), "palm")
    table = {"embeddings": {"position_embeddings": {"embedding": np.arange(24.0).reshape(12, 2)}}}
    _same_tree(hf_convert.extend_position_embeddings(table, 30, num_special=2),
               jax_convert.extend_position_embeddings(table, 30, num_special=2), "extend")
    for fn, cfg in (("hf_bert_config_to_encoder_config", _hf_cfg()),
                    ("hf_electra_config_to_encoder_config", _hf_cfg(embedding_size=4)),
                    ("hf_longformer_config_to_encoder_config",
                     _hf_cfg(attention_window=[8, 16], pad_token_id=None)),
                    ("ponet_config_to_encoder_config", {**vars(_hf_cfg()), "local_window_size": 5})):
        got, want = getattr(hf_convert, fn)(cfg), getattr(jax_convert, fn)(cfg)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), fn
    assert hf_convert.torch_state_dict_to_numpy(
        {"a": torch.ones(2, dtype=torch.bfloat16)})["a"].dtype == np.float32


def test_hf_export_matches_jax(tmp_path):
    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig
    from spokennlp_tpu.models import hf_export as jax_export

    H, I = 8, 16
    kw = dict(vocab_size=50, hidden_size=H, num_layers=2, num_heads=2, intermediate_size=I,
              max_position_embeddings=20)
    for attention, keys in (("dense", _bert_keys("", H, I, 2)),
                            ("sliding_window", _bert_keys("", H, I, 2, globals_=True)),
                            ("bigbird", _bert_keys("", H, I, 2))):
        cfg, jcfg = EncoderConfig(**kw, attention_type=attention), JaxEncoderConfig(
            **kw, attention_type=attention)
        trunk = hf_convert.bert_to_encoder_params(_random_sd(keys), cfg)
        task = {"encoder": trunk,
                "classifier": {"kernel": np.ones((H, 2), np.float32), "bias": np.zeros(2)}}
        for params in (trunk, task):
            _same_tree(hf_export.task_params_to_sd(params, cfg),
                       jax_export.task_params_to_sd(params, jcfg), attention)
        assert hf_export.encoder_config_to_hf_dict(cfg) == jax_export.encoder_config_to_hf_dict(jcfg)
        got = hf_export.save_hf_checkpoint(str(tmp_path / attention / "port"), task, cfg)
        want = jax_export.save_hf_checkpoint(str(tmp_path / attention / "jax"), task, jcfg)
        assert open(os.path.join(got, "config.json")).read() == \
            open(os.path.join(want, "config.json")).read()
        a = torch.load(os.path.join(got, "pytorch_model.bin"), weights_only=True)
        b = torch.load(os.path.join(want, "pytorch_model.bin"), weights_only=True)
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    ponet = hf_convert.ponet_to_encoder_params(_random_sd(_ponet_keys("ponet.", H, I, 2)),
                                               EncoderConfig(**kw))
    _same_tree(hf_export.encoder_params_to_ponet_sd(ponet, EncoderConfig(**kw)),
               jax_export.encoder_params_to_ponet_sd(ponet, JaxEncoderConfig(**kw)), "ponet")
    palm = hf_convert.palm_to_params(_random_sd(_palm_keys(H, I, 2, 2)), EncoderConfig(**kw), 2)
    _same_tree(hf_export.palm_params_to_sd(palm, EncoderConfig(**kw)),
               jax_export.palm_params_to_sd(palm, JaxEncoderConfig(**kw)), "palm")


# ------------------------------------------------------------ round trips


SMALL = dict(vocab_size=300, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
             max_position_embeddings=64)


@pytest.mark.parametrize("attention", ["dense", "sliding_window", "bigbird"])
def test_export_then_load_gives_back_the_params(tmp_path, attention):
    """A task model through save_hf_checkpoint, then maybe_load_pretrained
    into a model of another seed: every parameter comes back, the heads
    included (the HF config carries no pooler flag: the loader drops the
    pooler the directory lacks)."""
    extra = {"sliding_window": dict(attention_window=16, position_style="roberta", pad_token_id=1),
             "bigbird": dict(bigbird_block_size=16)}.get(attention, {})
    cfg = EncoderConfig(**SMALL, attention_type=attention, add_pooler=False, **extra)
    model = TopicSegModel(cfg, TopicSegConfig(), generator=torch.Generator().manual_seed(1))
    params = checkpoint_io.params_from_state_dict(model.state_dict())
    hf_export.save_hf_checkpoint(str(tmp_path), params, cfg)
    loaded_cfg, tree = common.maybe_load_pretrained(_args(tmp_path), _flags())
    assert set(tree) == {"encoder", "classifier", "tssp_classifier"}
    assert loaded_cfg.attention_type == attention and not loaded_cfg.add_pooler
    other = TopicSegModel(loaded_cfg, TopicSegConfig(), generator=torch.Generator().manual_seed(2))
    common.load_pretrained_into(other, tree)
    want, got = model.state_dict(), other.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _corpus(root):
    rng = np.random.default_rng(0)
    d = root / "data"
    d.mkdir()
    for split, n in (("train.jsonl", 3), ("dev.jsonl", 1), ("test.jsonl", 3)):
        with open(d / split, "w") as f:
            for _ in range(n):
                ns = int(rng.integers(6, 20))
                sents = [" ".join(f"w{i}" for i in rng.integers(0, 60, size=rng.integers(2, 9)))
                         for _ in range(ns)]
                labels = [int(rng.random() < 0.2) for _ in range(ns)]
                labels[-1] = 1
                f.write(json.dumps({"sentences": sents, "labels": labels}) + "\n")
    return str(d)


def test_both_clis_load_native_and_hf_checkpoints(tmp_path):
    """run_finetune --save_hf_format writes final_model (native) and
    final_model_hf; run_inference and run_finetune load either through
    --model_name_or_path, the native one into the JAX package too; the two
    give the same scores."""
    from spokennlp_tpu_torch.cli import run_finetune, run_inference

    data = _corpus(tmp_path)
    model_flags = ["--device", "cpu", "--hidden_size", "32", "--num_hidden_layers", "2",
                   "--num_attention_heads", "2", "--intermediate_size", "64",
                   "--max_seq_length", "64", "--per_device_eval_batch_size", "4"]
    out = tmp_path / "train"
    run_finetune.main(["--data_dir", data, "--output_dir", str(out), "--do_train",
                       "--num_train_epochs", "1", "--per_device_train_batch_size", "4",
                       "--gradient_accumulation_steps", "1", "--save_hf_format"] + model_flags)
    assert {"params.msgpack", "config.json", "model.pt"} <= set(os.listdir(out / "final_model"))
    assert {"pytorch_model.bin", "config.json"} <= set(os.listdir(out / "final_model_hf"))
    state = torch.load(out / "final_model" / "model.pt", weights_only=True)
    runs = {}
    for name in ("final_model", "final_model_hf"):
        path = str(out / name)
        runs[name] = run_inference.main(["--data_dir", data, "--output_dir",
                                         str(tmp_path / f"infer_{name}"),
                                         "--model_name_or_path", path] + model_flags)
        _, tree = common.maybe_load_pretrained(_args(path), _flags())
        loaded = jax_params_to_state_dict(tree)
        for k, v in loaded.items():
            assert torch.equal(v, state[k]), (name, k)
    for a, b in zip(runs["final_model"]["per_doc"], runs["final_model_hf"]["per_doc"]):
        np.testing.assert_array_equal(a["scores"], b["scores"])

    # the native checkpoint is the JAX package's format
    from spokennlp_tpu.models import checkpoint_io as jax_io

    params, cfg = jax_io.load_checkpoint(str(out / "final_model"))
    assert cfg.hidden_size == 32
    _same_tree(checkpoint_io.params_from_state_dict(state), params, "native")

    # and training starts from a checkpoint as well
    again = run_finetune.main(["--data_dir", data, "--output_dir", str(tmp_path / "again"),
                               "--model_name_or_path", str(out / "final_model_hf"),
                               "--do_predict"] + model_flags)
    assert set(again) == {f"predict_{k}" for k in runs["final_model"]["metrics"]}


def test_resize_word_embeddings_matches_jax():
    from spokennlp_tpu.cli import common as jax_common
    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig

    emb = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32)
    for tree in ({"embeddings": {"word_embeddings": {"embedding": emb}}},
                 {"encoder": {"embeddings": {"word_embeddings": {"embedding": emb}}}}):
        for new in (8, 10, 13):
            got, gcfg = common.resize_word_embeddings(tree, EncoderConfig(vocab_size=7), new, 3)
            want, wcfg = jax_common.resize_word_embeddings(tree, JaxEncoderConfig(vocab_size=7),
                                                           new, 3)
            _same_tree(got, want)
            assert gcfg.vocab_size == wcfg.vocab_size


def test_tokenizer_of_a_checkpoint_directory_matches_jax(tmp_path):
    """A directory holding a BERT tokenizer: the same ids and special ids as
    the JAX package's AutoTokenizer path, [BOS] added past the vocabulary."""
    from spokennlp_tpu.cli import common as jax_common

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(40)] + [
        "hello", "world", "##s", ",", "!"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    transformers.BertTokenizer(vocab_file=str(tmp_path / "vocab.txt")).save_pretrained(tmp_path)
    args = argparse.Namespace(model_name_or_path=str(tmp_path), vocab_file=None)
    tok, special = common.resolve_tokenizer(args)
    jtok, jspecial = jax_common.resolve_tokenizer(args)
    assert special == jspecial and special["bos"] == len(vocab)
    for text in ("Hello worlds!", "w1 w2 , w39 unknownword", ""):
        assert tok(text) == jtok(text), text


# ------------------------------------------------------------ safetensors


def test_safetensors_reader_and_writer_match_safetensors(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g), "bf16": torch.randn(7, generator=g).bfloat16(),
        "f16": torch.randn(2, 2, 2, generator=g).half(), "f64": torch.randn(4).double(),
        "i64": torch.arange(6).reshape(2, 3), "i8": torch.tensor([-3, 4], dtype=torch.int8),
        "u8": torch.tensor([1, 255], dtype=torch.uint8), "flag": torch.tensor([True, False]),
        "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3),
    }
    save_file(tensors, str(tmp_path / "lib.safetensors"), metadata={"format": "pt"})
    hf_checkpoint.write_safetensors(str(tmp_path / "ours.safetensors"), tensors,
                                    metadata={"format": "pt"})
    for got in (hf_checkpoint.read_safetensors(str(tmp_path / "lib.safetensors")),
                load_file(str(tmp_path / "ours.safetensors")),
                hf_checkpoint.read_safetensors(str(tmp_path / "ours.safetensors"))):
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# -------------------------------------------------- what must raise


def test_unreadable_checkpoints_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="not a directory"):
        common.maybe_load_pretrained(_args(tmp_path / "missing"), _flags())
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        common.maybe_load_pretrained(_args(empty), _flags())
    roberta = tmp_path / "roberta"
    roberta.mkdir()
    (roberta / "config.json").write_text(json.dumps({"model_type": "roberta"}))
    with pytest.raises(ValueError, match="model_type 'roberta' is not read"):
        common.maybe_load_pretrained(_args(roberta), _flags())
    no_weights = tmp_path / "no_weights"
    no_weights.mkdir()
    (no_weights / "config.json").write_text(json.dumps({"model_type": "bert"}))
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        common.maybe_load_pretrained(_args(no_weights), _flags())

    hf, _, _ = _hf_model("bert")
    good = tmp_path / "good"
    hf.save_pretrained(good)
    data = (good / "model.safetensors").read_bytes()
    (no_weights / "model.safetensors").write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="byte range"):
        common.maybe_load_pretrained(_args(no_weights), _flags())
    sd = hf_checkpoint.read_safetensors(str(good / "model.safetensors"))
    del sd["encoder.layer.1.output.dense.weight"]
    hf_checkpoint.write_safetensors(str(no_weights / "model.safetensors"), sd)
    (no_weights / "config.json").write_text((good / "config.json").read_text())
    with pytest.raises(KeyError, match="encoder.layer.1.output.dense.weight"):
        common.maybe_load_pretrained(_args(no_weights), _flags())
    # a checkpoint of other widths than the model's
    _, tree = common.maybe_load_pretrained(_args(good), _flags())
    model = TopicSegModel(EncoderConfig(**SMALL), TopicSegConfig())
    with pytest.raises(RuntimeError, match="size mismatch"):
        common.load_pretrained_into(model, tree)
