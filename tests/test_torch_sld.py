"""SLD on the port against the JAX package: ``models/gpt2.py``,
``models/generation.py``, ``projects/sld.py``, ``eval/asr_metrics.py`` and
``cli/run_sld.py``. JAX is imported inside the tests.

Sizes: GPT-2 of width 32, 2 layers, 2 heads, an SLD vocabulary of 40 text
ids + 2 + 16 speech ids, blocks of 48. Parameters come from Flax's init and
load with ``strict=True``; dropout and time masking are 0 wherever the two
packages are compared. Tolerances (float32, sums in another order): logits
2e-5; the SLD loss and its parts 1e-5 relative, and 1e-4 relative against a
float64 evaluation of the same formula; one AdamW step's parameters 1e-6
(where the gradient is not zero up to rounding, whose Adam step is +-lr on
either side: those are held to |change| <= lr); epoch losses of the
trainer and the CLI 1e-4 relative. Decoded tokens are equal: greedy and
beam, with EOS made likelier (its embedding row scaled) so that rows and
beams finish at different steps, on left-padded prompts, and with planted
ties.
"""

import functools
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

# transformers without its TensorFlow half (nothing here needs it; its
# import alone takes seconds)
os.environ.setdefault("USE_TF", "0")

V_TEXT, V_SPEECH, BLOCK = 40, 16, 48
GPT = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
           max_position_embeddings=64, embd_dropout=0.0, resid_dropout=0.0, attn_dropout=0.0)


SLD_KW = dict(gpt_vocab_size=V_TEXT, vocab_size_speech=V_SPEECH, block_size=BLOCK,
              max_text_length=12, eos_token_id=V_TEXT - 1, time_masking=0.0, kl_temperature=2.0)


def _tcfg():
    from spokennlp_tpu_torch.projects import sld as tsld

    return tsld.SLDConfig(**SLD_KW)


def _cfgs():
    from spokennlp_tpu.projects import sld as jsld

    return jsld.SLDConfig(**SLD_KW), _tcfg()


@functools.lru_cache(maxsize=1)
def _jax_model():
    """(the JAX model, its jitted init): one compile for every seed."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models import gpt2 as jg

    jmodel = jg.GPT2LMModel(jg.GPT2Config(vocab_size=V_TEXT + 2 + V_SPEECH, **GPT))
    return jmodel, jax.jit(lambda key: jmodel.init(key, jnp.ones((1, 8), jnp.int32))["params"])


def _port_model(seed):
    """The port's model at its own init (tests of the port alone)."""
    from spokennlp_tpu_torch.models import gpt2 as tg

    cfg = tg.GPT2Config(vocab_size=V_TEXT + 2 + V_SPEECH, **GPT)
    return tg.GPT2LMModel(cfg, generator=torch.Generator().manual_seed(seed)).eval()


def _models(eos_scale=1.0, eos=None, seed=0):
    """The JAX model, its params (the ``eos`` row of the tied table scaled by
    ``eos_scale``) and the port's model carrying them, in eval mode."""
    import jax

    from spokennlp_tpu_torch.models import gpt2 as tg
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    V = V_TEXT + 2 + V_SPEECH
    jmodel, init = _jax_model()
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))
    if eos is not None:
        emb = params["wte"]["embedding"].copy()
        emb[eos] *= eos_scale
        params = {**params, "wte": {"embedding": emb}}
    tmodel = tg.GPT2LMModel(tg.GPT2Config(vocab_size=V, **GPT))
    tmodel.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jmodel, params, tmodel.eval()


def _packed(cfg, n, seed):
    from spokennlp_tpu_torch.projects.sld import pack_example  # JAX's gives the same

    rng = np.random.default_rng(seed)
    rows = [pack_example(rng.integers(0, V_SPEECH, size=int(rng.integers(6, 30))).tolist(),
                         rng.integers(1, V_TEXT - 1, size=int(rng.integers(2, 10))).tolist(),
                         cfg) for _ in range(n)]
    return {k: np.stack([r[k] for r in rows]) for k in ("input_ids", "attention_mask", "labels")}


def _float64_sld_loss(logits, labels, mask, cfg):
    """The reference formula (run_clm.py:787-831) in float64 numpy."""
    x = logits.astype(np.float64)
    B = x.shape[0]
    Vs, T, eps = cfg.vocab_size_speech, cfg.kl_temperature, 1e-9
    m = mask.astype(np.float64)

    def log_softmax(z):
        z = z - z.max(-1, keepdims=True)
        return z - np.log(np.exp(z).sum(-1, keepdims=True))

    sl = x[:, :-1, -Vs:] * m[:, :-1, None] + eps
    tgt = np.maximum((labels[:, 1:] - cfg.gpt_vocab_size - 2) * mask[:, 1:], 0)
    sm = np.eye(Vs)[tgt] * (1 - cfg.label_smoothing_eps) + cfg.label_smoothing_eps / Vs
    sm = sm * m[:, 1:, None] + eps
    q = np.exp(log_softmax(sm / T))
    kl = (q * (np.log(q) - log_softmax(sl / T))).sum() / B * T**2

    lp = log_softmax(x[:, :-1])
    lab = labels[:, 1:]

    def ce(valid):
        picked = np.take_along_axis(lp, np.where(valid, lab, 0)[..., None], -1)[..., 0]
        return -(picked * valid).sum() / valid.sum()

    ce_text = ce((lab != -100) & (lab < cfg.gpt_vocab_size + 1))
    ce_speech = ce((lab != -100) & (lab >= cfg.gpt_vocab_size + 1))
    return ce_speech + ce_text + kl, {"ce_speech": ce_speech, "ce_text": ce_text,
                                      "kl_speech": kl}


def test_logits_and_sld_loss_match_jax():
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.projects import sld as jsld
    from spokennlp_tpu_torch.projects import sld as tsld

    jcfg, tcfg = _cfgs()
    jmodel, params, tmodel = _models()
    b = _packed(jcfg, 3, seed=1)
    jout = jax.jit(lambda p, x, m: jmodel.apply({"params": p}, x, attention_mask=m))(
        params, jnp.asarray(b["input_ids"]), jnp.asarray(b["attention_mask"]))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(b["input_ids"]),
                      attention_mask=torch.from_numpy(b["attention_mask"]))
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                               atol=2e-5, rtol=2e-5)

    # the loss on the same logits: JAX, the port and float64
    rng = np.random.default_rng(2)
    logits = (3 * rng.normal(size=tout["logits"].shape)).astype(np.float32)
    jl, jaux = jax.jit(lambda *a: jsld.sld_loss(*a, jcfg))(
        jnp.asarray(logits), jnp.asarray(b["labels"]), jnp.asarray(b["attention_mask"]))
    tl, taux = tsld.sld_loss(torch.from_numpy(logits), torch.from_numpy(b["labels"]),
                             torch.from_numpy(b["attention_mask"]), tcfg)
    fl, faux = _float64_sld_loss(logits, b["labels"], b["attention_mask"], tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tl), fl, rtol=1e-4)
    for k in ("ce_speech", "ce_text", "kl_speech"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(taux[k]), faux[k], rtol=1e-4, err_msg=k)


def test_one_adamw_step_matches_jax():
    import jax
    import jax.numpy as jnp
    import optax

    from spokennlp_tpu.projects import sld as jsld
    from spokennlp_tpu.train.train_step import create_train_state
    from spokennlp_tpu_torch.projects import sld as tsld

    jcfg, tcfg = _cfgs()
    jmodel, params, tmodel = _models()
    b = _packed(jcfg, 4, seed=3)
    lr = 1e-3
    tx = optax.adamw(lr)
    state, jm = jsld.make_sld_train_step(jmodel, jcfg, tx)(
        create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx),
        {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    out = tmodel(tb["input_ids"], attention_mask=tb["attention_mask"])
    loss = tsld.sld_loss(out["logits"], tb["labels"], tb["attention_mask"], tcfg)[0]
    names = [n for n, _ in tmodel.named_parameters()]
    g = dict(zip(names, torch.autograd.grad(loss, list(tmodel.parameters()))))
    opt = torch.optim.AdamW(tmodel.parameters(), lr=lr, weight_decay=1e-4)
    tm = tsld.make_sld_train_step(tmodel, tcfg, opt, torch.Generator().manual_seed(0))(tb)
    for k in ("loss", "ce_speech", "ce_text", "kl_speech"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    before = jax_params_to_state_dict(params)
    for name, p in tmodel.state_dict().items():
        got, w = p.numpy(), want[name].numpy()
        gn = g[name].numpy()
        tiny = np.abs(gn) <= 1e-6 * max(np.abs(gn).max(), 1e-30)
        np.testing.assert_allclose(got[~tiny], w[~tiny], atol=1e-6, err_msg=name)
        assert (np.abs(got[tiny] - before[name].numpy()[tiny]) <= lr * 1.001).all(), name


def _prompts(rng, B=3):
    """Left-padded prompts of speech ids ending at speech_end."""
    jcfg = _tcfg()
    lens = [9, 6, 4][:B]
    P = max(lens)
    ids = np.full((B, P), jcfg.eos_token_id, np.int32)
    mask = np.zeros((B, P), np.int32)
    for i, n in enumerate(lens):
        row = (rng.integers(0, V_SPEECH, size=n - 1) + V_TEXT + 2).tolist() + [jcfg.speech_end_id]
        ids[i, P - n:] = row
        mask[i, P - n:] = 1
    return ids, mask


@pytest.mark.parametrize("eos_scale", [1.0, 6.0])
def test_greedy_and_beam_tokens_match_jax(eos_scale):
    """Left-padded prompts; with EOS made likelier rows and beams finish at
    different steps (the frozen lengths, the EOS-only extension, the final
    flush and the early stop all run)."""
    import jax.numpy as jnp

    from spokennlp_tpu.models import generation as jgen
    from spokennlp_tpu_torch.models import generation as tgen

    jcfg, _ = _cfgs()
    eos = jcfg.text_end_id
    jmodel, params, tmodel = _models(eos_scale, eos, seed=4)
    ids, mask = _prompts(np.random.default_rng(5))
    T = 24
    jg = np.asarray(jgen.greedy_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask),
                                         max_len=T, eos_id=eos))
    tg = tgen.greedy_generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), T, eos)
    np.testing.assert_array_equal(tg.numpy(), jg)
    jb = np.asarray(jgen.beam_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask),
                                       max_len=T, eos_id=eos, num_beams=3))
    tb = tgen.beam_generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), T, eos,
                            num_beams=3)
    np.testing.assert_array_equal(tb.numpy(), jb)
    # one beam is greedy (JAX's beam_generate gives the same, tests/test_gpt2_sld.py)
    np.testing.assert_array_equal(tgen.beam_generate(
        tmodel, torch.from_numpy(ids), torch.from_numpy(mask), T, eos, num_beams=1).numpy(),
        tg.numpy())
    if eos_scale > 1:  # the rows did finish, at different steps
        ends = [list(r[ids.shape[1]:]).index(eos) for r in tg.numpy()]
        assert len(set(ends)) > 1, ends


def test_cached_decode_matches_full_forward():
    """Each greedy step over the KV cache equals the argmax of a full
    forward over the sequence so far (left padding, positions from the real
    tokens)."""
    from spokennlp_tpu_torch.models import generation as tgen

    tmodel = _port_model(6)
    ids, mask = _prompts(np.random.default_rng(7))
    T = 20
    out = tgen.greedy_generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), T, 10**6)
    P = ids.shape[1]
    with torch.no_grad():
        for t in range(P, T):
            am = torch.cat([torch.from_numpy(mask), torch.ones((3, t - P), dtype=torch.int32)], 1)
            pos = tgen._prompt_position_ids(am)
            logits = tmodel(out[:, :t], attention_mask=am, position_ids=pos)["logits"]
            np.testing.assert_array_equal(torch.argmax(logits[:, -1], -1).numpy(),
                                          out[:, t].numpy(), err_msg=f"step {t}")


def test_planted_ties_take_the_lower_index():
    """top_k and the greedy argmax break ties as jax.lax.top_k and
    jnp.argmax do; a model whose table holds equal rows decodes to JAX's
    tokens with beams."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models import generation as jgen
    from spokennlp_tpu_torch.models import generation as tgen
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    x = np.array([[1.0, 3.0, 2.0, 3.0, 3.0, 0.5, 2.0], [0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0]],
                 np.float32)
    for k in (1, 2, 3, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tgen.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(torch.argmax(torch.from_numpy(x), -1).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(x), -1)))

    jcfg, _ = _cfgs()
    jmodel, params, tmodel = _models(seed=8)
    emb = params["wte"]["embedding"].copy()
    emb[5:12] = emb[4]  # seven tokens whose logits tie with token 4's
    emb[4] *= 3.0
    emb[5:12] *= 3.0
    params = {**params, "wte": {"embedding": emb}}
    tmodel.load_state_dict(jax_params_to_state_dict(params), strict=True)
    ids, mask = _prompts(np.random.default_rng(9))
    jb = np.asarray(jgen.beam_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask),
                                       max_len=24, eos_id=jcfg.text_end_id, num_beams=3))
    tb = tgen.beam_generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), 24,
                            jcfg.text_end_id, num_beams=3)
    np.testing.assert_array_equal(tb.numpy(), jb)


def test_greedy_and_beam_flush_the_final_eos():
    """The loop writes the PREVIOUS step's token: when every row has
    finished, the EOS that finished the last one is flushed into its slot
    (JAX's regression test, on the port)."""
    from spokennlp_tpu_torch.models import generation as tgen

    tmodel = _port_model(10)
    ids = torch.tensor([[5, 7, 9, 11]], dtype=torch.int32)
    am = torch.ones_like(ids)
    free = tgen.greedy_generate(tmodel, ids, am, 12, 10**6)
    c = int(free[0, 4])
    out = tgen.greedy_generate(tmodel, ids, am, 12, c)
    assert int(out[0, 4]) == c, out[0].tolist()
    assert out[0, 5:].tolist() == [0] * 7  # the loop stopped at once
    bout = tgen.beam_generate(tmodel, ids, am, 12, c, num_beams=2)
    assert c in bout[0, 4:].tolist(), bout[0].tolist()


def _trainer_data(cfg, seed=0, n_train=20, n_eval=3):
    from spokennlp_tpu_torch.projects.sld import pack_example

    rng = np.random.default_rng(seed)

    def make(n):
        sp = rng.integers(0, V_SPEECH, size=n).tolist()
        return sp, [3 + (t % 8) for t in sp[:6]]

    detok = lambda ids: " ".join(str(i) for i in ids)
    train = [pack_example(*make(int(rng.integers(6, 12))), cfg) for _ in range(n_train)]
    evals, texts = [], []
    for _ in range(n_eval):
        sp, tx = make(8)
        evals.append(pack_example(sp, tx, cfg))
        texts.append(detok(tx))
    return train, evals, texts, detok


def test_sld_trainer_keeps_the_two_best_checkpoints(tmp_path):
    """SLDTrainer for 3 epochs: the loss falls, and of the epochs' WERs the
    best two stay on disk (the later of equals), as JAX's Orbax manager
    keeps them (max_to_keep=2, best_fn = -WER)."""
    from spokennlp_tpu_torch.projects import sld as tsld

    tcfg = _tcfg()
    tmodel = _port_model(11)
    train, evals, texts, detok = _trainer_data(tcfg)
    trainer = tsld.SLDTrainer(tmodel, tcfg, torch.optim.Adam(tmodel.parameters(), lr=3e-3),
                              train, evals, texts, detok, batch_size=8, num_epochs=3,
                              decode_max_len=BLOCK, checkpoint_dir=str(tmp_path / "ckpt"))
    wers = iter([0.5, 0.25, 0.5])
    trainer.decode_eval = lambda: {"wer": next(wers), "cer": 0.1}
    hist = trainer.train()["history"]
    assert hist[2]["train_loss"] < hist[0]["train_loss"]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2", "3"]
    assert json.loads((tmp_path / "ckpt" / "3" / "metrics.json").read_text())["wer"] == 0.5
    assert (tmp_path / "ckpt" / "2" / "params.msgpack").exists()


def _write_corpus(tmp_path):
    rng = np.random.default_rng(12)
    words = ["go", "stop", "left", "right", "up", "down"]
    for name, n in (("train.jsonl", 12), ("eval.jsonl", 3)):
        with open(tmp_path / name, "w") as f:
            for _ in range(n):
                sp = rng.integers(0, 16, size=int(rng.integers(5, 10))).tolist()
                text = " ".join(words[t % len(words)] for t in sp[:4])
                f.write(json.dumps({"speech_tokens": sp, "text": text}) + "\n")


def test_run_sld_matches_jax(tmp_path):
    """run_sld (so SLDTrainer) for 2 epochs on a tiny corpus from JAX's init
    (captured), dropout and time masking 0, the linear schedule with warmup,
    the global-norm clip and a 2-beam decode eval: the epoch losses and
    WER/CER equal JAX's; the results file is written; the CLI defaults to
    the card. (JAX's Orbax writes are left out: the port's retention has its
    own test.)"""
    import flax.linen as nn
    import jax

    from spokennlp_tpu.cli import run_sld as jcli
    from spokennlp_tpu.models import gpt2 as jg
    from spokennlp_tpu_torch.cli import run_sld as tcli
    from spokennlp_tpu_torch.models import gpt2 as tg
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.projects import sld as tsld

    assert tcli.make_parser().parse_args(
        ["--train_file", "a", "--eval_file", "b", "--output_dir", "c"]).device == "cuda"
    _write_corpus(tmp_path)
    argv = ["--train_file", str(tmp_path / "train.jsonl"),
            "--eval_file", str(tmp_path / "eval.jsonl"),
            "--vocab_size_speech", "16", "--block_size", "32", "--max_text_length", "8",
            "--per_device_train_batch_size", "4", "--num_train_epochs", "2",
            "--learning_rate", "3e-3", "--num_warmup_steps", "2", "--clip_grad_norm", "0.5",
            "--time_masking", "0", "--hidden_size", "32", "--num_hidden_layers", "2",
            "--num_attention_heads", "2", "--decode_max_len", "32", "--num_beams", "2"]
    no_drop = dict(embd_dropout=0.0, resid_dropout=0.0, attn_dropout=0.0)
    inits = []
    real_init = nn.Module.init

    def capture(self, key, *a, **kw):  # jitted: Flax's eager init is slow on the CPU
        out = jax.jit(lambda k: real_init(self, k, *a, **kw))(key)
        inits.append(jax.tree_util.tree_map(np.asarray, out["params"]))
        return out

    from spokennlp_tpu.projects import sld as jsld

    with mock.patch.object(jg, "GPT2Config", functools.partial(jg.GPT2Config, **no_drop)), \
            mock.patch.object(nn.Module, "init", capture), \
            mock.patch.object(jsld.SLDTrainer, "_save", lambda *a: None):
        jres = jcli.main(argv + ["--output_dir", str(tmp_path / "j")])
    params = inits[0]
    real_step = tsld.make_sld_train_step

    def from_jax(model, *a, **kw):
        model.load_state_dict(jax_params_to_state_dict(params), strict=True)
        return real_step(model, *a, **kw)

    with mock.patch.object(tg, "GPT2Config", functools.partial(tg.GPT2Config, **no_drop)), \
            mock.patch.object(tsld, "make_sld_train_step", from_jax):
        tres = tcli.main(argv + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    for j, t in zip(jres["history"], tres["history"]):
        np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=1e-4)
        assert (t["wer"], t["cer"]) == (j["wer"], j["cer"]), (t, j)
    assert json.loads((tmp_path / "t" / "sld_results.json").read_text())["final"]["wer"] >= 0


def test_gpt2_hf_checkpoint_matches_jax(tmp_path):
    """A random HF GPT-2 written by transformers (safetensors) read by the
    port without transformers: the tree equals JAX's conversion, the
    logits equal HF's, the resized rows equal JAX's draws; run_sld's loader
    refuses other widths."""
    transformers = pytest.importorskip("transformers")

    from spokennlp_tpu.models import gpt2 as jg
    from spokennlp_tpu_torch.cli.run_sld import load_pretrained
    from spokennlp_tpu_torch.models import gpt2 as tg
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    hf_cfg = transformers.GPT2Config(vocab_size=50, n_positions=64, n_embd=32, n_layer=2,
                                     n_head=2, n_inner=64)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    hf.save_pretrained(tmp_path / "gpt2")
    raw, sd = tg.read_gpt2_checkpoint(str(tmp_path / "gpt2"))
    cfg = dict(GPT, vocab_size=50)
    tparams = tg.gpt2_hf_to_params(sd, tg.GPT2Config(**cfg))
    jparams = jg.gpt2_hf_to_params({k: v.detach().numpy() for k, v in hf.state_dict().items()},
                                   jg.GPT2Config(**cfg))
    want = jax_params_to_state_dict(jparams)
    got = jax_params_to_state_dict(tparams)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    model = tg.GPT2LMModel(tg.GPT2Config(**cfg))
    model.load_state_dict(got, strict=True)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 50, size=(2, 10)))
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(ids)["logits"].numpy(), hf(ids).logits.numpy(),
                                   atol=1e-4, rtol=1e-4)
    grown = load_pretrained(str(tmp_path / "gpt2"), tg.GPT2Config(**{**cfg, "vocab_size": 58}),
                            58, seed=3)
    np.testing.assert_array_equal(grown["wte"]["embedding"],
                                  jg.resize_token_embeddings(jparams, 58, seed=3)["wte"]["embedding"])
    with pytest.raises(ValueError, match="widths"):
        load_pretrained(str(tmp_path / "gpt2"), tg.GPT2Config(**{**cfg, "hidden_size": 64}),
                        58, seed=3)


# ---------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_decode_and_step_on_card(cuda):
    """GPT-2 of width 256 (4 layers) on the card: logits within 1e-4 of the
    CPU's, 16 KV-cache greedy steps equal to a full forward's argmax, one
    beam equal to greedy, and one SLD step's loss finite and equal to the
    CPU's within 1e-4 relative (dropout and time masking 0)."""
    from spokennlp_tpu_torch.models import generation as tgen
    from spokennlp_tpu_torch.models import gpt2 as tg
    from spokennlp_tpu_torch.projects import sld as tsld

    tcfg = _tcfg()
    cfg = tg.GPT2Config(vocab_size=tcfg.total_vocab, hidden_size=256, num_layers=4,
                        num_heads=4, intermediate_size=1024, max_position_embeddings=64,
                        embd_dropout=0.0, resid_dropout=0.0, attn_dropout=0.0)
    cpu = tg.GPT2LMModel(cfg, generator=torch.Generator().manual_seed(0)).eval()
    card = tg.GPT2LMModel(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda).eval()
    b = {k: torch.from_numpy(v) for k, v in _packed(tcfg, 4, seed=1).items()}
    with torch.no_grad():
        want = cpu(b["input_ids"], attention_mask=b["attention_mask"])["logits"]
        got = card(b["input_ids"].to(cuda), attention_mask=b["attention_mask"].to(cuda))["logits"]
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    ids, mask = (torch.from_numpy(a).to(cuda) for a in _prompts(np.random.default_rng(2)))
    P, eos = ids.shape[1], tcfg.text_end_id
    out = tgen.greedy_generate(card, ids, mask, P + 16, eos)
    assert torch.equal(tgen.beam_generate(card, ids, mask, P + 16, eos, num_beams=1), out)
    with torch.no_grad():
        for t in range(P, P + 16):
            am = torch.cat([mask, torch.ones((3, t - P), dtype=mask.dtype, device=cuda)], 1)
            full = card(out[:, :t], attention_mask=am,
                        position_ids=tgen._prompt_position_ids(am))["logits"][:, -1]
            going = ~(out[:, P:t] == eos).any(1)
            assert not (going & (full.argmax(-1).to(out.dtype) != out[:, t])).any(), t
    losses = []
    for model in (cpu, card):
        dev = next(model.parameters()).device
        step = tsld.make_sld_train_step(model, tcfg, torch.optim.AdamW(model.parameters(), 1e-3,
                                                                       weight_decay=1e-4))
        losses.append(float(step({k: v.to(dev) for k, v in b.items()})["loss"]))
    assert np.isfinite(losses).all() and abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
