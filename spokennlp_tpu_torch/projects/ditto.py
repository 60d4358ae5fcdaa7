"""Ditto: learning-free sentence embeddings via Diagonal Attention Pooling,
on PyTorch.

Counterpart of ``spokennlp_tpu/projects/ditto.py`` (reference: ditto/
evaluation_ditto.py:37-215): run any converted encoder checkpoint, weight
token hidden states by the token's self-attention diagonal from a chosen
(layer, head), and evaluate on STS with cosine similarity + Spearman, on
the SentEval transfer and probing tasks, and on the STS-B/SICK relatedness
regression.

All nine pooler variants of the reference (:130-172) are supported: cls,
cls_before_pooler, avg, avg_top2, avg_first_last, att_first_last, att_last,
att_static, avg_static.

``make_embed_fn`` runs the encoder in eval mode with
``output_hidden_states=True``, so on the card ``attention_impl="auto"``
takes the fused attention and MLP kernels (kernels 1 and 2) once a layer a
batch. The attention diagonal is computed without the (L, L) probabilities
of every head: diag_i = exp(s_ii - logsumexp_j s_ij) for ONE layer and ONE
head, from that layer's QKV weight in its Flax layout (H, 3, nh, hd).

The probes (``evaluate_transfer_classification`` with ``classifier="mlp"``,
``evaluate_similarity_regression``) train on ``device``; the logreg probe
and the k-fold splits use sklearn, imported where JAX imports it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spokennlp_tpu_torch.models.encoder import NEG_INF, Encoder

POOLERS = (
    "cls",
    "cls_before_pooler",
    "avg",
    "avg_top2",
    "avg_first_last",
    "att_first_last",
    "att_last",
    "att_static",
    "avg_static",
)


def attention_diagonal(
    encoder: Encoder,
    hidden_prev: torch.Tensor,
    attention_mask: torch.Tensor,
    layer: int,
    head: int,
) -> torch.Tensor:
    """Diagonal of the attention-prob matrix of one (layer, head).

    hidden_prev: (B, L, H) hidden states ENTERING the chosen layer.
    Returns (B, L) float32.
    """
    hd = encoder.cfg.head_dim
    qkv = getattr(encoder, f"layer_{layer}").attention.qkv
    kernel = qkv.kernel.to(hidden_prev.dtype)  # (H, 3, nh, hd)
    bias = qkv.bias.to(hidden_prev.dtype)  # (3, nh, hd)
    q = torch.einsum("blh,hd->bld", hidden_prev, kernel[:, 0, head, :]) + bias[0, head]
    k = torch.einsum("blh,hd->bld", hidden_prev, kernel[:, 1, head, :]) + bias[1, head]
    qs = q * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bld,bmd->blm", qs, k).float()
    scores = scores + (1.0 - attention_mask[:, None, :].float()) * NEG_INF
    lse = torch.logsumexp(scores, dim=-1)  # (B, L)
    s_ii = torch.einsum("bld,bld->bl", qs, k).float()
    return torch.exp(s_ii - lse)


def make_embed_fn(
    encoder: Encoder,
    pooler: str = "att_first_last",
    layer: int = 0,
    head: int = 9,
):
    """(input_ids, attention_mask) -> (B, H) embeddings on the encoder's
    device; the ids and mask may be numpy arrays or tensors."""
    assert pooler in POOLERS, pooler
    needs_attn = pooler.startswith("att_")
    device = next(encoder.parameters()).device

    @torch.no_grad()
    def embed(input_ids, attention_mask):
        encoder.eval()
        input_ids = torch.as_tensor(input_ids, device=device)
        attention_mask = torch.as_tensor(attention_mask, device=device)
        out = encoder(input_ids, attention_mask=attention_mask, output_hidden_states=True)
        hs = out.hidden_states  # tuple: embeddings output + per-layer
        last = out.last_hidden_state
        mask = attention_mask[..., None].to(last.dtype)

        if needs_attn:
            diag = attention_diagonal(encoder, hs[layer], attention_mask, layer, head)
            diag = diag[..., None].to(last.dtype)

        if pooler == "cls":
            return out.pooled_output
        if pooler == "cls_before_pooler":
            return last[:, 0]
        if pooler == "avg":
            return (last * mask).sum(1) / mask.sum(1)
        if pooler == "avg_top2":
            h = (hs[-1] + hs[-2]) / 2.0
            return (h * mask).sum(1) / mask.sum(1)
        if pooler == "avg_first_last":
            h = (hs[0] + hs[-1]) / 2.0
            return (h * mask).sum(1) / mask.sum(1)
        if pooler == "att_first_last":
            h = (hs[0] + hs[-1]) / 2.0
            return (h * mask * diag).sum(1)
        if pooler == "att_last":
            return (last * mask * diag).sum(1)
        static = encoder.embeddings.word_embeddings.embedding[input_ids].to(last.dtype)
        if pooler == "att_static":
            return (static * mask * diag).sum(1)
        return (static * mask).sum(1) / mask.sum(1)

    return embed


# ---------------------------------------------------------------------------
# STS evaluation
# ---------------------------------------------------------------------------


def cosine_scores(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return (an * bn).sum(-1)


def spearman(x: np.ndarray, y: np.ndarray) -> float:
    try:
        from scipy import stats

        return float(stats.spearmanr(x, y).statistic)
    except Exception:
        rx = np.argsort(np.argsort(x)).astype(np.float64)
        ry = np.argsort(np.argsort(y)).astype(np.float64)
        rx -= rx.mean()
        ry -= ry.mean()
        return float((rx * ry).sum() / np.sqrt((rx**2).sum() * (ry**2).sum()))


@dataclasses.dataclass
class StsDataset:
    """One STS task: possibly multiple subsets of (sent1, sent2, gold)."""

    name: str
    subsets: Dict[str, Tuple[List[str], List[str], List[float]]]


def load_sts_tsv(path: str, name: str = "sts") -> StsDataset:
    """Generic loader: TSV lines 'sent1<TAB>sent2<TAB>score'."""
    s1, s2, gold = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            s1.append(parts[0])
            s2.append(parts[1])
            gold.append(float(parts[2]))
    return StsDataset(name=name, subsets={"all": (s1, s2, gold)})


def load_senteval_sts(task_dir: str, subsets: Sequence[str], name: str) -> StsDataset:
    """SentEval STS layout: STS.input.<subset>.txt + STS.gs.<subset>.txt."""
    import os

    out = {}
    for ss in subsets:
        s1, s2, gold = [], [], []
        with open(os.path.join(task_dir, f"STS.input.{ss}.txt")) as fi, open(
            os.path.join(task_dir, f"STS.gs.{ss}.txt")
        ) as fg:
            for line, g in zip(fi, fg):
                g = g.strip()
                if not g:
                    continue
                a, b = line.rstrip("\n").split("\t")[:2]
                s1.append(a)
                s2.append(b)
                gold.append(float(g))
        out[ss] = (s1, s2, gold)
    return StsDataset(name=name, subsets=out)


def evaluate_sts(
    embed_fn,
    tokenize_fn: Callable[[List[str]], Tuple[np.ndarray, np.ndarray]],
    dataset: StsDataset,
    batch_size: int = 64,
) -> Dict[str, float]:
    """Spearman per subset + 'all' over the concatenation (SentEval style)."""
    all_sims: List[np.ndarray] = []
    all_gold: List[np.ndarray] = []
    results: Dict[str, float] = {}
    for ss, (s1, s2, gold) in dataset.subsets.items():
        embs1 = _embed_corpus(embed_fn, tokenize_fn, s1, batch_size)
        embs2 = _embed_corpus(embed_fn, tokenize_fn, s2, batch_size)
        sims = cosine_scores(embs1, embs2)
        results[f"{ss}_spearman"] = spearman(sims, np.asarray(gold))
        all_sims.append(sims)
        all_gold.append(np.asarray(gold))
    results["all_spearman"] = spearman(
        np.concatenate(all_sims), np.concatenate(all_gold)
    )
    return results


def _embed_corpus(embed_fn, tokenize_fn, sentences, batch_size) -> np.ndarray:
    outs = []
    for start in range(0, len(sentences), batch_size):
        chunk = sentences[start : start + batch_size]
        real = len(chunk)
        while len(chunk) < batch_size:  # every batch at one shape, as in JAX
            chunk = chunk + chunk[: batch_size - len(chunk)]
        ids, mask = tokenize_fn(chunk)
        emb = embed_fn(ids, mask)
        outs.append(emb[:real].float().cpu().numpy())
    return np.concatenate(outs, axis=0)


# ---------------------------------------------------------------------------
# per-model (layer, head) recipes + SentEval-style transfer harness
# ---------------------------------------------------------------------------

# the reference's run-script table of which attention diagonal to pool with
# (reference: ditto/run_eval_ditto.sh:17-37)
DITTO_RECIPES: Dict[str, Tuple[int, int]] = {
    "bert-base-uncased": (0, 9),
    "roberta-base": (0, 4),
    "electra-base-discriminator": (0, 10),
    "sbert": (2, 6),
    "sentence-bert": (2, 6),
}


def recipe_for(model_name: str) -> Tuple[int, int]:
    """(layer, head) for a model name, by substring match; default (0, 9)."""
    low = model_name.lower()
    for key, lh in DITTO_RECIPES.items():
        if key in low:
            return lh
    return (0, 9)


def evaluate_transfer_classification(
    embed_fn,
    tokenize_fn,
    tasks: Dict[str, Dict[str, Tuple[Sequence[str], Sequence[int]]]],
    batch_size: int = 32,
    kfold: int = 5,
    c_grid: Sequence[float] = (2.0**-2, 2.0**-1, 1.0, 2.0, 4.0, 8.0),
    seed: int = 1111,
    classifier: str = "logreg",
    mlp_nhid: int = 0,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Probing over frozen embeddings, two classifier protocols.

    ``classifier="logreg"`` (fast default): sklearn LogisticRegression with
    an L2 grid; tasks with a train/test split pick C on an inner split of
    train, single-set tasks ("all") run k-fold CV.

    ``classifier="mlp"``: the port of SentEval's pytorch classifier
    (projects/senteval_classifier.py: adam, summed CE, tenacity-5 early
    stopping on dev, l2 grid 1e-5..1e-2; the published Ditto transfer
    protocol is this with nhid=0, evaluation_ditto.py:82-84), trained on
    ``device``.

    Returns {task: {"acc": %, "best_c"/"best_reg": chosen reg}}.
    """
    if classifier == "mlp":
        return _transfer_senteval_mlp(
            embed_fn, tokenize_fn, tasks, batch_size, kfold, seed, mlp_nhid, device
        )
    from sklearn.linear_model import LogisticRegression
    from sklearn.model_selection import StratifiedKFold, train_test_split

    results = {}
    for name, data in tasks.items():
        if "train" in data:
            Xtr = _embed_corpus(embed_fn, tokenize_fn, data["train"][0], batch_size)
            ytr = np.asarray(data["train"][1])
            Xte = _embed_corpus(embed_fn, tokenize_fn, data["test"][0], batch_size)
            yte = np.asarray(data["test"][1])
            if "dev" in data:
                # explicit validation split (the probing tasks ship tr/va/te;
                # reference: senteval/tools/validation.py SplitClassifier)
                Xin, yin = Xtr, ytr
                Xval = _embed_corpus(embed_fn, tokenize_fn, data["dev"][0], batch_size)
                yval = np.asarray(data["dev"][1])
            else:
                Xin, Xval, yin, yval = train_test_split(
                    Xtr, ytr, test_size=0.2, random_state=seed, stratify=ytr
                )
            best_c, best_acc = c_grid[0], -1.0
            for C in c_grid:
                clf = LogisticRegression(C=C, max_iter=2000, random_state=seed)
                clf.fit(Xin, yin)
                acc = clf.score(Xval, yval)
                if acc > best_acc:
                    best_acc, best_c = acc, C
            clf = LogisticRegression(C=best_c, max_iter=2000, random_state=seed)
            clf.fit(Xtr, ytr)
            results[name] = {"acc": 100.0 * clf.score(Xte, yte), "best_c": best_c}
        else:
            sents, labels = data["all"]
            X = _embed_corpus(embed_fn, tokenize_fn, sents, batch_size)
            y = np.asarray(labels)
            skf = StratifiedKFold(n_splits=kfold, shuffle=True, random_state=seed)
            best_c, best_acc = c_grid[0], -1.0
            for C in c_grid:
                accs = []
                for tr, te in skf.split(X, y):
                    clf = LogisticRegression(C=C, max_iter=2000, random_state=seed)
                    clf.fit(X[tr], y[tr])
                    accs.append(clf.score(X[te], y[te]))
                acc = float(np.mean(accs))
                if acc > best_acc:
                    best_acc, best_c = acc, C
            results[name] = {"acc": 100.0 * best_acc, "best_c": best_c}
    return results


def _transfer_senteval_mlp(
    embed_fn, tokenize_fn, tasks, batch_size, kfold, seed, nhid, device
):
    """SentEval pytorch-classifier protocol (see
    evaluate_transfer_classification docstring). Split tasks follow
    SplitClassifier (reg picked on dev); single-set tasks follow the
    inner-selection spirit of InnerKFoldClassifier with a 90/10 inner dev
    split per outer fold (the JAX package's documented simplification)."""
    from sklearn.model_selection import StratifiedKFold, train_test_split

    from spokennlp_tpu_torch.projects.senteval_classifier import (
        MLPParams,
        fit_with_reg_grid,
    )

    cfg = MLPParams(nhid=nhid)
    results = {}
    for name, data in tasks.items():
        if "train" in data:
            Xtr = _embed_corpus(embed_fn, tokenize_fn, data["train"][0], batch_size)
            ytr = np.asarray(data["train"][1])
            Xte = _embed_corpus(embed_fn, tokenize_fn, data["test"][0], batch_size)
            yte = np.asarray(data["test"][1])
            if "dev" in data:
                Xval = _embed_corpus(
                    embed_fn, tokenize_fn, data["dev"][0], batch_size
                )
                yval = np.asarray(data["dev"][1])
                Xin, yin = Xtr, ytr
            else:
                Xin, Xval, yin, yval = train_test_split(
                    Xtr, ytr, test_size=0.2, random_state=seed, stratify=ytr
                )
            ncls = int(max(ytr.max(), yte.max())) + 1
            clf, reg, _ = fit_with_reg_grid(Xin, yin, Xval, yval, ncls,
                                            cfg=cfg, seed=seed, device=device)
            results[name] = {"acc": 100.0 * clf.score(Xte, yte),
                             "best_reg": reg}
        else:
            sents, labels = data["all"]
            X = _embed_corpus(embed_fn, tokenize_fn, sents, batch_size)
            y = np.asarray(labels)
            ncls = int(y.max()) + 1
            skf = StratifiedKFold(n_splits=kfold, shuffle=True,
                                  random_state=seed)
            accs, regs = [], []
            for tr, te in skf.split(X, y):
                Xin, Xval, yin, yval = train_test_split(
                    X[tr], y[tr], test_size=0.1, random_state=seed,
                    stratify=y[tr]
                )
                clf, reg, _ = fit_with_reg_grid(Xin, yin, Xval, yval, ncls,
                                                cfg=cfg, seed=seed, device=device)
                accs.append(clf.score(X[te], y[te]))
                regs.append(reg)
            results[name] = {"acc": 100.0 * float(np.mean(accs)),
                             "best_reg": float(np.median(regs))}
    return results


def _score_distribution(scores: np.ndarray, n_classes: int = 5) -> np.ndarray:
    """Tai et al. (2015) encoding: score s in [1, n] -> probability mass on
    floor(s)/ceil(s) (the SentEval relatedness target)."""
    y = np.zeros((len(scores), n_classes), np.float32)
    for i, s in enumerate(np.clip(scores, 1.0, float(n_classes))):
        lo = int(np.floor(s))
        if lo == s:
            y[i, lo - 1] = 1.0
        else:
            y[i, lo - 1] = lo + 1 - s
            y[i, lo] = s - lo
    return y


def evaluate_similarity_regression(
    embed_fn,
    tokenize_fn,
    data: Dict[str, Tuple[Sequence[str], Sequence[str], Sequence[float]]],
    batch_size: int = 32,
    n_classes: int = 5,
    epochs: int = 300,
    lr: float = 0.05,
    l2: float = 1e-4,
    seed: int = 1111,
    device="cuda",
) -> Dict[str, float]:
    """STS-B / SICK-Relatedness regression head over frozen embeddings.

    The SentEval protocol (reference: SentEval/senteval/tools/relatedness.py):
    features [u*v, |u-v|], softmax regression trained with KL against the
    Tai-style score distribution; prediction = expected class value.
    Zero init, full-batch Adam for ``epochs`` steps on ``device``. Train on
    data["train"], report Pearson/Spearman on data["test"].
    """

    def feats(split):
        a, b, s = data[split]
        ua = _embed_corpus(embed_fn, tokenize_fn, a, batch_size)
        ub = _embed_corpus(embed_fn, tokenize_fn, b, batch_size)
        X = np.concatenate([ua * ub, np.abs(ua - ub)], axis=1).astype(np.float32)
        return X, np.asarray(s, np.float32)

    Xtr, str_ = feats("train")
    Xte, ste = feats("test")
    Ytr = _score_distribution(str_, n_classes)

    D = Xtr.shape[1]
    w = torch.zeros((D, n_classes), dtype=torch.float32, device=device, requires_grad=True)
    b = torch.zeros((n_classes,), dtype=torch.float32, device=device, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr)
    Xj = torch.from_numpy(Xtr).to(device)
    Yj = torch.from_numpy(Ytr).to(device)
    for _ in range(epochs):
        logp = F.log_softmax(Xj @ w + b, -1)
        loss = -torch.mean(torch.sum(Yj * logp, dim=-1)) + l2 * torch.sum(w**2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    with torch.no_grad():
        probs = F.softmax(torch.from_numpy(Xte).to(device) @ w + b, -1).cpu().numpy()
    classes = np.arange(1, n_classes + 1, dtype=np.float32)
    pred = probs @ classes
    pearson = float(np.corrcoef(pred, ste)[0, 1])
    return {
        "pearson": pearson,
        "spearman": spearman(pred, ste),
        "mse": float(np.mean((pred - ste) ** 2)),
    }


def load_senteval_classification(task_dir: str, task: str):
    """SentEval downstream-task files -> the evaluate_transfer_classification
    input format (reference loaders: ditto/SentEval/senteval/binary.py,
    sst.py, trec.py, mrpc.py).

    Two-file polarity tasks (MR/CR/SUBJ/MPQA) -> {"all": ...} (k-fold);
    split tasks (SST2, TREC, MRPC) -> {"train": ..., "test": ...}.
    """
    import codecs
    import os

    def read_lines(path):
        with codecs.open(path, "r", encoding="latin-1") as f:
            return [l.strip() for l in f if l.strip()]

    two_file = {
        "MR": ("rt-polarity.pos", "rt-polarity.neg"),
        "CR": ("custrev.pos", "custrev.neg"),
        "SUBJ": ("subj.subjective", "subj.objective"),
        "MPQA": ("mpqa.pos", "mpqa.neg"),
    }
    task = task.upper()
    if task in two_file:
        pos_f, neg_f = two_file[task]
        pos = read_lines(os.path.join(task_dir, pos_f))
        neg = read_lines(os.path.join(task_dir, neg_f))
        return {"all": (pos + neg, [1] * len(pos) + [0] * len(neg))}
    if task == "SST2":
        def split(name):
            rows = read_lines(os.path.join(task_dir, name))
            sents, labels = [], []
            for r in rows:
                lab, _, sent = r.partition("\t")
                if sent:
                    sents.append(sent)
                    labels.append(int(lab))
            return sents, labels

        return {"train": split("sentiment-train"), "test": split("sentiment-test")}
    if task == "TREC":
        label_ids: Dict[str, int] = {}  # SHARED across splits: train/test
        # label ids must agree or the probe scores against a permutation

        def split(name):
            sents, labels = [], []
            for r in read_lines(os.path.join(task_dir, name)):
                tag, _, text = r.partition(" ")
                coarse = tag.split(":")[0]
                sents.append(text)
                labels.append(label_ids.setdefault(coarse, len(label_ids)))
            return sents, labels

        return {"train": split("train_5500.label"), "test": split("TREC_10.label")}
    if task == "MRPC":
        def split(name):
            sents, labels = [], []
            rows = read_lines(os.path.join(task_dir, name))
            for r in rows[1:]:  # header
                parts = r.split("\t")
                if len(parts) >= 5:
                    # pair encoded as concatenation for the linear probe
                    sents.append(parts[3] + " " + parts[4])
                    labels.append(int(parts[0]))
            return sents, labels

        return {
            "train": split("msr_paraphrase_train.txt"),
            "test": split("msr_paraphrase_test.txt"),
        }
    raise ValueError(f"unknown SentEval task {task}")


def load_senteval_probing(path: str):
    """SentEval PROBING-task file -> train/dev/test transfer splits.

    One file per task (sentence_length, word_content, tree_depth,
    top_constituents, bigram_shift, past_present, subj_number, obj_number,
    odd_man_out, coordination_inversion) with rows
    ``tr|va|te \\t label \\t sentence`` (reference:
    ditto/SentEval/senteval/probing.py:40-55; label ids = sorted unique
    TRAIN labels, matching the reference's tok2label construction).
    """
    import codecs

    split_map = {"tr": "train", "va": "dev", "te": "test"}
    raw: Dict[str, Tuple[list, list]] = {v: ([], []) for v in split_map.values()}
    with codecs.open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3 or parts[0] not in split_map:
                continue
            sents, labs = raw[split_map[parts[0]]]
            sents.append(parts[-1])
            labs.append(parts[1])
    tok2label = {l: i for i, l in enumerate(sorted(set(raw["train"][1])))}
    return {
        split: (sents, [tok2label[l] for l in labs])
        for split, (sents, labs) in raw.items()
    }


def load_relatedness_files(task_dir: str, fmt: str = "tsv"):
    """STS-B / SICK relatedness splits -> {"train"/"test": (s1, s2, scores)}.

    Formats (reference data layouts consumed by SentEval's sts.py/sick.py):
      - "sick":  SICK_train.txt / SICK_test_annotated.txt, tab columns
                 pair_ID, sentence_A, sentence_B, relatedness_score, ...
      - "stsb":  sts-train.csv / sts-test.csv, tab columns
                 genre, file, year, id, score, sentence1, sentence2
      - "tsv":   train.tsv / test.tsv with score\\tsent1\\tsent2
    """
    import os

    def rows(path):
        with open(path, encoding="utf-8") as f:
            return [l.rstrip("\n").split("\t") for l in f if l.strip()]

    if fmt == "sick":
        def split(name):
            a, b, s = [], [], []
            for r in rows(os.path.join(task_dir, name))[1:]:  # header
                if len(r) >= 4:
                    a.append(r[1])
                    b.append(r[2])
                    s.append(float(r[3]))
            return a, b, s

        return {"train": split("SICK_train.txt"),
                "test": split("SICK_test_annotated.txt")}
    if fmt == "stsb":
        def split(name):
            a, b, s = [], [], []
            for r in rows(os.path.join(task_dir, name)):
                if len(r) >= 7:
                    s.append(float(r[4]))
                    a.append(r[5])
                    b.append(r[6])
            return a, b, s

        return {"train": split("sts-train.csv"), "test": split("sts-test.csv")}
    if fmt == "tsv":
        def split(name):
            a, b, s = [], [], []
            for r in rows(os.path.join(task_dir, name)):
                if len(r) >= 3:
                    s.append(float(r[0]))
                    a.append(r[1])
                    b.append(r[2])
            return a, b, s

        return {"train": split("train.tsv"), "test": split("test.tsv")}
    raise ValueError(fmt)
