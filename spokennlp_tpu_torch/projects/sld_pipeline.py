"""SLD host-side pipeline: manifests, k-means quantization, speech-token BPE,
on PyTorch.

Counterpart of ``spokennlp_tpu/projects/sld_pipeline.py``, which rebuilds
the reference's 8-stage shell pipeline (reference: sld/run.sh:51-280) as
library functions:

  stage 1  audio manifests (fairseq wav2vec style tsv)        -> make_manifest
  stage 2  frozen-encoder feature dumping (WavLM layer-k)     -> dump_wavlm_features
           (models/wavlm.py on ``device``, the card by default; the HF
           weights are read without ``transformers``)
  stage 3  MiniBatchKMeans over sampled features              -> learn_kmeans
  stage 4  nearest-centroid speech tokens                     -> apply_kmeans
  stage 6  subword vocab over space-joined speech tokens      -> train_bpe
           (a standard BPE trainer over whitespace-separated symbols, as
           in JAX: sentencepiece is not used)
  stage 7  training                                           -> cli/run_sld.py

The host functions are copies of JAX's (the same outputs); sklearn is
imported where JAX imports it (``learn_kmeans``). JAX's ``device="tpu"`` /
``"torch"`` switch of stage 2 becomes a torch ``device``.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from spokennlp_tpu_torch.models.wavlm import extract_wavlm_features


# ------------------------------------------------------------------ manifests


def make_manifest(
    root: str, ext: str = "flac", valid_percent: float = 0.01, seed: int = 42
) -> Dict[str, List[str]]:
    """Walk ``root`` for audio files -> {"train": [...], "valid": [...]} tsv
    lines "relpath\tnum_frames" with the root dir as line 0 (fairseq
    wav2vec_manifest format; reference: fairseq/examples/wav2vec/
    wav2vec_manifest.py)."""
    rng = np.random.default_rng(seed)
    rows = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fname in sorted(files):
            if fname.endswith("." + ext):
                path = os.path.relpath(os.path.join(dirpath, fname), root)
                rows.append(f"{path}\t0")
    train, valid = [root], [root]
    for r in rows:
        (valid if rng.random() < valid_percent else train).append(r)
    return {"train": train, "valid": valid}


# -------------------------------------------------------------------- kmeans


def learn_kmeans(
    features: np.ndarray,
    n_clusters: int = 2000,
    seed: int = 0,
    batch_size: int = 10000,
    max_iter: int = 100,
    percent: float = 1.0,
):
    """MiniBatchKMeans over (optionally sampled) features
    (reference: simple_kmeans/learn_kmeans.py:25-112)."""
    from sklearn.cluster import MiniBatchKMeans

    if percent < 1.0:
        rng = np.random.default_rng(seed)
        n = int(len(features) * percent)
        idx = rng.choice(len(features), size=n, replace=False)
        features = features[idx]
    km = MiniBatchKMeans(
        n_clusters=n_clusters,
        random_state=seed,
        batch_size=batch_size,
        max_iter=max_iter,
        n_init="auto",
        compute_labels=False,
    )
    km.fit(features)
    return km


def apply_kmeans(km, features: np.ndarray) -> np.ndarray:
    """Nearest-centroid tokens (reference: dump_km.py). Vectorized
    ||x - c||^2 = |x|^2 - 2 x.c + |c|^2 argmin."""
    C = km.cluster_centers_.astype(np.float32)
    x = features.astype(np.float32)
    d = (
        (x**2).sum(-1, keepdims=True)
        - 2.0 * x @ C.T
        + (C**2).sum(-1)[None, :]
    )
    return np.argmin(d, axis=-1)


def speed_perturb(waveform: np.ndarray, factor: float) -> np.ndarray:
    """Speed perturbation by resampling (reference: sld/run.sh:106-118 dumps
    features at speeds 0.9/1.0/1.1 via torchaudio Resample).

    factor > 1 speeds up (shorter output), < 1 slows down. Band-limited
    linear interpolation over the time axis — adequate for the k-means
    feature path, no torch dependency.
    """
    if factor == 1.0:
        return np.asarray(waveform)
    w = np.asarray(waveform, np.float32)
    n = w.shape[-1]
    m = max(int(round(n / factor)), 1)
    src = np.linspace(0.0, n - 1, m)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    frac = (src - lo).astype(np.float32)
    return w[..., lo] * (1.0 - frac) + w[..., hi] * frac


def dedupe_runs(tokens: Sequence[int]) -> List[int]:
    """Collapse consecutive repeats (speech-token convention)."""
    out: List[int] = []
    for t in tokens:
        if not out or out[-1] != t:
            out.append(int(t))
    return out


# ---------------------------------------------------------------------- BPE


def train_bpe(
    corpus_lines: Iterable[str], vocab_size: int = 6000
) -> List[Tuple[str, str]]:
    """Byte-pair-encoding merges over whitespace-separated symbol sequences.

    Operates at the line level (a line = one utterance of space-joined speech
    tokens). Returns the ordered merge list.
    """
    seqs = [tuple(line.split()) for line in corpus_lines if line.strip()]
    base_vocab = {s for seq in seqs for s in seq}
    merges: List[Tuple[str, str]] = []
    counts = collections.Counter(seqs)

    while len(base_vocab) + len(merges) < vocab_size:
        pair_counts: collections.Counter = collections.Counter()
        for seq, c in counts.items():
            for a, b in zip(seq, seq[1:]):
                pair_counts[(a, b)] += c
        if not pair_counts:
            break
        (a, b), freq = pair_counts.most_common(1)[0]
        if freq < 2:
            break
        merges.append((a, b))
        merged = a + "▁" + b  # joiner marker
        new_counts: collections.Counter = collections.Counter()
        for seq, c in counts.items():
            out = []
            i = 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            new_counts[tuple(out)] += c
        counts = new_counts
    return merges


def bpe_encode(tokens: Sequence[str], merges: Sequence[Tuple[str, str]]) -> List[str]:
    """Apply merges greedily in training order."""
    seq = list(tokens)
    rank = {pair: i for i, pair in enumerate(merges)}
    while len(seq) > 1:
        best = None
        best_rank = None
        for i, pair in enumerate(zip(seq, seq[1:])):
            r = rank.get(pair)
            if r is not None and (best_rank is None or r < best_rank):
                best, best_rank = i, r
        if best is None:
            break
        a, b = seq[best], seq[best + 1]
        seq[best : best + 2] = [a + "▁" + b]
    return seq


# ------------------------------------------------------- feature extraction


def dump_wavlm_features(
    wav_arrays: Sequence[np.ndarray],
    layer: int = 23,
    model_name: str = "microsoft/wavlm-large",
    device: str = "cuda",
    max_chunk: int = 1_600_000,
) -> List[np.ndarray]:
    """Frozen WavLM layer-k features (reference: simple_kmeans/
    dump_wavlm_feature.py:38-112): the port's WavLM (models/wavlm.py) with
    the weights of the local HF directory ``model_name`` (a WavLM or, its
    ``model_type`` says so, a HuBERT checkpoint; reference alternative
    dumper: simple_kmeans/dump_hubert_feature.py), on ``device``, streaming
    ``max_chunk`` windows per utterance."""
    model = load_feature_model(model_name, device)
    return [
        extract_wavlm_features(
            model, np.asarray(wav, np.float32)[None, :], layer, chunk_samples=max_chunk,
        )[0]
        for wav in wav_arrays
    ]


def load_feature_model(model_name: str, device: str = "cuda"):
    """The port's WavLM / HuBERT with the weights of the local HF directory
    ``model_name``, in eval mode on ``device`` (a card raises when none is
    present)."""
    import torch

    from spokennlp_tpu_torch.cli.run_inference import resolve_device
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.models.wavlm import WavLMModel, read_wavlm_checkpoint

    device = resolve_device(str(device))
    cfg, params = read_wavlm_checkpoint(model_name)
    with torch.device(device):
        model = WavLMModel(cfg)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


# ------------------------------------------------------ stage orchestration


def read_wav(path: str) -> np.ndarray:
    """16-bit PCM wav -> float32 in [-1, 1] (stdlib; no torchaudio)."""
    import wave

    with wave.open(path, "rb") as w:
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        ch = w.getnchannels()
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x


def make_labels(manifest_lines: Sequence[str], transcript_map: Dict[str, str]):
    """Word transcripts aligned to a manifest (reference: fairseq/examples/
    wav2vec/libri_labels.py extracts .wrd lines per manifest row)."""
    out = []
    for line in manifest_lines[1:]:  # line 0 = root
        rel = line.split("\t")[0]
        key = os.path.splitext(os.path.basename(rel))[0]
        out.append(transcript_map.get(rel, transcript_map.get(key, "")))
    return out


def run_sld_stages(
    audio_dir: str,
    transcript_file: str,
    work_dir: str,
    start_stage: int = 1,
    stop_stage: int = 7,
    speeds: Sequence[float] = (0.9, 1.0, 1.1),
    nshard: int = 1,
    rank: Optional[int] = None,
    feature_fn=None,
    layer: int = 23,
    model_name: str = "microsoft/wavlm-large",
    n_clusters: int = 100,
    kmeans_percent: float = 0.1,
    bpe_vocab_size: int = 200,
    valid_percent: float = 0.1,
    seed: int = 42,
    train_kwargs: Optional[Dict] = None,
    device: str = "cuda",
) -> Dict:
    """The reference's 8-stage pipeline (sld/run.sh:51-280) as one function.

      1 manifests        3 learn k-means      5 join tokens+text jsonl
      2 feature dump     4 dump .km tokens    6 speech-token BPE
      (speed-perturbed, sharded over ranks)   7 train (cli/run_sld)

    Stage 2 fans out like the reference's per-(speed, shard) GPU jobs
    (run.sh:104-130): with ``rank`` set, only that shard's features are
    dumped (run one process per rank); with rank=None all shards run
    serially. k-means uses speed 1.0 features only, like the reference.
    ``feature_fn(wave) -> (frames, D)`` defaults to the port's WavLM tap at
    ``layer`` (models/wavlm.py) with weights from ``model_name``, on
    ``device``; stage 7 trains on ``device`` too, unless ``train_kwargs``
    names another.
    """
    import json

    os.makedirs(work_dir, exist_ok=True)
    state: Dict = {}
    # k-means / BPE / eval run on the unperturbed speed when present,
    # otherwise the first configured speed (speed-only ablations)
    base_speed = 1.0 if 1.0 in speeds else speeds[0]

    def stage_on(i):
        return start_stage <= i <= stop_stage

    man_path = os.path.join(work_dir, "manifests.json")
    if stage_on(1):
        manifests = make_manifest(
            audio_dir, ext="wav", valid_percent=valid_percent, seed=seed
        )
        tmap: Dict[str, str] = {}
        with open(transcript_file) as f:
            for line in f:
                if "\t" in line:
                    k, v = line.rstrip("\n").split("\t", 1)
                    tmap[k] = v
        labels = {s: make_labels(manifests[s], tmap) for s in manifests}
        with open(man_path, "w") as f:
            json.dump({"manifests": manifests, "labels": labels}, f)
    if stop_stage < 2:
        return state
    with open(man_path) as f:
        man = json.load(f)
    manifests, labels = man["manifests"], man["labels"]

    if feature_fn is None and stage_on(2):
        model = load_feature_model(model_name, device)

        def feature_fn(wave):
            return extract_wavlm_features(model, wave[None], layer)[0]

    feat_dir = os.path.join(work_dir, "feats")
    os.makedirs(feat_dir, exist_ok=True)
    if stage_on(2):
        ranks = [rank] if rank is not None else list(range(nshard))
        for split in manifests:
            rows = manifests[split][1:]
            for speed in speeds:
                for r in ranks:
                    shard_rows = rows[r::nshard]
                    feats, lens = [], []
                    for row in shard_rows:
                        wav = read_wav(os.path.join(audio_dir, row.split("\t")[0]))
                        wav = speed_perturb(wav, speed)
                        f = np.asarray(feature_fn(wav), np.float32)
                        feats.append(f)
                        lens.append(len(f))
                    tag = f"{split}_sp{speed}_{r}_{nshard}"
                    np.save(
                        os.path.join(feat_dir, tag + ".npy"),
                        np.concatenate(feats, 0) if feats else np.zeros((0, 1)),
                    )
                    np.save(os.path.join(feat_dir, tag + ".len.npy"),
                            np.asarray(lens, np.int64))

    km_path = os.path.join(work_dir, "kmeans_centers.npy")
    if stage_on(3):
        # k-means on unperturbed train features across all shards (run.sh
        # stage 3 samples ~10% of speed-1.0 features)
        parts = [
            np.load(os.path.join(feat_dir, f"train_sp{base_speed}_{r}_{nshard}.npy"))
            for r in range(nshard)
        ]
        allfeat = np.concatenate([p for p in parts if len(p)], 0)
        km = learn_kmeans(
            allfeat, n_clusters=min(n_clusters, max(len(allfeat) // 2, 2)),
            seed=seed, percent=kmeans_percent if len(allfeat) > 100 else 1.0,
        )
        np.save(km_path, km.cluster_centers_)
        state["kmeans"] = km

    class _KM:  # apply_kmeans duck type
        pass

    if stage_on(4) or stage_on(5):
        km = _KM()
        km.cluster_centers_ = np.load(km_path)

    tokens_path = os.path.join(work_dir, "speech_tokens.json")
    if stage_on(4):
        tokens: Dict[str, Dict[str, list]] = {}
        for split in manifests:
            tokens[split] = {}
            for speed in speeds:
                rows_tokens = [None] * len(manifests[split][1:])
                for r in range(nshard):
                    tag = f"{split}_sp{speed}_{r}_{nshard}"
                    flat = np.load(os.path.join(feat_dir, tag + ".npy"))
                    lens = np.load(os.path.join(feat_dir, tag + ".len.npy"))
                    pos = 0
                    for j, ln in enumerate(lens):
                        toks = apply_kmeans(km, flat[pos : pos + ln])
                        rows_tokens[r + j * nshard] = dedupe_runs(toks.tolist())
                        pos += ln
                tokens[split][str(speed)] = rows_tokens
        with open(tokens_path, "w") as f:
            json.dump(tokens, f)

    join_paths = {}
    if stage_on(5):
        with open(tokens_path) as f:
            tokens = json.load(f)
        for split in manifests:
            path = os.path.join(work_dir, f"{split}.jsonl")
            with open(path, "w") as f:
                for speed in speeds if split == "train" else [base_speed]:
                    for toks, text in zip(tokens[split][str(speed)], labels[split]):
                        if toks and text:
                            f.write(json.dumps(
                                {"speech_tokens": toks, "text": text}) + "\n")
            join_paths[split] = path
        state["join_paths"] = join_paths

    if stage_on(6):
        with open(tokens_path) as f:
            tokens = json.load(f)
        corpus = [
            " ".join(str(t) for t in row)
            for row in tokens["train"][str(base_speed)]
            if row
        ]
        merges = train_bpe(corpus, vocab_size=bpe_vocab_size)
        with open(os.path.join(work_dir, "bpe_merges.txt"), "w") as f:
            for a, b in merges:
                f.write(f"{a} {b}\n")
        state["bpe_merges"] = merges

    if stage_on(7):
        from spokennlp_tpu_torch.cli import run_sld

        kw = {"device": str(device), **(train_kwargs or {})}
        args = [
            "--train_file", os.path.join(work_dir, "train.jsonl"),
            "--eval_file", os.path.join(work_dir, "valid.jsonl"),
            "--output_dir", os.path.join(work_dir, "train_out"),
        ]
        for k, v in kw.items():
            args += [f"--{k}", str(v)]
        state["train_result"] = run_sld.main(args)
    return state
