"""BigBird block-sparse attention (ITC), PyTorch.

The port's copy of ``spokennlp_tpu/ops/bigbird_attention.py``. Every query
block of ``block_size`` rows attends to its own and the adjacent blocks
(clamped at the edges), the first ``num_global_blocks`` blocks (global keys)
and ``num_random_blocks`` random blocks; global-block queries attend to every
key and are attended by every query. The random assignment is drawn on the
host from a seeded numpy generator into a static (nb, G + 3 + R) table, the
same table as the JAX package's for the same arguments.

- ``bigbird_attention_bias``: the (B, 1, L, L) additive bias, the oracle and
  the short-sequence path;
- ``bigbird_block_sparse_attention``: the gather path, O(L K block) memory;
- ``bigbird_tables``: what the CUDA kernels read instead of the table: the
  random tail, its validity flags (the first-occurrence dedup) and, for the
  backward, the inverse (key block -> query entries) table, cached on the
  device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

NEG_INF = -1e9


def bigbird_block_indices(
    num_blocks: int,
    num_global_blocks: int = 2,
    num_random_blocks: int = 3,
    seed: int = 0,
) -> np.ndarray:
    """Static (num_blocks, K) key-block index table.

    K = num_global + 3 (prev/self/next, clamped at edges) + num_random.
    Random blocks are drawn per query block without replacement from the
    non-global, non-window blocks (falling back to the window blocks when
    the sequence is too short to have enough candidates).
    """
    g, r = num_global_blocks, num_random_blocks
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(num_blocks):
        window = [max(i - 1, 0), i, min(i + 1, num_blocks - 1)]
        fixed = list(range(min(g, num_blocks))) + window
        cand = [
            b
            for b in range(num_blocks)
            if b not in fixed
        ]
        take = min(r, len(cand))
        rand = list(rng.choice(cand, size=take, replace=False)) if take else []
        # pad with self so the row is fixed-width (duplicates are harmless:
        # the mask dedups nothing but softmax normalizes over allowed keys —
        # duplicated blocks are masked below via a first-occurrence mask)
        while len(rand) < r:
            rand.append(i)
        rows.append(fixed + rand)
    return np.asarray(rows, np.int32)  # (nq, g + 3 + r)


def _first_occurrence_mask(indices: np.ndarray) -> np.ndarray:
    """(nq, K) bool: True where this column is the first occurrence of the
    block id in its row (so duplicated blocks don't double-count keys)."""
    nq, K = indices.shape
    mask = np.zeros((nq, K), bool)
    for i in range(nq):
        seen = set()
        for j in range(K):
            b = int(indices[i, j])
            if b not in seen:
                seen.add(b)
                mask[i, j] = True
    return mask


def bigbird_attention_bias(
    attention_mask: torch.Tensor,  # (B, L) 1 = real
    block_size: int,
    num_global_blocks: int = 2,
    num_random_blocks: int = 3,
    seed: int = 0,
    neg_inf: float = NEG_INF,
) -> torch.Tensor:
    """(B, 1, L, L) float32 additive bias materialising the BigBird pattern
    (the oracle and the short-sequence path; the block path's exact twin)."""
    B, L = attention_mask.shape
    if L % block_size:
        raise ValueError(f"sequence length {L} is not a multiple of block_size {block_size}")
    nb = L // block_size
    idx = bigbird_block_indices(nb, num_global_blocks, num_random_blocks, seed)
    allowed_blocks = np.zeros((nb, nb), bool)
    for i in range(nb):
        allowed_blocks[i, idx[i]] = True
    G = min(num_global_blocks, nb)
    allowed_blocks[:G, :] = True
    allowed_blocks[:, :G] = True
    allowed = np.kron(allowed_blocks, np.ones((block_size, block_size), bool))
    dev = attention_mask.device
    bias = torch.where(torch.from_numpy(allowed).to(dev)[None, None], 0.0, neg_inf)
    key_pad = (1.0 - attention_mask[:, None, None, :].float()) * neg_inf
    return bias + key_pad


def bigbird_block_sparse_attention(
    q: torch.Tensor,  # (B, L, nh, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: torch.Tensor,  # (B, L)
    block_size: int,
    num_global_blocks: int = 2,
    num_random_blocks: int = 3,
    seed: int = 0,
    softmax_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """O(L K block) BigBird attention; returns (B, L, nh, hd) in q's dtype.
    Matches ``bigbird_attention_bias`` + a dense softmax on every row."""
    B, L, nh, hd = q.shape
    if L % block_size:
        raise ValueError(f"sequence length {L} is not a multiple of block_size {block_size}")
    nb, bsz = L // block_size, block_size
    G = min(num_global_blocks, nb)
    idx_np = bigbird_block_indices(nb, G, num_random_blocks, seed)
    dev = q.device
    idx = torch.from_numpy(idx_np).long().to(dev)  # (nq, K)
    occ = torch.from_numpy(_first_occurrence_mask(idx_np)).to(dev)
    K = idx.shape[1]

    scale = 1.0 / float(hd) ** 0.5
    qb = q.reshape(B, nb, bsz, nh, hd)
    kb = k.reshape(B, nb, bsz, nh, hd)
    vb = v.reshape(B, nb, bsz, nh, hd)
    mb = attention_mask.reshape(B, nb, bsz)

    # key/value blocks of each query block: (B, nq, K, b, nh, hd)
    flat = idx.reshape(-1)
    kg = kb[:, flat].reshape(B, nb, K, bsz, nh, hd)
    vg = vb[:, flat].reshape(B, nb, K, bsz, nh, hd)
    mg = mb[:, flat].reshape(B, nb, K, bsz)

    scores = torch.einsum("bqind,bqkjnd->bnqikj", qb * scale, kg).reshape(B, nh, nb, bsz, K * bsz)
    live = (mg.bool() & occ[None, :, :, None]).reshape(B, 1, nb, 1, K * bsz)
    scores = torch.where(live, scores, NEG_INF)
    probs = torch.softmax(scores.to(softmax_dtype), dim=-1).to(q.dtype)
    ctx = torch.einsum("bnqim,bqmnd->bqind", probs,
                       vg.reshape(B, nb, K * bsz, nh, hd)).reshape(B, L, nh, hd)

    # global query rows: dense attention over all keys, overwriting the first G*b
    if G > 0:
        Lg = G * bsz
        g_scores = torch.einsum("blnd,bmnd->bnlm", q[:, :Lg] * scale, k)
        pad = (1.0 - attention_mask[:, None, None, :].float()) * NEG_INF
        g_scores = g_scores + pad.to(g_scores.dtype)
        g_probs = torch.softmax(g_scores.to(softmax_dtype), -1).to(q.dtype)
        g_ctx = torch.einsum("bnlm,bmnd->blnd", g_probs, v)
        ctx = torch.cat([g_ctx, ctx[:, Lg:]], dim=1)
    return ctx


def reference_bigbird_attention(q, k, v, attention_mask, block_size, num_global_blocks=2,
                                num_random_blocks=3, seed=0):
    """Dense oracle: softmax over the materialised (L, L) bias."""
    bias = bigbird_attention_bias(attention_mask, block_size, num_global_blocks,
                                  num_random_blocks, seed)
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    scores = torch.einsum("blnd,bmnd->bnlm", q.float() * scale, k.float()) + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bnlm,bmnd->blnd", probs.to(v.dtype), v)


# ------------------------------------------------------- the kernels' tables


@dataclasses.dataclass(frozen=True)
class BigBirdTables:
    """The static pattern as the kernels read it, for nb blocks.

    ``G`` = min(num_global_blocks, nb) and ``R`` the random blocks a query
    block holds (0 when nb == 1, as the TPU kernels take it); ``rand`` (nb,
    R) the random key blocks and ``rok`` (nb, R) 1 where the entry is a real
    random block, 0 where it is the padded-self fallback of a short sequence
    (int32, on the device). ``inv_offsets`` (nb + 1) and ``inv_entries``
    (int32) list, for each key block j, the entries i * R + r with rand[i, r]
    == j, rok[i, r] == 1 and i >= G (a global query block attends densely,
    its random entries are dead), in increasing order: the query blocks that
    reach key block j through a random entry, for the backward's key-owned
    sums."""

    G: int
    R: int
    rand: torch.Tensor
    rok: torch.Tensor
    inv_offsets: torch.Tensor
    inv_entries: torch.Tensor


def random_tail(nb: int, num_global_blocks: int, num_random_blocks: int, seed: int):
    """(G, R, rand (nb, R) int32, rok (nb, R) int32) on the host: the random
    tail of ``bigbird_block_indices`` and its validity flags, as the TPU
    kernels build them (an entry whose block already occurs earlier in its
    row, the padded-self fallback, gets rok = 0)."""
    G = min(num_global_blocks, nb)
    R = num_random_blocks if nb > 1 else 0
    idx = bigbird_block_indices(nb, G, num_random_blocks, seed)
    rand = np.ascontiguousarray(idx[:, G + 3: G + 3 + R], np.int32)
    rok = np.ones_like(rand)
    for i in range(nb):
        seen = set(int(b) for b in idx[i, : G + 3])
        for r in range(R):
            b = int(rand[i, r])
            if b in seen:
                rok[i, r] = 0
            seen.add(b)
    return G, R, rand, rok


@functools.lru_cache(maxsize=None)
def _tables(nb: int, num_global_blocks: int, num_random_blocks: int, seed: int,
            device: str) -> BigBirdTables:
    G, R, rand, rok = random_tail(nb, num_global_blocks, num_random_blocks, seed)
    per_key = [[] for _ in range(nb)]
    for i in range(G, nb):
        for r in range(R):
            if rok[i, r]:
                per_key[int(rand[i, r])].append(i * R + r)
    offsets = np.cumsum([0] + [len(e) for e in per_key]).astype(np.int32)
    entries = np.asarray([e for es in per_key for e in es] or [0], np.int32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    # a zero-width table still needs an address
    return BigBirdTables(G, R, to(rand if R else np.zeros((nb, 1), np.int32)),
                         to(rok if R else np.zeros((nb, 1), np.int32)), to(offsets), to(entries))


def bigbird_tables(nb: int, num_global_blocks: int, num_random_blocks: int, seed: int,
                   device) -> BigBirdTables:
    """The kernels' tables for this pattern, built once per (nb, G, R, seed,
    device) and then served from a cache."""
    return _tables(int(nb), int(num_global_blocks), int(num_random_blocks), int(seed),
                   str(torch.device(device)))
