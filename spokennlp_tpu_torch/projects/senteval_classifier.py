"""SentEval-protocol classifier over frozen embeddings, on PyTorch.

Counterpart of ``spokennlp_tpu/projects/senteval_classifier.py``, itself
faithful to ditto's vendored SentEval classifier (reference:
ditto/SentEval/senteval/tools/classifier.py):

  model      nhid=0 -> Linear(in, ncls) (logistic regression);
             nhid>0 -> Linear -> Dropout -> **Sigmoid** -> Linear
  loss       summed cross entropy (loss_fn.size_average = False)
  optimizer  adam lr 1e-3 with COUPLED L2: ``torch.optim.Adam(weight_decay=
             l2)`` adds l2 * w to the gradient before the moment updates,
             which is JAX's ``optax.chain(add_decayed_weights(l2),
             adam(lr))`` (``AdamW``'s decoupled decay is not)
  fit        epochs of ``epoch_size`` full passes; early stopping when dev
             accuracy fails to improve ``tenacity`` times; best dev model
             restored (classifier.py:61-85)
  reg grid   l2 in {1e-5, 1e-4, 1e-3, 1e-2} (tools/validation.py:61)

The weights are drawn with numpy (``_init_params``) and the batches follow
numpy's permutations from the same ``default_rng(seed)``, as in JAX, so both
packages start from the same weights and see the same batches. The model
(``MLPClassifier``) names its parameters after JAX's tree (``out.w``,
``out.b``, ``hid.w``, ``hid.b``) and trains on ``device`` (the card unless
the caller asks for the CPU); dropout, when ``cfg.dropout`` > 0, draws from
a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

REG_GRID = (1e-5, 1e-4, 1e-3, 1e-2)  # validation.py:61 (usepytorch branch)


@dataclasses.dataclass
class MLPParams:
    nhid: int = 0  # 0 = logistic regression (the Ditto protocol)
    optim_lr: float = 1e-3  # torch adam default
    tenacity: int = 5
    epoch_size: int = 4
    max_epoch: int = 200
    dropout: float = 0.0
    batch_size: int = 64


class _Linear(nn.Module):
    """JAX's ``{"w": (din, dout), "b": (dout,)}``."""

    def __init__(self, w: np.ndarray, b: np.ndarray):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(np.array(w, np.float32)))
        self.b = nn.Parameter(torch.from_numpy(np.array(b, np.float32)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class MLPClassifier(nn.Module):
    """The probe: ``out`` alone (nhid = 0) or ``hid`` -> dropout -> sigmoid
    -> ``out``, from a tree of numpy arrays."""

    def __init__(self, params, dropout: float = 0.0):
        super().__init__()
        self.hid = _Linear(**params["hid"]) if "hid" in params else None
        self.out = _Linear(**params["out"])
        self.rate = dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if self.hid is None:
            return self.out(x)
        h = self.hid(x)
        if self.training and self.rate > 0:
            keep = torch.rand(h.shape, generator=generator, device=h.device) < 1 - self.rate
            h = torch.where(keep, h / (1 - self.rate), 0.0)
        return self.out(torch.sigmoid(h))  # classifier.py:193 (Sigmoid, not ReLU)


class SentEvalMLP:
    """scikit-style fit/score over frozen embeddings (one (l2, seed) run)."""

    def __init__(self, inputdim: int, nclasses: int, l2reg: float = 0.0,
                 cfg: Optional[MLPParams] = None, seed: int = 1111, device="cuda"):
        self.cfg = cfg or MLPParams()
        self.inputdim = inputdim
        self.nclasses = nclasses
        self.l2reg = l2reg
        self.seed = seed
        self.device = torch.device(device)
        self.model: Optional[MLPClassifier] = None

    def _init_params(self, rng: np.random.Generator):
        c = self.cfg

        def linear(din, dout):
            # torch nn.Linear init: U(-1/sqrt(din), 1/sqrt(din))
            bound = 1.0 / np.sqrt(din)
            return {
                "w": rng.uniform(-bound, bound, size=(din, dout)).astype(np.float32),
                "b": rng.uniform(-bound, bound, size=(dout,)).astype(np.float32),
            }

        if c.nhid == 0:
            return {"out": linear(self.inputdim, self.nclasses)}
        return {
            "hid": linear(self.inputdim, c.nhid),
            "out": linear(c.nhid, self.nclasses),
        }

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    @torch.no_grad()
    def _predict(self, model: MLPClassifier, X) -> np.ndarray:
        model.eval()
        return torch.argmax(model(self._tensor(X)), -1).cpu().numpy()

    def fit(self, X, y, validation_data: Tuple[np.ndarray, np.ndarray]) -> float:
        c = self.cfg
        rng = np.random.default_rng(self.seed)
        model = MLPClassifier(self._init_params(rng), c.dropout).to(self.device)
        opt = torch.optim.Adam(model.parameters(), lr=c.optim_lr, weight_decay=self.l2reg)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        devX, devy = validation_data
        Xt, yt = self._tensor(X), self._tensor(y, torch.long)

        best_acc, best_state = -1.0, None
        early = 0
        n = len(X)
        epoch = 0
        while epoch <= c.max_epoch:
            model.train()
            for _ in range(c.epoch_size):
                perm = rng.permutation(n)
                for i in range(0, n, c.batch_size):
                    idx = torch.from_numpy(perm[i : i + c.batch_size]).to(self.device)
                    logp = F.log_softmax(model(Xt[idx], gen), -1)
                    # summed CE: classifier.py:200 size_average = False
                    loss = -logp.gather(1, yt[idx, None]).sum()
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
            epoch += c.epoch_size
            acc = float((self._predict(model, devX) == devy).mean())
            if acc > best_acc:
                best_acc = acc
                best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
                early = 0
            else:
                if early >= c.tenacity:
                    break
                early += 1
        model.load_state_dict(best_state)
        self.model = model
        return best_acc

    def score(self, X, y) -> float:
        return float((self._predict(self.model, X) == y).mean())


def fit_with_reg_grid(
    Xtr, ytr, Xval, yval, nclasses: int, cfg: Optional[MLPParams] = None,
    reg_grid: Sequence[float] = REG_GRID, seed: int = 1111, device="cuda",
) -> Tuple[SentEvalMLP, float, float]:
    """Pick l2 on (Xval, yval), keep the best fitted model.

    SplitClassifier semantics (validation.py): the model trained during the
    grid IS the final model (train split only; no retrain on train+dev).
    Returns (fitted_clf, best_reg, best_dev_acc)."""
    best = (None, reg_grid[0], -1.0)
    for reg in reg_grid:
        clf = SentEvalMLP(Xtr.shape[1], nclasses, l2reg=reg, cfg=cfg, seed=seed, device=device)
        acc = clf.fit(Xtr, ytr, validation_data=(Xval, yval))
        if acc > best[2]:
            best = (clf, reg, acc)
    return best
