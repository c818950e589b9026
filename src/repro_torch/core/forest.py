"""Random Forest / Gradient Boosting with *oblivious* trees (paper §III-B).

The paper trains classic Random Forests (plus Gradient Boosting as the
Table III comparison) with *oblivious* trees — every node at depth d of a
tree shares one (feature, threshold) — so inference is a fixed walk: D
feature reads, D compares, a bit-packed leaf index and one leaf lookup
per tree, which `repro_torch.kernels.forest` runs on the card. Training
is host-side numpy (a once-a-day background job in the paper), carried
over unchanged from `repro.core.forest` so that the same seed trains the
same arrays.

`predict_proba_np` is the numpy oracle; `repro_torch.kernels.forest.ref`
mirrors it in torch and the CUDA kernel is held against both.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ObliviousForest:
    """Ensemble of oblivious trees.

    feat_idx:    (n_trees, depth) int32 — feature tested at each level
    thresholds:  (n_trees, depth) float32 — go right iff x[f] > t
    leaf_values: (n_trees, 2**depth, n_out) float32 — per-leaf outputs
    kind:        'rf' (leaf = class-prob vector, averaged) or
                 'gb' (leaf = logit increments, summed then softmax)
    """
    feat_idx: np.ndarray
    thresholds: np.ndarray
    leaf_values: np.ndarray
    kind: str
    n_features: int

    @property
    def n_trees(self) -> int:
        return self.feat_idx.shape[0]

    @property
    def depth(self) -> int:
        return self.feat_idx.shape[1]

    @property
    def n_out(self) -> int:
        return self.leaf_values.shape[2]

    def leaf_index_np(self, x: np.ndarray) -> np.ndarray:
        """(B, F) -> (B, n_trees) leaf indices."""
        gathered = x[:, self.feat_idx.reshape(-1)].reshape(
            x.shape[0], self.n_trees, self.depth)
        bits = (gathered > self.thresholds[None]).astype(np.int64)
        weights = (2 ** np.arange(self.depth))[::-1]
        return (bits * weights[None, None, :]).sum(-1)

    def predict_proba_np(self, x: np.ndarray) -> np.ndarray:
        """(B, F) -> (B, n_out) class probabilities (numpy oracle)."""
        leaves = self.leaf_index_np(np.asarray(x, np.float32))
        vals = self.leaf_values[np.arange(self.n_trees)[None, :], leaves]
        if self.kind == "rf":
            return vals.mean(axis=1)
        logits = vals.sum(axis=1)
        logits = logits - logits.max(-1, keepdims=True)
        e = np.exp(logits)
        return e / e.sum(-1, keepdims=True)

    def predict_np(self, x: np.ndarray):
        """Returns (predicted class, confidence). Confidence = max prob —
        the Resource-Central-style score the scheduler gates on (>= 0.6)."""
        p = self.predict_proba_np(x)
        return p.argmax(-1), p.max(-1)


def _fit_oblivious_tree(x: np.ndarray, y: np.ndarray, depth: int,
                        rng: np.random.Generator,
                        feature_frac: float = 1.0,
                        n_thresholds: int = 15) -> tuple:
    """Fit one oblivious regression tree to targets y (B, K) by greedy
    level-wise (feature, threshold) selection maximizing variance
    reduction. Returns (feat_idx (d,), thresholds (d,), leaf_sum
    (2**d, K), leaf_cnt (2**d,))."""
    n, n_feat = x.shape
    k = y.shape[1]
    leaf = np.zeros(n, dtype=np.int64)
    feats, thrs = [], []
    for level in range(depth):
        n_leaves = 1 << level
        if feature_frac < 1.0:
            cand_feats = rng.choice(
                n_feat, max(1, int(feature_frac * n_feat)), replace=False)
        else:
            cand_feats = np.arange(n_feat)
        best = (-np.inf, 0, 0.0)
        for f in cand_feats:
            col = x[:, f]
            qs = np.quantile(col, np.linspace(0.05, 0.95, n_thresholds))
            for t in np.unique(qs):
                bit = (col > t).astype(np.int64)
                new_leaf = leaf * 2 + bit
                cnt = np.bincount(new_leaf, minlength=n_leaves * 2) + 1e-9
                score = 0.0
                for c in range(k):
                    s = np.bincount(new_leaf, weights=y[:, c],
                                    minlength=n_leaves * 2)
                    score += float((s * s / cnt).sum())
                if score > best[0]:
                    best = (score, f, float(t))
        _, f, t = best
        feats.append(f)
        thrs.append(t)
        leaf = leaf * 2 + (x[:, f] > t).astype(np.int64)
    n_leaves = 1 << depth
    cnt = np.bincount(leaf, minlength=n_leaves).astype(np.float64)
    sums = np.stack([np.bincount(leaf, weights=y[:, c], minlength=n_leaves)
                     for c in range(y.shape[1])], axis=1)
    return (np.array(feats, np.int32), np.array(thrs, np.float32),
            sums, cnt)


def train_random_forest(x: np.ndarray, y: np.ndarray, n_classes: int,
                        n_trees: int = 48, depth: int = 6,
                        feature_frac: float = 0.6,
                        seed: int = 0) -> ObliviousForest:
    """Bagged oblivious-forest classifier. y: (B,) int class labels."""
    x = np.asarray(x, np.float32)
    rng = np.random.default_rng(seed)
    onehot = np.eye(n_classes, dtype=np.float64)[y]
    n = x.shape[0]
    fi, th, lv = [], [], []
    prior = onehot.mean(0)
    for _ in range(n_trees):
        idx = rng.integers(0, n, n)                     # bootstrap
        f, t, sums, cnt = _fit_oblivious_tree(
            x[idx], onehot[idx], depth, rng, feature_frac)
        # Laplace-smoothed leaf class probabilities; empty leaves -> prior
        probs = (sums + prior[None] * 2.0) / (cnt[:, None] + 2.0)
        fi.append(f); th.append(t); lv.append(probs.astype(np.float32))
    return ObliviousForest(np.stack(fi), np.stack(th), np.stack(lv),
                           kind="rf", n_features=x.shape[1])


def train_gradient_boosting(x: np.ndarray, y: np.ndarray, n_classes: int,
                            n_trees: int = 48, depth: int = 4,
                            learning_rate: float = 0.25,
                            seed: int = 0) -> ObliviousForest:
    """Softmax gradient boosting with oblivious trees (Table III 'GB').

    Each round fits one tree per run to the multiclass gradient; leaf
    values are Newton steps on the softmax loss.
    """
    x = np.asarray(x, np.float32)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    onehot = np.eye(n_classes, dtype=np.float64)[y]
    logits = np.zeros((n, n_classes))
    fi, th, lv = [], [], []
    for _ in range(n_trees):
        m = logits - logits.max(-1, keepdims=True)
        p = np.exp(m); p /= p.sum(-1, keepdims=True)
        grad = onehot - p                               # negative gradient
        f, t, sums, cnt = _fit_oblivious_tree(x, grad, depth, rng)
        hess = np.maximum(p * (1 - p), 1e-6)
        hsum = np.zeros_like(sums)
        leaf = ObliviousForest(f[None], t[None], np.zeros((1, 1 << depth, 1),
                               np.float32), "gb", x.shape[1]
                               ).leaf_index_np(x)[:, 0]
        for c in range(n_classes):
            hsum[:, c] = np.bincount(leaf, weights=hess[:, c],
                                     minlength=1 << depth)
        step = learning_rate * sums / (hsum + 1.0)
        logits += step[leaf]
        fi.append(f); th.append(t); lv.append(step.astype(np.float32))
    return ObliviousForest(np.stack(fi), np.stack(th), np.stack(lv),
                           kind="gb", n_features=x.shape[1])


def evaluate(forest: ObliviousForest, x: np.ndarray, y: np.ndarray,
             confidence: float = 0.6) -> dict:
    """Paper Table III metrics: % high-confidence predictions, per-bucket
    recall/precision among high-confidence predictions, and accuracy."""
    pred, conf = forest.predict_np(x)
    hi = conf >= confidence
    out = {"pct_high_conf": float(hi.mean()),
           "accuracy_high_conf": float((pred[hi] == y[hi]).mean())
           if hi.any() else float("nan"),
           "buckets": {}}
    for c in np.unique(y):
        tp = int(((pred == c) & (y == c) & hi).sum())
        fn = int(((pred != c) & (y == c) & hi).sum())
        fp = int(((pred == c) & (y != c) & hi).sum())
        out["buckets"][int(c)] = {
            "recall": tp / max(tp + fn, 1),
            "precision": tp / max(tp + fp, 1)}
    return out
