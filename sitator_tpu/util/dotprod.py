"""``DotProdClassifier`` — API-parity wrapper over the on-device clustering.

Reference parity: ``sitator/util/DotProdClassifier.py`` (SURVEY.md §3.7).
The reference's online Python loop is replaced by the matmul formulation in
:mod:`sitator_tpu.ops.cluster`; this class preserves the fit/predict
object API for users porting scripts.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from sitator_tpu.ops.cluster import dotprod_fit
from sitator_tpu.ops.landmark import assign_to_centers


class DotProdClassifier:
    """Parameters
    ----------
    threshold : cosine similarity above which a sample joins a cluster
        during fitting.
    max_converge_iters : Lloyd refinement iterations.
    min_samples : drop clusters smaller than this after fitting.
    k_max : static capacity for discovered clusters.
    """

    def __init__(self, threshold=0.9, max_converge_iters=10, min_samples=1,
                 k_max=512):
        self.threshold = float(threshold)
        self.max_converge_iters = int(max_converge_iters)
        self.min_samples = int(min_samples)
        self.k_max = int(k_max)
        self._centers = None
        self._active = None

    @staticmethod
    def _normalize(X):
        X = np.asarray(X, dtype=np.float32)
        norms = np.linalg.norm(X, axis=1, keepdims=True)
        return X / np.maximum(norms, 1e-12)

    def fit(self, X):
        Xn = self._normalize(X)
        res = dotprod_fit(jnp.asarray(Xn), k_max=self.k_max,
                          cluster_threshold=self.threshold,
                          min_samples=self.min_samples,
                          n_iters=self.max_converge_iters)
        keep = np.asarray(res["active"])
        self._centers = np.asarray(res["centers"])[keep]
        self._active = np.ones(len(self._centers), dtype=bool)
        return self

    @property
    def n_clusters(self):
        if self._centers is None:
            raise ValueError("classifier has not been fit")
        return len(self._centers)

    @property
    def cluster_centers(self):
        if self._centers is None:
            raise ValueError("classifier has not been fit")
        return self._centers

    def predict(self, X, threshold=None, return_confidences=False):
        """Labels (−1 below ``threshold``; defaults to the fit threshold)."""
        if self._centers is None:
            raise ValueError("classifier has not been fit")
        thr = self.threshold if threshold is None else float(threshold)
        Xn = self._normalize(X)
        labels, confs = assign_to_centers(
            jnp.asarray(Xn), jnp.asarray(self._centers),
            jnp.asarray(self._active), thr)
        if return_confidences:
            return np.asarray(labels), np.asarray(confs)
        return np.asarray(labels)

    def fit_predict(self, X, predict_threshold=None,
                    return_confidences=False):
        self.fit(X)
        return self.predict(X, threshold=predict_threshold,
                            return_confidences=return_confidences)
