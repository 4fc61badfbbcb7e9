"""Factorizations of tall matrices for the production-scale pipeline
(counterpart of ``gp_bayesopinf_tpu/parallel/``, on one device)."""

from .sharded import randomized_pod, sharded_gram_pod, tall_skinny_svd

__all__ = ["randomized_pod", "sharded_gram_pod", "tall_skinny_svd"]
