"""The production-scale pipeline, one module per stage (counterpart of
``gp_bayesopinf_tpu/pipeline/scaled.py``): ``data`` (snapshot sources),
``estimate`` (GP estimation and weighting per window), ``gamma`` (the
shape of a user-given Tikhonov regularizer), ``search`` (the windowed
screen, the grid and its refinements), ``rollout`` (the final ensembles
and the chaining schemes) and ``run`` (``run_scaled``)."""

from .run import ScaledNormals, ScaledResult, run_scaled

__all__ = ["ScaledNormals", "ScaledResult", "run_scaled"]
