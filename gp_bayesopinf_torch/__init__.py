"""gp_bayesopinf_torch: GP-BayesOpInf in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of the JAX package ``gp_bayesopinf_tpu`` (which stays in the
repository as the reference). The layout mirrors it module by module
(``ops``, ``gp``, ``rom``, ``solve``, ``bayes``, ``models``,
``pipeline``, ``utils``) so each counterpart is easy to find; every
module's docstring names its JAX counterpart.

Conventions:

* every entry point takes an explicit ``device``; nothing falls back to
  the CPU when CUDA is missing (``utils.device.resolve_device``);
* randomness comes from explicit ``torch.Generator`` streams, one per
  pipeline stage (``utils.keys``);
* estimation, regression and ensembles run in float64 on the device;
  the regularization screen runs in float32, which is its kernel's
  contract (``ops.ensemble_screen``).

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
