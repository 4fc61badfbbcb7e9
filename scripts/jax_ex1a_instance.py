"""Export the random inputs of the JAX package's ex1a data instance, so that
the PyTorch port can run its own pipeline on that very instance
(``scripts/torch_ex1a_stability_study.py``'s second witness).

The JAX pipeline (``gp_bayesopinf_tpu.pipeline.pdes.run_euler``) draws two
things at random before its GP fits: the sorted sample times, from its
``sample`` key, and the standard normals of ``Euler.noise``, shaped
(3 nx, num_samples - 1), from its ``noise`` key. This script draws the same
two arrays from the same keys, with no solve, and saves them with the seed
and workload they belong to. The port's ``Euler.noise(..., normals=)``
then makes the JAX instance's noisy snapshots from its own truth solve.
It needs JAX, and runs where JAX is installed::

    python scripts/jax_ex1a_instance.py [--out docs/torch/ex1a_jax_instance.npz]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gp_bayesopinf_tpu.pipeline.configs import EulerConfig  # noqa: E402
from gp_bayesopinf_tpu.utils import key_from_seed, split_tree  # noqa: E402

OUT = os.path.join("docs", "torch", "ex1a_jax_instance.npz")


def instance(config=None, num_samples=200, training_span=(0.0, 0.06)):
    """The sample times and noise normals ``run_euler`` draws for
    ``config`` (``EulerConfig()`` unless given), as NumPy float64 arrays
    with the seed and workload they belong to."""
    config = config or EulerConfig()
    keys = split_tree(key_from_seed(config.seed), ["sample", "noise", "fit", "search", "draws"])
    lo, hi = training_span
    t_sampled = np.sort(np.asarray(
        jax.random.uniform(keys["sample"], (num_samples,), minval=lo, maxval=hi)))
    t_sampled[0], t_sampled[-1] = training_span
    shape = (3 * len(config.spatial_domain), num_samples - 1)
    normals = np.asarray(jax.random.normal(keys["noise"], shape, dtype=jnp.float64))
    return {"t_sampled": t_sampled, "normals": normals, "seed": np.int64(config.seed),
            "training_span": np.asarray(training_span, dtype=np.float64)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(args.out, **instance())
    print("wrote", args.out)


if __name__ == "__main__":
    main()
