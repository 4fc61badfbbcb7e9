"""Shared by the HDF5 tests of the PyTorch port: rebuild the JAX package's
objects from the port's arrays, and compare two HDF5 files group by
group, dataset by dataset and attribute by attribute."""

import h5py
import jax.numpy as jnp
import numpy as np

from gp_bayesopinf_tpu.bayes import OperatorPosterior as JPosterior
from gp_bayesopinf_tpu.gp import GaussianProcess as JGP
from gp_bayesopinf_tpu.rom import EulerScaledBasis as JEulerBasis
from gp_bayesopinf_tpu.rom import GalerkinROM as JROM
from gp_bayesopinf_tpu.rom import QuadraticLiftedBasis as JLiftedBasis

#: Relative tolerance of the datasets that the exporters compute (the GP
#: moments, the basis products, the covariances from their factors):
#: the same float64 arithmetic in XLA and in PyTorch, summed in another
#: order.
RTOL = 1e-10


def host(x):
    return np.array(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def j_gps(gps):
    """The JAX package's GPs with the port's data and hyperparameters."""
    return [JGP(jnp.asarray(host(g.t_training)), jnp.asarray(host(g.y)), g.constant,
                g.length_scale, g.noise_level) for g in gps]


def j_posterior(post):
    return JPosterior(jnp.asarray(host(post.means)), jnp.asarray(host(post.cov_factors)))


def j_rom(rom):
    return JROM(rom.structure, rom.state_dimension, rom.input_dimension, rom.ivp_method,
                rom.substeps)


def j_basis(basis):
    fields = {n: jnp.asarray(host(getattr(basis, n))) for n in ("entries", "shift_vec", "svdvals")}
    if hasattr(basis, "v_ref"):
        return JEulerBasis(**fields, v_ref=basis.v_ref, rho_ref=basis.rho_ref)
    return JLiftedBasis(**fields)


def h5_items(path):
    """{name: (is dataset, value, dtype, shape, attrs)} of every object."""
    out = {}

    def visit(name, obj):
        attrs = {k: obj.attrs[k] for k in obj.attrs}
        if isinstance(obj, h5py.Dataset):
            out[name] = (True, obj[()], obj.dtype, obj.shape, attrs)
        else:
            out[name] = (False, None, None, None, attrs)

    with h5py.File(path, "r") as hf:
        hf.visititems(visit)
        out["/"] = (False, None, None, None, {k: hf.attrs[k] for k in hf.attrs})
    return out


def assert_same_h5(port_path, jax_path, computed=()):
    """The same groups, datasets, dtypes, shapes and attributes; values
    equal, exactly but for the datasets named in ``computed`` (to
    ``RTOL``)."""
    a, b = h5_items(port_path), h5_items(jax_path)
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for name in a:
        (is_a, va, da, sa, aa), (is_b, vb, db, sb, ab) = a[name], b[name]
        assert is_a == is_b and da == db and sa == sb, (name, da, db, sa, sb)
        assert sorted(aa) == sorted(ab), (name, sorted(aa), sorted(ab))
        for key in aa:
            np.testing.assert_array_equal(aa[key], ab[key], err_msg=f"{name} attr {key}")
        if not is_a:
            continue
        if name.split("/")[-1] in computed:
            scale = float(np.abs(vb).max()) if vb.size else 0.0
            np.testing.assert_allclose(va, vb, rtol=RTOL, atol=RTOL * scale, err_msg=name)
        else:
            np.testing.assert_array_equal(va, vb, err_msg=name)
