"""The mesh-sharded regularization grid (``auto_regularize(mesh=...)``) in 3
gloo ranks against the port's one-device search and the JAX
package's mesh run (``_mesh_sharded_grid`` on 3 of its 8 virtual CPU
devices), on the linear problem of ``tests/test_bayes.py``, through both
objectives: the generic one ("cA", float64 integrations) and the kernel
one ("cAH", kernel A's plain version on the CPU, float32). Each rank
screens one of one device's chunks of 16 candidates: the JAX test's 9
candidates are one chunk, which every rank screens (every random number of
the JAX run replayed); a 40-point grid is three chunks, the last padded by
wrapping, split over the ranks.

Tolerances: against the port's one-device call the grid errors and the
chosen lambda are bit for bit equal (each objective call sees one
device's batch). Against the JAX mesh run the same rejections and argmin,
and rtol 1e-6 on the grid errors and lambda through the float64 generic
objective; through the float32 kernel objective 1e-5 on the grid errors
(two codes' float32 RK4 sums differ by more than 1e-6 relative at this
size) and 1e-4 on lambda (the bounded refinement stops at 1e-5 in log10
lambda, 2.3e-5 relative).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_common as common
from gp_bayesopinf_tpu.bayes import auto_regularize as j_auto_regularize
from gp_bayesopinf_tpu.bayes.regsearch import MAXOPTVAL
from gp_bayesopinf_tpu.parallel.mesh import make_mesh as j_make_mesh
from gp_bayesopinf_tpu.rom import GalerkinROM as JROM
from gp_bayesopinf_tpu.solve import weighted_lstsq_fit as j_weighted_lstsq_fit
from gp_bayesopinf_torch.parallel import spawn

GRID = np.logspace(-10, 2, 9)
STRUCTURES = ("cA", "cAH")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_search(structure):
    """The JAX package's mesh search on its ``linear_problem``."""
    r, A_true = 3, np.diag([-0.6, -1.1, -1.7])
    rom = JROM(structure, state_dimension=r, substeps=4)
    t = np.linspace(0, 4, 120)
    q0 = np.array([1.0, -0.8, 0.5])
    Q = np.stack([np.exp(np.diag(A_true) * tt) * q0 for tt in t], axis=1)
    sqrtW = np.broadcast_to(30.0 * np.eye(len(t)), (r, 1, len(t), len(t))).copy()
    fac = j_weighted_lstsq_fit(rom.data_matrix(jnp.asarray(Q))[None], jnp.asarray(sqrtW),
                               jnp.asarray(A_true @ Q)[:, None, :])
    key = jax.random.PRNGKey(1)
    res = j_auto_regularize(
        fac, [lambda O, q, tt: rom.predict(O, q, tt)], jnp.asarray(q0)[None], jnp.asarray(t),
        jnp.asarray(t), jnp.asarray(Q)[None], key, grid=GRID, ndraws=8, verbose=False,
        rom=rom, use_kernel=structure == "cAH",
        mesh=j_make_mesh({"draw": 3}, devices=jax.devices()[:3]),
    )
    return res


@pytest.fixture(scope="module")
def searches():
    """(JAX's mesh runs, the port's one-device runs, every rank's mesh
    runs): the ranks work while this process runs the other two."""
    normals = {s: _normals(s) for s in STRUCTURES}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, common.search_case, 3, ["cpu"] * 3,
                            args=({"draw": 3}, normals), timeout=300)
        jax_runs = {s: _jax_search(s) for s in STRUCTURES}
        one = common.search_case(None, None, normals)
        return jax_runs, one, ranks.result()


def _normals(structure):
    """The JAX run's grid and refinement normals for the 9-point grid."""
    d = {"cA": 4, "cAH": 10}[structure]
    key = jax.random.PRNGKey(1)
    xi_grid = np.stack([np.asarray(jax.random.normal(k, (8, 3, d), dtype=jnp.float64))
                        for k in jax.random.split(key, GRID.size)])
    xi_refine = np.asarray(jax.random.normal(jax.random.fold_in(key, 0x5EED), (8, 3, d),
                                             dtype=jnp.float64))
    return xi_grid, xi_refine


@pytest.mark.parametrize("size", common.SEARCH_GRIDS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_mesh_grid_is_one_device_bit_for_bit(searches, structure, size):
    _, one, ranks = searches
    lam1, best1, errs1, refined1, _ = one[structure, size]
    for out in ranks:
        lam, best, errs, refined, _ = out[structure, size]
        assert errs.shape == (size,)
        np.testing.assert_array_equal(errs, errs1)
        assert (lam, best, refined) == (lam1, best1, refined1)


@pytest.mark.parametrize("structure", STRUCTURES)
def test_mesh_grid_matches_the_jax_mesh_run(searches, structure):
    jax_res, _, ranks = searches
    jres = jax_res[structure]
    lam, best, errs, refined, _ = ranks[0][structure, 9]
    rejected = jres.grid_errors >= MAXOPTVAL
    np.testing.assert_array_equal(errs >= MAXOPTVAL, rejected)
    assert (~rejected).sum() >= 2
    np.testing.assert_allclose(errs, jres.grid_errors, rtol={"cA": 1e-6, "cAH": 1e-5}[structure])
    assert np.argmin(errs) == np.argmin(jres.grid_errors) and best == jres.grid_best
    np.testing.assert_allclose(lam, jres.regularizer, rtol={"cA": 1e-6, "cAH": 1e-4}[structure])
    assert refined == jres.refined


@pytest.mark.parametrize("structure", STRUCTURES)
def test_chunks_split_over_the_ranks(searches, structure):
    """Objective calls and their candidate counts: one device screens the
    40-point grid in three calls of 16, one on each rank of the mesh (the
    last padded by wrapping); the 9-point grid is one call of 9, on one
    device and on every rank (the copies of ranks 1 and 2 discarded). The
    refinement's calls, each of one candidate padded to the chunk's width,
    run on every rank as on one device."""
    _, one, ranks = searches
    for out in ranks:
        for size, chunks in ((9, [9]), (40, [16, 16, 16])):
            calls, calls1 = out[structure, size][4], one[structure, size][4]
            assert calls1[: len(chunks)] == chunks and calls[0] == chunks[0]
            assert calls[1:] == calls1[len(chunks):] and len(calls) > 2
