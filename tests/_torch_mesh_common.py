"""Rank bodies of the port's multi-device tests (``tests/test_torch_mesh*.py``).

Each function runs in a rank of ``gp_bayesopinf_torch.parallel.spawn`` (a
gloo process on the CPU) and must be importable there, so this module
imports ``torch``, NumPy and the port only. Arguments and values travel
pickled: NumPy arrays and plain values.
"""

import os
import time

import numpy as np
import torch

from gp_bayesopinf_torch.bayes import auto_regularize
from gp_bayesopinf_torch.parallel import (
    gather_leading_axis, make_mesh, randomized_pod, shard_leading_axis, sharded_gram_pod,
    tall_skinny_svd,
)
from gp_bayesopinf_torch.parallel import mesh as pmesh
from gp_bayesopinf_torch.pipeline import run_scaled
from gp_bayesopinf_torch.pipeline.scaled import search
from gp_bayesopinf_torch.rom import GalerkinROM
from gp_bayesopinf_torch.solve import weighted_lstsq_fit

#: The run of the JAX package's ``tests/test_pipeline.py::test_scaled_pipeline_on_mesh``.
SCALED = dict(n_space=128, n_snapshots=300, num_modes=4, num_gp_samples=80,
              num_regression_points=96, n_restarts=2, ndraws=16, grid_size=8, modelform="cAH")


def value(rank, x):
    return (rank, x, torch.distributed.get_world_size(), torch.get_num_threads())


def raise_on_1(rank):
    if rank == 1:
        raise ArithmeticError("rank 1 fails")
    torch.distributed.barrier()  # rank 0 waits for a peer that has failed


def exit_on_1(rank):
    if rank == 1:
        os._exit(3)
    time.sleep(600)


def hang(rank):
    time.sleep(600)


def _np(x):
    return x.cpu().numpy()


def factorizations(rank, shape, X, snaps, omega, omega32):
    """The three sharded factorizations on a mesh of ``shape``, each with
    its one-device call beside it, and the collectives' round trips."""
    mesh = make_mesh(shape, "cpu")
    space = tuple(shape)
    X, snaps = torch.as_tensor(X), torch.as_tensor(snaps)
    out = {"rank": rank}
    U, S, V = tall_skinny_svd(X, mesh, ("mode", "draw", None))
    out["tsqr"] = tuple(map(_np, (U, S, V)))
    P = pmesh.axis_size(mesh, "draw")
    out["tsqr_one"] = tuple(map(_np, tall_skinny_svd(X, row_blocks=P)))
    for name, sketch, dtype in (("pod", omega, torch.float64), ("pod32", omega32, torch.float32)):
        Y = snaps.to(dtype)
        pod = randomized_pod(Y, 6, mesh, space, oversample=8, Omega=torch.as_tensor(sketch))
        one = randomized_pod(Y, 6, oversample=8, Omega=torch.as_tensor(sketch))
        out[name], out[name + "_one"] = tuple(map(_np, pod)), tuple(map(_np, one))
    out["gram"] = tuple(map(_np, sharded_gram_pod(snaps[:, :12], 4, mesh, space)))
    out["gram_one"] = tuple(map(_np, sharded_gram_pod(snaps[:, :12], 4)))
    rows = torch.arange(24.0).reshape(12, 2)
    out["block"] = _np(shard_leading_axis(rows, mesh, space))
    out["round_trip"] = _np(gather_leading_axis(shard_leading_axis(rows, mesh, space), mesh, space))
    out["sum"] = _np(pmesh.all_reduce_sum(torch.tensor([rank + 1.0]), mesh, space))
    for name, call in (("odd", lambda: shard_leading_axis(rows[:7], mesh, space)),
                       ("axis", lambda: shard_leading_axis(rows, mesh, "seq"))):
        try:
            call()
        except ValueError as exc:
            out[name] = str(exc)
    return out


def linear_problem(structure):
    """The regression of the JAX package's ``tests/test_bayes.py``
    ``linear_problem``: a stable diagonal linear truth, r 3, 120 points,
    weights 30 I; the data matrix of ``structure``. Returns (rom, fac, Q,
    t, q0) in float64 on the CPU."""
    r = 3
    A_true = np.diag([-0.6, -1.1, -1.7])
    rom = GalerkinROM(structure, state_dimension=r, substeps=4)
    t = np.linspace(0, 4, 120)
    q0 = np.array([1.0, -0.8, 0.5])
    Q = np.stack([np.exp(np.diag(A_true) * tt) * q0 for tt in t], axis=1)
    Qt = torch.as_tensor(Q)
    sqrtW = torch.as_tensor(np.broadcast_to(30.0 * np.eye(len(t)), (r, 1, len(t), len(t))).copy())
    fac = weighted_lstsq_fit(rom.data_matrix(Qt)[None], sqrtW, torch.as_tensor(A_true @ Q)[:, None])
    return rom, fac, Qt, torch.as_tensor(t), torch.as_tensor(q0)


SEARCH_GRIDS = (9, 40)


def search_case(rank, shape, normals):
    """``auto_regularize`` on the linear problem through the generic ("cA")
    and the kernel ("cAH", its plain version on the CPU) objective, on a
    mesh of ``shape`` (``rank`` None: on one device) for the grids of
    ``SEARCH_GRIDS``; ``normals[structure]`` = (xi_grid, xi_refine) of the
    9-point grid, the 40-point grid's drawn from a seeded generator. Each
    result carries the candidate count of every objective call made."""
    from gp_bayesopinf_torch.bayes import regsearch

    calls = []

    def counted(make):
        def build(*args, **kwargs):
            objective = make(*args, **kwargs)

            def evaluate(lams, xi):
                calls.append(len(lams))
                return objective(lams, xi)

            return evaluate

        return build

    kernel, generic = regsearch._kernel_objective, regsearch._generic_objective
    regsearch._kernel_objective, regsearch._generic_objective = counted(kernel), counted(generic)
    try:
        mesh = None if rank is None else make_mesh(shape, "cpu")
        out = {}
        for structure, (xi_grid, xi_refine) in normals.items():
            rom, fac, Q, t, q0 = linear_problem(structure)
            grids = {
                9: dict(grid=np.logspace(-10, 2, 9), xi_grid=torch.as_tensor(xi_grid),
                        xi_refine=torch.as_tensor(xi_refine)),
                40: dict(grid=np.logspace(-10, 2, 40)),
            }
            for size, kw in grids.items():
                calls.clear()
                res = auto_regularize(fac, rom, q0[None], t, t, Q[None], ndraws=8, verbose=False,
                                      generator=torch.Generator().manual_seed(7), mesh=mesh,
                                      **kw)
                out[structure, size] = (res.regularizer, res.grid_best, res.grid_errors,
                                        res.refined, list(calls))
        return out
    finally:
        regsearch._kernel_objective, regsearch._generic_objective = kernel, generic


def _scaled_digest(res):
    keys = ("regularizer", "stable_fraction", "train_error", "svdvals", "samples",
            "hyperparameters", "grid_errors", "ensemble_mean", "window_regularizers",
            "window_bases", "sample_times")
    out = {k: getattr(res, k) for k in keys}
    out["stages"] = sorted(res.stage_seconds)
    return out


def scaled_runs(rank, shape, runs):
    """``run_scaled`` on a mesh of ``shape`` for each keyword set of
    ``runs`` (added to ``SCALED``); every rank's digests."""
    mesh = make_mesh(shape, "cpu")
    out = []
    for kw in runs:
        try:
            out.append(_scaled_digest(run_scaled(**{**SCALED, **kw}, mesh=mesh, device="cpu")))
        except ValueError as exc:
            out.append(str(exc))
    return out


def grid_split(rank, shape):
    """``search.grid_screen`` with its candidates split over "draw", held
    bit for bit against the one-device screen on the same problem: the
    linear problem's regression as a one-window "cAH" search."""
    mesh = make_mesh(shape, "cpu")
    rom, fac, Q, t, _ = linear_problem("cAH")
    problem = search.build_problem(rom, fac, Q[None], t[None], "scalar", None, 0.02,
                                   torch.float32)
    gen = torch.Generator().manual_seed(0)
    grid = np.logspace(-10, 2, 9)
    xi = torch.randn((9, search.SCREEN_DRAWS, 3, fac.num_unknowns), generator=gen)
    return (search.grid_screen(problem, grid, xi, False, mesh),
            search.grid_screen(problem, grid, xi, False))
