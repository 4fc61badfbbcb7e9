"""ex1a posterior-stability study on the PyTorch port (the counterpart of
``scripts/ex1a_stability_study.py``).

The JAX study (``docs/ex1a_stability_study.md``) found the ex1a final
ensemble keeping ~530/600 draws across a flat lambda basin (1e-14 to
1e-3), the search's 20-draw screen passing a basin candidate with
probability ~0.07, and the selected lambda jittering across the basin
between runs. The port's ex1a run lands at the basin's shrinkage edge
instead. This script measures, on the port's own factorization:

1. the ex1a pipeline once (``run_euler``), and the weighted regression
   factorization rebuilt from its GPs;
2. a lambda ladder: for each lambda, ``--ndraws`` draws evaluated under
   BOTH the screen semantics (GP-estimate IC and envelope, both time
   domains) and the final-ensemble semantics (noisy-snapshot IC and
   envelope, prediction domain): stable counts, the chance that a 20-draw
   screen passes, and the ensemble-mean error against the compressed
   truth; the draws of a rung are shared by both semantics;
3. the regularization search repeated on that factorization with 8 other
   random streams: where lambda lands, and how many grid candidates pass
   the screen in and out of the basin;
4. the pipeline again at data seeds 1 to 4 (``EulerConfig.seed``): where
   each search lands, its final ensemble, and one basin rung (1e-6) of its
   own factorization;
5. the port's pipeline on the JAX package's own data instance (its sample
   times and noise normals, from ``scripts/jax_ex1a_instance.py``): the
   searches, the final ensemble and the basin rung, which tell a property
   of the data instance from one of the port;
6. unless ``--skip-oracle``, a serial NumPy/SciPy oracle of the reference
   search (sequential RNG, adaptive RK45, early exit, bounded refinement;
   ``PDEs/step3_estimate.py:25-180``) on the SAME GP products, and its
   lambda's stable count under the reference's final filter (serial
   SciPy: minutes where candidates fail early, ~25 where they pass).

Everything runs in float64 on one device (the JAX study's TPU float32
ensembles and host transfers have no counterpart here). The random
streams differ from the JAX study's ``PRNGKey(20260817)`` with a
``fold_in`` a rung: rung j draws from child j of
``SeedSequence(20260817)``, search s from child s of
``SeedSequence(20260818)``.

Writes ``<outdir>/ex1a_stability_study.md`` and ``.json``::

    python scripts/torch_ex1a_stability_study.py [--ndraws 600] [--outdir docs/torch]
        [--device cuda] [--skip-oracle]
    python scripts/torch_ex1a_stability_study.py --from-json docs/torch/ex1a_stability_study.json
"""

import argparse
import dataclasses
import json
import os
import sys
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gp_bayesopinf_torch.bayes import BayesianROM, OperatorPosterior, auto_regularize  # noqa: E402
from gp_bayesopinf_torch.gp import fit_gaussian_processes  # noqa: E402
from gp_bayesopinf_torch.models import Euler  # noqa: E402
from gp_bayesopinf_torch.pipeline.configs import EulerConfig  # noqa: E402
from gp_bayesopinf_torch.pipeline.pdes import run_euler  # noqa: E402
from gp_bayesopinf_torch.rom import EulerScaledBasis, GalerkinROM  # noqa: E402
from gp_bayesopinf_torch.solve.lstsq import weighted_lstsq_fit  # noqa: E402
from gp_bayesopinf_torch.utils import resolve_device, stage_generators  # noqa: E402
from gp_bayesopinf_torch.utils.device import to_host  # noqa: E402
from gp_bayesopinf_torch.utils.reporting import card_line  # noqa: E402

MAXOPTVAL = 1e12
LADDER_SEED, SEARCH_SEED, ORACLE_SEED = 20260817, 20260818, 27092023
#: The basin's upper end: the JAX ladder's final count is flat up to here.
BASIN_MAX = 1e-3
#: Other search streams on the run's factorization, and other data seeds
#: (``EulerConfig.seed``) of the whole pipeline.
SEARCH_STREAMS, DATA_SEEDS = 8, (1, 2, 3, 4)
#: The basin rung each data instance's own factorization is probed at.
BASIN_PROBE = 1e-6
#: run_euler's ex1a workload (reference ``PDEs/experiments.sh:13``).
EX1A = dict(training_span=(0.0, 0.06), num_samples=200, noiselevel=0.03,
            num_regression_points=400, num_pod_modes=6)
#: The random inputs of the JAX package's ex1a data instance, written by
#: ``scripts/jax_ex1a_instance.py``.
JAX_INSTANCE = os.path.join(REPO, "docs", "torch", "ex1a_jax_instance.npz")

#: docs/ex1a_stability_study.md's ladder (the JAX package, 600 draws):
#: lambda -> (final stable, screen stable, P(20-draw screen), error).
JAX_LADDER = {
    3.162e-14: (528, 524, 0.067, 0.2556), 3.162e-13: (529, 526, 0.072, 0.2465),
    3.162e-12: (526, 524, 0.067, 0.2212), 1e-10: (528, 526, 0.072, 0.2399),
    1e-09: (526, 523, 0.064, 0.2427), 1e-08: (531, 527, 0.075, 0.2265),
    1e-07: (542, 539, 0.117, 0.2281), 1e-06: (527, 528, 0.078, 0.2348),
    1e-05: (535, 533, 0.094, 0.2507), 1e-04: (537, 534, 0.097, 0.2360),
    1e-03: (538, 537, 0.109, 0.2440), 1e-02: (558, 555, 0.210, 0.1728),
    1e-01: (599, 599, 0.967, 0.6154), 1e+00: (600, 600, 1.000, 1.6333),
}
JAX_CHOSEN = 3.162e-14


# ---------------------------------------------------------------------------
# NumPy oracle of the reference search semantics (serial, RK45, early exit):
# a copy of scripts/ex1a_stability_study.py's, which must not be imported
# where JAX is not installed.
# ---------------------------------------------------------------------------
def _ckron_np(q):
    r = q.shape[0]
    rows, cols = np.tril_indices(r)
    return q[rows] * q[cols]


def _rhs_np(t, q, Ohat):
    feats = np.concatenate([[1.0], q, _ckron_np(q)])
    return Ohat @ feats


def _integrate_np(Ohat, q0, t_eval):
    import scipy.integrate

    sol = scipy.integrate.solve_ivp(
        _rhs_np, (t_eval[0], t_eval[-1]), q0, t_eval=t_eval, args=(Ohat,),
        rtol=1e-5, atol=1e-8, method="RK45",
    )
    return sol.y, sol.y.shape[1] == t_eval.size


def _sample_np(rng, U, S, V, Utz, lam, ndraws):
    """Serial posterior draws matching the reference's rvs-per-row order."""
    r, d = S.shape
    filt = S / (S * S + lam * lam)  # (r, d)
    mean = np.einsum("rij,rj->ri", V, filt * Utz)
    scale = 1.0 / np.sqrt(S * S + lam * lam)
    draws = np.empty((ndraws, r, d))
    for n in range(ndraws):
        for i in range(r):
            draws[n, i] = mean[i] + V[i] @ (rng.standard_normal(d) * scale[i])
    return draws


def oracle_search(U, S, V, Utz, state_est, t_pred, t_est, grid, seed,
                  ndraws=20, verbose=True):
    """Reference-semantics regularization search (PDEs/step3_estimate.py)."""
    import scipy.optimize

    rng = np.random.default_rng(seed)
    shift = state_est.mean(axis=1)[:, None]
    limits = 5.0 * np.abs(state_est - shift).max(axis=1)
    snapshotnorm = np.linalg.norm(state_est)
    q0 = state_est[:, 0]

    def unstable(sol, size):
        if sol.shape[-1] != size:
            return True
        return np.any(np.abs(sol - shift).max(axis=1) > limits)

    def training_error(lam):
        ohats = _sample_np(rng, U, S, V, Utz, lam, ndraws)
        draws = []
        for O in ohats:
            for tdom in (t_pred, t_est):
                sol, ok = _integrate_np(O, q0, tdom)
                if not ok or unstable(sol, tdom.size):
                    return MAXOPTVAL
            draws.append(sol)
        return np.linalg.norm(np.mean(draws, axis=0) - state_est) / snapshotnorm

    errors = []
    for lam in grid:
        e = training_error(lam)
        errors.append(e)
        if verbose:
            tag = "UNSTABLE" if e >= MAXOPTVAL else f"{e:.2%}"
            print(f"  oracle reg {lam:.4e}: {tag}", flush=True)
    errors = np.asarray(errors)
    ibest = int(np.argmin(errors))
    best = float(grid[ibest])
    if ibest == 0:
        bounds = [best / 100.0, float(grid[1])]
    elif ibest == len(grid) - 1:
        bounds = [float(grid[-2]), best * 100.0]
    else:
        bounds = [float(grid[ibest - 1]), float(grid[ibest + 1])]

    opt = scipy.optimize.minimize_scalar(
        lambda lg: float(training_error(10.0 ** lg)),
        method="bounded", bounds=np.log10(bounds),
    )
    if opt.success and opt.fun < MAXOPTVAL:
        return float(10.0 ** opt.x), best, errors
    return best, best, errors


def oracle_final_count(U, S, V, Utz, lam, q0_noisy, qbar, bound, t_pred,
                       seed, ndraws):
    """Reference final-filter stable count (PDEs/main.py:126-141)."""
    rng = np.random.default_rng(seed + 1)
    ohats = _sample_np(rng, U, S, V, Utz, lam, ndraws)
    stable = 0
    for O in ohats:
        sol, ok = _integrate_np(O, q0_noisy, t_pred)
        if ok and not np.any(np.abs(sol - qbar[:, None]).max(axis=1) > bound):
            stable += 1
    return stable


# ---------------------------------------------------------------------------
# The ladder on the port's factorization.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Ladder:
    """What a rung needs, on one device: the ROM, its weighted regression
    factorization, both semantics' initial conditions and envelopes, the
    time grids and the compressed truth."""

    rom: object  # GalerkinROM
    fac: object  # WeightedLSTSQ
    state_est: torch.Tensor  # (r, m') GP state estimates
    t_pred: torch.Tensor  # (k,)
    t_est: torch.Tensor  # (m',)
    q0_noisy: torch.Tensor  # final semantics: the noisy first snapshot
    qbar: torch.Tensor
    bound: torch.Tensor
    q0_scr: torch.Tensor  # screen semantics: the GP estimates
    shift_scr: torch.Tensor
    lim_scr: torch.Tensor
    truth_c: torch.Tensor  # (r, k) compressed truth

    @classmethod
    def build(cls, rom, fac, state_est, snapshots_compressed, truth_c, t_pred, t_est):
        snaps = snapshots_compressed
        qbar = snaps.mean(dim=1)
        shift = state_est.mean(dim=1)
        like = dict(dtype=state_est.dtype, device=state_est.device)
        return cls(
            rom=rom, fac=fac, state_est=state_est,
            t_pred=torch.as_tensor(t_pred, **like), t_est=torch.as_tensor(t_est, **like),
            q0_noisy=snaps[:, 0], qbar=qbar,
            bound=5.0 * torch.amax(torch.abs(snaps - qbar[:, None]), dim=1),
            q0_scr=state_est[:, 0], shift_scr=shift,
            lim_scr=5.0 * torch.amax(torch.abs(state_est - shift[:, None]), dim=1),
            truth_c=truth_c,
        )

    @classmethod
    def from_result(cls, res):
        """The ladder of an ``EulerResult``: its regression rebuilt from its
        GPs (dense weight roots)."""
        gps = res.gps
        state_est = torch.stack([gp.state_estimate for gp in gps])
        D = res.rom.data_matrix(state_est)[None]
        sqrtW = torch.stack([gp.sqrtW for gp in gps])[:, None]
        rhs = torch.stack([gp.ddt_estimate for gp in gps])[:, None]
        fac = weighted_lstsq_fit(
            D, sqrtW, rhs,
            weights_are_cholesky=(gps[0].weight_method == "chol"),
        )
        return cls.build(res.rom, fac, state_est, res.snapshots_compressed,
                         res.basis.compress(res.true_states), res.time_domain,
                         res.t_estimation)


def child_generator(seed: int, j: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from child j of
    ``SeedSequence(seed)`` (the same child whatever the count)."""
    child = np.random.SeedSequence(seed).spawn(j + 1)[j]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(child.generate_state(1, dtype=np.uint64)[0]))
    return gen


def rung_generator(j: int, device) -> torch.Generator:
    """Rung j's stream."""
    return child_generator(LADDER_SEED, j, device)


def rung(ladder: Ladder, lam: float, ndraws: int = 600, generator=None, xi=None):
    """One lambda of the ladder: (final stable, screen stable, P(20-draw
    screen passes), ensemble-mean error against the compressed truth).
    The standard normals ``xi`` (ndraws, r, d) come from ``generator``
    unless given; all three ensembles share them."""
    fac = ladder.fac
    brom = BayesianROM(ladder.rom, OperatorPosterior.from_lstsq(fac, lam), lam)
    if xi is None:
        xi = torch.randn((ndraws, fac.num_problems, fac.num_unknowns), generator=generator,
                         dtype=fac.S.dtype, device=fac.S.device)
    # Final-ensemble semantics: noisy IC, snapshot envelope, t_pred.
    draws, valid = brom.solution_posterior(
        ladder.q0_noisy, ladder.t_pred, xi=xi, stability_envelope=(ladder.qbar, ladder.bound),
    )
    n_final = int(valid.sum())
    mean_sol = torch.where(valid[:, None, None], draws, 0.0).sum(dim=0) / max(n_final, 1)
    err = float(torch.linalg.norm(mean_sol - ladder.truth_c) / torch.linalg.norm(ladder.truth_c))
    # Screen semantics: GP-estimate IC and envelope, both domains.
    envelope = (ladder.shift_scr, ladder.lim_scr)
    _, v_p = brom.solution_posterior(ladder.q0_scr, ladder.t_pred, xi=xi,
                                     stability_envelope=envelope)
    _, v_e = brom.solution_posterior(ladder.q0_scr, ladder.t_est, xi=xi,
                                     stability_envelope=envelope)
    n_screen = int((v_p & v_e).sum())
    return n_final, n_screen, (n_screen / xi.shape[0]) ** 20, err


def lambda_ladder(chosen: float):
    """The JAX study's rungs: the chosen lambda, 10x and 100x it, and
    1e-10 ... 1e0."""
    return sorted(set([chosen, chosen * 10, chosen * 100] + list(np.logspace(-10, 0, 11))))


def search_repeats(ladder: Ladder, n: int, grid):
    """The regularization search on the ladder's factorization with ``n``
    other streams (child s of ``SeedSequence(SEARCH_SEED)``): one dict a
    search with its lambda and the grid candidates it let pass."""
    out = []
    for s in range(n):
        res = auto_regularize(
            ladder.fac, ladder.rom, ladder.q0_scr, ladder.t_pred, ladder.t_est,
            ladder.state_est, generator=child_generator(SEARCH_SEED, s, ladder.t_pred.device),
            grid=grid, ndraws=20, verbose=False,
        )
        passed = np.asarray(grid)[np.asarray(res.grid_errors) < MAXOPTVAL]
        out.append({"seed_child": s, "lambda": float(res.regularizer),
                    "grid_best": float(res.grid_best),
                    "passed_basin": int((passed <= BASIN_MAX).sum()),
                    "passed_above": int((passed > BASIN_MAX).sum())})
    return out


def data_instances(seeds, *, device, ndraws, config, workload):
    """The ex1a pipeline at other data seeds (``EulerConfig.seed``: the
    sample times, the noise, the GP fits' starts and the search's draws
    all follow it): one dict a seed with where its search landed, its
    final count and error, and one basin rung (``BASIN_PROBE``) of its own
    factorization: the per-draw screen share there."""
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        try:
            res = run_euler(ndraws=ndraws, config=dataclasses.replace(config, seed=seed),
                            decompress_draws=False, verbose=False, device=device, **workload)
        except ValueError as exc:  # a GP fit without a definite weight, or no stable candidate
            out.append({"seed": seed, "failed": str(exc), "wall_s": time.perf_counter() - t0})
            continue
        ladder = Ladder.from_result(res)
        n_final, n_screen, p20, err = rung(ladder, res.regularizer, ndraws,
                                           generator=rung_generator(0, ladder.t_pred.device))
        row = {"seed": seed, "lambda": float(res.regularizer), "stable": int(res.valid.sum()),
               "err": err, **probe_basin(ladder, ndraws), "wall_s": time.perf_counter() - t0}
        out.append(row)
        print(f"data seed {seed}: lambda {row['lambda']:.4e}, stable {row['stable']}/{ndraws}, "
              f"error {err:.4f}; at {BASIN_PROBE:.0e}: final {row['basin_final']}/{ndraws}, "
              f"screen share {row['basin_screen_share']:.3f}, P(20) {row['basin_p20']:.3f}, "
              f"error {row['basin_err']:.4f}", flush=True)
    return out


def probe_basin(ladder: Ladder, ndraws: int):
    """The rung at ``BASIN_PROBE`` (rung 1's stream) as a row's ``basin_*``
    entries."""
    final, screen, p20, err = rung(ladder, BASIN_PROBE, ndraws,
                                   generator=rung_generator(1, ladder.t_pred.device))
    return {"basin_lambda": BASIN_PROBE, "basin_final": final,
            "basin_screen_share": screen / ndraws, "basin_p20": p20, "basin_err": err}


def instance_ladder(path, *, device, config, workload):
    """The ladder of the port's pipeline on a data instance whose random
    inputs were drawn elsewhere: the port's truth solve at the saved sample
    times, ``Euler.noise`` with the saved standard normals, then
    ``run_euler``'s POD and GP fits (their restarts from the port's ``fit``
    stream) and the regression ``Ladder.from_result`` rebuilds. ``path``
    holds what ``scripts/jax_ex1a_instance.py`` writes; its seed, span and
    sample count must be ``config``'s and ``workload``'s."""
    saved = np.load(path)
    span = tuple(workload["training_span"])
    if (int(saved["seed"]) != config.seed or tuple(saved["training_span"]) != span
            or saved["t_sampled"].shape != (workload["num_samples"],)):
        raise ValueError(f"{path} holds another instance than data seed {config.seed}, "
                         f"span {span}, {workload['num_samples']} samples")
    dev = resolve_device(device)
    like = dict(dtype=torch.float64, device=dev)
    model = Euler(config.spatial_domain, substeps=config.fom_substeps)
    q0 = model.initial_conditions(config.init_params, device=dev)
    t_sampled = saved["t_sampled"]
    snapshots = model.noise(model.solve(q0, t_sampled), workload["noiselevel"],
                            normals=torch.as_tensor(saved["normals"], **like))
    basis = EulerScaledBasis.fit(snapshots, num_vectors=workload["num_pod_modes"],
                                 v_ref=config.v_ref, rho_ref=config.rho_ref)
    snapshots_c = basis.compress(snapshots)
    t_est = np.linspace(*span, workload["num_regression_points"])
    bounds = config.gp_bounds
    gps = fit_gaussian_processes(
        torch.as_tensor(t_est, **like), torch.as_tensor(t_sampled, **like), snapshots_c,
        constant_bounds=bounds.constant, length_scale_bounds=bounds.length_scale,
        noise_level_bounds=bounds.noise_level, n_restarts_optimizer=bounds.n_restarts,
        gp_regularizer=1e-8, generator=stage_generators(config.seed, dev)["fit"],
    )
    rom = GalerkinROM(config.structure, state_dimension=workload["num_pod_modes"],
                      ivp_method=config.ivp_method, substeps=config.rom_substeps)
    t_pred = np.asarray(config.time_domain, dtype=np.float64)
    return Ladder.from_result(types.SimpleNamespace(
        gps=gps, rom=rom, snapshots_compressed=snapshots_c, basis=basis,
        true_states=model.solve(q0, t_pred), time_domain=t_pred, t_estimation=t_est))


def jax_instance(ladder: Ladder, ndraws: int, grid):
    """The second witness, on ``instance_ladder``'s ladder of the JAX
    package's data instance: the search with the ``SEARCH_STREAMS``
    streams, the final ensemble at the first stream's lambda, and the
    basin rung."""
    searches = search_repeats(ladder, SEARCH_STREAMS, grid)
    lam = searches[0]["lambda"]
    final, screen, p20, err = rung(ladder, lam, ndraws,
                                   generator=rung_generator(0, ladder.t_pred.device))
    row = {"lambda": lam, "stable": final, "err": err, **probe_basin(ladder, ndraws),
           "searches": searches}
    print("JAX instance: searches land at "
          + ", ".join(f"{s['lambda']:.3e}" for s in searches)
          + f"; at {lam:.4e} final {final}/{ndraws}, error {err:.4f}; at {BASIN_PROBE:.0e}: "
          f"final {row['basin_final']}/{ndraws}, screen share {row['basin_screen_share']:.3f}, "
          f"P(20) {row['basin_p20']:.3f}, error {row['basin_err']:.4f}", flush=True)
    return row


def compute(*, device, ndraws=600, skip_oracle=False):
    """Run the study at ex1a (``EulerConfig()``, ``EX1A``) on ``device``;
    returns it as plain numbers (``write_report``'s input)."""
    config = EulerConfig()
    walls = {}
    t0 = time.perf_counter()
    print("== running ex1a pipeline ==", flush=True)
    res = run_euler(ndraws=ndraws, config=config, decompress_draws=False, verbose=True,
                    device=device, **EX1A)
    n_valid = int(res.valid.sum())
    walls["pipeline"] = time.perf_counter() - t0
    print(f"pipeline done in {walls['pipeline']:.1f} s; lambda*={res.regularizer:.4e}, "
          f"stable {n_valid}/{ndraws}", flush=True)
    ladder = Ladder.from_result(res)

    rows = []
    t0 = time.perf_counter()
    print(f"\n== lambda ladder ({ndraws} draws each, final + screen semantics) ==", flush=True)
    for j, lam in enumerate(lambda_ladder(res.regularizer)):
        n_final, n_screen, p20, err = rung(ladder, lam, ndraws,
                                           generator=rung_generator(j, ladder.t_pred.device))
        rows.append({"lambda": float(lam), "final": n_final, "screen": n_screen,
                     "p20": p20, "err": err})
        print(f"lam {lam:.4e}: final {n_final}/{ndraws}  screen {n_screen}/{ndraws}"
              f"  P(20-draw screen passes) {p20:.3f}  mean-err-vs-truth {err:.4f}", flush=True)
    walls["ladder"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    searches = search_repeats(ladder, SEARCH_STREAMS, config.reg_grid)
    walls["searches"] = time.perf_counter() - t0
    for s in searches:
        print(f"search {s['seed_child']}: lambda {s['lambda']:.4e}, passed "
              f"{s['passed_basin']} in the basin, {s['passed_above']} above", flush=True)

    t0 = time.perf_counter()
    instances = data_instances(DATA_SEEDS, device=device, ndraws=ndraws, config=config,
                               workload=EX1A)
    walls["data_seeds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("\n== the port's pipeline on the JAX package's data instance ==", flush=True)
    witness = jax_instance(instance_ladder(JAX_INSTANCE, device=device, config=config,
                                           workload=EX1A), ndraws, config.reg_grid)
    walls["jax_instance"] = time.perf_counter() - t0

    oracle = None
    if not skip_oracle:
        print("\n== NumPy oracle: reference-semantics search ==", flush=True)
        fac = ladder.fac
        U, S, V, Utz = (to_host(x) for x in (fac.U, fac.S, fac.V, fac.Utz))
        t0 = time.perf_counter()
        lam_ref, lam_grid_ref, _ = oracle_search(
            U, S, V, Utz, to_host(ladder.state_est), to_host(ladder.t_pred),
            to_host(ladder.t_est), config.reg_grid, seed=ORACLE_SEED, verbose=True,
        )
        n_ref = oracle_final_count(
            U, S, V, Utz, lam_ref, to_host(ladder.q0_noisy), to_host(ladder.qbar),
            to_host(ladder.bound), to_host(ladder.t_pred), seed=ORACLE_SEED, ndraws=ndraws,
        )
        walls["oracle"] = time.perf_counter() - t0
        print(f"oracle chose lambda {lam_ref:.4e} (grid best {lam_grid_ref:.4e}); final "
              f"stable {n_ref}/{ndraws} [{walls['oracle']:.0f} s]", flush=True)
        oracle = {"lambda": lam_ref, "lambda_grid": lam_grid_ref, "stable": n_ref}

    return {"card": card_line(device), "device": str(device), "ndraws": ndraws,
            "chosen": float(res.regularizer), "stable": n_valid, "rows": rows,
            "searches": searches, "basin_grid": int((config.reg_grid <= BASIN_MAX).sum()),
            "seed": config.seed, "data_seeds": instances, "jax_instance": witness,
            "oracle": oracle, "walls_s": walls}


def verdict(study):
    """Whether the port, run on the JAX package's data instance, keeps the
    JAX basin: "instance" where its basin rung's per-draw screen share
    reaches the JAX ladder's basin shares (less three binomial standard
    deviations), "port" where it stays at the port's own instance's basin
    shares (plus three), "unresolved" between them or without the
    witness."""
    w, nd = study.get("jax_instance"), study["ndraws"]
    if not w:
        return "unresolved"
    share = w["basin_screen_share"]
    sd = np.sqrt(max(share * (1.0 - share), 1.0 / nd) / nd)
    jax_low = min(v[1] for lam, v in JAX_LADDER.items() if lam <= BASIN_MAX) / 600
    own_high = max((r["screen"] / nd for r in study["rows"] if r["lambda"] <= BASIN_MAX),
                   default=1.0)
    if share >= jax_low - 3 * sd:
        return "instance"
    if share <= own_high + 3 * sd:
        return "port"
    return "unresolved"


def answer(study):
    """Whether the port's ex1a lambda is the luck of its search's 20-draw
    screens, a property of its data instance, or a property of the port,
    with the evidence for each."""
    searches, instances, oracle = study["searches"], study["data_seeds"], study["oracle"]
    parts = []
    if searches:
        lams = ", ".join(f"{s['lambda']:.3e}" for s in searches)
        passed = [s["passed_basin"] for s in searches]
        in_basin = [s for s in searches if s["lambda"] <= BASIN_MAX]
        parts.append(
            f"The search on the same factorization with {len(searches)} other streams lands "
            f"at {lams}; {min(passed)}-{max(passed)} of the grid's {study['basin_grid']} basin "
            "candidates pass its screen.")
        if in_basin:
            return " ".join(parts) + (
                f" **Seed luck**: {len(in_basin)} of {len(searches)} streams land in the "
                "basin, so where a run ends depends on its search's 20-draw screens, as the "
                "JAX study found for the JAX package.")
    lost = "" if not oracle or oracle["lambda"] > BASIN_MAX else " (the oracle's does)"
    parts.append(
        "**Not the luck of one seed's screens**: no other stream lands in the basin"
        + (", nor does the reference-semantics oracle" if oracle and not lost else lost)
        + ", because a basin candidate passes a 20-draw screen with P at most "
        f"{max([r['p20'] for r in study['rows'] if r['lambda'] <= BASIN_MAX], default=0.0):.1e}"
        " here.")
    landed = [r for r in instances if "lambda" in r]
    if landed:
        shares = [r["basin_screen_share"] for r in landed]
        parts.append(
            f"At {len(landed)} other data seeds of the port the pipeline lands at (data seed: "
            f"lambda, per-draw screen share at {BASIN_PROBE:.0e}) "
            + "; ".join(f"{r['seed']}: {r['lambda']:.3e}, {r['basin_screen_share']:.3f}"
                        for r in sorted(landed, key=lambda r: r["basin_screen_share"]))
            + f": the basin's screen share ranges {min(shares):.3f}-{max(shares):.3f} from one "
            "data instance to the next.")
    failed = [r for r in instances if "failed" in r]
    if failed:
        parts.append(f"Data seeds {[r['seed'] for r in failed]} did not finish: "
                     + "; ".join(r["failed"] for r in failed) + ".")
    w = study.get("jax_instance")
    kind = verdict(study)
    jax_shares = [v[1] / 600 for lam, v in JAX_LADDER.items() if lam <= BASIN_MAX]
    jax_low, jax_high = min(jax_shares), max(jax_shares)
    if w:
        w_in = [s for s in w["searches"] if s["lambda"] <= BASIN_MAX]
        own = [r["screen"] / study["ndraws"] for r in study["rows"] if r["lambda"] <= BASIN_MAX]
        parts.append(
            "On the JAX package's own data instance (its sample times and noise, "
            "`scripts/jax_ex1a_instance.py`), the port's GP fits and regression give a "
            f"per-draw screen share of {w['basin_screen_share']:.3f} at {BASIN_PROBE:.0e} "
            f"(final {w['basin_final']}/{study['ndraws']}), against {jax_low:.3f}-{jax_high:.3f} "
            "in the JAX ladder's basin and "
            + (f"{min(own):.3f}-{max(own):.3f} on the port's own instance" if own else
               "no basin rung on the port's own instance")
            + f"; {len(w_in)} of its {len(w['searches'])} searches land in the basin.")
    if kind == "instance":
        parts.append(
            f"**A property of data seed {study['seed']}'s instance as the port's streams draw "
            "it, not of the port**: on the JAX instance the port keeps the JAX basin.")
    elif kind == "port":
        parts.append(
            "**A property of the port**: on the JAX instance the port's pipeline loses the "
            "basin as it does on its own, so its GP fits, regression or ROM integration "
            "differ from the JAX package's there (ROADMAP queue 3).")
    else:
        parts.append(
            "**Unresolved**: the JAX instance's basin share lies between the JAX ladder's and "
            "the port's own." if w else "**Unresolved**: the JAX instance was not run.")
    return " ".join(parts)


def findings(study):
    """The findings, each set beside docs/ex1a_stability_study.md's, and the
    answer to where the port's search lands."""
    nd, rows = study["ndraws"], study["rows"]
    by_lam = {round(np.log10(r["lambda"]), 6): r for r in rows}
    shared = [(lam, by_lam[round(np.log10(lam), 6)]) for lam in JAX_LADDER
              if round(np.log10(lam), 6) in by_lam]
    basin = [r for r in rows if r["lambda"] <= BASIN_MAX]
    out = []
    if basin:
        finals = [r["final"] for r in basin]
        jax_finals = [v[0] for lam, v in JAX_LADDER.items() if lam <= BASIN_MAX]
        flat = max(finals) - min(finals) <= 0.05 * nd
        out.append(
            f"- **Retention across the basin.** JAX: {min(jax_finals)}-{max(jax_finals)}/600 "
            f"final draws kept, flat from 1e-14 to 1e-3. Port: {min(finals)}-{max(finals)}/{nd} "
            f"over its {len(basin)} rungs up to 1e-3 "
            f"({'flat: held' if flat else 'moved: not flat within 5% of the draws'})."
        )
        shares = [r["screen"] / nd for r in basin]
        p20s = [r["p20"] for r in basin]
        out.append(
            "- **The 20-draw screen in the basin.** JAX: per-draw screen share ~0.87, "
            "P(20-draw screen passes) 0.064-0.117. Port: per-draw share "
            f"{min(shares):.3f}-{max(shares):.3f}, P {min(p20s):.3f}-{max(p20s):.3f}."
        )
    cmp = "; ".join(
        f"{lam:.0e}: final {r['final']} (JAX {v[0]}), screen {r['screen']} (JAX {v[1]}), "
        f"error {r['err']:.4f} (JAX {v[3]:.4f})"
        for lam, r in shared if lam >= 1e-3 for v in [JAX_LADDER[lam]]
    )
    out.append(f"- **The shrinkage edge**, rung by rung beside the JAX ladder: {cmp}.")
    chosen = next(r for r in rows if r["lambda"] == study["chosen"])
    basin_err = [r["err"] for r in basin]
    out.append(
        f"- **The port's chosen lambda {study['chosen']:.6e}**: final {chosen['final']}/{nd}, "
        f"screen {chosen['screen']}/{nd}, P(20-draw screen) {chosen['p20']:.3f}, error "
        f"{chosen['err']:.4f}"
        + (f", against {min(basin_err):.4f}-{max(basin_err):.4f} in the basin" if basin else "")
        + f" (the JAX run chose {JAX_CHOSEN:.3e}: 528/600, error 0.2556)."
    )
    if study["oracle"]:
        o = study["oracle"]
        out.append(
            f"- **Reference semantics** (the NumPy oracle on the same GP products, its own "
            f"stream): lambda {o['lambda']:.4e} (grid best {o['lambda_grid']:.4e}), "
            f"{o['stable']}/{nd} under the reference's final filter (JAX study: 7.6346e-09, "
            "535/600, in the basin)."
        )
    out.append("- **Seed luck or a property of the port?** " + answer(study))
    out.append(
        "- The draws are the port's own (one torch.Generator a rung from SeedSequence), "
        "not the JAX study's threefry keys, and so is the data instance but for the JAX "
        "instance's witness; counts agree with the JAX ladder only in distribution. "
        "`tests/test_torch_studies.py` holds the ladder's rung against the JAX package's on "
        "injected draws, and the JAX instance's saved inputs against the JAX package's "
        "draws."
    )
    return out


def write_report(study, outdir):
    """Write ``ex1a_stability_study.md`` and ``.json`` into ``outdir``;
    returns the document's path."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "ex1a_stability_study.json"), "w") as fh:
        json.dump(study, fh)
    nd, walls = study["ndraws"], study["walls_s"]
    lines = [
        "# ex1a posterior-stability study (PyTorch port)",
        "",
        f"Run on `{study['device']}`: {study['card']}. The port's ex1a pipeline",
        f"(`euler 0.06 200 0.03 400 6`, {nd} draws) chose lambda = {study['chosen']:.6e} and",
        f"kept {study['stable']}/{nd} final draws stable. The JAX package's study is",
        "`docs/ex1a_stability_study.md`.",
        "",
        "Walls (s): " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f" ({study['card']}).",
        "",
        "Lambda ladder, one stream a rung shared by both semantics. `screen` = the",
        "search's acceptance semantics (GP-estimate IC and envelope, both time",
        "domains, `PDEs/step3_estimate.py:64-73`); `final` = the ensemble filter",
        "(noisy-snapshot IC and envelope, prediction domain, `PDEs/main.py:126-141`).",
        "P(screen) = the chance that a 20-draw screen accepts, from the screen-stable",
        "share. Error: the final ensemble's mean against the compressed truth.",
        "",
        "| lambda | final stable | screen stable | P(20-draw screen) | mean err vs truth |",
        "|---|---|---|---|---|",
    ]
    for r in study["rows"]:
        mark = " <- chosen" if r["lambda"] == study["chosen"] else ""
        lines.append(f"| {r['lambda']:.3e}{mark} | {r['final']}/{nd} | {r['screen']}/{nd} | "
                     f"{r['p20']:.3f} | {r['err']:.4f} |")
    if study["searches"]:
        lines += [
            "",
            f"The search (81-point grid, 20 draws a candidate, bounded refinement) on the",
            f"same factorization, with {len(study['searches'])} other streams:",
            "",
            "| stream | lambda | grid best | basin candidates passed | above the basin |",
            "|---|---|---|---|---|",
        ]
        for s in study["searches"]:
            lines.append(f"| {s['seed_child']} | {s['lambda']:.4e} | {s['grid_best']:.4e} | "
                         f"{s['passed_basin']} | {s['passed_above']} |")
    if study["data_seeds"]:
        lines += [
            "",
            f"The pipeline at other data seeds (data seed {study['seed']} above), each with its",
            "chosen lambda's final ensemble and one basin rung of its own factorization:",
            "",
            "| data seed | lambda | stable | error | basin rung | final | screen share | "
            "P(20-draw screen) | error |",
            "|---|---|---|---|---|---|---|---|---|",
        ]
        for r in study["data_seeds"]:
            if "failed" in r:
                lines.append(f"| {r['seed']} | failed: {r['failed']} | | | | | | | |")
                continue
            lines.append(
                f"| {r['seed']} | {r['lambda']:.4e} | {r['stable']}/{nd} | {r['err']:.4f} | "
                f"{r['basin_lambda']:.0e} | {r['basin_final']}/{nd} | "
                f"{r['basin_screen_share']:.3f} | {r['basin_p20']:.3f} | {r['basin_err']:.4f} |")
    w = study.get("jax_instance")
    if w:
        lines += [
            "",
            "The port's pipeline on the JAX package's data instance (data seed "
            f"{study['seed']} as the JAX",
            "package draws it: `scripts/jax_ex1a_instance.py` saves its sample times and noise",
            "normals, `docs/torch/ex1a_jax_instance.npz`; the truth solve, POD, GP fits,",
            "regression and ensembles are the port's):",
            "",
            "| search stream | lambda | grid best | basin candidates passed | above the basin |",
            "|---|---|---|---|---|",
        ]
        for s in w["searches"]:
            lines.append(f"| {s['seed_child']} | {s['lambda']:.4e} | {s['grid_best']:.4e} | "
                         f"{s['passed_basin']} | {s['passed_above']} |")
        lines += [
            "",
            "| rung | final stable | screen share | P(20-draw screen) | error |",
            "|---|---|---|---|---|",
            f"| {w['lambda']:.4e} (stream 0's lambda) | {w['stable']}/{nd} | | | "
            f"{w['err']:.4f} |",
            f"| {w['basin_lambda']:.0e} (basin) | {w['basin_final']}/{nd} | "
            f"{w['basin_screen_share']:.3f} | {w['basin_p20']:.3f} | {w['basin_err']:.4f} |",
        ]
    if study["oracle"]:
        o = study["oracle"]
        lines += ["", f"The NumPy oracle (the reference's serial search semantics on the same GP",
                  f"products) chose lambda = {o['lambda']:.4e} (grid best {o['lambda_grid']:.4e})",
                  f"and kept {o['stable']}/{nd} under the reference's final filter."]
    else:
        lines += ["", "The NumPy oracle was not run (`--skip-oracle`)."]
    lines += [
        "",
        "## Findings",
        "",
        *findings(study),
        "",
        "Reproduce: `python scripts/torch_ex1a_stability_study.py --outdir docs/torch` "
        "(`--skip-oracle` skips the oracle).",
    ]
    out = os.path.join(outdir, "ex1a_stability_study.md")
    with open(out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("wrote", out, flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ndraws", type=int, default=600)
    parser.add_argument("--outdir", default=os.path.join("docs", "torch"))
    parser.add_argument("--skip-oracle", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--from-json", metavar="PATH",
                        help="write the report from a saved study instead of running it")
    args = parser.parse_args(argv)
    if args.from_json:
        with open(args.from_json) as fh:
            study = json.load(fh)
    else:
        study = compute(device=args.device, ndraws=args.ndraws, skip_oracle=args.skip_oracle)
    write_report(study, args.outdir)
    print(json.dumps({"rows": [[r["lambda"], r["final"]] for r in study["rows"]]}))


if __name__ == "__main__":
    main()
