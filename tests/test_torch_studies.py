"""The port's method studies against the JAX-era scripts, on the CPU.

- ``examples/torch_extrapolation_study.py::domain_errors`` against
  ``examples/extrapolation_study.py``'s on the same seeded arrays (rtol
  1e-12; the JAX module imports JAX only inside ``main``).
- ``scripts/torch_ex1a_stability_study.py``'s copy of the NumPy oracle
  against ``scripts/ex1a_stability_study.py``'s on a tiny problem, bit for
  bit; one ladder rung on a tiny quadratic ROM: the JAX package's
  ``BayesianROM.solution_posterior`` under the JAX study's three
  semantics, and the port's ``rung`` on the JAX factorization carried
  across by ``convert.py`` with the same standard normals injected: final
  and screen counts equal, the error at rtol 1e-8; its report written
  from a saved study.
- The JAX package's ex1a data instance: the inputs
  ``scripts/jax_ex1a_instance.py`` saves are the JAX pipeline's draws, and
  the port's noise on them is the JAX package's (rtol 1e-12); the
  stability study's verdict rule.
- In processes where JAX refuses to import, at tiny sizes: the stability
  study's data seeds, its run on a JAX instance and its report; the
  low-rank sweep and the blocked study, their rows held against the
  originals' formulas computed again on the same runs, and their reports.
"""

import importlib.util
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_no_jax import finish, start

from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.models import Euler as TorchEuler
from gp_bayesopinf_torch.rom import GalerkinROM as TorchROM
from gp_bayesopinf_tpu.bayes.posterior import BayesianROM, OperatorPosterior
from gp_bayesopinf_tpu.models import Euler as JaxEuler
from gp_bayesopinf_tpu.pipeline.configs import EulerConfig as JaxEulerConfig
from gp_bayesopinf_tpu.rom.model import GalerkinROM
from gp_bayesopinf_tpu.solve.lstsq import weighted_lstsq_fit
from gp_bayesopinf_tpu.utils import key_from_seed, split_tree

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem + "_under_test", REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_domain_errors_match_the_jax_study():
    jax_study = load("examples/extrapolation_study.py")
    port_study = load("examples/torch_extrapolation_study.py")
    rng = np.random.default_rng(5)
    nx, k, nv = 7, 23, 9
    t = np.linspace(0.0, 0.15, k)
    truth = 1.0 + rng.random((3 * nx, k))
    draws = truth + 0.05 * rng.standard_normal((nv, 3 * nx, k))
    jax_res = types.SimpleNamespace(time_domain=t, true_states=truth, draws=draws)
    port_res = types.SimpleNamespace(time_domain=t, true_states=torch.as_tensor(truth),
                                     draws=torch.as_tensor(draws))
    want = jax_study.domain_errors(jax_res, 0.06)
    got = port_study.domain_errors(port_res, 0.06)
    assert got.keys() == want.keys() and len(got) == 12
    np.testing.assert_allclose([got[key] for key in want], list(want.values()), rtol=1e-12, atol=0)
    # The per-time curve of the figure, against the JAX figure's formula.
    denom = np.linalg.norm(truth, axis=0)
    np.testing.assert_allclose(port_study.per_time_error(port_res),
                               np.linalg.norm(draws.mean(axis=0) - truth, axis=0) / denom,
                               rtol=1e-12)


def _oracle_problem():
    """A stable 2-mode quadratic ROM's posterior (S large, so draws stay
    near the mean operator c = 0, A = -I, H = 0) and its GP-like data."""
    rng = np.random.default_rng(11)
    r, d = 2, 6
    S = np.full((r, d), 10.0) + rng.random((r, d))
    V = np.stack([np.linalg.qr(rng.standard_normal((d, d)))[0] for _ in range(r)])
    target = np.zeros((r, d))
    target[0, 1] = target[1, 2] = -1.0
    # Utz such that the posterior mean at lambda -> 0 is the target.
    Utz = np.einsum("rji,rj->ri", V, target) * S
    t_est, t_pred = np.linspace(0, 1, 12), np.linspace(0, 2, 17)
    state_est = np.exp(-t_est)[None] * np.array([[1.0], [0.5]])
    return dict(U=None, S=S, V=V, Utz=Utz, state_est=state_est, t_pred=t_pred, t_est=t_est)


def test_oracle_copy_is_the_jax_study_oracle_bit_for_bit():
    jax_study = load("scripts/ex1a_stability_study.py")
    port_study = load("scripts/torch_ex1a_stability_study.py")
    p = _oracle_problem()
    grid = np.array([1e-6, 1e-2, 3.0, 1e3])
    args = (p["U"], p["S"], p["V"], p["Utz"], p["state_est"], p["t_pred"], p["t_est"], grid)
    want = jax_study.oracle_search(*args, seed=3, ndraws=4, verbose=False)
    got = port_study.oracle_search(*args, seed=3, ndraws=4, verbose=False)
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert np.all(want[2] < port_study.MAXOPTVAL)  # the stable case is exercised
    snaps = p["state_est"][:, ::3]
    qbar = snaps.mean(axis=1)
    bound = 5.0 * np.abs(snaps - qbar[:, None]).max(axis=1)
    final = [mod.oracle_final_count(p["U"], p["S"], p["V"], p["Utz"], want[0], snaps[:, 0], qbar,
                                    bound, p["t_pred"], seed=3, ndraws=6)
             for mod in (jax_study, port_study)]
    assert final[0] == final[1] and 0 < final[0] <= 6
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    np.testing.assert_array_equal(
        port_study._sample_np(rng_a, None, p["S"], p["V"], p["Utz"], 0.5, 3),
        jax_study._sample_np(rng_b, None, p["S"], p["V"], p["Utz"], 0.5, 3))


R, MPRIME, NDRAWS = 3, 30, 64


def _ladder_problem():
    """A tiny cAH regression: GP-like state estimates of a stable quadratic
    system, noisy derivatives, identity weights; noisy snapshots and a
    compressed truth on the prediction grid."""
    rng = np.random.default_rng(2)
    t_est, t_pred = np.linspace(0, 1, MPRIME), np.linspace(0, 2.5, 41)
    A = -0.8 * np.eye(R) + 0.3 * np.triu(rng.standard_normal((R, R)), 1)

    def traj(t):
        return np.exp(-0.8 * t)[None] * np.array([[1.0], [-0.6], [0.4]]) + 0.05 * np.sin(3 * t)

    state_est = traj(t_est)
    ddt = A @ state_est + 0.05 * rng.standard_normal((R, MPRIME))
    snaps = traj(t_est[::3]) * (1 + 0.03 * rng.standard_normal((R, 10)))
    return dict(t_est=t_est, t_pred=t_pred, state_est=state_est, ddt=ddt, snaps=snaps,
                truth_c=traj(t_pred))


def _jax_rung(rom, fac, lam, key, p):
    """The JAX study's loop body (scripts/ex1a_stability_study.py:217-245)
    for one lambda, in float64 on the CPU."""
    brom = BayesianROM(rom, OperatorPosterior.from_lstsq(fac, lam), lam)
    snaps, est = jnp.asarray(p["snaps"]), jnp.asarray(p["state_est"])
    qbar = snaps.mean(axis=1)
    bound = 5.0 * jnp.abs(snaps - qbar[:, None]).max(axis=1)
    shift = est.mean(axis=1)
    lim = 5.0 * jnp.abs(est - shift[:, None]).max(axis=1)
    draws, valid = brom.solution_posterior(key, snaps[:, 0], p["t_pred"], ndraws=NDRAWS,
                                           stability_envelope=(qbar, bound))
    mean_sol = np.asarray(jnp.sum(jnp.where(valid[:, None, None], draws, 0.0), axis=0)
                          / jnp.maximum(valid.sum(), 1))
    err = np.linalg.norm(mean_sol - p["truth_c"]) / np.linalg.norm(p["truth_c"])
    _, v_p = brom.solution_posterior(key, est[:, 0], p["t_pred"], ndraws=NDRAWS,
                                     stability_envelope=(shift, lim))
    _, v_e = brom.solution_posterior(key, est[:, 0], p["t_est"], ndraws=NDRAWS,
                                     stability_envelope=(shift, lim))
    return int(np.asarray(valid).sum()), int(np.asarray(v_p & v_e).sum()), err


@pytest.mark.parametrize("lam", [3e-2, 0.3], ids=["mixed", "shrunk"])
def test_ladder_rung_matches_the_jax_package_on_injected_draws(lam, tmp_path):
    study = load("scripts/torch_ex1a_stability_study.py")
    p = _ladder_problem()
    rom = GalerkinROM("cAH", R, substeps=4)
    D = rom.data_matrix(jnp.asarray(p["state_est"]))[None]
    fac = weighted_lstsq_fit(D, jnp.broadcast_to(jnp.eye(MPRIME), (R, 1, MPRIME, MPRIME)),
                             jnp.asarray(p["ddt"])[:, None])
    key = jax.random.PRNGKey(20260817)
    n_final, n_screen, err = _jax_rung(rom, fac, lam, key, p)

    dev = "cpu"
    ladder = study.Ladder.build(
        TorchROM("cAH", state_dimension=R, substeps=4), convert.weighted_lstsq(fac, device=dev),
        torch.as_tensor(p["state_est"]), torch.as_tensor(p["snaps"]),
        torch.as_tensor(p["truth_c"]), p["t_pred"], p["t_est"],
    )
    xi = torch.as_tensor(np.array(jax.random.normal(key, (NDRAWS, R, fac.S.shape[1]))))
    got = study.rung(ladder, lam, xi=xi)
    assert got[:2] == (n_final, n_screen)
    assert got[2] == pytest.approx((n_screen / NDRAWS) ** 20)
    assert got[3] == pytest.approx(err, rel=1e-8, abs=0.0)
    if lam < 0.1:  # the counts decide something: some draws leave an envelope
        assert 0 < n_final < NDRAWS and 0 < n_screen < NDRAWS

    # The report, from a saved study whose rows hold this rung.
    row = {"lambda": lam, "final": got[0], "screen": got[1], "p20": got[2], "err": got[3]}
    saved = {"card": "cpu (no card)", "device": "cpu", "ndraws": NDRAWS, "chosen": lam,
             "stable": got[0], "rows": [row], "searches": [
                 {"seed_child": 0, "lambda": lam, "grid_best": lam, "passed_basin": 0,
                  "passed_above": 1}],
             "basin_grid": 53, "seed": 27092023, "data_seeds": [
                 {"seed": 1, "lambda": lam, "stable": got[0], "err": got[3], "basin_lambda": 1e-6,
                  "basin_final": got[0], "basin_screen_share": 0.5, "basin_p20": 0.0,
                  "basin_err": got[3], "wall_s": 1.0},
                 {"seed": 2, "failed": "no stable candidate", "wall_s": 1.0}],
             "oracle": None, "walls_s": {"pipeline": 1.0}}
    (tmp_path / "in.json").write_text(json.dumps(saved))
    study.main(["--from-json", str(tmp_path / "in.json"), "--outdir", str(tmp_path)])
    text = (tmp_path / "ex1a_stability_study.md").read_text()
    assert f"| {lam:.3e} <- chosen | {got[0]}/{NDRAWS} | {got[1]}/{NDRAWS} |" in text
    assert "## Findings" in text and "Seed luck or a property of the port?" in text
    assert "| 1 | " in text and "| 2 | failed: no stable candidate |" in text


#: The tiny Euler workload of the runs below (a run_euler takes seconds).
TINY = """
import numpy as np
from gp_bayesopinf_torch.pipeline.configs import EulerConfig, GPBounds
SMALL = EulerConfig(spatial_domain=np.linspace(0, 2, 41)[:-1], time_domain=np.linspace(0, 0.09, 61),
                    gp_bounds=GPBounds((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2), 16),
                    reg_grid=np.logspace(-10, 4, 9))
"""
TINY_NX, TINY_SAMPLES, TINY_SPAN = 40, 40, (0.0, 0.06)

STABILITY = TINY + r"""
import json
study = load("scripts/torch_ex1a_stability_study.py")
study.SEARCH_STREAMS = 1  # one search, not eight, at this size
workload = dict(training_span=(0.0, 0.06), num_samples=40, noiselevel=0.03,
                num_regression_points=60, num_pod_modes=3)
nd = 40
instances = study.data_instances((1,), device="cpu", ndraws=nd, config=SMALL, workload=workload)
ladder = study.instance_ladder(sys.argv[1], device="cpu", config=SMALL, workload=workload)
witness = study.jax_instance(ladder, nd, SMALL.reg_grid)
try:
    study.instance_ladder(sys.argv[1], device="cpu", config=SMALL,
                          workload={**workload, "num_samples": 41})
    raise AssertionError("another instance's inputs were taken")
except ValueError:
    pass
# The report, with this run's rows under a study that holds them.
rows = [{"lambda": lam, "final": f, "screen": s, "p20": p, "err": e}
        for lam in (1e-6, witness["lambda"]) for f, s, p, e in [study.rung(ladder, lam, nd)]]
saved = {"card": "cpu (no card)", "device": "cpu", "ndraws": nd, "chosen": witness["lambda"],
         "stable": witness["stable"], "rows": rows, "searches": witness["searches"],
         "basin_grid": int((SMALL.reg_grid <= study.BASIN_MAX).sum()), "seed": SMALL.seed,
         "data_seeds": instances, "jax_instance": witness, "oracle": None, "walls_s": {}}
study.write_report(saved, sys.argv[2])
assert_no_jax()
print(json.dumps({"instances": instances, "witness": witness, "verdict": study.verdict(saved)}))
"""

SWEEP = TINY + r"""
import json
import scipy.linalg, torch
from gp_bayesopinf_torch.gp import lowrank
sweep = load("scripts/torch_lowrank_fidelity_sweep.py")
runs, real = [], sweep.run_euler
def recorded(**kw):
    runs.append(real(**kw))
    return runs[-1]
sweep.run_euler = recorded
default = lowrank.DEFAULT_TOL_FACTOR
study = sweep.compute(device="cpu", tols=(1e-6,), mprime=60, ndraws=20, config=SMALL,
                      num_samples=40, noiselevel=0.01, num_pod_modes=3)
assert lowrank.DEFAULT_TOL_FACTOR == default  # restored
sweep.write_report(study, sys.argv[1])
# The original's formulas on the recorded runs, in NumPy and SciPy.
dense, low = runs
probe = np.random.default_rng(0).standard_normal((60, 8))
errs = []
for gd, gl in zip(dense.gps, low.gps):
    half = scipy.linalg.solve_triangular(gd.sqrtW.numpy(), probe, lower=True)
    want = half.T @ half
    if gl.lowrank_root is None:
        errs.append(0.0)
        continue
    got = gl.lowrank_root.apply(torch.as_tensor(probe)).numpy()
    errs.append(float(np.linalg.norm(got.T @ got - want) / np.linalg.norm(want)))
assert_no_jax()
print(json.dumps({"study": study, "independent": {
    "lambda": [float(r.regularizer) for r in runs],
    "stable": [int(np.asarray(r.valid).sum()) for r in runs],
    "ranks": [int(g.lowrank_root.rank) for g in low.gps if g.lowrank_root is not None],
    "weight_gram_relerr": errs}}))
"""

BLOCKED_STUDY = r"""
import json
study = load("scripts/torch_blocked_reg_study.py")
runs, real = [], study.run_scaled
def recorded(**kw):
    try:
        runs.append(real(**kw))
    except ValueError:
        runs.append(None)
        raise
    return runs[-1]
study.run_scaled = recorded
study.main(["--device", "cpu", "--seeds", "0", "--nx", "32", "--k", "200", "--r", "4",
            "--mprime", "64", "--gp-samples", "60", "--restarts", "2", "--ndraws", "8",
            "--grid-size", "6", "--outdir", sys.argv[1]])
assert_no_jax()
# The original's row: the result's fields.
print(json.dumps([None if r is None else {
    "lambda": r.regularizer, "lambda_quad": r.regularizer_quad, "stable": r.stable_fraction,
    "train_error": r.train_error} for r in runs]))
"""


@pytest.fixture(scope="module")
def no_jax_runs(tmp_path_factory):
    """The three studies' runs at tiny sizes, side by side in three
    processes where JAX refuses to import: the stability study's pieces
    on a tiny JAX instance drawn here, the low-rank sweep and the blocked
    study. Each test waits for its own."""
    jax_instance = load("scripts/jax_ex1a_instance.py")
    tiny = JaxEulerConfig(spatial_domain=np.linspace(0, 2, TINY_NX + 1)[:-1])
    npz = tmp_path_factory.mktemp("instance") / "tiny.npz"
    np.savez(npz, **jax_instance.instance(tiny, TINY_SAMPLES, TINY_SPAN))
    out = {name: tmp_path_factory.mktemp(name) for name in ("stability", "sweep", "blocked")}
    procs = {"stability": start(STABILITY, npz, out["stability"]),
             "sweep": start(SWEEP, out["sweep"]),
             "blocked": start(BLOCKED_STUDY, out["blocked"])}
    yield {name: (procs[name], out[name]) for name in procs}
    for proc in procs.values():
        proc.kill()
        proc.communicate()


def test_jax_instance_is_the_jax_package_draws():
    """The committed inputs are what ``scripts/jax_ex1a_instance.py`` draws,
    and the port's ``Euler.noise`` on them is the JAX package's
    ``Euler.noise`` under the pipeline's key (rtol 1e-12, a tiny grid)."""
    jax_instance = load("scripts/jax_ex1a_instance.py")
    committed = np.load(REPO / "docs" / "torch" / "ex1a_jax_instance.npz")
    want = jax_instance.instance()
    assert committed.files == list(want)
    for key, value in want.items():
        np.testing.assert_array_equal(committed[key], value)
    assert committed["normals"].shape == (600, 199) and committed["t_sampled"].shape == (200,)

    tiny = JaxEulerConfig(spatial_domain=np.linspace(0, 2, TINY_NX + 1)[:-1])
    drawn = jax_instance.instance(tiny, TINY_SAMPLES, TINY_SPAN)
    keys = split_tree(key_from_seed(tiny.seed), ["sample", "noise", "fit", "search", "draws"])
    t = np.sort(np.asarray(jax.random.uniform(keys["sample"], (TINY_SAMPLES,),
                                              minval=TINY_SPAN[0], maxval=TINY_SPAN[1])))
    t[0], t[-1] = TINY_SPAN
    np.testing.assert_array_equal(drawn["t_sampled"], t)
    jax_model = JaxEuler(tiny.spatial_domain, substeps=tiny.fom_substeps)
    port_model = TorchEuler(tiny.spatial_domain, substeps=tiny.fom_substeps)
    rng = np.random.default_rng(4)
    states = np.concatenate([1.0 + rng.random((TINY_NX, TINY_SAMPLES)),  # positive density
                             rng.standard_normal((TINY_NX, TINY_SAMPLES)),
                             2.0 + rng.random((TINY_NX, TINY_SAMPLES))])
    want = np.asarray(jax_model.noise(keys["noise"], jnp.asarray(states), 0.03))
    got = port_model.noise(torch.as_tensor(states), 0.03,
                           normals=torch.as_tensor(np.array(drawn["normals"]))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert not np.array_equal(got, states)


def test_stability_study_runs_without_jax(no_jax_runs):
    proc, out = no_jax_runs["stability"]
    result = json.loads(finish(proc).strip().splitlines()[-1])
    nd = 40
    (seed1,) = result["instances"]
    witness = result["witness"]
    for row in (seed1, witness):
        assert row["lambda"] > 0 and 0 <= row["stable"] <= nd and np.isfinite(row["err"])
        assert 0 <= row["basin_final"] <= nd and 0 <= row["basin_screen_share"] <= 1
        assert row["basin_p20"] == pytest.approx(row["basin_screen_share"] ** 20)
    assert seed1["seed"] == 1 and len(witness["searches"]) == 1
    assert witness["searches"][0]["lambda"] == witness["lambda"]
    assert result["verdict"] in ("instance", "port", "unresolved")
    text = (out / "ex1a_stability_study.md").read_text()
    assert "The port's pipeline on the JAX package's data instance" in text
    assert f"| {witness['basin_lambda']:.0e} (basin) | {witness['basin_final']}/{nd} |" in text
    assert "Seed luck or a property of the port?" in text


def test_verdict_reads_the_jax_instance_basin_share():
    study = load("scripts/torch_ex1a_stability_study.py")
    base = {"ndraws": 600, "rows": [{"lambda": 1e-6, "screen": 380}, {"lambda": 0.06, "screen": 590}]}

    def verdict(share):
        return study.verdict({**base, "jax_instance": {"basin_screen_share": share}})

    # JAX's basin shares are 523/600 to 539/600; the port's own here 380/600.
    assert verdict(0.87) == "instance" and verdict(523 / 600 - 0.03) == "instance"
    assert verdict(0.64) == "port" and verdict(0.30) == "port"
    assert verdict(0.76) == "unresolved"
    assert study.verdict(base) == "unresolved"


def test_lowrank_sweep_at_a_tiny_size(no_jax_runs):
    proc, out = no_jax_runs["sweep"]
    result = json.loads(finish(proc).strip().splitlines()[-1])
    study, independent = result["study"], result["independent"]
    assert [r["run"] for r in study["rows"]] == ["dense-chol", "lowrank@1e-06"]
    # The original's keys, and its formulas computed again on the same runs.
    assert {"run", "lambda", "stable", "ndraws", "wall_s"} <= study["rows"][0].keys()
    assert all(r["kernel_a_launches"] == 0 for r in study["rows"])  # the plain screen on the CPU
    assert [r["lambda"] for r in study["rows"]] == independent["lambda"]
    assert [r["stable"] for r in study["rows"]] == independent["stable"]
    low = study["rows"][1]
    assert low["tol_factor"] == 1e-6 and low["ranks"] == independent["ranks"]
    assert len(low["weight_gram_relerr"]) == 3
    # Each error is a difference of two Grams that agree to ~1e-5, so the two
    # computations (SciPy's triangular solve, torch's) agree to 1e-11 of |G|.
    np.testing.assert_allclose(low["weight_gram_relerr"], independent["weight_gram_relerr"],
                               rtol=0, atol=1e-11)
    text = (out / "lowrank_fidelity_sweep.md").read_text()
    assert "| dense-chol |" in text and "| lowrank@1e-06 |" in text and "## Findings" in text
    assert json.loads((out / "lowrank_fidelity_sweep.json").read_text()) == study


def test_blocked_study_at_a_tiny_size(no_jax_runs):
    proc, out = no_jax_runs["blocked"]
    stdout = finish(proc)
    independent = json.loads(stdout.strip().splitlines()[-1])
    rows = [json.loads(x) for x in stdout.split("== summary ==")[1].splitlines()[:-1]
            if x.startswith("{")]
    assert [(r["reg"], r["seed"]) for r in rows] == [("scalar", 0), ("blocked", 0)]
    assert len(independent) == len(rows)
    for row, want in zip(rows, independent):
        if want is None:  # an all-unstable grid is a row of its own kind
            assert "error" in row
            continue
        assert {key: row[key] for key in want} == want
        assert row["lambda"] > 0 and np.isfinite(row["train_error"])
    assert any(want is not None for want in independent)
    text = (out / "blocked_reg_study.md").read_text()
    assert "| scalar | 0 |" in text and "| blocked | 0 |" in text and "## Findings" in text
