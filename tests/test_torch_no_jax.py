"""The PyTorch port imports no JAX: in a fresh interpreter, importing every
module of ``gp_bayesopinf_torch`` and running a forward call through the
GP, the regression, both screens, a cAHBN ROM integration with inputs and
a SEIRD search and ensemble leaves ``jax`` out of ``sys.modules``; the
SEIRD part, the low-rank Euler route, the Tikhonov regularizers, the
tall-matrix factorizations, ``run_scaled``, the ``scaled`` command line,
a named workload, the HDF5 export, the scaled checkpoint, ``serve`` and
``warmup`` (its workloads replaced) run with ``jax`` and
``gp_bayesopinf_tpu`` blocked from import."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import gp_bayesopinf_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)

from gp_bayesopinf_torch.gp import fit_gaussian_processes
from gp_bayesopinf_torch.ops import quadratic_ensemble_screen
from gp_bayesopinf_torch.rom import GalerkinROM
from gp_bayesopinf_torch.solve import weighted_lstsq_fit

gen = torch.Generator().manual_seed(0)
t = torch.linspace(0, 1, 20, dtype=torch.float64)
Y = torch.stack([torch.sin(6 * t), torch.cos(4 * t)])
t_est = torch.linspace(0, 1, 12, dtype=torch.float64)
gps = fit_gaussian_processes(t_est, t, Y, n_restarts_optimizer=2, generator=gen,
                             adam_steps=5, polish_iters=2)
rom = GalerkinROM("cAH", 2)
st = torch.stack([g.state_estimate for g in gps])
fac = weighted_lstsq_fit(rom.data_matrix(st)[None],
                         torch.stack([g.sqrtW for g in gps])[:, None],
                         torch.stack([g.ddt_estimate for g in gps])[:, None])
ohats = fac.sample(1e-3, 4, generator=gen).reshape(4, 2, -1)
stable, err = quadratic_ensemble_screen(ohats, st[:, 0], t_est, st.mean(1),
                                        torch.full((2,), 10.0), st, nd=2)
assert stable.shape == (4,) and err.shape == (2,)

from gp_bayesopinf_torch.ops import cahbn_ensemble_screen, input_stage_times
from gp_bayesopinf_torch.pipeline.pdes_multi import input_func_factory

u_of = input_func_factory((1.0, -1.0))
heat = GalerkinROM("cAHBN", 2, input_dimension=2, ivp_method="dirk2", substeps=2)
O = 0.1 * torch.randn((4, 2, heat.operator_dimension), generator=gen, dtype=torch.float64)
O[:, :, 1:3] -= torch.eye(2, dtype=torch.float64)
sol = heat.predict(O, st[:, 0], t_est, input_func=u_of)
assert sol.shape == (4, 2, 12) and bool(torch.isfinite(sol).all())
u_tab = u_of(input_stage_times(t_est, 2)).T
stable, err = cahbn_ensemble_screen(O, st[:, 0], t_est, st.mean(1), torch.full((2,), 10.0),
                                    u_tab, st, nd=2, substeps=2)
assert stable.shape == (4,) and err.shape == (2,)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))

# From here on an import of jax or of the JAX package fails.
import importlib.abc
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "gp_bayesopinf_tpu"):
            raise ImportError(f"{name} is blocked in this test")
sys.meta_path.insert(0, Block())

import numpy as np
from gp_bayesopinf_torch.bayes import BayesianODE, KernelScreenSpec, OperatorPosterior
from gp_bayesopinf_torch.bayes import auto_regularize
from gp_bayesopinf_torch.models import SEIRD2
from gp_bayesopinf_torch.pipeline import GPBounds, SEIRDConfig, run_seird

cfg = SEIRDConfig(time_domain=np.linspace(0, 90, 31),
                  gp_bounds=GPBounds((1e-8, 1e5), (0.1, 100.0), (1e-16, 0.5), 4),
                  reg_grid=np.logspace(-6, 2, 3))
res = run_seird((0.0, 60.0), 24, 0.05, 32, ndraws=8, config=cfg, device="cpu", verbose=False)
assert res.draws.shape == (8, 5, 31) and res.regularizer > 0
model = res.model
post = res.bayesian_model.posterior
ode = BayesianODE(model, post)
draws, valid = ode.solution_posterior(torch.tensor(cfg.initial_conditions, dtype=torch.float64),
                                      torch.linspace(0, 90, 31, dtype=torch.float64), 6,
                                      generator=gen)
assert draws.shape == (6, 5, 31) and bool(valid.any())
assert model.cah_operators(ode.rvs(5, generator=gen)[:, None, :]).shape == (5, 5, 21)

# The large-m' and production-scale modules.
from gp_bayesopinf_torch import convert, parallel
from gp_bayesopinf_torch.gp import lowrank_gp_estimates
from gp_bayesopinf_torch.pipeline import EulerConfig, cli, experiments, run_scaled
from gp_bayesopinf_torch.pipeline.scaled import data, estimate, gamma, rollout, run, search
from gp_bayesopinf_torch.solve import MatrixTikhonovLSTSQ, TikhonovLSTSQ

est = lowrank_gp_estimates(t, Y[0], t_est, 1.0, 0.3, 1e-4)
assert est.root.apply(torch.ones(12, dtype=torch.float64)).shape == (12,)
tik = fac.tikhonov()
assert tik.sample(0.1, 3, generator=gen).shape == (3, 2, fac.num_unknowns)
assert bool(fac.matrix_tikhonov(torch.eye(fac.num_unknowns, dtype=torch.float64)).posterior_spd(0.1))
X = torch.randn((40, 12), generator=gen, dtype=torch.float64)
assert parallel.tall_skinny_svd(X)[1].shape == (12,)
assert parallel.randomized_pod(X, 3, oversample=4, generator=gen)[0].shape == (40, 3)
small = EulerConfig(spatial_domain=np.linspace(0, 2, 25)[:-1], time_domain=np.linspace(0, 0.08, 21),
                    gp_bounds=GPBounds((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2), 4),
                    reg_grid=np.logspace(-6, 2, 3))
experiments.EULER_WORKLOADS["tiny"] = (0.06, 20, 0.01, 30, 2)
res = experiments.run_workload("euler", "tiny", ndraws=6, config=small, weight_method="lowrank",
                               verbose=False, device="cpu")
assert all(g.weight_method == "lowrank" for g in res.gps) and res.regularizer > 0
tiny = ["scaled", "--n-space", "48", "--k", "80", "--modes", "2", "--gp-samples", "30", "--mprime",
        "32", "--restarts", "2", "--ndraws", "4", "--grid-size", "4", "--device", "cpu", "--quiet"]
out = cli.run(tiny + ["--windows", "2", "--weights", "lowrank"])
assert out.window_regularizers.shape == (2,) and out.weight_ranks.shape == (2, 2)
assert cli.main(tiny + ["--modelform", "cAH", "--regularization", "blocked"]) == 0

# The service layer: export, checkpoint, serve and warmup.
import io, json, tempfile
from gp_bayesopinf_torch.io import export_result, load_bayesian_rom

scratch = tempfile.mkdtemp()
export_result(res, scratch + "/euler")
assert load_bayesian_rom(scratch + "/euler_posterior.h5", device="cpu").ndims == 2
ckpt = tiny + ["--checkpoint-dir", scratch]
first, again = cli.run(ckpt), cli.run(ckpt)
assert "gp_fit" in first.stage_seconds and "gp_fit" not in again.stage_seconds
assert again.regularizer == first.regularizer
experiments.run_workload = lambda pipeline, name, ndraws=600, *, device, **kw: None
sys.stdin = io.StringIO(" ".join(tiny) + "\nwarmup seird --device cpu\n42\nquit\n")
real_stdout, sys.stdout = sys.stdout, io.StringIO()
assert cli.main(["serve"]) == 0
lines, sys.stdout = sys.stdout.getvalue().splitlines(), real_stdout
acks = [json.loads(l)["serve"] for l in lines if l.startswith('{"serve"')]
assert [a["rc"] for a in acks] == [0, 0, 2], acks
assert not any(m.split(".")[0] in ("jax", "jaxlib", "gp_bayesopinf_tpu") for m in sys.modules)
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
