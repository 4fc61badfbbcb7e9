"""The PyTorch port imports no JAX: in a fresh interpreter, importing every
module of ``gp_bayesopinf_torch`` and running a forward call through the
GP, the regression, both screens and a cAHBN ROM integration with inputs
leaves ``jax`` out of ``sys.modules``."""

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
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
