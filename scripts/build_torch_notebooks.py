"""Generate the PyTorch port's demo notebooks in examples/ (the
counterparts of ``seird.ipynb`` and ``heat.ipynb``, which
``scripts/build_notebooks.py`` writes for the JAX package):

    python scripts/build_torch_notebooks.py

writes ``examples/torch_seird.ipynb`` and ``examples/torch_heat.ipynb``,
output-free and with fixed cell ids, so the committed files equal what
this script writes. The notebooks run on the device that
``GPBOI_NB_DEVICE`` names (default ``cuda``, no fallback: set
``GPBOI_NB_DEVICE=cpu`` where there is no card) and need matplotlib.
"""

import os

import nbformat as nbf

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "..", "examples")

DEVICE_CELL = """\
import os

import numpy as np
import matplotlib.pyplot as plt
import torch

from gp_bayesopinf_torch.utils.device import resolve_device

# The device comes from GPBOI_NB_DEVICE (default cuda). There is no
# fallback: where there is no card, set GPBOI_NB_DEVICE=cpu.
DEVICE = resolve_device(os.environ.get("GPBOI_NB_DEVICE", "cuda"))"""


def nb(name, cells):
    book = nbf.v4.new_notebook()
    book["metadata"]["kernelspec"] = {
        "display_name": "Python 3",
        "language": "python",
        "name": "python3",
    }
    book["cells"] = [
        (nbf.v4.new_markdown_cell if kind == "md" else nbf.v4.new_code_cell)(
            src, id=f"{name}-{i}"
        )
        for i, (kind, src) in enumerate(cells)
    ]
    return book


# --------------------------- torch_seird.ipynb --------------------------------
seird = nb("seird", [
    ("md", "# Epidemiological Model Simulations (PyTorch port)\n\n"
     "Forward simulations of the SEIRD family on one device\n"
     "(`gp_bayesopinf_torch.models.seird`; the port's counterpart of\n"
     "`seird.ipynb` and of the reference notebook `models/seird.ipynb`).\n"
     "The five-compartment model is reparameterized to the four regression\n"
     "unknowns the operator-inference pipeline estimates."),
    ("code", DEVICE_CELL + "\n\nfrom gp_bayesopinf_torch.models.seird import SEIRD2"),
    ("md", "## SEIRD model\n\n"
     "Epidemiological parameters $(N, \\beta, \\delta, \\gamma, \\alpha, \\rho)$\n"
     "map to the four regression parameters\n"
     "$(\\beta/N,\\ \\delta,\\ (1-\\alpha)\\gamma,\\ \\alpha\\rho)$\n"
     "(`SEIRD2.convert_parameters`). Integration is a fixed-step float64\n"
     "RK4 on the device of the initial state."),
    ("code", """\
N = 1.0
beta, delta, gamma, alpha, rho = 0.25, 0.1, 0.1, 0.05, 0.05
E0, I0, R0, D0 = 0.005, 0.001, 0.0, 0.0
S0 = N - E0 - I0 - R0 - D0

params4 = SEIRD2.convert_parameters((N, beta, delta, gamma, alpha, rho))
seird = SEIRD2(parameters=tuple(params4.tolist()))
t = np.linspace(0, 200, 500)
q0 = torch.tensor([S0, E0, I0, R0, D0], dtype=torch.float64, device=DEVICE)
solution = seird.solve(q0, torch.as_tensor(t, device=DEVICE), strict=True)
solution.shape"""),
    ("code", """\
# Plot the solution without noise.
seird.plot(t, solution, ls="-")
plt.show()"""),
    ("code", """\
# Plot the solution with multiplicative truncated-normal noise (the
# reference's noise model, kept inside [0, 1] for count-like variables),
# drawn on the device from a seeded generator.
generator = torch.Generator(device=DEVICE).manual_seed(0)
noisy = seird.noise(solution, 0.1, generator=generator)
fig, ax = seird.plot(t, noisy)
ax.set_ylim(top=1.4)
ax.legend(loc="upper center", ncol=5)
plt.show()"""),
    ("code", """\
# Phase-plane view (susceptible vs infected).
seird.plot_phase(t, solution, variables=(0, 2))
plt.show()"""),
])

# --------------------------- torch_heat.ipynb ---------------------------------
heat = nb("heat", [
    ("md", "# Heat Simulations (PyTorch port)\n\n"
     "Solution behavior for the forced cubic heat equation\n"
     "(`gp_bayesopinf_torch.models.heat.CubicHeatBimodal`; the port's\n"
     "counterpart of `heat.ipynb` and of the reference notebook\n"
     "`models/heat.ipynb`).\n\n"
     "$$\\frac{\\partial q}{\\partial t} = \\kappa\\,\\frac{\\partial^2 q}"
     "{\\partial x^2} - q^3 + f(x, t),\\qquad x \\in (0, 1),$$\n\n"
     "with Dirichlet boundary conditions $q(0,t)=\\alpha$, $q(1,t)=\\beta$\n"
     "and the bimodal forcing\n"
     "$f(x,t) = a\\,\\frac{\\sin(2\\pi t)}{1 + 100 (x - 1/4)^2}"
     " + b\\,\\frac{\\sin(4\\pi t)}{1 + 100 (x - 3/4)^2}$.\n"
     "Time stepping is an implicit SDIRK2 scheme whose Newton systems are\n"
     "tridiagonal: `solve_host` solves them on the host with LAPACK `dgtsv`\n"
     "(the pipelines' truth solves), `solve` on the device by a batched\n"
     "Thomas algorithm.\n\n"
     "The full-size solves below (500 x 500) run on the host, with\n"
     "`solve_host`, whatever `DEVICE` is: at this size the device `solve` is\n"
     "a chain of millions of small launches and takes minutes (its wall:\n"
     "`python scripts/torch_heat_solve_wall.py`). The device solve is shown\n"
     "on a 41 x 41 grid, against the host's."),
    ("code", DEVICE_CELL + "\n\nfrom gp_bayesopinf_torch.models.heat import CubicHeatBimodal"),
    ("code", """\
alpha, beta = 0.0, 1.0
kappa = 5e-3
x = np.linspace(0, 1, 500)
t = np.linspace(0, 2, 500)

model = CubicHeatBimodal(x, alpha, beta, diffusion=kappa, a=1.0, b=1.0)
q0 = x * (1 - x) + x  # smooth initial profile compatible with the BCs
solution = model.solve_host(q0, t)
solution.shape"""),
    ("code", """\
# The same SDIRK2 on the device: each Newton step is a Thomas solve of
# 2N dependent elementwise steps, so the device solve is a long chain of
# small launches. On a coarse grid, against the host twin.
xc, tc = np.linspace(0, 1, 41), np.linspace(0, 2, 41)
coarse = CubicHeatBimodal(xc, alpha, beta, diffusion=kappa, a=1.0, b=1.0)
qc0 = xc * (1 - xc) + xc
on_device = coarse.solve(torch.as_tensor(qc0, device=DEVICE), tc)
np.testing.assert_allclose(on_device.cpu().numpy(), coarse.solve_host(qc0, tc), rtol=1e-10)
on_device.device, on_device.shape"""),
    ("code", """\
fig, axes = model.plot_spacetime(t, solution, nlines=12)
axes[0].set_title("profiles in space")
axes[1].set_title("traces in time")
plt.show()"""),
    ("code", """\
# Render the animation to a file (HTML display works in a live kernel:
# from IPython.display import HTML; HTML(anim.to_jshtml())). Subsampled
# frames keep the GIF render quick.
anim = model.animate(solution[:, ::20], saveas="torch_heat_cubic.gif")"""),
    ("md", "A bimodal forcing with opposite-sign amplitudes drives the two\n"
     "humps against each other; the cubic reaction saturates the response."),
    ("code", """\
model2 = CubicHeatBimodal(x, alpha, beta, diffusion=kappa, a=1.0, b=-2.0)
solution2 = model2.solve_host(q0, t)
fig, axes = model2.plot_spacetime(t, solution2, nlines=12)
plt.show()"""),
])

NOTEBOOKS = {"torch_seird.ipynb": seird, "torch_heat.ipynb": heat}


def main(out=OUT):
    os.makedirs(out, exist_ok=True)
    for name, book in NOTEBOOKS.items():
        path = os.path.join(out, name)
        nbf.write(book, path)
        print("wrote", path)


if __name__ == "__main__":
    main()
