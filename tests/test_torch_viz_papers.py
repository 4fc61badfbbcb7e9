"""The three paper functions of the PyTorch port's plotting layer
(``gp_bayesopinf_torch.viz.paper``: ``euler_paper``, ``seird_paper``,
``heat_paper``, each drawing a pipeline's whole figure set) against the
JAX package's, on the CPU under Agg, on the
same seeded artifacts as ``tests/test_torch_viz.py``: every job draws,
nothing is skipped, the same files are saved under the same names, and
every figure one saves equals the JAX package's artist by artist and
exactly (``tests/_torch_viz_common.py``)."""

import os

import matplotlib
import pytest

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
from _torch_viz_common import PAPERS, assert_same_figure, write_artifacts  # noqa: E402

from gp_bayesopinf_tpu.viz import paper as jpaper  # noqa: E402
from gp_bayesopinf_torch.viz import paper  # noqa: E402

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_artifacts(tmp_path_factory.mktemp("artifacts"))


@pytest.mark.parametrize("name", sorted(PAPERS))
def test_paper_matches_jax(name, data, tmp_path, capsys, monkeypatch):
    made, drawn = {}, {}
    for mod, sub in ((paper, "port"), (jpaper, "jax")):
        drawn[sub] = []
        save = mod._save_or_return

        def recording(figs, savedir, save=save, seen=drawn[sub]):
            seen.extend(figs.items())
            return save(figs, savedir)

        monkeypatch.setattr(mod, "_save_or_return", recording)
        out = str(tmp_path / sub)
        jobs = PAPERS[name](mod, data, out)
        made[sub] = {job: {k: os.path.relpath(v, out) for k, v in figs.items()}
                     for job, figs in jobs.items()}
        saved = sorted(os.listdir(out))
        assert saved == sorted({f for figs in made[sub].values() for f in figs.values()})
    assert "skipped" not in capsys.readouterr().out
    assert made["port"] == made["jax"] and len(made["port"]) >= 3
    assert [k for k, _ in drawn["port"]] == [k for k, _ in drawn["jax"]]
    for (_, fig), (_, ref) in zip(drawn["port"], drawn["jax"]):
        assert_same_figure(fig, ref)
    assert not plt.get_fignums()  # each figure is closed once saved
