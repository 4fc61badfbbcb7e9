"""The port's multi-device layer (``gp_bayesopinf_torch.parallel``) on the
CPU: the mesh rules and messages against the JAX package's, the process
group's set-up and refusals, and the three sharded factorizations in 2 and
4 gloo ranks against the JAX package's sharded forms on its 8 virtual CPU
devices (``tests/conftest.py``) and against the port's own one-device
calls, on the same seeded inputs with the POD sketch replayed.

Tolerances: the TSQR's singular values to rtol 1e-7 and its
reconstruction to atol 1e-8 in float64 (the JAX package's own test); the
randomized POD's leading singular values to 1e-9 (float64) and 1e-5
(float32) of the largest; the Gram route's to 1e-8 of the largest (it
squares the condition number). Against the port's one-device calls: the
TSQR bit for bit (the same row blocks), the PODs to the same bounds (their
sums run in another order).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_common as common
from gp_bayesopinf_tpu.parallel import make_mesh as j_make_mesh
from gp_bayesopinf_tpu.parallel import mesh_shape_for as j_mesh_shape_for
from gp_bayesopinf_tpu.parallel import sharded as jsh
from gp_bayesopinf_torch.parallel import distributed, initialize, mesh_shape_for, spawn
from gp_bayesopinf_torch.parallel.mesh import make_mesh, mesh_sizes

SHAPES = {2: {"draw": 2, "mode": 1}, 4: {"mode": 2, "draw": 2}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("axis_sizes,n", [
    ({"draw": -1}, 8), ({"draw": 4, "mode": 2}, 8), ({"draw": -1, "mode": 2}, 6),
    ({"a": -1, "b": -1}, 4), ({"draw": -1, "mode": 3}, 8), ({"draw": 2, "mode": 2}, 8),
    ({"seq": 1}, 1), ({"draw": 3}, 2),
])
def test_mesh_rules_and_messages_match_jax(axis_sizes, n):
    try:
        jsizes = list(j_make_mesh(dict(axis_sizes), devices=jax.devices()[:n]).shape.values())
    except ValueError as exc:
        with pytest.raises(ValueError) as caught:
            mesh_sizes(dict(axis_sizes), n)
        assert str(caught.value) == str(exc)
    else:
        assert mesh_sizes(dict(axis_sizes), n) == jsizes


def test_mesh_shape_for_matches_jax():
    for n in range(1, 9):
        assert mesh_shape_for(n) == j_mesh_shape_for(n)


def test_initialize_alone_is_a_no_op_and_a_mesh_needs_a_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize() is None and initialize(num_processes=1) is None
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_mesh({"draw": 1}, "cpu")
    with pytest.raises(ValueError, match=r"mesh \[2\] != 1 devices"):
        make_mesh({"draw": 2}, "cpu")


@pytest.mark.parametrize("backend,device,match", [
    ("mpi", "cpu", "unknown backend 'mpi'"),
    ("nccl", "cpu", "NCCL takes CUDA devices"),
])
def test_an_unknown_or_unfit_backend_is_refused(backend, device, match):
    with pytest.raises(ValueError, match=match):
        initialize("localhost:1", 2, 0, backend=backend, device=device)
    with pytest.raises(ValueError, match=match):
        spawn(common.value, 2, [device] * 2, backend=backend)
    assert not torch.distributed.is_initialized()


def test_a_rank_whose_peers_never_come_fails_within_its_time_limit():
    t0 = time.monotonic()
    with pytest.raises(Exception, match="(?i)time"):
        initialize(f"localhost:{distributed._free_port()}", 2, 0, device="cpu", timeout=3.0)
    assert time.monotonic() - t0 < 30
    assert not torch.distributed.is_initialized()


def test_two_ranks_on_one_card_are_refused_under_nccl():
    distributed.check_distinct_cards(["GPU-a", "GPU-b"])
    with pytest.raises(ValueError, match=r"ranks 0 and 2 are on the same card \(GPU-a\)"):
        distributed.check_distinct_cards(["GPU-a", "GPU-b", "GPU-a"])


def test_spawn_returns_values_in_rank_order():
    assert spawn(common.value, 3, ["cpu"] * 3, args=("x",), timeout=120) == [
        (0, "x", 3, 1), (1, "x", 3, 1), (2, "x", 3, 1)]


@pytest.mark.parametrize("fn,timeout,error,match", [
    (common.raise_on_1, 60.0, RuntimeError,
     "(?s)rank 1 of 2 failed:.*ArithmeticError: rank 1 fails"),
    (common.exit_on_1, 60.0, RuntimeError, r"exited without a value, exit codes \{1: 3\}"),
    (common.hang, 8.0, TimeoutError, r"rank\(s\) \[0, 1\] gave no value within 8"),
])
def test_a_failing_rank_fails_the_caller_within_the_time_limit(fn, timeout, error, match):
    t0 = time.monotonic()
    with pytest.raises(error, match=match):
        spawn(fn, 2, ["cpu"] * 2, timeout=timeout)
    assert time.monotonic() - t0 < 30


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(27092023)
    X = rng.standard_normal((2, 64, 5)) * np.logspace(0, -4, 5)
    left = np.linalg.qr(rng.standard_normal((96, 20)))[0]
    right = np.linalg.qr(rng.standard_normal((40, 20)))[0]
    snaps = (left * np.logspace(0, -3, 20)) @ right.T + 1e-5 * rng.standard_normal((96, 40))
    key = jax.random.PRNGKey(4)
    omega = np.asarray(jax.random.normal(key, (40, 14), dtype=jnp.float64))
    omega32 = np.asarray(jax.random.normal(key, (40, 14), dtype=jnp.float32))
    return dict(X=X, snaps=snaps, key=key, omega=omega, omega32=omega32)


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every rank's values at world 2 and world 4 (one spawn each)."""
    args = lambda w: (SHAPES[w], inputs["X"], inputs["snaps"], inputs["omega"],  # noqa: E731
                      inputs["omega32"])
    return {w: spawn(common.factorizations, w, ["cpu"] * w, args=args(w), timeout=300)
            for w in SHAPES}


@pytest.fixture(scope="module")
def jax_forms(inputs):
    devs = jax.devices()
    X, snaps = jnp.asarray(inputs["X"]), jnp.asarray(inputs["snaps"])
    seq = j_make_mesh({"seq": 4}, devices=devs[:4])
    return dict(
        tsqr=jsh.tall_skinny_svd(X, mesh=j_make_mesh({"mode": 2, "draw": 2}, devices=devs[:4]),
                                 spec=("mode", "draw", None)),
        pod=jsh.randomized_pod(snaps, 6, mesh=seq, row_axis="seq", oversample=8,
                               key=inputs["key"]),
        pod32=jsh.randomized_pod(snaps.astype(jnp.float32), 6, mesh=seq, row_axis="seq",
                                 oversample=8, key=inputs["key"]),
        gram=jsh.sharded_gram_pod(snaps[:, :12], 4, mesh=seq, row_axis="seq"),
    )


@pytest.mark.parametrize("world", sorted(SHAPES))
def test_tall_skinny_svd_on_a_mesh_matches_jax_and_one_device(ranks, jax_forms, inputs, world):
    X = inputs["X"]
    jU, jS, jV = map(np.asarray, jax_forms["tsqr"])
    for out in ranks[world]:
        U, S, V = out["tsqr"]
        np.testing.assert_allclose(S, jS, rtol=1e-7)
        np.testing.assert_allclose(S, np.linalg.svd(X, compute_uv=False), rtol=1e-7)
        np.testing.assert_allclose((U * S[:, None, :]) @ np.swapaxes(V, 1, 2), X, atol=1e-8)
        # The same row blocks as one device's call: the same bits.
        for mine, one in zip(out["tsqr"], out["tsqr_one"]):
            np.testing.assert_array_equal(mine, one)
        for mine, first in zip(out["tsqr"], ranks[world][0]["tsqr"]):
            np.testing.assert_array_equal(mine, first)


@pytest.mark.parametrize("world", sorted(SHAPES))
@pytest.mark.parametrize("name,tol", [("pod", 1e-9), ("pod32", 1e-5)])
def test_randomized_pod_on_a_mesh_matches_jax_and_one_device(ranks, jax_forms, inputs, world,
                                                             name, tol):
    exact_U, exact_S, _ = np.linalg.svd(inputs["snaps"], full_matrices=False)
    jU, jS = map(np.asarray, jax_forms[name])
    for out in ranks[world]:
        U, S = out[name]
        U1, S1 = out[name + "_one"]
        assert U.shape == (96, 6) and S.shape == (14,) and S.dtype == np.float64
        for ref in (jS, S1, exact_S):
            np.testing.assert_allclose(S[:6], ref[:6], rtol=0, atol=tol * exact_S[0])
        signs = np.sign(np.sum(U * U1, axis=0))
        np.testing.assert_allclose(U * signs, U1, atol=100 * tol)
        signs = np.sign(np.sum(U * jU, axis=0))
        np.testing.assert_allclose(U * signs, jU, atol=100 * tol)
        np.testing.assert_array_equal(U, ranks[world][0][name][0])


@pytest.mark.parametrize("world", sorted(SHAPES))
def test_sharded_gram_pod_on_a_mesh_matches_jax_and_one_device(ranks, jax_forms, inputs, world):
    jU, jS = map(np.asarray, jax_forms["gram"])
    exact = np.linalg.svd(inputs["snaps"][:, :12], compute_uv=False)
    for out in ranks[world]:
        U, S = out["gram"]
        U1, S1 = out["gram_one"]
        for ref in (jS, S1):
            np.testing.assert_allclose(S, ref, rtol=0, atol=1e-8 * exact[0])
        for ref in (jU, U1):
            signs = np.sign(np.sum(U * ref, axis=0))
            np.testing.assert_allclose(U * signs, ref, atol=1e-6)


@pytest.mark.parametrize("world", sorted(SHAPES))
def test_shard_gather_and_sum_over_the_ranks(ranks, world):
    rows = np.arange(24.0).reshape(12, 2)
    blocks = [out["block"] for out in ranks[world]]
    # Rank i holds block i of the row-major order over the mesh's axes.
    np.testing.assert_array_equal(np.concatenate(blocks), rows)
    for out in ranks[world]:
        np.testing.assert_array_equal(out["round_trip"], rows)
        assert out["sum"].tolist() == [world * (world + 1) / 2]
        assert out["odd"] == f"a leading dimension of 7 does not divide over {world} ranks of " \
            f"{tuple(SHAPES[world])}"
        assert "have no ['seq']" in out["axis"]
