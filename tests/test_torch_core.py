"""``repro_torch.core`` against ``repro.core`` on the same inputs."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import consensus as jcns  # noqa: E402
from repro.core import dual_averaging as jda  # noqa: E402
from repro.core import stragglers as jstr  # noqa: E402
from repro_torch.core import consensus as cns  # noqa: E402
from repro_torch.core import stragglers  # noqa: E402
from repro_torch.core.dual_averaging import BetaSchedule  # noqa: E402


@pytest.mark.parametrize("k,mu,scale", [(1.0, 1.0, 1.0), (50.0, 32.0, 200.0),
                                        (100.0, 1.0, 100.0)])
def test_beta_schedule_is_bit_exact_in_float32(k, mu, scale):
    mine, theirs = BetaSchedule(k, mu, scale), jda.BetaSchedule(k, mu, scale)
    for t in (1, 2, 3, 7, 100, 12345):
        assert np.float32(mine(t)) == np.float32(theirs(t))


@pytest.mark.parametrize("name,n", [("ring", 2), ("ring", 5), ("torus", 4),
                                    ("torus", 6), ("complete", 4),
                                    ("star", 5), ("paper", 10)])
def test_graphs_and_metropolis_weights_match(name, n):
    adj = cns.build_graph(name, n)
    np.testing.assert_array_equal(adj, jcns.build_graph(name, n))
    assert cns.is_connected(adj) and jcns.is_connected(adj)
    for lazy in (0.0, 0.3, 0.5):
        np.testing.assert_allclose(cns.metropolis_weights(adj, lazy),
                                   jcns.metropolis_weights(adj, lazy),
                                   rtol=0, atol=0)


def test_torus_and_disconnected_graph():
    np.testing.assert_array_equal(cns.torus_graph(2, 3),
                                  jcns.torus_graph(2, 3))
    adj = np.zeros((4, 4), dtype=bool)
    adj[0, 1] = adj[1, 0] = True
    assert not cns.is_connected(adj) and not jcns.is_connected(adj)


@pytest.mark.parametrize("rounds", [0, 1, 4])
def test_dense_gossip_and_exact_average(rounds):
    rng = np.random.default_rng(0)
    m = rng.standard_normal((6, 3, 5)).astype(np.float32)
    p = jcns.metropolis_weights(jcns.ring_graph(6), 0.5)
    want = jcns.gossip(jnp.asarray(m), jnp.asarray(p, jnp.float32), rounds)
    got = cns.gossip(torch.from_numpy(m), p, rounds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        cns.exact_average(torch.from_numpy(m)).numpy(),
        np.asarray(jcns.exact_average(jnp.asarray(m))), rtol=1e-6,
        atol=1e-6)


# (per-node round counts, max_rounds): JAX's own case
# (tests/test_consensus.py::test_gossip_per_node_rounds), the uniform
# case, a max_rounds above the largest count, and no max_rounds
PER_NODE = [([0, 1, 2, 3, 4, 5], 5), ([3] * 6, 3), ([2, 0, 1, 2, 0, 1], 7),
            ([1, 4, 0, 2, 2, 3], None)]


@pytest.mark.parametrize("counts,max_rounds", PER_NODE)
def test_gossip_per_node_rounds_match_jax(counts, max_rounds):
    """An (n,) count r_i(t) a node (the paper's fixed T_c, in which nodes
    finish different numbers of rounds): a node past its count keeps its
    value; the same numbers as JAX's ``gossip`` on the same inputs."""
    n = len(counts)
    rng = np.random.default_rng(sum(counts))
    m = rng.standard_normal((n, 3, 2)).astype(np.float32)
    p = jcns.metropolis_weights(jcns.ring_graph(n), 0.5)
    want = np.asarray(jcns.gossip(jnp.asarray(m), jnp.asarray(p, jnp.float32),
                                  jnp.asarray(counts), max_rounds=max_rounds))
    got = cns.gossip(torch.from_numpy(m), p, torch.tensor(counts),
                     max_rounds=max_rounds)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    for i in np.nonzero(np.asarray(counts) == 0)[0]:
        np.testing.assert_array_equal(got[i].numpy(), m[i])
    if len(set(counts)) == 1:          # uniform counts: the scalar rounds
        np.testing.assert_allclose(
            got.numpy(), cns.gossip(torch.from_numpy(m), p,
                                    counts[0]).numpy(), rtol=1e-6, atol=1e-6)


def test_gossip_scalar_rounds_with_max_rounds_match_jax():
    """A scalar count with a static ``max_rounds`` above it: every node
    stops at the count, as JAX's masked loop does."""
    rng = np.random.default_rng(2)
    m = rng.standard_normal((5, 4)).astype(np.float32)
    p = jcns.metropolis_weights(jcns.ring_graph(5), 0.5)
    want = np.asarray(jcns.gossip(jnp.asarray(m), jnp.asarray(p, jnp.float32),
                                  2, max_rounds=6))
    got = cns.gossip(torch.from_numpy(m), p, 2, max_rounds=6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), cns.gossip(torch.from_numpy(m), p, 2).numpy(),
        rtol=1e-6, atol=1e-6)


def test_graphs_dict_matches_jax():
    """``GRAPHS``: the same builders by name, the same graphs."""
    assert sorted(cns.GRAPHS) == sorted(jcns.GRAPHS)
    for name, build in cns.GRAPHS.items():
        args = () if name == "paper" else (6,)
        np.testing.assert_array_equal(build(*args), jcns.GRAPHS[name](*args))


@pytest.mark.parametrize("budget", [0.0, 0.004, 0.02, 1e3])
def test_amb_batch_sizes_match(budget):
    rng = np.random.default_rng(1)
    times = (rng.random((5, 16)) * 0.003).astype(np.float32)
    want = jstr.amb_batch_sizes(jnp.asarray(times), budget)
    got = stragglers.amb_batch_sizes(torch.from_numpy(times), budget)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shifted_exponential_moments():
    """Sample mean and std of T_i = b_ref * per-gradient time, n = 20000:
    3 standard errors of the mean (1.5 / sqrt(20000) = 0.011) is 0.034."""
    model = stragglers.ShiftedExponential(lam=2.0 / 3.0, zeta=1.0, b_ref=600)
    ref = jstr.ShiftedExponential(lam=2.0 / 3.0, zeta=1.0, b_ref=600)
    gen = torch.Generator().manual_seed(0)
    times = model.per_gradient_times(gen, 20000, 3)
    assert times.shape == (20000, 3) and times.dtype == torch.float32
    assert torch.equal(times[:, 0], times[:, 2])         # linear progress
    t_batch = times[:, 0].double() * model.b_ref
    assert abs(float(t_batch.mean()) - ref.mean_batch_time()) < 0.034
    assert abs(float(t_batch.std()) - ref.std_batch_time()) < 0.05
    assert float(t_batch.min()) >= ref.zeta * (1 - 1e-6)


def test_deterministic_model_matches():
    model = stragglers.Deterministic(grad_time=0.25, b_ref=4)
    ref = jstr.Deterministic(grad_time=0.25, b_ref=4)
    times = model.per_gradient_times(torch.Generator(), 3, 5)
    np.testing.assert_array_equal(
        times.numpy(), np.asarray(ref.per_gradient_times(None, 3, 5)))
    assert model.mean_batch_time() == ref.mean_batch_time()
