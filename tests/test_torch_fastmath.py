"""The port's torch fastmath flavour against its numpy flavour and the JAX
package's ``jx_*`` / ``np_*`` flavours, on the CPU.

Every function must give the same f32 bits in all of them: that is what
makes the device tracker's tracks equal the host tracker's.  Inputs come
from seeded numpy, with values placed on and around the clamps (sigmoid's
±30, exp's -87/88) and integer gaps 0-5000 (past the 4096-entry log1p
table).  Tolerance: none (bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.fastmath as jfm  # noqa: E402
import repro_torch.core.fastmath as tfm  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops run faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _inputs(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edges = []
    for c in (30.0, 60.0, 87.0, 88.0, 15.0, 44.0):     # x, 2x, and -x sides
        for v in (c, -c):
            f = np.float32(v)
            edges += [f, np.nextafter(f, np.float32(0)),
                      np.nextafter(f, np.float32(np.sign(v) * np.inf))]
    return np.concatenate([
        rng.standard_normal(4000).astype(np.float32),
        (rng.standard_normal(4000) * 40).astype(np.float32),
        rng.uniform(-100, 100, 4000).astype(np.float32),
        np.asarray(edges, np.float32), np.float32([0.0, -0.0, 1e-30])])


@pytest.mark.parametrize("name", ["exp", "sigmoid", "tanh"])
def test_transcendentals_match(name):
    x = _inputs(seed=len(name))
    t = getattr(tfm, "t_" + name)(torch.from_numpy(x)).numpy()
    n = getattr(tfm, "np_" + name)(x)
    jn = getattr(jfm, "np_" + name)(x)
    jx = jax.jit(getattr(jfm, "jx_" + name))(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(t), _bits(n))
    np.testing.assert_array_equal(_bits(t), _bits(jn))
    np.testing.assert_array_equal(_bits(t), _bits(jx))


def test_fmadd_matches_single_rounding():
    rng = np.random.default_rng(7)
    a, b, c = rng.standard_normal((3, 20000)).astype(np.float32)
    # products cancelling most of c: where double rounding would differ
    c[:5000] = -(a[:5000].astype(np.float64) * b[:5000]).astype(np.float32)
    t = tfm.t_fmadd(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    np.testing.assert_array_equal(_bits(t), _bits(tfm.np_fmadd(a, b, c)))
    np.testing.assert_array_equal(_bits(t), _bits(jfm.np_fmadd(a, b, c)))
    jx = jax.jit(jfm.jx_fmadd)(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(c))
    np.testing.assert_array_equal(_bits(t), _bits(jx))
    # scalar operands, as the exp polynomial passes them
    s = tfm.t_fmadd(tfm._EXP_POLY[0], torch.from_numpy(a),
                    tfm._EXP_POLY[1]).numpy()
    np.testing.assert_array_equal(
        _bits(s), _bits(tfm.np_fmadd(tfm._EXP_POLY[0], a, tfm._EXP_POLY[1])))


def test_log1p_int_gaps():
    te = np.arange(0, 5001, dtype=np.float32)
    table = torch.from_numpy(tfm.LOG1P_TABLE)
    t = tfm.t_log1p_int(torch.from_numpy(te), table).numpy()
    np.testing.assert_array_equal(_bits(t), _bits(tfm.np_log1p_int(te)))
    np.testing.assert_array_equal(_bits(t), _bits(jfm.np_log1p_int(te)))
    jx = jax.jit(jfm.jx_log1p_int)(jnp.asarray(te))
    np.testing.assert_array_equal(_bits(t), _bits(jx))
    np.testing.assert_array_equal(tfm.LOG1P_TABLE, jfm.LOG1P_TABLE)


@pytest.mark.parametrize("n,k,m", [(33, 64, 1),       # match/w1: one column
                                   (50, 102, 64),     # match/w0, full width
                                   (7, 96, 64),       # GRU gates
                                   (9, 38, 32)])      # det_proj
def test_matmul_pinned_order(n, k, m):
    rng = np.random.default_rng(n * k + m)
    a = np.tanh(rng.standard_normal((n, k))).astype(np.float32)
    w = (rng.standard_normal((k, m)) / np.sqrt(k)).astype(np.float32)
    t = tfm.t_matmul(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    assert t.shape == (n, m)
    np.testing.assert_array_equal(_bits(t), _bits(tfm.np_matmul(a, w)))
    np.testing.assert_array_equal(_bits(t), _bits(jfm.np_matmul(a, w)))
    jx = jax.jit(jfm.jx_matmul)(jnp.asarray(a), jnp.asarray(w))
    np.testing.assert_array_equal(_bits(t), _bits(jx))
