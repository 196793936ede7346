"""The in-repo module core against flax.linen, whose conventions it keeps.

Each case builds the same small model in both systems and checks parameter
paths, initial values, outputs, state updates and captured intermediates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from matten_tpu.nn.module import Dense, Module

fnn = pytest.importorskip("flax.linen")


def _normal(key, shape, dtype=jnp.float32):
    return jax.random.normal(key, shape, dtype)


# ---- the same models in both systems ---------------------------------------


class Leaf(Module):
    width: int

    def __call__(self, x):
        w = self.param("w", _normal, (x.shape[-1], self.width))
        b = self.param("b", _normal, (self.width,))
        return x @ w + b


class Nested(Module):
    def __call__(self, x):
        s = self.param("scale", _normal, (x.shape[-1],))
        x = Dense(6)(x * s)  # Dense_0
        x = Leaf(width=5, name="leaf")(x)
        x = Dense(4)(jnp.tanh(x))  # Dense_1
        return Leaf(width=3)(x)  # Leaf_0


class Chain(Module):
    layers: tuple
    head: Module

    def __call__(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.head(x)


class Stats(Module):
    def __call__(self, x, train: bool = True):
        mean = self.variable("batch_stats", "mean", lambda: jnp.zeros(x.shape[-1]))
        g = self.param("g", jax.nn.initializers.ones, (x.shape[-1],))
        if train and not self.is_initializing():
            mean.value = 0.9 * mean.value + 0.1 * x.mean(0)
        return (x - mean.value) * g


def _flax_twins():
    """The same classes, under the same names (auto-names use them), in flax."""

    class Leaf(fnn.Module):
        width: int

        @fnn.compact
        def __call__(self, x):
            w = self.param("w", _normal, (x.shape[-1], self.width))
            b = self.param("b", _normal, (self.width,))
            return x @ w + b

    class Nested(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            s = self.param("scale", _normal, (x.shape[-1],))
            x = fnn.Dense(6)(x * s)
            x = Leaf(width=5, name="leaf")(x)
            x = fnn.Dense(4)(jnp.tanh(x))
            return Leaf(width=3)(x)

    class Chain(fnn.Module):
        layers: tuple
        head: fnn.Module

        @fnn.compact
        def __call__(self, x):
            for layer in self.layers:
                x = layer(x)
            return self.head(x)

    class Stats(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = True):
            mean = self.variable("batch_stats", "mean", lambda: jnp.zeros(x.shape[-1]))
            g = self.param("g", jax.nn.initializers.ones, (x.shape[-1],))
            if train and not self.is_initializing():
                mean.value = 0.9 * mean.value + 0.1 * x.mean(0)
            return (x - mean.value) * g

    return Leaf, Nested, Chain, Stats


FLAX_LEAF, FLAX_NESTED, FLAX_CHAIN, FLAX_STATS = _flax_twins()


def _chain(leaf, stats, chain, dense):
    return chain(
        layers=(leaf(width=7, name="ignored"), stats(), dense(5)),
        head=leaf(width=2),
    )


CASES = {
    "dense": (lambda: Dense(3), lambda: fnn.Dense(3)),
    "nested": (Nested, FLAX_NESTED),
    "chain": (
        lambda: _chain(Leaf, Stats, Chain, Dense),
        lambda: _chain(FLAX_LEAF, FLAX_STATS, FLAX_CHAIN, fnn.Dense),
    ),
}


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _x():
    return jax.random.normal(jax.random.PRNGKey(1), (4, 8))


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_matches_flax(case):
    ours, theirs = (f() for f in CASES[case])
    key = jax.random.PRNGKey(20260819)
    _assert_trees_equal(ours.init(key, _x()), dict(theirs.init(key, _x())))


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_matches_flax(case):
    ours, theirs = (f() for f in CASES[case])
    v = ours.init(jax.random.PRNGKey(3), _x())
    x = _x() * 2.0
    mutable = ["batch_stats"] if "batch_stats" in v else False
    out_ours = ours.apply(v, x, mutable=mutable)
    out_theirs = theirs.apply(v, x, mutable=mutable)
    if mutable:
        out_theirs = (out_theirs[0], dict(out_theirs[1]))
    _assert_trees_equal(out_ours, out_theirs)


def test_capture_intermediates_matches_flax():
    ours, theirs = (f() for f in CASES["chain"])
    v = ours.init(jax.random.PRNGKey(3), _x())
    keep = lambda mdl, name: name == "__call__"  # noqa: E731
    kw = dict(mutable=["batch_stats"], capture_intermediates=keep)
    _, ours_cols = ours.apply(v, _x(), **kw)
    _, theirs_cols = theirs.apply(v, _x(), **kw)
    _assert_trees_equal(ours_cols["intermediates"], dict(theirs_cols)["intermediates"])
    assert set(ours_cols["intermediates"]) == {"layers_0", "layers_1", "layers_2", "head", "__call__"}


def test_immutable_state_write_raises():
    model = Stats()
    v = model.init(jax.random.PRNGKey(0), _x())
    with pytest.raises(ValueError, match="immutable"):
        model.apply(v, _x())
    out = model.apply(v, _x(), train=False)
    assert out.shape == (4, 8)


def test_missing_param_without_rng_raises():
    with pytest.raises(ValueError, match="no rng"):
        Leaf(width=2).apply({"params": {}}, _x())


def test_unbound_module_with_params_raises():
    with pytest.raises(ValueError, match="not bound"):
        Leaf(width=2)(_x())
