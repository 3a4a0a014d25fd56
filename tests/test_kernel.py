"""Kernel tests — mirrors the reference suite tests/test_kernel.cpp.

Covers construction/copy (:48-68), composition operators before & after
update_location (:80-151), evaluate/grad vs closed forms (:153-174), and
location/parameter update semantics on a composed kernel (:176-248).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from svgdcpp_jax import DimensionMismatchError, Kernel, UnsetError


def sq_exp_fn(x, params, location):
    # exp(-||x - x'||^2) — the reference oracle kernel (test_svgd.cpp:97-104)
    diff = x - location
    return jnp.exp(-diff @ diff)


def sq_exp_np(x, loc):
    d = x - loc
    return np.exp(-d @ d)


def sq_exp_grad_np(x, loc):
    d = x - loc
    return -2.0 * d * np.exp(-d @ d)


def poly_fn(x, params, location):
    # (x . x' + c)^2
    (c,) = params
    return (x @ location + c) ** 2


POLY_C = np.array(1.5)


def poly_np(x, loc, c=POLY_C):
    return (x @ loc + c) ** 2


def poly_grad_np(x, loc, c=POLY_C):
    return 2.0 * (x @ loc + c) * loc


@pytest.fixture
def sq_exp():
    k = Kernel(2, kernel_fn=sq_exp_fn)
    k.initialize()
    return k


@pytest.fixture
def poly():
    k = Kernel(2, kernel_fn=poly_fn, parameters=(POLY_C,))
    k.initialize()
    return k


class TestConstruction:
    def test_unset_raises(self):
        with pytest.raises(UnsetError):
            Kernel(2).initialize()

    def test_location_zero_initialized(self, sq_exp):
        # reference Kernel.hpp:45
        np.testing.assert_array_equal(np.asarray(sq_exp.location), np.zeros(2))

    def test_location_dim_mismatch(self, sq_exp):
        with pytest.raises(DimensionMismatchError):
            sq_exp.update_location(np.zeros(3))

    def test_clone_is_deep(self, sq_exp):
        c = sq_exp.clone()
        c.update_location(np.ones(2))
        np.testing.assert_array_equal(np.asarray(sq_exp.location), np.zeros(2))


class TestEvaluate:
    def test_kernel_value(self, sq_exp, rng):
        loc = rng.uniform(-1, 1, 2)
        sq_exp.update_location(loc)
        for _ in range(5):
            x = rng.uniform(-1, 1, 2)
            assert np.isclose(float(sq_exp.evaluate_kernel(x)), sq_exp_np(x, loc))

    def test_kernel_grad(self, sq_exp, rng):
        loc = rng.uniform(-1, 1, 2)
        sq_exp.update_location(loc)
        x = rng.uniform(-1, 1, 2)
        np.testing.assert_allclose(
            np.asarray(sq_exp.evaluate_kernel_grad(x)),
            sq_exp_grad_np(x, loc),
            rtol=1e-12,
        )

    def test_parameterized_kernel(self, poly, rng):
        loc = rng.uniform(-1, 1, 2)
        poly.update_location(loc)
        x = rng.uniform(-1, 1, 2)
        assert np.isclose(float(poly.evaluate_kernel(x)), poly_np(x, loc))
        np.testing.assert_allclose(
            np.asarray(poly.evaluate_kernel_grad(x)), poly_grad_np(x, loc), rtol=1e-12
        )

    def test_batched_evaluate(self, sq_exp, rng):
        loc = rng.uniform(-1, 1, 2)
        sq_exp.update_location(loc)
        xs = rng.uniform(-1, 1, (6, 2))
        vals = np.asarray(sq_exp.evaluate_kernel(xs))
        for i in range(6):
            assert np.isclose(vals[i], sq_exp_np(xs[i], loc))


class TestComposition:
    def test_sum_before_and_after_location_update(self, sq_exp, poly, rng):
        k = sq_exp + poly
        x = rng.uniform(-1, 1, 2)
        # location defaults to zero
        assert np.isclose(
            float(k.evaluate_kernel(x)),
            sq_exp_np(x, np.zeros(2)) + poly_np(x, np.zeros(2)),
        )
        loc = rng.uniform(-1, 1, 2)
        k.update_location(loc)
        assert np.isclose(
            float(k.evaluate_kernel(x)), sq_exp_np(x, loc) + poly_np(x, loc)
        )

    def test_all_operators(self, sq_exp, poly, rng):
        loc = rng.uniform(-1, 1, 2)
        x = rng.uniform(-1, 1, 2)
        a, b = sq_exp_np(x, loc), poly_np(x, loc)
        for k, expected in [
            (sq_exp + poly, a + b),
            (sq_exp - poly, a - b),
            (sq_exp * poly, a * b),
            (sq_exp / poly, a / b),
        ]:
            k.update_location(loc)
            assert np.isclose(float(k.evaluate_kernel(x)), expected)

    def test_product_grad(self, sq_exp, poly, rng):
        k = sq_exp * poly
        loc = rng.uniform(-1, 1, 2)
        k.update_location(loc)
        x = rng.uniform(-1, 1, 2)
        expected = sq_exp_grad_np(x, loc) * poly_np(x, loc) + sq_exp_np(
            x, loc
        ) * poly_grad_np(x, loc)
        np.testing.assert_allclose(
            np.asarray(k.evaluate_kernel_grad(x)), expected, rtol=1e-12
        )

    def test_dimension_mismatch_raises(self, sq_exp):
        with pytest.raises(DimensionMismatchError):
            _ = sq_exp + Kernel(3, kernel_fn=sq_exp_fn)

    def test_unset_operand_raises(self, sq_exp):
        with pytest.raises(UnsetError):
            _ = sq_exp + Kernel(2)

    def test_composed_parameter_update(self, sq_exp, poly, rng):
        # Composed params = concatenation; update the poly slot
        # (reference test_kernel.cpp:176-248).
        k = poly + poly
        assert len(k.parameters) == 2
        loc = rng.uniform(-1, 1, 2)
        k.update_location(loc)
        x = rng.uniform(-1, 1, 2)
        k.update_parameters([np.array(2.0), np.array(3.0)])
        expected = poly_np(x, loc, 2.0) + poly_np(x, loc, 3.0)
        assert np.isclose(float(k.evaluate_kernel(x)), expected)


def test_update_kernel_clears_composed_structure(rng):
    """Replacing a composed kernel's function must drop BOTH the algebraic
    compose record and the old adaptive slots — the stale slot list would
    make the driver refill (or index past) the new function's parameters
    every step."""
    import svgdcpp_jax as sv

    x0 = rng.normal(size=(12, 2))
    model = sv.MultivariateNormal(np.zeros(2), np.eye(2))
    composed = sv.GaussianRBFKernel(
        x0, sv.ScaleMethod.MEDIAN, model
    ) + sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    assert len(composed.adaptive_slots()) == 2

    composed.update_kernel(
        lambda x, params, loc: jnp.exp(-jnp.sum((x - loc) ** 2) * params[0][0, 0])
    )
    composed.update_parameters((0.5 * np.eye(2),))
    assert composed.adaptive_slots() == []  # stale slots dropped

    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=2, num_iterations=2, coordinate_matrix=x0.copy(),
            kernel=composed, model=model, optimizer=sv.AdaGrad(2, 12, 0.1),
        )
    )
    svgd.initialize()
    out = np.asarray(svgd.run())
    assert np.isfinite(out).all()
    # the fixed-bandwidth parameter is NOT overwritten by median refills
    np.testing.assert_allclose(
        np.asarray(composed.parameters[0]), 0.5 * np.eye(2)
    )
