"""Nothing the benchmark loads is JAX or the JAX package, and its
reference loads nothing of the port: checked in fresh interpreters, by
whole top-level module names (``guards.harness_loads_no_jax``,
``guards.reference_loads_nothing_of_the_port``)."""

from benchmark.tests import guards


def test_harness_loads_no_jax():
    guards.harness_loads_no_jax()


def test_reference_loads_nothing_of_the_port():
    guards.reference_loads_nothing_of_the_port()
