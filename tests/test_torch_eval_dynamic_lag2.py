"""The dynamic slice with evaluation on at dispatch lag 2 against the JAX
package's (tests/test_torch_eval_dynamic.py runs lag 1 and says how)."""

from test_torch_eval_dynamic import check_dynamic_run, run_lag
from torch_threads import threads

torch_threads = threads(2)


def test_dynamic_slice_lag2_csvs_match_jax(tmp_path_factory):
    check_dynamic_run(run_lag(tmp_path_factory, 2))
