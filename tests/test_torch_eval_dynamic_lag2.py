"""The dynamic slice with evaluation on at dispatch lag 2 against the JAX
package's (tests/test_torch_eval_dynamic.py runs lag 1 and says how)."""

import pytest

from test_torch_eval_dynamic import (
    REGION_IDS, REGIONS, check_dynamic_run, run_lag,
)
from test_torch_eval_slice import SliceRun, check_fill, check_renders, \
    check_witness
from torch_threads import threads

torch_threads = threads(2)


@pytest.fixture(scope="module")
def lag2(tmp_path_factory) -> SliceRun:
    return run_lag(tmp_path_factory, 2)


def test_dynamic_lag2_render_candidates_fit(lag2):
    check_fill(lag2.fill)


@pytest.mark.parametrize("region", REGIONS, ids=REGION_IDS)
def test_dynamic_lag2_renders_agree(lag2, region):
    check_renders(*lag2.renders, region=region)


def test_dynamic_lag2_witness_rows(lag2):
    check_witness(lag2.jax_eval, *lag2.renders, lag2.tdir)


def test_dynamic_slice_lag2_csvs_match_jax(lag2):
    check_dynamic_run(lag2)
