"""``optimize --strategy opt_with_cam`` through both command lines: the
stage-hoisted cam stage (the JAX engine's ``run_all_stages_hoisted``,
``ihmr_tpu/refine/opt_engine.py:1075-1076``) held to the JAX package's at
cut epochs. Same corpus, flags and bounds as
``tests/test_torch_port_cli_jax.py`` (params 2e-4 absolute, ``metric_dict``
1e-3 relative); a file of its own so that its JAX compile (~105 s on one
core) runs on another xdist worker than that one's.
"""

import pytest

from tests.test_torch_port_cli_jax import check_metrics, check_params, check_result_keys, run_both
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(str(tmp_path_factory.mktemp("cli_jax_opt_with_cam")), "opt_with_cam")


def test_refined_params_match_jax_with_cam(runs):
    check_params(runs)


def test_metric_dict_matches_jax_with_cam(runs):
    check_metrics(runs)


def test_evaluator_entries_match_jax_with_cam(runs):
    check_result_keys(runs)
