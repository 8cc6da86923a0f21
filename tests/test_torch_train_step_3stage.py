"""The 3-stage cases of ``tests/test_torch_train_step.py``: the same tests on
``n_stages=3`` (one image and a batch of two), in a file of their own so that
this architecture's JAX gradient compiles on another worker than the 5-stage
one.  Tolerances and method are stated there.
"""

from tests.test_torch_train_step import (  # noqa: F401  (collected here)
    case_fixture,
    check_losses_match_in_float32,
    test_gradient_leaves_match,
    test_losses_match,
    test_parameters_after_one_step_match,
    test_sampled_rois_and_labels_identical,
)
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

case = case_fixture(3)


def test_losses_match_in_float32():
    check_losses_match_in_float32()
